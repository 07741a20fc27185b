"""Port vs reference, training of the vlm (pixtral-12b, ``image_embeds`` in
the loss) and ssm (rwkv6-3b) families: the checks of
``tests/test_torch_train_families.py`` (prune specs, loss and gradients
with ``cfg.remat`` on and off, ADMM and ``finalize`` over the RWKV
projections, ``make_train_step`` in the ADMM and retrain phases with grad
accumulation 1 and 2, and, for rwkv6, ``train_loop``'s phases) on their
SMOKE configs, at that file's tolerances."""

import pytest

pytest.importorskip("jax")

from test_torch_train_families import (  # noqa: E402
    _check_admm_and_finalize, _check_loss_and_grads, _check_make_train_step,
    _check_prune_specs, _check_train_loop_phases)

ARCHS = ("pixtral-12b", "rwkv6-3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_prune_specs_match_reference(arch):
    _check_prune_specs(arch)


@pytest.mark.parametrize("arch,remat", [("pixtral-12b", True),
                                        ("rwkv6-3b", True),
                                        ("rwkv6-3b", False)])
def test_loss_and_grads_match_reference(arch, remat):
    _check_loss_and_grads(arch, remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_admm_and_finalize_match_reference(arch):
    _check_admm_and_finalize(arch)


@pytest.mark.parametrize("phase", ["admm", "retrain"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_reference(arch, accum, phase):
    _check_make_train_step(arch, accum, phase)


def test_train_loop_phases_and_pruned_members():
    _check_train_loop_phases("rwkv6-3b")

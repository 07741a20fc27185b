"""Port vs reference, training of the hybrid family (jamba-v0.1-52b's
SMOKE config: one period of 8 layers, mamba and one attention layer, MoE
on every other layer): the checks of ``tests/test_torch_train_families.py``
(prune specs over ``in_proj``/``out_proj`` and the stacked experts, loss
and gradients with ``cfg.remat`` on and off, ADMM and ``finalize`` over
both, ``make_train_step`` in the ADMM and retrain phases with grad
accumulation 1 and 2, ``train_loop``'s phases) at that file's
tolerances."""

import pytest

pytest.importorskip("jax")

from test_torch_train_families import (  # noqa: E402
    _check_admm_and_finalize, _check_loss_and_grads, _check_make_train_step,
    _check_prune_specs, _check_train_loop_phases)

ARCH = "jamba-v0.1-52b"


def test_prune_specs_match_reference():
    _check_prune_specs(ARCH)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(remat):
    _check_loss_and_grads(ARCH, remat)


def test_admm_and_finalize_match_reference():
    _check_admm_and_finalize(ARCH)


@pytest.mark.parametrize("phase", ["admm", "retrain"])
@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_reference(accum, phase):
    _check_make_train_step(ARCH, accum, phase)


def test_train_loop_phases_and_pruned_members():
    _check_train_loop_phases(ARCH)

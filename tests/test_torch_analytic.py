"""Port vs reference, ``runtime/analytic``: ``param_count`` (total and
active, with and without embeddings), ``ideal_bytes_per_chip`` and
``model_flops`` for every arch × input shape, full and SMOKE configs; and
``param_count`` against the numel of the port's own SMOKE parameter trees,
as the reference's ``tests/test_substrate.py`` checks its own.

Tolerance: none against the reference (the same integer and float
arithmetic); 12% against a real tree, the reference's own bound (norms,
biases and mixing vectors are not counted)."""

import pytest

pytest.importorskip("jax")

from repro import configs as jcfgs  # noqa: E402
from repro.runtime import analytic as janalytic  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.runtime import analytic as tanalytic  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_analytic_matches_reference(arch, smoke):
    get_j = jcfgs.get_smoke_config if smoke else jcfgs.get_config
    get_t = tcfgs.get_smoke_config if smoke else tcfgs.get_config
    jcfg, tcfg = get_j(arch), get_t(arch)
    for active in (False, True):
        for embed in (False, True):
            assert tanalytic.param_count(
                tcfg, active=active, include_embed=embed) == \
                janalytic.param_count(jcfg, active=active,
                                      include_embed=embed)
    for name in tcfgs.SHAPES:
        tshape, jshape = tcfgs.SHAPES[name], jcfgs.SHAPES[name]
        for chips in (1, 4, 256):
            assert tanalytic.ideal_bytes_per_chip(tcfg, tshape, chips) == \
                janalytic.ideal_bytes_per_chip(jcfg, jshape, chips)
        assert tanalytic.model_flops(tcfg, tshape) == \
            janalytic.model_flops(jcfg, jshape)


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_param_count_matches_the_ports_own_tree(arch):
    cfg = tcfgs.get_smoke_config(arch)
    params = model_fns(cfg).init_params(0, device="cpu")
    real = sum(leaf.numel() for leaf in leaves(params)
               if hasattr(leaf, "numel"))
    assert tanalytic.param_count(cfg) == pytest.approx(real, rel=0.12)

"""The tensor-core launch plan of the block-skipping matmul
(``kernels/bcr_spmm_skip.py:skip_plan``), a pure function of ``row_start``,
M, the block shape and the SM count, pinned on the CPU: every tile of every
block row is covered once, in order, by contiguous splits; every empty
block row gets a unit; the grid fills an H100's 132 SMs at decode for the
full-width wq and MLP wo packs; units run longest first; every CTA fits two
to an SM; and the wrapper's rule for which body runs."""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.bcr import BCRSpec

# ``repro_torch.kernels`` exports the function under its module's name
SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")

SMS = 132                       # an H100 SXM's streaming multiprocessors
MS = [1, 8, 16, 17, 64, 65, 300, 1024, 2048]


def _pack(n, k, block=(128, 128), keep=0.25, seed=0, zero_rows=0):
    """``pack_skip`` of seeded normal weights with one lognormal (sigma 1)
    factor per block, as phase 3 of ``chip_smoke.py`` makes them."""
    rng = np.random.default_rng(seed)
    br, bc = block
    w = rng.normal(size=(n, k)) * np.exp(rng.normal(
        size=(n // br, 1, k // bc, 1))).repeat(br, 1).repeat(bc, 3).reshape(
            n, k)
    w[:zero_rows] = 0.0
    return SK.pack_skip(torch.as_tensor(w, dtype=torch.float32),
                        BCRSpec(block_shape=block, keep_frac=keep,
                                align=8 if br >= 32 else 1, balanced=False))


@pytest.fixture(scope="module")
def full():
    """Full-width llama3.2-1b wq (2048 x 2048) and MLP wo (2048 x 8192)
    at unbalanced keep 0.25, block 128; wq also with two zeroed block
    rows."""
    return {"wq": _pack(2048, 2048), "mlp_wo": _pack(2048, 8192, seed=1),
            "wq_empty": _pack(2048, 2048, seed=2, zero_rows=256)}


def _lm_head_row_start(seed=3):
    """lm_head's shape (1002 block rows of 16 blocks) at a surviving share
    of about 0.51, drawn directly: packing the 128256 x 2048 weight on the
    CPU would take a gigabyte."""
    counts = np.random.default_rng(seed).binomial(16, 0.51, size=1002)
    counts[::97] = 0                               # a few empty block rows
    return tuple(int(v) for v in np.concatenate([[0], np.cumsum(counts)]))


def _rs(p):
    return tuple(p.row_start.tolist())


def _check_cover(plan, row_start):
    """Every tile of every block row covered exactly once, in order, by
    the row's splits 0..s-1; partial slots and counters distinct."""
    nb_r = len(row_start) - 1
    by_row = {}
    for u in plan.units:
        assert len(u) == SK.UNIT_FIELDS
        by_row.setdefault(u[0], []).append(u)
    assert sorted(by_row) == list(range(nb_r))     # every row, empty too
    parts, ctrs = set(), set()
    for i, us in by_row.items():
        us.sort(key=lambda u: u[3])
        s = len(us)
        assert [u[3] for u in us] == list(range(s))  # contiguous splits
        assert all(u[4] == s for u in us)
        assert us[0][1] == row_start[i] and us[-1][2] == row_start[i + 1]
        for a, b in zip(us, us[1:]):
            assert a[2] == b[1]                    # in order, no gap
        assert all(u[2] - u[1] >= 1 for u in us) or s == 1
        if s == 1:
            assert us[0][5] == us[0][6] == -1
        else:
            assert len({(u[5], u[6]) for u in us}) == 1
            parts.update(range(us[0][5], us[0][5] + s))
            ctrs.add(us[0][6])
    assert parts == set(range(plan.parts))
    assert ctrs == set(range(plan.split_rows))


def _check_legal(plan, m, block):
    br, bc = block
    assert plan.chunks * plan.rows == br and plan.rows % 16 == 0
    assert plan.m_tiles * plan.m_tile >= m > (plan.m_tiles - 1) * plan.m_tile
    assert bc % plan.kc == 0 and plan.kc in (16, 32, 64)
    assert 2 <= plan.stages <= SK.MAX_STAGES
    assert plan.smem_bytes == SK.skip_smem(plan.m_tile, plan.rows, plan.kc,
                                           plan.stages)
    assert plan.smem_bytes <= SK.TWO_CTA_SMEM     # two CTAs an SM
    assert plan.grid == len(plan.units) * plan.chunks * plan.m_tiles
    assert plan.workspace_floats == (plan.parts * plan.chunks * plan.m_tiles
                                     * plan.m_tile * plan.rows)
    assert plan.counters == plan.split_rows * plan.chunks * plan.m_tiles
    assert len(plan.args()) == 9
    lengths = [u[2] - u[1] for u in plan.units]
    assert lengths == sorted(lengths, reverse=True)   # longest first


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", ["wq", "mlp_wo", "wq_empty"])
def test_units_cover_every_tile_once(full, name, m):
    p = full[name]
    plan = SK.skip_plan(_rs(p), m, (128, 128), SMS)
    _check_cover(plan, _rs(p))
    _check_legal(plan, m, (128, 128))


@pytest.mark.parametrize("m", MS)
def test_lm_head_units(m):
    rs = _lm_head_row_start()
    plan = SK.skip_plan(rs, m, (128, 128), SMS)
    _check_cover(plan, rs)
    _check_legal(plan, m, (128, 128))
    assert plan.parts == 0          # 1002 block rows fill the card unsplit


def test_empty_block_rows_get_a_unit(full):
    p = full["wq_empty"]
    rs = _rs(p)
    assert rs[2] == 0               # block rows 0 and 1 hold no tile
    for m in (8, 2048):
        plan = SK.skip_plan(rs, m, (128, 128), SMS)
        empty = [u for u in plan.units if u[0] in (0, 1)]
        assert [(u[1], u[2], u[4]) for u in empty] == [(0, 0, 1), (0, 0, 1)]
    # a fully pruned W packs one zero tile; its other rows are empty units
    zero = SK.pack_skip(torch.zeros((512, 256)),
                        BCRSpec(block_shape=(128, 128), keep_frac=0.25,
                                align=8, balanced=False))
    plan = SK.skip_plan(_rs(zero), 8, (128, 128), SMS)
    _check_cover(plan, _rs(zero))
    assert sum(u[2] - u[1] for u in plan.units) == 1


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("name", ["wq", "mlp_wo", "wq_empty"])
def test_decode_grid_fills_the_card(full, name, m):
    plan = SK.skip_plan(_rs(full[name]), m, (128, 128), SMS)
    assert plan.grid >= SMS
    assert plan.parts > 0           # 16 block rows alone leave SMs idle
    assert not plan.wgmma and plan.m_tile == 8


def test_serving_choices(full):
    """Decode: wq's ~130 tiles become single-tile units over 64-row
    slices (the grid doubles past 132), MLP wo's ~530 keep 128 rows in
    units of a few tiles; prefill: wgmma on the 128 tile, no split (16
    block rows x 16 M tiles fill the card), three 32 KB stages."""
    wq = SK.skip_plan(_rs(full["wq"]), 8, (128, 128), SMS)
    assert (wq.rows, wq.chunks) == (64, 2)
    assert max(u[2] - u[1] for u in wq.units) == 1
    wo = SK.skip_plan(_rs(full["mlp_wo"]), 8, (128, 128), SMS)
    assert (wo.rows, wo.chunks) == (128, 1)
    assert max(u[2] - u[1] for u in wo.units) <= 4
    for name in ("wq", "mlp_wo"):
        pre = SK.skip_plan(_rs(full[name]), 2048, (128, 128), SMS)
        assert (pre.wgmma, pre.m_tile, pre.rows, pre.kc) == (True, 128, 128,
                                                             64)
        assert pre.parts == 0 and pre.stages == 3 and pre.grid == 16 * 16


@pytest.mark.parametrize("m", [1, 8, 17, 300])
@pytest.mark.parametrize("block", [(16, 16), (16, 32), (32, 32), (64, 64),
                                   (128, 128), (48, 80), (256, 128)])
def test_gpu_test_blocks_get_a_legal_plan(block, m):
    """The block shapes the GPU tests launch (and two more multiples of 16)
    all get a tensor-core plan; wgmma only where both sides are multiples
    of 64 and M passes the mma.sync tiles."""
    br, bc = block
    p = _pack(4 * br, 3 * bc, block, keep=0.3, seed=5)
    plan = SK.skip_plan(_rs(p), m, block, SMS)
    _check_cover(plan, _rs(p))
    _check_legal(plan, m, block)
    assert plan.wgmma == (m > 64 and br % 64 == 0 and bc % 64 == 0)
    assert plan.kc == (64 if bc % 64 == 0 else 32 if bc % 32 == 0 else 16)


@pytest.mark.parametrize("dtype,block,aligned,want", [
    (torch.bfloat16, (128, 128), True, True),
    (torch.bfloat16, (16, 32), True, True),
    (torch.bfloat16, (8, 8), True, False),      # sides not multiples of 16
    (torch.bfloat16, (24, 16), True, False),
    (torch.bfloat16, (128, 128), False, False),  # unaligned tiles
    (torch.float32, (128, 128), True, False)])   # fp32: the 1e-4 body
def test_which_body_runs(dtype, block, aligned, want):
    assert SK.tensor_core_body(dtype, block, aligned) is want


def test_other_blocks_raise_in_the_plan():
    with pytest.raises(ValueError, match="multiples of 16"):
        SK.skip_plan((0, 1, 2), 8, (8, 8), SMS)


def test_plan_is_pure(full):
    rs = _rs(full["mlp_wo"])
    a = SK.skip_plan(rs, 8, (128, 128), SMS)
    SK.skip_plan.cache_clear()
    b = SK.skip_plan(rs, 8, (128, 128), SMS)
    assert a == b and a is not b
    assert SK.split_units(rs, 1, SMS) == SK.split_units(rs, 1, SMS)


def test_row_start_that_disagrees_with_bi_raises(full):
    p = full["wq"]
    rs = p.row_start.clone()
    rs[5] += 1                       # row 4 claims a tile of row 5
    bad = SK.SkipPacked(tiles=p.tiles, bi=p.bi, bj=p.bj, last=p.last,
                        shape=p.shape, block_shape=p.block_shape,
                        row_mask=p.row_mask, row_start=rs)
    with pytest.raises(ValueError, match="row_start disagrees"):
        SK._checked_plan(bad, torch.device("cpu"))
    # the checked pack keeps row_start on the host for the plan
    SK._checked_plan(p, torch.device("cpu"))
    assert p._checked[2] == _rs(p)

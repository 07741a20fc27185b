"""Port vs reference, the paper-general (unbalanced) BCR half: masks,
projections and set membership, ``pack_skip`` and the block-skipping
matmul's plain version against the reference's Pallas kernel in interpret
mode, its edge cases, the wrapper's plan checks, and the converter. Inputs
come from numpy with a fixed seed.

Tolerances: masks, packs and membership are compared exactly (the same
fp32 energies rank the same stripes); the matmul within 1e-5 × the output
scale (fp32 sums in another order)."""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bcr as jbcr  # noqa: E402

from repro_torch.convert import from_jax_skip  # noqa: E402
from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.bcr_spmm_skip import (  # noqa: E402
    SkipPacked, _checked_plan, bcr_spmm_skip, pack_skip, row_start_from_bi)

# ``repro.kernels`` exports the function under its module's name
jskip = importlib.import_module("repro.kernels.bcr_spmm_skip")

torch.set_num_threads(2)

CASES = [  # (shape, block, keep)
    ((64, 64), (16, 16), 0.25),
    ((128, 64), (32, 16), 0.1),
    ((64, 128), (16, 32), 0.5),
    ((96, 96), (32, 32), 0.05),
    ((256, 512), (32, 32), 0.05),
]


def _w(shape, seed=0, skew=True):
    """Seeded normal weights; with ``skew`` each block row is scaled by a
    lognormal factor so some blocks lose the global ranking."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape)
    if skew:
        w = w * np.exp(rng.normal(size=(shape[0], 1)))
    return w.astype(np.float32)


def _specs(block, keep, balanced=False, align=1):
    return (jbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align,
                         balanced=balanced),
            tbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align,
                         balanced=balanced))


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("shape,block,keep", CASES)
def test_masks_match_reference(shape, block, keep, balanced):
    w = _w(shape)
    js, ts = _specs(block, keep, balanced)
    want = np.asarray(jbcr.bcr_mask(jnp.asarray(w), js))
    got = tbcr.bcr_mask(torch.from_numpy(w), ts)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbcr.bcr_project(torch.from_numpy(w), ts).numpy(),
        np.asarray(jbcr.bcr_project(jnp.asarray(w), js)))


def test_unbalanced_ranks_by_mean_and_keeps_ties():
    """Two traps of the reference's rule, pinned: stripes rank by MEAN
    energy (a taller block's stripe does not win by its length), and the
    ``sort(flat)[-k] / >=`` threshold keeps every stripe of a tie."""
    w = np.ones((32, 32), np.float32)
    js, ts = _specs((16, 16), 0.25)
    want = np.asarray(jbcr.bcr_mask(jnp.asarray(w), js))
    got = tbcr.bcr_mask(torch.from_numpy(w), ts).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.all()          # all stripes tie: every one survives
    w2 = _w((64, 32), seed=3, skew=False)
    js, ts = _specs((32, 16), 0.3)
    np.testing.assert_array_equal(
        tbcr.bcr_mask(torch.from_numpy(w2), ts).numpy(),
        np.asarray(jbcr.bcr_mask(jnp.asarray(w2), js)))


@pytest.mark.parametrize("balanced", [False, True])
def test_stacked_masks_match_reference(balanced):
    w = np.stack([_w((64, 96), seed=s) for s in range(3)])
    js, ts = _specs((16, 32), 0.25, balanced, align=4)
    want = np.asarray(jbcr.bcr_mask_any(jnp.asarray(w), js))
    got = tbcr.bcr_mask_any(torch.from_numpy(w), ts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbcr.bcr_project_any(torch.from_numpy(w), ts).numpy(),
        np.asarray(jbcr.bcr_project_any(jnp.asarray(w), js)))
    assert float(tbcr.density(got)) == pytest.approx(
        float(jbcr.density(jnp.asarray(want))))
    assert float(tbcr.pruning_rate(got)) == pytest.approx(
        float(jbcr.pruning_rate(jnp.asarray(want))))


def test_mask_from_indices_matches_reference():
    w = _w((64, 96), skew=False)
    js, ts = _specs((16, 32), 0.25, balanced=True, align=4)
    ri, ci = tbcr.bcr_indices(torch.from_numpy(w), ts)
    want = np.asarray(jbcr.mask_from_indices(
        jnp.asarray(ri.numpy()), jnp.asarray(ci.numpy()), (64, 96),
        (16, 32)))
    np.testing.assert_array_equal(
        tbcr.mask_from_indices(ri, ci, (64, 96), (16, 32)).numpy(), want)


@pytest.mark.parametrize("make", ["projected", "raw", "one_extra",
                                  "zeros"])
def test_is_bcr_set_member_matches_reference(make):
    w = _w((64, 96), skew=False)
    js, ts = _specs((16, 32), 0.25, balanced=True, align=4)
    if make == "projected":
        w = np.asarray(jbcr.bcr_project(jnp.asarray(w), js))
    elif make == "one_extra":       # one stray weight outside the support
        w = np.asarray(jbcr.bcr_project(jnp.asarray(w), js)).copy()
        blk = w[:16, :32]
        r, c = np.argwhere(blk == 0)[0]
        w[r, c] = 1.0
    elif make == "zeros":
        w = np.zeros_like(w)
    want = jbcr.is_bcr_set_member(w, js)
    assert tbcr.is_bcr_set_member(w, ts) == want
    assert tbcr.is_bcr_set_member(torch.from_numpy(w.copy()), ts) == want
    assert tbcr.is_bcr_set_member(w, ts, strict_counts=False) == \
        jbcr.is_bcr_set_member(w, js, strict_counts=False)


def _both_packs(shape, block, keep, w=None):
    w = _w(shape) if w is None else w
    js, ts = _specs(block, keep)
    return w, jskip.pack_skip(jnp.asarray(w), js), \
        pack_skip(torch.from_numpy(w), ts)


@pytest.mark.parametrize("shape,block,keep", CASES)
def test_pack_skip_matches_reference(shape, block, keep):
    _, jp, tp = _both_packs(shape, block, keep)
    for name in ("tiles", "bi", "bj", "last", "row_mask"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert tp.tiles.dtype == torch.float32
    assert tp.nbytes() == jp.nbytes()
    assert tp.shape == tuple(jp.shape)
    assert tp.block_shape == tuple(jp.block_shape)
    nb_r = shape[0] // block[0]
    counts = np.bincount(np.asarray(jp.bi), minlength=nb_r)
    np.testing.assert_array_equal(tp.row_start.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))


@pytest.mark.parametrize("shape,block,keep", CASES)
@pytest.mark.parametrize("m", [1, 8])
def test_skip_plain_matches_pallas_interpret(shape, block, keep, m):
    _, jp, tp = _both_packs(shape, block, keep)
    x = np.random.default_rng(1).normal(size=(m, shape[1])).astype(
        np.float32)
    want = np.asarray(jskip.bcr_spmm_skip(jnp.asarray(x), jp,
                                          interpret=True))
    scale = max(1.0, float(np.abs(want).max()))
    for got in (tref.bcr_spmm_skip_ref(torch.from_numpy(x), tp),
                bcr_spmm_skip(torch.from_numpy(x), tp)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_skip_plain_matches_reference_oracle_bf16():
    _, jp, tp = _both_packs((128, 64), (32, 16), 0.25)
    x = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32)
    want = np.asarray(jskip.bcr_spmm_skip_ref(
        jnp.asarray(x, jnp.bfloat16),
        dataclasses.replace(jp, tiles=jp.tiles.astype(jnp.bfloat16))),
        np.float32)
    got = tref.bcr_spmm_skip_ref(
        torch.from_numpy(x).bfloat16(),
        dataclasses.replace(tp, tiles=tp.tiles.bfloat16()))
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * scale)


def test_fully_pruned_matrix():
    w = np.zeros((32, 32), np.float32)
    _, jp, tp = _both_packs((32, 32), (16, 16), 0.25, w=w)
    assert tp.tiles.shape == (1, 16, 16) and not tp.tiles.any()
    assert tp.bi.tolist() == [0] and tp.bj.tolist() == [0]
    assert tp.last.tolist() == [1] and tp.row_start.tolist() == [0, 1, 1]
    np.testing.assert_array_equal(tp.row_mask.numpy(),
                                  np.asarray(jp.row_mask))
    y = bcr_spmm_skip(torch.ones(4, 32), tp)
    assert torch.equal(y, torch.zeros(4, 32))


def test_empty_block_row_is_exact_zero():
    w = _w((96, 96), skew=False)
    w[:32, :] = 0.0                 # a whole block row pruned away
    _, jp, tp = _both_packs((96, 96), (32, 32), 0.1, w=w)
    assert not bool(tp.row_mask[:32].any())
    assert tp.row_start[0] == tp.row_start[1] == 0
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 96)).astype(np.float32))
    y = bcr_spmm_skip(x, tp)
    assert torch.equal(y[:, :32], torch.zeros(8, 32))
    want = np.asarray(jskip.bcr_spmm_skip(jnp.asarray(x.numpy()), jp,
                                          interpret=True))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-4)


def test_hand_rolled_pack_without_row_mask():
    """A pack built by hand (no ``row_mask``, no ``row_start``) runs, and
    its plan is rebuilt from ``bi`` — the reference rebuilds its mask."""
    _, jp, tp = _both_packs((96, 96), (32, 32), 0.1)
    legacy = SkipPacked(tp.tiles, tp.bi, tp.bj, tp.last, tp.shape,
                        tp.block_shape)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(8, 96)).astype(np.float32))
    torch.testing.assert_close(bcr_spmm_skip(x, legacy),
                               bcr_spmm_skip(x, tp), rtol=0, atol=1e-6)
    assert torch.equal(_checked_plan(legacy, torch.device("cpu")),
                       tp.row_start)
    jlegacy = jskip.SkipPacked(jp.tiles, jp.bi, jp.bj, jp.last, jp.shape,
                               jp.block_shape)
    want = np.asarray(jskip.bcr_spmm_skip(jnp.asarray(x.numpy()), jlegacy,
                                          interpret=True))
    np.testing.assert_allclose(bcr_spmm_skip(x, legacy).numpy(), want,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("fault", ["unsorted", "bi_range", "bj_range",
                                   "row_start", "tile_count", "dtype",
                                   "hand_rolled_bi_range"])
def test_plan_check_rejects_bad_packs(fault):
    """The wrapper's plan check (run once per pack before the first launch
    on the card) fails loudly on a hand-rolled pack it cannot run."""
    _, _, tp = _both_packs((96, 96), (32, 32), 0.5)
    assert tp.bi.numel() >= 3
    kw = {}
    if fault == "unsorted":
        kw = dict(bi=tp.bi.flip(0).contiguous(), row_mask=None,
                  row_start=None)
    elif fault in ("bi_range", "hand_rolled_bi_range"):
        bi = tp.bi.clone()
        bi[-1] = 3
        kw = dict(bi=bi)
        if fault == "hand_rolled_bi_range":
            kw.update(row_mask=None, row_start=None)
    elif fault == "bj_range":
        bj = tp.bj.clone()
        bj[0] = -1
        kw = dict(bj=bj)
    elif fault == "row_start":
        rs = tp.row_start.clone()
        rs[1] += 1
        kw = dict(row_start=rs)
    elif fault == "tile_count":
        kw = dict(tiles=tp.tiles[:-1].contiguous())
    elif fault == "dtype":
        kw = dict(bi=tp.bi.long())
    bad = dataclasses.replace(tp, **kw)
    with pytest.raises(TypeError if fault == "dtype" else ValueError):
        _checked_plan(bad, torch.device("cpu"))
    assert torch.equal(_checked_plan(tp, torch.device("cpu")), tp.row_start)


def test_row_start_from_bi():
    bi = torch.tensor([0, 0, 2, 2, 2, 3], dtype=torch.int32)
    assert row_start_from_bi(bi, 5).tolist() == [0, 2, 2, 5, 6, 6]


@pytest.mark.parametrize("with_mask", [True, False])
def test_converter_carries_reference_skip_pack(with_mask):
    _, jp, tp = _both_packs((128, 64), (32, 16), 0.1)
    if not with_mask:
        jp = jskip.SkipPacked(jp.tiles, jp.bi, jp.bj, jp.last, jp.shape,
                              jp.block_shape)
    conv = from_jax_skip(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    for name in ("tiles", "bi", "bj", "last", "row_start"):
        assert torch.equal(getattr(conv, name), getattr(tp, name)), name
    assert conv.bi.dtype == torch.int32
    if with_mask:
        assert torch.equal(conv.row_mask, tp.row_mask)
        assert conv.nbytes() == jp.nbytes()
    else:
        assert conv.row_mask is None
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 64)).astype(np.float32))
    torch.testing.assert_close(bcr_spmm_skip(x, conv),
                               bcr_spmm_skip(x, tp), rtol=0, atol=0)

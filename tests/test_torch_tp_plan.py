"""The port's BCR plan splitters for tensor-parallel serving, held to the
reference's (``kernels/plan.py``'s ``split_packed``, ``merge_packed``,
``split_grouped``, ``merge_grouped``, ``splittable_packed``) leaf by leaf
over fp and int8 packs; the shards' plain-version products concatenated
bit-equal to the whole's; and the launch decisions a shard keeps: its
``launch_genome`` and its whole ``launch_plan`` (M tile, configuration,
split, stages) equal to the whole weight's at M in {1, 4, 8, 32} and tp in
{2, 4}, as ``paged_plan``'s row tile and split over a head shard of the
pool."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core.bcr import BCRSpec as JBCRSpec  # noqa: E402
from repro.core.bcrc import tbcrc_pack as jtbcrc_pack  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402

from repro_torch.core.bcr import BCRSpec  # noqa: E402
from repro_torch.core.bcrc import TBCRC, tbcrc_pack  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels.bcr_spmm import (bcr_spmm, bcr_spmm_grouped,  # noqa
                                          launch_plan)
from repro_torch.kernels.paged_decode_attention import paged_plan  # noqa

torch.set_num_threads(2)

SMS = 132


def _jpack(n=32, k=24, seed=0, block=(8, 8), keep=0.5):
    w = jax.random.normal(jax.random.PRNGKey(seed), (n, k))
    return jplan.attach_plan(jtbcrc_pack(w, JBCRSpec(block_shape=block,
                                                     keep_frac=keep,
                                                     align=1)))


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _port(jp):
    """The port's pack of the same weight: the reference pack's arrays."""
    scales = jp.plan.block_scales
    plan = tplan.BCRPlan(gather_cols=_t(jp.plan.gather_cols, torch.int32),
                         scatter_rows=_t(jp.plan.scatter_rows, torch.int32),
                         block_scales=None if scales is None else _t(scales))
    kw = dict(vals=_t(jp.vals), row_idx=_t(jp.row_idx, torch.int32),
              col_idx=_t(jp.col_idx, torch.int32), plan=plan,
              shape=tuple(jp.shape), block_shape=tuple(jp.block_shape))
    if isinstance(jp, jplan.GroupedTBCRC):
        return tplan.GroupedTBCRC(group_size=jp.group_size, **kw)
    return TBCRC(**kw)


def _same(port, ref):
    """Leaf by leaf: the packed arrays, the flat vectors, the tile scales,
    the local shape."""
    assert tuple(port.shape) == tuple(ref.shape)
    for name in ("vals", "row_idx", "col_idx"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("gather_cols", "scatter_rows", "block_scales"):
        r = getattr(ref.plan, name)
        p = getattr(port.plan, name)
        assert (p is None) == (r is None), name
        if r is not None:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_split_and_merge_match_the_reference(tp, int8):
    jp = _jpack()
    if int8:
        jp = jplan.quantize_packed(jp)
    tp_shards = tplan.split_packed(_port(jp), tp)
    j_shards = jplan.split_packed(jp, tp)
    for p, r in zip(tp_shards, j_shards):
        _same(p, r)
        assert p.plan.row_shards == tp
        # local index spaces: rows of the shard, columns of the whole K
        assert int(p.plan.scatter_rows.max()) < p.shape[0]
        assert int(p.plan.gather_cols.max()) < p.shape[1]
    merged = tplan.merge_packed(tp_shards)
    _same(merged, jplan.merge_packed(j_shards))
    _same(merged, jp)
    assert merged.plan.row_shards == 1


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_grouped_split_and_merge_match_the_reference(tp, int8):
    jg = jplan.pack_group([_jpack(seed=s) for s in range(2)])
    if int8:
        jg = jplan.quantize_grouped(jg)
    tg = _port(jg)
    t_shards = tplan.split_grouped(tg, tp)
    j_shards = jplan.split_grouped(jg, tp)
    for p, r in zip(t_shards, j_shards):
        _same(p, r)
        assert p.group_size == r.group_size == 2
    _same(tplan.merge_grouped(t_shards), jplan.merge_grouped(j_shards))
    _same(tplan.merge_grouped(t_shards), jg)


def test_splittable_gives_the_reference_reasons():
    for n, tp in ((24, 2), (24, 3), (32, 2), (32, 4), (32, 3)):
        jp = _jpack(n=n)
        assert tplan.splittable_packed(_port(jp), tp) == \
            jplan.splittable_packed(jp, tp)
    with pytest.raises(ValueError, match="not divisible"):
        tplan.split_packed(_port(_jpack(n=24)), 2)
    with pytest.raises(ValueError, match="not divisible"):
        tplan.split_grouped(_port(jplan.pack_group(
            [_jpack(n=24, seed=s) for s in range(2)])), 2)


@pytest.mark.parametrize("int8", [False, True])
def test_shard_products_concatenate_to_the_whole(int8):
    """The plain versions the shards run on the CPU: column-parallel
    outputs concatenate bit-exactly, grouped ones too. Under the SwiGLU
    epilogue each shard's output is the epilogue of its slice of the
    whole's products, bit for bit; the concatenation itself is not held
    bit-exact here, because the CPU's ``F.silu`` rounds the elements of a
    buffer's scalar tail apart from its vectorized body, so an element's
    last bit depends on the buffer's length (the card's epilogue is
    per-element)."""
    from repro_torch.kernels.ref import bcr_spmm_grouped_ref, \
        grouped_epilogue
    jp = _jpack(n=32, k=24)
    jg = jplan.pack_group([_jpack(seed=s) for s in range(2)])
    if int8:
        jp, jg = jplan.quantize_packed(jp), jplan.quantize_grouped(jg)
    p, g = _port(jp), _port(jg)
    x = torch.randn(5, 24, generator=torch.Generator().manual_seed(1))
    for tp in (2, 4):
        assert torch.equal(torch.cat([bcr_spmm(x, s) for s in
                                      tplan.split_packed(p, tp)], -1),
                           bcr_spmm(x, p))
        shards = tplan.split_grouped(g, tp)
        assert torch.equal(torch.cat([bcr_spmm_grouped(x, s)
                                      for s in shards], -1),
                           bcr_spmm_grouped(x, g))
        n = g.shape[0] // tp
        for i, s in enumerate(shards):
            want = grouped_epilogue(
                bcr_spmm_grouped_ref(x, g).float()[..., i * n:(i + 1) * n]
                .contiguous(), None, "swiglu", x.dtype)
            assert torch.equal(bcr_spmm_grouped(x, s, epilogue="swiglu"),
                               want)


def _decision(p, m, g=1):
    nb_r, nb_c, r, c = p.vals.shape[-4:]
    lp = launch_plan(m, p.shape[0], p.shape[1], g, tuple(p.block_shape),
                     (r, c), SMS, p.vals.dtype == torch.int8, True, 1,
                     tplan.launch_genome(p.plan, m), tplan.plan_shards(p.plan))
    return (lp.m_tile, lp.slabs, lp.warps_m, lp.warps, lp.n_chunk,
            lp.chunks, lp.splits, lp.stages, lp.smem_bytes)


@pytest.fixture(scope="module")
def served_packs():
    """llama3.2-1b's projections at block 128, keep 0.25, bf16 tiles: the
    whole packs, each tuned for the decode batch 8 as ``pack_params`` tunes
    them, and untuned (the kernel's rule)."""
    gen = torch.Generator().manual_seed(0)
    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)
    out = {}
    for name, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192),
                       ("wi", 8192, 2048)):
        w = torch.randn(n, k, generator=gen) * k ** -0.5
        rule = tbcrc_pack(w, spec)
        rule.vals = rule.vals.to(torch.bfloat16)
        out[name] = rule
        out[name + " tuned"] = tplan.tune_packed(rule, m=8)
    out["wgi tuned"] = tplan.pack_group(
        [out["wi"], out["wi"]],
        tplan.tune_genome_for(out["wi"], m=8, max_group=2), m=8)
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_every_shard_keeps_the_whole_launch(served_packs, tp):
    """A shard has 1/tp of the output tiles; planned alone it would split
    its contraction over more CTAs and sum its partials in another order.
    Carrying the whole's genome and shard count keeps every decision."""
    bites = 0
    for name, whole in served_packs.items():
        grouped = isinstance(whole, tplan.GroupedTBCRC)
        g = whole.group_size if grouped else 1
        shards = (tplan.split_grouped(whole, tp) if grouped
                  else tplan.split_packed(whole, tp))
        for m in (1, 4, 8, 32):
            want = _decision(whole, m, g)
            for s in shards:
                assert tplan.launch_genome(s.plan, m) == \
                    tplan.launch_genome(whole.plan, m), (name, m)
                assert _decision(s, m, g) == want, (name, m, tp)
            # the same shard planned as a whole weight of its own size
            alone = dataclasses.replace(
                shards[0], plan=dataclasses.replace(shards[0].plan,
                                                    row_shards=1))
            bites += _decision(alone, m, g) != want
    assert bites, "no case where a shard planned alone would launch apart"


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("b,rows,n_cols,ps", [(8, 4, 32, 16), (8, 4, 4, 16),
                                              (2, 4, 64, 16), (8, 16, 8, 16),
                                              (1, 1, 256, 16)])
def test_paged_plan_keeps_the_whole_pool_launch(tp, b, rows, n_cols, ps):
    whole = paged_plan(b, 8, rows, n_cols, ps, SMS)
    shard = paged_plan(b, 8 // tp, rows, n_cols, ps, SMS, head_shards=tp)
    assert (shard.row_tile, shard.row_tiles, shard.pages_per_split,
            shard.splits) == (whole.row_tile, whole.row_tiles,
                              whole.pages_per_split, whole.splits)
    assert shard.units * tp == whole.units

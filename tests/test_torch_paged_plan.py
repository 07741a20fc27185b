"""The paged attention kernel's launch plan and its split-merge arithmetic,
on the CPU.

``paged_plan`` (pure Python) decides the CUDA kernel's grid from what the
host has — the block table's width, never the device lengths. The merge
tests replay the kernel's scheme in plain torch: each split's fp32 partial
(m, l, acc) over its ``pages_per_split`` pages, merged in one online pass in
split order with a partial that no key reaches weighing 0, against the plain
versions
``ref.paged_decode_attention_ref`` / ``ref.paged_prefill_append_ref`` at fp32
(tolerance 1e-5: the same products summed in another order).
"""

import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_decode_attention as PA
from repro_torch.kernels import ref
from repro_torch.kernels.paged_decode_attention import (
    F32_CONFIGS, F32_HEAD_DIMS, F32_SPLIT_KEYS, MIN_SPLIT_KEYS, SMEM_LIMIT,
    SPLIT_KEYS,
    TC_HEAD_DIMS, F32Config, cuda_core_row_tile, f32_config, launch_plan,
    paged_body, paged_plan, tensor_core_body)
from repro_torch.kernels.quant import quantize_rows

H100_SMS = 132
NEG_INF = -1e30


# -- the plan ----------------------------------------------------------------


def test_plan_at_the_serving_shapes():
    # decode, 8 slots x 8 kv-heads, G = 4 rows padded to one 16-row slab
    p = paged_plan(8, 8, 4, 32, 16, H100_SMS)
    assert (p.row_tile, p.row_tiles, p.units) == (16, 1, 64)
    assert p.splits * p.pages_per_split >= 32 and p.grid >= H100_SMS
    # prefill-append, S = 16 suffix rows x G = 4: 16-row tiles fill the
    # card, so the 128-position table is not split
    p = paged_plan(8, 8, 64, 8, 16, H100_SMS)
    assert (p.row_tile, p.row_tiles, p.units, p.splits) == (16, 4, 256, 1)
    # a longer suffix fills the card with 64-row tiles
    p = paged_plan(8, 8, 160, 16, 16, H100_SMS)
    assert (p.row_tile, p.row_tiles, p.units) == (64, 3, 192)
    # long context: no CTA walks more than SPLIT_KEYS positions
    p = paged_plan(8, 8, 4, 256, 16, H100_SMS)
    assert p.pages_per_split * 16 <= SPLIT_KEYS
    assert p.splits == 4096 // SPLIT_KEYS


@pytest.mark.parametrize("b,hkv,rows", [(32, 8, 4), (8, 16, 64), (67, 1, 1),
                                        (4, 8, 160)])
def test_one_split_when_splitting_would_not_double_the_grid(b, hkv, rows):
    for n_cols in (1, 4, SPLIT_KEYS // 16):
        p = paged_plan(b, hkv, rows, n_cols, 16, H100_SMS)
        assert 2 * p.units > H100_SMS
        assert p.splits == 1 and p.pages_per_split == n_cols
        assert p.workspace_floats(64) == 0


@pytest.mark.parametrize("b,hkv,rows", [(1, 1, 1), (8, 8, 4), (8, 8, 64),
                                        (3, 2, 12), (2, 8, 40), (33, 2, 4)])
@pytest.mark.parametrize("n_cols", [1, 2, 9, 33, 100, 1024])
def test_split_fills_the_card_and_covers_the_table(b, hkv, rows, n_cols):
    p = paged_plan(b, hkv, rows, n_cols, 16, H100_SMS)
    units = b * hkv * p.row_tiles
    assert p.units == units and p.row_tiles * p.row_tile >= rows
    # every page in exactly one split, and no split empty
    assert (p.splits - 1) * p.pages_per_split < n_cols
    assert p.splits * p.pages_per_split >= n_cols
    fill = -(-H100_SMS // units)
    if 2 * units <= H100_SMS and n_cols * 16 >= fill * MIN_SPLIT_KEYS:
        assert p.grid >= H100_SMS          # wide enough: the card is full
    if 2 * units <= H100_SMS and n_cols * 16 <= SPLIT_KEYS:
        assert p.splits == 1 or n_cols * 16 // p.splits >= MIN_SPLIT_KEYS
    if n_cols * 16 > SPLIT_KEYS:
        assert p.pages_per_split * 16 <= SPLIT_KEYS
    if p.splits > 1:
        assert p.workspace_floats(64) == p.grid * p.row_tile * 66


def test_splits_follow_the_table_width_only():
    """The plan takes no lengths (nothing to read back from the card): the
    same table width gives the same launch, and each width gets at least
    the splits that fill the card or cap a CTA's walk."""
    assert "len" not in " ".join(inspect.signature(paged_plan).parameters)
    for n_cols in range(1, 300):
        p = paged_plan(8, 8, 4, n_cols, 16, H100_SMS)
        assert p == paged_plan(8, 8, 4, n_cols, 16, H100_SMS)
        fill = min(-(-H100_SMS // 64), max(1, n_cols * 16 // MIN_SPLIT_KEYS))
        want = min(n_cols, max(fill, -(-n_cols * 16 // SPLIT_KEYS)))
        assert want <= p.splits <= n_cols


def test_cuda_core_row_tile_fits_shared_memory():
    assert cuda_core_row_tile(4, 64, 16) == 4
    assert cuda_core_row_tile(160, 64, 16) == 64
    assert cuda_core_row_tile(64, 256, 64) < 64
    with pytest.raises(ValueError):
        cuda_core_row_tile(64, 512, 128)     # not even one row fits
    p = paged_plan(2, 2, 160, 8, 16, H100_SMS, row_tile=64)
    assert (p.row_tile, p.row_tiles) == (64, 3)


@pytest.mark.parametrize("q_dtype,page_dtype,d,ps,want", [
    (torch.bfloat16, torch.bfloat16, 64, 16, True),
    (torch.bfloat16, torch.int8, 64, 16, True),
    (torch.bfloat16, torch.bfloat16, 128, 32, True),
    (torch.bfloat16, torch.int8, 16, 64, True),
    (torch.float32, torch.float32, 64, 16, False),    # fp32 pages
    (torch.float32, torch.int8, 64, 16, False),       # fp32 q, int8 pages
    (torch.bfloat16, torch.bfloat16, 12, 16, False),  # head_dim
    (torch.bfloat16, torch.bfloat16, 48, 16, False),
    (torch.bfloat16, torch.bfloat16, 64, 8, False),   # page size
    (torch.bfloat16, torch.int8, 64, 24, False),
])
def test_tensor_core_body_rule(q_dtype, page_dtype, d, ps, want):
    assert tensor_core_body(q_dtype, page_dtype, d, ps) is want
    assert not tensor_core_body(q_dtype, page_dtype, d, ps, aligned=False)
    assert set(TC_HEAD_DIMS) == {16, 32, 64, 128}


@pytest.mark.parametrize("q_dtype,page_dtype,d,ps,want", [
    (torch.bfloat16, torch.bfloat16, 64, 16, "tc"),
    (torch.bfloat16, torch.int8, 128, 32, "tc"),
    (torch.float32, torch.float32, 64, 16, "f32"),     # fp32 pages
    (torch.float32, torch.int8, 128, 16, "f32"),       # fp32 q, int8 pages
    (torch.float32, torch.float32, 16, 32, "f32"),
    (torch.float32, torch.int8, 32, 8, "f32"),         # any page size
    (torch.float32, torch.float32, 128, 24, "f32"),
    (torch.float32, torch.float32, 48, 16, "cuda_core"),   # head_dim
    (torch.float32, torch.int8, 12, 16, "cuda_core"),
    (torch.bfloat16, torch.bfloat16, 48, 16, "cuda_core"),
    (torch.bfloat16, torch.int8, 64, 24, "cuda_core"),     # page size
    (torch.bfloat16, torch.float32, 64, 16, "cuda_core"),
])
def test_three_body_rule(q_dtype, page_dtype, d, ps, want):
    assert paged_body(q_dtype, page_dtype, d, ps) == want
    assert (paged_body(q_dtype, page_dtype, d, ps) == "tc") \
        is tensor_core_body(q_dtype, page_dtype, d, ps)
    # unaligned q or pages: the CUDA-core body, whatever the dtypes
    assert paged_body(q_dtype, page_dtype, d, ps, aligned=False) \
        == "cuda_core"
    assert set(F32_HEAD_DIMS) == {16, 32, 64, 128}


def test_f32_config_rows_a_cta():
    """Decode's G = 1..4 rows take the 4-row tile (the warps split the
    keys), verify's 16 the 16-row tile, prefill-append's 64 and more the
    64-row tile."""
    assert [f32_config(r).row_tile for r in (1, 4, 5, 8, 16, 17, 64, 256)] \
        == [4, 4, 16, 16, 16, 64, 64, 64]
    for c in F32_CONFIGS:
        rows_w = c.row_tile * c.key_warps // c.warps
        keys_w = c.keys // c.key_warps
        assert c.warps % c.key_warps == 0 and keys_w % 4 == 0
        assert 32 % (c.lane_rows * c.lane_keys) == 0
        assert rows_w % c.lane_rows == 0 and keys_w % c.lane_keys == 0
    assert f32_config(4).key_warps == f32_config(4).warps     # decode
    assert f32_config(64).key_warps == 1                       # append
    # a 4 x 4 tile of logits a lane for verify and prefill-append
    for c in (f32_config(16), f32_config(64)):
        assert c.row_tile // c.warps // c.lane_rows == 4
        assert c.keys // c.lane_keys == 4


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows", [1, 4, 16, 64, 256])
def test_f32_plan_fits_shared_memory(d, ps, int8, rows):
    for n_cols in (1, 8, 33, 256):
        lp = launch_plan(torch.float32, torch.int8 if int8 else torch.float32,
                         8, 8, rows, n_cols, ps, d, H100_SMS)
        cfg, plan = lp.f32, lp.plan
        assert lp.body == "f32" and plan.row_tile == cfg.row_tile
        assert plan.row_tiles * plan.row_tile >= rows
        assert lp.smem_bytes == cfg.smem_bytes(d, int8, plan.pages_per_split)
        assert lp.smem_bytes <= SMEM_LIMIT
        # no CTA walks more than F32_SPLIT_KEYS positions
        if n_cols * ps > F32_SPLIT_KEYS:
            assert plan.pages_per_split * ps <= F32_SPLIT_KEYS
        assert (plan.splits - 1) * plan.pages_per_split < n_cols
        assert plan.splits * plan.pages_per_split >= n_cols
    # head_dim 128 over fp32 pages: two CTAs an SM in every configuration
    # (228 KB of shared memory an SM, 1 KB of it reserved a CTA)
    if d == 128 and not int8:
        assert (SMEM_LIMIT + 1024) // (lp.smem_bytes + 1024) == 2


def test_f32_plan_at_the_served_shapes():
    # row 3f's prefill-append: 8 slots x 8 kv-heads x 64 rows over tables
    # of 32 pages of 16: 64 units split to fill four CTAs an SM, down to
    # 64 positions a CTA
    lp = launch_plan(torch.float32, torch.float32, 8, 8, 64, 32, 16, 128,
                     H100_SMS)
    assert (lp.plan.row_tile, lp.plan.units, lp.plan.pages_per_split,
            lp.plan.splits) == (64, 64, 4, 8)
    # decode at G = 4: 4 rows a CTA, the same split
    lp = launch_plan(torch.float32, torch.float32, 8, 8, 4, 32, 16, 128,
                     H100_SMS)
    assert (lp.plan.row_tile, lp.plan.units, lp.plan.splits) == (4, 64, 8)
    # phase 9a's admission, 64 rows over 384: 256 units already fill the
    # card, so three splits of 160 positions
    lp = launch_plan(torch.float32, torch.int8, 8, 8, 256, 28, 16, 64,
                     H100_SMS)
    assert (lp.plan.row_tiles, lp.plan.units, lp.plan.pages_per_split,
            lp.plan.splits) == (4, 256, 10, 3)
    # a long table: no CTA walks more than 256 positions
    lp = launch_plan(torch.float32, torch.float32, 8, 8, 4, 256, 16, 64,
                     H100_SMS)
    assert lp.plan.pages_per_split * 16 <= 256 and lp.plan.splits == 16
    # bf16 keeps the tensor-core body's plan
    lp = launch_plan(torch.bfloat16, torch.bfloat16, 8, 8, 4, 32, 16, 128,
                     H100_SMS)
    assert lp.body == "tc" and lp.f32 is None
    assert lp.plan == paged_plan(8, 8, 4, 32, 16, H100_SMS)


# -- the split-merge arithmetic ----------------------------------------------


def _weight(m, mx):
    """A partial's weight against the running max; a partial that no key
    reaches (m still NEG_INF) weighs 0."""
    return torch.where(m <= 0.5 * NEG_INF, torch.zeros_like(m),
                       torch.exp(m - mx))


def split_attention(q, kp, vp, bt, plen, tlen, pps, k_scale=None,
                    v_scale=None):
    """The kernel's scheme in plain fp32 torch: per (slot, kv-head) and
    split s, the partial softmax over the live pages [s·pps, (s+1)·pps);
    then the partials merged in split order."""
    b, s, h, d = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    g = h // hkv
    out = torch.zeros(b, s, h, d, dtype=torch.float64)
    for bi in range(b):
        tl = int(tlen[bi])
        live = min(-(-tl // ps), bt.shape[1]) if tl > 0 else 0
        if live == 0:
            continue                      # split 0 writes exact zeros
        qpos = int(plen[bi]) + torch.arange(s)
        for hi in range(hkv):
            qh = q[bi, :, hi * g:(hi + 1) * g].float().reshape(s * g, d)
            qrow = qpos.repeat_interleave(g)
            parts = []
            for p0 in range(0, live, pps):
                pages = bt[bi, p0:min(p0 + pps, live)].long()
                k = kp[pages, :, hi].float().reshape(-1, d)
                v = vp[pages, :, hi].float().reshape(-1, d)
                pos = p0 * ps + torch.arange(k.shape[0])
                x = (qh @ k.T) * d ** -0.5
                if k_scale is not None:
                    x = x * k_scale[pages, :, hi].reshape(-1)[None]
                ok = (pos[None] <= qrow[:, None]) & (pos[None] < tl)
                x = torch.where(ok, x, torch.full_like(x, NEG_INF))
                m = x.max(dim=1).values
                p = torch.exp(x - m[:, None])
                l = p.sum(dim=1)
                if v_scale is not None:
                    p = p * v_scale[pages, :, hi].reshape(-1)[None]
                parts.append((m, l, p @ v))
            # one online pass in split order: running max, rescaled sum
            mx = torch.full((s * g,), NEG_INF)
            lsum = torch.zeros(s * g)
            acc = torch.zeros(s * g, d)
            for m, l, a in parts:
                mn = torch.maximum(mx, m)
                alpha, w = _weight(mx, mn), _weight(m, mn)
                lsum = lsum * alpha + w * l
                acc = acc * alpha[:, None] + w[:, None] * a
                mx = mn
            o = acc / torch.clamp(lsum, min=1e-30)[:, None]
            out[bi, :, hi * g:(hi + 1) * g] = o.reshape(s, g, d).double()
    return out.float()


def _pool(rng, lens, n_cols, ps, hkv, d):
    n_pages = 1 + len(lens) * n_cols
    kp = torch.as_tensor(rng.normal(size=(n_pages, ps, hkv, d)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.normal(size=(n_pages, ps, hkv, d)),
                         dtype=torch.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(lens), n_cols), np.int32)
    nxt = 0
    for i, length in enumerate(lens):
        for j in range(-(-int(length) // ps)):
            bt[i, j] = perm[nxt]
            nxt += 1
    return kp, vp, torch.as_tensor(bt)


# page 4: lengths 0, 1, on a split boundary (8 = 2 pages x 4), across one
# (9), the table's whole width (32), and partial pages; the table (8 pages)
# is wider than most slots' live pages
DECODE_LENS = [0, 1, 8, 9, 13, 32, 24, 3]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pps", [1, 2, 3, 8])
def test_split_merge_matches_plain_decode(int8, pps):
    rng = np.random.default_rng(5)
    ps, hkv, g, d, n_cols = 4, 2, 3, 16, 8
    kp, vp, bt = _pool(rng, DECODE_LENS, n_cols, ps, hkv, d)
    ks = vs = None
    if int8:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
    q = torch.as_tensor(rng.normal(size=(len(DECODE_LENS), 1, hkv * g, d)),
                        dtype=torch.float32)
    lens = torch.as_tensor(DECODE_LENS, dtype=torch.int32)
    got = split_attention(q, kp, vp, bt, lens - 1, lens, pps, ks, vs)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, k_scale=ks,
                                          v_scale=vs)
    live = lens > 0
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=1e-5)
    assert not got[~live].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pps", [1, 2, 3, 16])
def test_split_merge_matches_plain_prefill_append(int8, pps):
    """Rows whose keys all lie in later splits (prefix 0) and splits that
    hold only keys past a row's position: those partials weigh 0."""
    rng = np.random.default_rng(6)
    ps, hkv, g, d, n_cols, s = 4, 2, 2, 16, 16, 5
    plens = [0, 4, 7, 30, 0]
    slens = [5, 5, 2, 5, 1]
    tlens = [p + q for p, q in zip(plens, slens)]
    kp, vp, bt = _pool(rng, tlens, n_cols, ps, hkv, d)
    ks = vs = None
    if int8:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
    q = torch.as_tensor(rng.normal(size=(len(plens), s, hkv * g, d)),
                        dtype=torch.float32)
    pl = torch.as_tensor(plens, dtype=torch.int32)
    tl = torch.as_tensor(tlens, dtype=torch.int32)
    got = split_attention(q, kp, vp, bt, pl, tl, pps, ks, vs)
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl, k_scale=ks,
                                        v_scale=vs)
    for b, sl in enumerate(slens):        # rows past a slot's suffix are
        torch.testing.assert_close(       # garbage the caller drops
            got[b, :sl], want[b, :sl], rtol=1e-5, atol=1e-5)


def f32_split_attention(q, kp, vp, bt, plen, tlen, pps, cfg, k_scale=None,
                        v_scale=None):
    """The fp32 body's scheme in plain fp32 torch, in log2 units as the
    kernel keeps them: per (slot, kv-head) and split, rounds of
    ``cfg.keys`` keys; warp w of the ``cfg.key_warps`` takes keys [w·kw,
    (w+1)·kw) of every round and runs its own online softmax (a row none of
    whose keys it has reached yet keeps m at NEG_INF and weighs 0 below);
    the warps' (m, l, acc) merged in warp order, then the splits' partials
    in split order."""
    b, s, h, d = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    g = h // hkv
    kw = cfg.keys // cfg.key_warps
    sl2 = d ** -0.5 * math.log2(math.e)
    out = torch.zeros(b, s, h, d)

    def weight(m, mx):
        return torch.where(m <= 0.5 * NEG_INF, torch.zeros_like(m),
                           torch.exp2(m - mx))

    def merge(parts):
        mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        lsum = torch.zeros_like(mx)
        acc = torch.zeros(mx.shape[0], d)
        for m, l, a in parts:
            w = weight(m, mx)
            lsum = lsum + w * l
            acc = acc + w[:, None] * a
        return mx, lsum, acc

    for bi in range(b):
        tl = int(tlen[bi])
        live = min(-(-tl // ps), bt.shape[1]) if tl > 0 else 0
        if live == 0:
            continue
        for hi in range(hkv):
            qh = q[bi, :, hi * g:(hi + 1) * g].float().reshape(s * g, d)
            qrow = (int(plen[bi]) + torch.arange(s)).repeat_interleave(g)
            splits = []
            for p0 in range(0, live, pps):
                kbeg, kend = p0 * ps, min(tl, min(p0 + pps, live) * ps)
                warps = [(torch.full((s * g,), NEG_INF), torch.zeros(s * g),
                          torch.zeros(s * g, d))
                         for _ in range(cfg.key_warps)]
                for k0 in range(kbeg, kend, cfg.keys):
                    for w in range(cfg.key_warps):
                        pos = k0 + w * kw + torch.arange(kw)
                        ok_pos = pos < kend
                        lp = torch.div(pos.clamp(max=kend - 1), ps,
                                       rounding_mode="floor")
                        pages = bt[bi, lp].long()
                        slot = pos.clamp(max=kend - 1) - lp * ps
                        k = kp[pages, slot, hi].float()
                        v = vp[pages, slot, hi].float()
                        k[~ok_pos] = 0.0          # arrive as zeros
                        v[~ok_pos] = 0.0
                        x = (qh @ k.T) * sl2
                        if k_scale is not None:
                            ks = k_scale[pages, slot, hi] * ok_pos
                            x = x * ks[None]
                        ok = (pos[None] <= qrow[:, None]) & ok_pos[None]
                        x = torch.where(ok, x, torch.full_like(x, NEG_INF))
                        m, l, a = warps[w]
                        mn = torch.maximum(m, x.max(dim=1).values)
                        alpha = torch.exp2(m - mn)
                        p = torch.exp2(x - mn[:, None])
                        l = l * alpha + p.sum(dim=1)
                        if v_scale is not None:
                            vs = v_scale[pages, slot, hi] * ok_pos
                            p = p * vs[None]
                        warps[w] = (mn, l, a * alpha[:, None] + p @ v)
                splits.append(merge(warps))
            # the splits in split order: one online pass
            mx = torch.full((s * g,), NEG_INF)
            lsum = torch.zeros(s * g)
            acc = torch.zeros(s * g, d)
            for m, l, a in splits:
                mn = torch.maximum(mx, m)
                alpha, w = weight(mx, mn), weight(m, mn)
                lsum = lsum * alpha + w * l
                acc = acc * alpha[:, None] + w[:, None] * a
                mx = mn
            o = acc / torch.clamp(lsum, min=1e-30)[:, None]
            out[bi, :, hi * g:(hi + 1) * g] = o.reshape(s, g, d)
    return out


# small configurations that walk several rounds and key chunks at page 4
SMALL_F32 = [F32Config(4, 4, 4, 8, 1, 2, 3),     # decode: 4 key warps
             F32Config(16, 4, 1, 8, 1, 8, 3),    # one warp a row
             F32Config(4, 2, 2, 12, 1, 2, 2)]    # rounds across pages


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pps", [1, 2, 3, 8])
@pytest.mark.parametrize("cfg", SMALL_F32 + [f32_config(4)],
                         ids=["kw2x4", "kw8", "k12", "decode"])
def test_f32_partition_matches_plain_decode(int8, pps, cfg):
    rng = np.random.default_rng(15)
    ps, hkv, g, d, n_cols = 4, 2, 3, 16, 8
    kp, vp, bt = _pool(rng, DECODE_LENS, n_cols, ps, hkv, d)
    ks = vs = None
    if int8:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
    q = torch.as_tensor(rng.normal(size=(len(DECODE_LENS), 1, hkv * g, d)),
                        dtype=torch.float32)
    lens = torch.as_tensor(DECODE_LENS, dtype=torch.int32)
    got = f32_split_attention(q, kp, vp, bt, lens - 1, lens, pps, cfg, ks,
                              vs)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, k_scale=ks,
                                          v_scale=vs)
    live = lens > 0
    torch.testing.assert_close(got[live], want[live], rtol=1e-5, atol=1e-5)
    assert not got[~live].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pps", [1, 3, 16])
@pytest.mark.parametrize("cfg", SMALL_F32 + [f32_config(64)],
                         ids=["kw2x4", "kw8", "k12", "append"])
def test_f32_partition_matches_plain_prefill_append(int8, pps, cfg):
    """Rows whose keys all lie in later splits or later key chunks (prefix
    0): those partials weigh 0."""
    rng = np.random.default_rng(16)
    ps, hkv, g, d, n_cols, s = 4, 2, 2, 16, 16, 5
    plens = [0, 4, 7, 30, 0]
    slens = [5, 5, 2, 5, 1]
    tlens = [p + q for p, q in zip(plens, slens)]
    kp, vp, bt = _pool(rng, tlens, n_cols, ps, hkv, d)
    ks = vs = None
    if int8:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
    q = torch.as_tensor(rng.normal(size=(len(plens), s, hkv * g, d)),
                        dtype=torch.float32)
    pl = torch.as_tensor(plens, dtype=torch.int32)
    tl = torch.as_tensor(tlens, dtype=torch.int32)
    got = f32_split_attention(q, kp, vp, bt, pl, tl, pps, cfg, ks, vs)
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl, k_scale=ks,
                                        v_scale=vs)
    for b, sl in enumerate(slens):
        torch.testing.assert_close(got[b, :sl], want[b, :sl], rtol=1e-5,
                                   atol=1e-5)


# -- the launch counters -----------------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,s", [(3, 0), (0, 4)])
def test_empty_call_counts_no_launch(int8, b, s):
    """An empty batch or suffix returns before any launch, so neither the
    form's count nor its prefill-append count moves."""
    rng = np.random.default_rng(7)
    ps, hkv, g, d = 4, 2, 2, 16
    kp, vp, bt = _pool(rng, [9, 4, 1][:max(b, 1)], 4, ps, hkv, d)
    sc = {}
    if int8:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    bt = bt[:b].contiguous()
    q = torch.zeros(b, s, hkv * g, d)
    lens = torch.full((b,), 4, dtype=torch.int32)
    before = dict(PA.LAUNCHES)
    out = PA._paged_attention(q, kp, vp, bt, lens - s, lens, append=True,
                              **sc)
    assert out.shape == q.shape
    assert PA.LAUNCHES == before


def test_cpu_calls_count_no_launch():
    rng = np.random.default_rng(8)
    ps, hkv, g, d = 4, 2, 2, 16
    kp, vp, bt = _pool(rng, [9, 4], 4, ps, hkv, d)
    lens = torch.as_tensor([9, 4], dtype=torch.int32)
    before = dict(PA.LAUNCHES)
    PA.paged_decode_attention(torch.zeros(2, 1, hkv * g, d), kp, vp, bt, lens)
    PA.paged_prefill_append_attention(torch.zeros(2, 3, hkv * g, d), kp, vp,
                                      bt, lens - 3, lens)
    assert PA.LAUNCHES == before

"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one.

Run them on the machine with the card (its Python has no JAX, and the
suite-wide conftest imports it, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-4 (the kernel sums in another order than the plain
einsum); bf16 2e-2 relative to the output scale (both round one fp32 sum to
bf16, which can differ by one bf16 ulp, ~0.4%, plus the order difference).
The int8 forms take the same tolerances: both sides read the same codes and
scales and differ in where the scale multiplies (under bf16 x the kernel
rounds code × scale to bf16, at most 2^-9 relative per weight). The block-skipping
matmul too: the kernel and its plain version sum the same fp32 products.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.bcr import BCRSpec
from repro_torch.core.bcrc import tbcrc_pack
from repro_torch.kernels import bcr_spmm as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_decode_attention as PA
from repro_torch.kernels import ref
from repro_torch.kernels.plan import (pack_group, quantize_grouped,
                                      quantize_packed)
from repro_torch.kernels.quant import quantize_rows

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * scale, (err, scale)


def _packed(rng, n, k, block, keep, dtype, dev, align=8):
    w = torch.as_tensor(rng.normal(size=(n, k)), dtype=torch.float32,
                        device=dev)
    p = tbcrc_pack(w, BCRSpec(block_shape=block, keep_frac=keep,
                              align=align))
    p.vals = p.vals.to(dtype)
    return p


CASES = [  # (N, K, block, keep, align)
    (256, 384, (128, 128), 0.25, 8),     # serving block, R = C = 64
    (64, 96, (16, 32), 0.25, 4),         # non-square blocks
    (48, 40, (8, 8), 0.05, 1),           # kept counts of 1..2
    # the paper's own workloads: the GRU at d_model 1024 ((8, 8) blocks,
    # keep 0.1, 2 x 4 tiles) and a VGG-16 conv3 GEMM ((8, 16), 4 x 8)
    (1024, 1024, (8, 8), 0.1, 2),
    (256, 2304, (8, 16), 0.25, 1),
    # jamba's mamba x_proj (288 x 8192 at full width): 144 x 128 blocks,
    # 72 x 64 tiles, 72 rows not a multiple of the MMA's 16
    (288, 1024, (144, 128), 0.25, 8),
    # whisper-large-v3's lm_head (51866 = 2 x 25933 rows): (2, 128) blocks,
    # one kept row a tile
    (518, 1280, (2, 128), 0.25, 1),
]
# decode (1, 8), a ragged M tile (37), prefill tiles with a ragged edge
# (300) and a full prefill (2048)
MS = [1, 8, 37, 300, 2048]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", MS)
def test_bcr_spmm_matches_plain(cuda, dtype, case, m):
    rng = np.random.default_rng(0)
    n, k, block, keep, align = case
    p = _packed(rng, n, k, block, keep, dtype, cuda, align)
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=dtype, device=cuda)
    before = K.LAUNCHES["bcr_spmm"]
    got = K.bcr_spmm(x, p)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bcr_spmm"] == before + 1
    _close(got, ref.bcr_spmm_packed_ref(x, p), dtype)
    # rows no kept index reaches are exact zeros in both
    _close(got, ref.bcr_spmm_ref(x, p), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,epilogue,bias", [
    (2, None, False), (3, None, True), (2, "swiglu", True),
    (2, "swiglu", False)])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("case", CASES)
def test_bcr_spmm_grouped_matches_plain(cuda, dtype, g, epilogue, bias, m,
                                        case):
    rng = np.random.default_rng(1)
    n, k, block, keep, align = case
    members = [_packed(rng, n, k, block, keep, dtype, cuda, align)
               for _ in range(g)]
    grouped = pack_group(members)
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=dtype, device=cuda)
    b = (torch.as_tensor(rng.normal(size=(g, n)), dtype=torch.float32,
                         device=cuda) if bias else None)
    got = K.bcr_spmm_grouped(x, grouped, bias=b, epilogue=epilogue)
    torch.cuda.synchronize()
    want = ref.bcr_spmm_grouped_ref(x, grouped, bias=b, epilogue=epilogue)
    if epilogue is None:
        want = want.transpose(0, 1)
    assert got.shape == want.shape
    _close(got, want, dtype)


def _pages(rng, lens, page_size, hkv, d, dtype, dev, extra_cols=1):
    b = len(lens)
    max_pages = max(-(-int(l) // page_size) for l in lens) + extra_cols
    n_pages = 1 + b * max_pages
    kp = torch.as_tensor(rng.normal(size=(n_pages, page_size, hkv, d)),
                         dtype=dtype, device=dev)
    vp = torch.as_tensor(rng.normal(size=(n_pages, page_size, hkv, d)),
                         dtype=dtype, device=dev)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, max_pages), np.int32)
    nxt = 0
    for i, l in enumerate(lens):
        for p in range(-(-int(l) // page_size)):
            bt[i, p] = perm[nxt]
            nxt += 1
    return kp, vp, torch.as_tensor(bt, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 12])   # 12: rows not 16-byte multiples
def test_paged_decode_matches_plain(cuda, dtype, g, d):
    rng = np.random.default_rng(2)
    lens = [13, 1, 64, 0, 100]            # partial pages, 1 token, inactive
    hkv, ps = 2, 16
    kp, vp, bt = _pages(rng, lens, ps, hkv, d, dtype, cuda)
    q = torch.as_tensor(rng.normal(size=(len(lens), 1, hkv * g, d)),
                        dtype=dtype, device=cuda)
    cl = torch.as_tensor(lens, dtype=torch.int32, device=cuda)
    got = PA.paged_decode_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, cl)
    live = [i for i, l in enumerate(lens) if l > 0]
    _close(got[live], want[live], dtype)
    # a slot with no live position reads no page and emits zeros
    assert torch.count_nonzero(got[3]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [3, 16, 40])
def test_paged_prefill_append_matches_plain(cuda, dtype, s):
    rng = np.random.default_rng(3)
    plens = [100, 0, 7]
    slens = [s, s - 1, 2]
    tlens = [p + l for p, l in zip(plens, slens)]
    hkv, g, d, ps = 2, 4, 64, 16
    kp, vp, bt = _pages(rng, tlens, ps, hkv, d, dtype, cuda)
    q = torch.as_tensor(rng.normal(size=(3, s, hkv * g, d)), dtype=dtype,
                        device=cuda)
    pl = torch.as_tensor(plens, dtype=torch.int32, device=cuda)
    tl = torch.as_tensor(tlens, dtype=torch.int32, device=cuda)
    got = PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl)
    torch.cuda.synchronize()
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl)
    for b, sl in enumerate(slens):          # rows past slen are garbage
        _close(got[b, :sl], want[b, :sl], dtype)


def test_wrappers_reject_bad_inputs(cuda):
    rng = np.random.default_rng(4)
    p = _packed(rng, 256, 256, (128, 128), 0.25, torch.bfloat16, cuda)
    x = torch.zeros((4, 256), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        K.bcr_spmm(x, p)                      # vals dtype != x dtype
    with pytest.raises(ValueError):
        K.bcr_spmm(torch.zeros((4, 128), dtype=torch.bfloat16,
                               device=cuda), p)


# -- int8 forms ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", MS)
def test_int8_bcr_spmm_matches_plain(cuda, dtype, case, m):
    rng = np.random.default_rng(5)
    n, k, block, keep, align = case
    p = quantize_packed(_packed(rng, n, k, block, keep, torch.float32, cuda,
                                align))
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=dtype, device=cuda)
    before = dict(K.LAUNCHES)
    got = K.bcr_spmm(x, p)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bcr_spmm_int8"] == before["bcr_spmm_int8"] + 1
    assert K.LAUNCHES["bcr_spmm"] == before["bcr_spmm"]
    _close(got, ref.bcr_spmm_packed_ref(x, p), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,epilogue,bias", [
    (2, None, False), (3, None, True), (2, "swiglu", True)])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("block,keep", [((128, 128), 0.25), ((16, 16), 0.25)])
def test_int8_bcr_spmm_grouped_matches_plain(cuda, dtype, g, epilogue, bias,
                                             m, block, keep):
    rng = np.random.default_rng(6)
    grouped = quantize_grouped(pack_group(
        [_packed(rng, 256, 256, block, keep, torch.float32, cuda, 4)
         for _ in range(g)]))
    x = torch.as_tensor(rng.normal(size=(m, 256)), dtype=dtype, device=cuda)
    b = (torch.as_tensor(rng.normal(size=(g, 256)), dtype=torch.float32,
                         device=cuda) if bias else None)
    before = K.LAUNCHES["bcr_spmm_grouped_int8"]
    got = K.bcr_spmm_grouped(x, grouped, bias=b, epilogue=epilogue)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bcr_spmm_grouped_int8"] == before + 1
    want = ref.bcr_spmm_grouped_ref(x, grouped, bias=b, epilogue=epilogue)
    if epilogue is None:
        want = want.transpose(0, 1)
    _close(got, want, dtype)


# the wide body (the 128 M tile): (N, K, G, epilogue, bias, experts, M) at
# the serving block (128 x 128, keep 0.25): G = 1, 2, 3 with bias and with
# SwiGLU, stacked experts, ragged last M tiles (300 = 2 x 128 + 44, 240 =
# 128 + 112), and a split (3 x 3 blocks at M = 130: 6 output tiles)
WG_CASES = [
    (384, 384, 1, None, False, 0, 300),
    (384, 384, 1, None, False, 0, 130),
    (256, 384, 2, None, True, 0, 300),
    (384, 384, 2, "swiglu", True, 0, 300),
    (384, 384, 3, None, True, 0, 300),
    (384, 256, 1, None, False, 3, 240),
    (256, 384, 2, "swiglu", False, 3, 240),
    (256, 256, 3, None, True, 3, 240),
]


def _wg_case(rng, dev, n, k, g, epilogue, bias, e, m, int8):
    lead = (e,) if e else ()
    members = []
    for _ in range(g):
        w = torch.as_tensor(rng.normal(size=lead + (n, k)),
                            dtype=torch.float32, device=dev)
        members.append(tbcrc_pack(w, BCRSpec(block_shape=(128, 128),
                                             keep_frac=0.25, align=8)))
    fp = members[0] if g == 1 else pack_group(members)
    w = ((quantize_packed(fp) if g == 1 else quantize_grouped(fp)) if int8
         else dataclasses.replace(fp, vals=fp.vals.to(torch.bfloat16)))
    x = torch.as_tensor(rng.normal(size=lead + (m, k)),
                        dtype=torch.bfloat16, device=dev)
    b = (torch.as_tensor(rng.normal(size=lead + (g, n)), dtype=torch.float32,
                         device=dev) if bias else None)

    def run(x=x):
        if g == 1:
            return K.bcr_spmm(x, w)
        return K.bcr_spmm_grouped(x, w, bias=b, epilogue=epilogue)

    def plain(x=x):
        if g == 1:
            return ref.bcr_spmm_packed_ref(x, w)
        y = ref.bcr_spmm_grouped_ref(x, w, bias=b, epilogue=epilogue)
        return y if epilogue else y.transpose(-3, -2)

    plan = K.launch_plan(m, n, k, g, (128, 128), tuple(w.vals.shape[-2:]),
                         torch.cuda.get_device_properties(
                             dev).multi_processor_count, int8,
                         experts=max(e, 1))
    return plan, x, run, plain


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n,k,g,epilogue,bias,e,m", WG_CASES)
def test_wide_body_matches_plain(cuda, n, k, g, epilogue, bias, e, m, int8):
    """The 128 M tile's wide body against its plain version, then twice
    more over freed NaN-filled output and workspace blocks: bit-equal
    launches, the split counters back at 0."""
    plan, x, run, plain = _wg_case(np.random.default_rng(20), cuda, n, k, g,
                                   epilogue, bias, e, m, int8)
    assert plan.body == "wg" and plan.m_tile == 128
    want = plain()
    got = run()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    _close(got, want, torch.bfloat16)
    ws = torch.full((max(plan.workspace_floats, 1),), float("nan"),
                    device=cuda)
    y = torch.full(tuple(got.shape), float("nan"), dtype=torch.bfloat16,
                   device=cuda)
    del ws, y
    first, second = run(), run()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(first).all()) and torch.equal(first, second)
    assert torch.equal(first, got)
    counters = K.split_counters(cuda, plan.tiles)[:plan.tiles]
    assert int(torch.count_nonzero(counters)) == 0


@pytest.mark.parametrize("int8", [False, True])
def test_wide_body_unaligned_x(cuda, int8):
    """x one element off 16-byte alignment: the wide body's plain loads."""
    rng = np.random.default_rng(21)
    plan, x, run, plain = _wg_case(rng, cuda, 384, 384, 3, None, True, 0,
                                   300, int8)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
    xs = xs.view(x.shape)
    xs.copy_(x)
    got = run(xs)
    torch.cuda.synchronize()
    _close(got, plain(xs), torch.bfloat16)
    _close(got, run(), torch.bfloat16)


# the fp32 body's split forms: (N, K, G, block, keep, align, M)
FP32_SPLITS = {"gru_fp32": (1024, 1024, 1, (8, 8), 0.1, 2, 1),
               "xproj_fp32": (288, 8192, 1, (144, 128), 0.25, 8, 8),
               "wo_fp32": (2048, 8192, 1, (128, 128), 0.25, 8, 8),
               "wgi_fp32": (8192, 2048, 2, (128, 128), 0.25, 8, 8)}


# the fp32 body (fp32 x) at GRIM's blocks and the 128 blocks: (N, K, block,
# keep, align); block-row counts no CTA's units divide
FP32_CASES = [
    (1000, 1024, (8, 8), 0.1, 2),        # the GRU's blocks, 2 x 4 tiles
    (200, 2304, (8, 16), 0.25, 2),       # VGG conv3's, 4 x 8 tiles
    (384, 640, (128, 128), 0.25, 8),     # the serving block, 64 x 64 tiles
    (288, 1024, (144, 128), 0.25, 8),    # jamba's x_proj blocks
    (130, 256, (2, 128), 0.25, 1),       # whisper's lm_head blocks
    (111, 144, (3, 16), 0.5, 1),         # an odd block, 2 x 8 tiles
]
# (G, epilogue, bias): bcr_spmm, a pair, a triple with bias, SwiGLU + bias
FP32_FORMS = [(1, None, False), (2, None, False), (3, None, True),
              (2, "swiglu", True)]


@pytest.mark.parametrize("variant", ["fp32", "int8", "experts", "unaligned"])
@pytest.mark.parametrize("form", FP32_FORMS)
@pytest.mark.parametrize("m", [1, 5, 33, 300])
@pytest.mark.parametrize("case", FP32_CASES)
def test_fp32_body_matches_plain(cuda, case, m, form, variant):
    """The fp32 body against its plain version at 1e-4: ragged M (1, 5, 33,
    300), G = 1, 2, 3 with bias and SwiGLU; fp32 tiles, int8 tiles, 3
    stacked experts (one launch), and x and the tiles one element off
    16-byte alignment (4-byte tile copies)."""
    rng = np.random.default_rng(12)
    n, k, block, keep, align = case
    g, epilogue, bias = form
    e = 3 if variant == "experts" else 0
    lead = (e,) if e else ()
    spec = BCRSpec(block_shape=block, keep_frac=keep, align=align)
    members = [tbcrc_pack(torch.as_tensor(
        rng.normal(size=lead + (n, k)) * k ** -0.5, dtype=torch.float32,
        device=cuda), spec) for _ in range(g)]
    w = members[0] if g == 1 else pack_group(members)
    if variant == "int8":
        w = quantize_packed(w) if g == 1 else quantize_grouped(w)
    x = torch.as_tensor(rng.normal(size=lead + (m, k)), dtype=torch.float32,
                        device=cuda)
    if variant == "unaligned":
        xs = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
        xs.copy_(x)
        vs = torch.empty(w.vals.numel() + 1, device=cuda)[1:].view(
            w.vals.shape)
        vs.copy_(w.vals)
        x, w = xs, dataclasses.replace(w, vals=vs)
    b = (torch.as_tensor(rng.normal(size=lead + (g, n)), dtype=torch.float32,
                         device=cuda) if bias else None)
    key = "bcr_spmm" + ("_grouped" if g > 1 else "") + (
        "_int8" if variant == "int8" else "")
    before = dict(K.LAUNCHES)
    if g == 1:
        got = K.bcr_spmm(x, w)
        want = ref.bcr_spmm_packed_ref(x, w)
    else:
        got = K.bcr_spmm_grouped(x, w, bias=b, epilogue=epilogue)
        want = ref.bcr_spmm_grouped_ref(x, w, bias=b, epilogue=epilogue)
        if epilogue is None:
            want = want.transpose(-3, -2)
    torch.cuda.synchronize()
    moved = {kk: v - before[kk] for kk, v in K.LAUNCHES.items()
             if v != before[kk]}
    assert moved == ({key: 1, key + "_experts": 1} if e else {key: 1})
    assert got.shape == want.shape
    _close(got, want, torch.float32)


def _split_case(rng, dev, form):
    """A (2048 x 8192) weight at M = 8 (MLP wo at decode: a split launch),
    or the gate/up pair (2 x 8192 x 2048, SwiGLU), fp or int8 tiles under
    bf16 x; under fp32 x (the fp32 body: ``FP32_SPLITS``, fp32 or int8
    tiles) the same two, the GRU's (8, 8) blocks at M = 1 and jamba's
    x_proj at M = 8. Returns the plan, the launch, its plain version and x's
    dtype."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int8 = form.endswith("int8")
    if "fp32" in form:
        n, k, g, block, keep, align, m = FP32_SPLITS[form.replace("_int8",
                                                                  "")]
        dtype = torch.float32
    else:
        n, k = (8192, 2048) if form.startswith("wgi") else (2048, 8192)
        g, block, keep, align, m = (2 if form.startswith("wgi") else 1,
                                    (128, 128), 0.25, 8, 8)
        dtype = torch.bfloat16
    tiles = torch.float32 if int8 or dtype == torch.float32 else dtype
    packs = [_packed(rng, n, k, block, keep, tiles, dev, align)
             for _ in range(g)]
    if g == 2:
        w = pack_group(packs)
        w = quantize_grouped(w) if int8 else w
    else:
        w = quantize_packed(packs[0]) if int8 else packs[0]
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=dtype, device=dev)
    r, c = w.vals.shape[-2:]
    plan = (K.fp32_plan(m, n, k, g, block, (r, c), sms, int8)
            if dtype == torch.float32
            else K.launch_plan(m, n, k, g, block, (r, c), sms, int8))

    def run():
        if g == 2:
            return K.bcr_spmm_grouped(x, w, epilogue="swiglu")
        return K.bcr_spmm(x, w)

    def plain():
        if g == 2:
            return ref.bcr_spmm_grouped_ref(x, w, epilogue="swiglu")
        return ref.bcr_spmm_packed_ref(x, w)

    return plan, run, plain, dtype


SPLIT_FORMS = ["wo", "wo_int8", "wgi", "wgi_int8", "gru_fp32",
               "gru_fp32_int8", "xproj_fp32", "wo_fp32", "wo_fp32_int8",
               "wgi_fp32", "wgi_fp32_int8"]


@pytest.mark.parametrize("form", SPLIT_FORMS)
def test_bcr_split_path_is_deterministic(cuda, form):
    plan, run, plain, dtype = _split_case(np.random.default_rng(9), cuda,
                                          form)
    assert plan.splits > 1
    first, second = run(), run()
    torch.cuda.synchronize()
    # the last split sums the partials in split order: bit-equal launches
    assert torch.equal(first, second)
    _close(first, plain(), dtype)
    if form.startswith(("wo", "gru", "xproj")):   # these fill the card
        assert plan.grid >= torch.cuda.get_device_properties(
            cuda).multi_processor_count


@pytest.mark.parametrize("form", SPLIT_FORMS)
def test_bcr_split_path_over_nan_buffers(cuda, form):
    plan, run, plain, dtype = _split_case(np.random.default_rng(10), cuda,
                                          form)
    want = plain()
    # freed NaN-filled blocks of the workspace's and the output's sizes: the
    # allocator hands them back to the call
    ws = torch.full((plan.workspace_floats,), float("nan"),
                    dtype=torch.float32, device=cuda)
    y = torch.full(tuple(want.shape), float("nan"), dtype=dtype, device=cuda)
    del ws, y
    got = run()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _close(got, want, dtype)


@pytest.mark.parametrize("form", SPLIT_FORMS)
def test_bcr_split_counters_back_at_zero(cuda, form):
    plan, run, _, _ = _split_case(np.random.default_rng(11), cuda, form)
    run()
    run()
    torch.cuda.synchronize()
    counters = K.split_counters(cuda, plan.tiles)[:plan.tiles]
    assert int(torch.count_nonzero(counters)) == 0


def _int8_pages(kp, vp):
    kc, ks = quantize_rows(kp.float())
    vc, vs = quantize_rows(vp.float())
    return kc, vc, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 16, 12])   # 12: rows not 16-byte multiples
def test_int8_paged_decode_matches_plain(cuda, dtype, g, d):
    rng = np.random.default_rng(7)
    lens = [13, 1, 64, 0, 100]
    hkv, ps = 2, 16
    kp, vp, bt = _pages(rng, lens, ps, hkv, d, torch.float32, cuda)
    kc, vc, ks, vs = _int8_pages(kp, vp)
    q = torch.as_tensor(rng.normal(size=(len(lens), 1, hkv * g, d)),
                        dtype=dtype, device=cuda)
    cl = torch.as_tensor(lens, dtype=torch.int32, device=cuda)
    before = PA.LAUNCHES["paged_attention_int8"]
    got = PA.paged_decode_attention(q, kc, vc, bt, cl, k_scale=ks,
                                    v_scale=vs)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["paged_attention_int8"] == before + 1
    assert got.dtype == dtype
    want = ref.paged_decode_attention_ref(q, kc, vc, bt, cl, k_scale=ks,
                                          v_scale=vs)
    live = [i for i, l in enumerate(lens) if l > 0]
    _close(got[live], want[live], dtype)
    assert torch.count_nonzero(got[3]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [3, 16, 40])
def test_int8_paged_prefill_append_matches_plain(cuda, dtype, s):
    rng = np.random.default_rng(8)
    plens = [100, 0, 7]
    slens = [s, s - 1, 2]
    tlens = [p + l for p, l in zip(plens, slens)]
    hkv, g, d, ps = 2, 4, 64, 16
    kp, vp, bt = _pages(rng, tlens, ps, hkv, d, torch.float32, cuda)
    kc, vc, ks, vs = _int8_pages(kp, vp)
    q = torch.as_tensor(rng.normal(size=(3, s, hkv * g, d)), dtype=dtype,
                        device=cuda)
    pl = torch.as_tensor(plens, dtype=torch.int32, device=cuda)
    tl = torch.as_tensor(tlens, dtype=torch.int32, device=cuda)
    got = PA.paged_prefill_append_attention(q, kc, vc, bt, pl, tl,
                                            k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = ref.paged_prefill_append_ref(q, kc, vc, bt, pl, tl, k_scale=ks,
                                        v_scale=vs)
    for b, sl in enumerate(slens):
        _close(got[b, :sl], want[b, :sl], dtype)


# -- fused flash attention -------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal,q_offset,sq,skv", [
    (True, 0, 128, 128), (True, 0, 77, 77), (False, 0, 40, 200),
    (True, 64, 64, 128), (True, 5, 30, 100)])
def test_flash_attention_matches_plain(cuda, dtype, d, causal, q_offset, sq,
                                       skv):
    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.normal(size=(6, n, d)), dtype=dtype,
                               device=cuda) for n in (sq, skv, skv))
    kw = dict(causal=causal, q_chunk=sq, kv_chunk=skv, q_offset=q_offset)
    before = FA.LAUNCHES["flash_attention_fused"]
    got = FA.flash_attention_fused(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_fused"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    _close(got, want, dtype)


@pytest.mark.parametrize("causal,q_offset,sq,skv", [
    (True, 0, 512, 512), (False, 0, 512, 512), (True, 0, 200, 200),
    (True, 384, 128, 512), (False, 0, 77, 300)])
def test_flash_attention_bf16_serving_shapes(cuda, causal, q_offset, sq,
                                             skv):
    """bf16 at the cold-prefill width (D = 64) and S = 512, and query
    counts that are not a multiple of the 64-row q tile."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.as_tensor(rng.normal(size=(16, n, 64)),
                               dtype=torch.bfloat16, device=cuda)
               for n in (sq, skv, skv))
    got = FA.flash_attention_fused(q, k, v, causal=causal, q_chunk=sq,
                                   kv_chunk=skv, q_offset=q_offset)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    _close(got, want, torch.bfloat16)


def test_flash_attention_cta_order_changes_no_output(cuda):
    """The heaviest-first CTA order (causal's) and the B·H-major one give
    bit-equal outputs (each CTA owns its rows; the order only schedules
    them), and each launch counts once."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.as_tensor(rng.normal(size=(8, 300, 64)),
                               dtype=torch.bfloat16, device=cuda)
               for _ in range(3))
    before = FA.LAUNCHES["flash_attention_fused"]
    outs = []
    for bh_major in (False, True):
        out = torch.empty_like(q)
        FA._launch(q, k, v, out, True, 0, bh_major=bh_major)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert FA.LAUNCHES["flash_attention_fused"] == before + 2


def test_int8_wrappers_reject_bad_inputs(cuda):
    rng = np.random.default_rng(10)
    p = quantize_packed(_packed(rng, 256, 256, (128, 128), 0.25,
                                torch.float32, cuda))
    x = torch.zeros((4, 256), dtype=torch.bfloat16, device=cuda)
    bad = dataclasses.replace(p, plan=dataclasses.replace(p.plan,
                                                          block_scales=None))
    with pytest.raises(ValueError):
        K.bcr_spmm(x, bad)                    # int8 codes without scales
    kp = torch.zeros((3, 16, 2, 64), dtype=torch.int8, device=cuda)
    q = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16, device=cuda)
    bt = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        PA.paged_decode_attention(q, kp, kp, bt, torch.ones(
            1, dtype=torch.int32, device=cuda))   # int8 pages, no scales
    with pytest.raises(ValueError):
        FA.flash_attention_fused(torch.zeros((1, 8, 48), device=cuda),
                                 torch.zeros((1, 8, 48), device=cuda),
                                 torch.zeros((1, 8, 48), device=cuda))


# -- block-skipping matmul (unbalanced BCR) ---------------------------------

SKIP_CASES = [  # (N, K, block, keep)
    (256, 512, (32, 32), 0.05),          # the reference tests' shape
    (256, 384, (128, 128), 0.25),        # the serving block
    (96, 80, (16, 16), 0.1),             # narrow blocks, ragged 64-row slice
    (64, 96, (16, 32), 0.5),             # non-square blocks
]


def _skip_pack(rng, n, k, block, keep, dtype, dev, zero_rows=0):
    from repro_torch.kernels.bcr_spmm_skip import pack_skip
    w = rng.normal(size=(n, k)) * np.exp(rng.normal(
        size=(n // block[0], 1, k // block[1], 1))).repeat(
            block[0], 1).repeat(block[1], 3).reshape(n, k)
    w[:zero_rows] = 0.0
    p = pack_skip(torch.as_tensor(w, dtype=torch.float32, device=dev),
                  BCRSpec(block_shape=block, keep_frac=keep, align=1,
                          balanced=False))
    return dataclasses.replace(p, tiles=p.tiles.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SKIP_CASES)
@pytest.mark.parametrize("m", [1, 8, 17, 300])
def test_bcr_spmm_skip_matches_plain(cuda, dtype, case, m):
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    n, k, block, keep = case
    rng = np.random.default_rng(11)
    p = _skip_pack(rng, n, k, block, keep, dtype, cuda)
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=dtype, device=cuda)
    before = SK.LAUNCHES["bcr_spmm_skip"]
    got = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["bcr_spmm_skip"] == before + 1
    _close(got, ref.bcr_spmm_skip_ref(x, p), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bcr_spmm_skip_empty_rows_are_exact_zeros(cuda, dtype):
    """A block row with no tile comes out exact zeros even where the
    caching allocator hands back a NaN-filled block; a fully pruned W gives
    an all-zero y."""
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    rng = np.random.default_rng(12)
    p = _skip_pack(rng, 256, 384, (64, 64), 0.25, dtype, cuda, zero_rows=64)
    assert int(p.row_start[1]) == 0
    x = torch.as_tensor(rng.normal(size=(40, 384)), dtype=dtype, device=cuda)
    poison = torch.full((40, 256), float("nan"), dtype=dtype, device=cuda)
    del poison
    y = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    assert torch.equal(y[:, :64], torch.zeros_like(y[:, :64]))
    _close(y, ref.bcr_spmm_skip_ref(x, p), dtype)
    empty = _skip_pack(rng, 128, 128, (32, 32), 0.25, dtype, cuda,
                       zero_rows=128)
    assert empty.tiles.shape[0] == 1
    y = SK.bcr_spmm_skip(x[:, :128].contiguous(), empty)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros_like(y))


def test_bcr_spmm_skip_prefill_at_block_128(cuda):
    """bf16 M = 2048 at the serving block (the wgmma body)."""
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    rng = np.random.default_rng(16)
    p = _skip_pack(rng, 1024, 512, (128, 128), 0.25, torch.bfloat16, cuda)
    x = torch.as_tensor(rng.normal(size=(2048, 512)), dtype=torch.bfloat16,
                        device=cuda)
    plan = SK.skip_plan(tuple(p.row_start.tolist()), 2048, (128, 128),
                        torch.cuda.get_device_properties(
                            cuda).multi_processor_count)
    assert plan.wgmma and plan.m_tile == 128
    got = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    _close(got, ref.bcr_spmm_skip_ref(x, p), torch.bfloat16)


def _skip_split_case(rng, dev, n, k, zero_rows=0):
    """A full-width projection at M = 8 (wq 2048 x 2048, MLP wo 2048 x
    8192): 16 block rows, so the plan splits them."""
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    p = _skip_pack(rng, n, k, (128, 128), 0.25, torch.bfloat16, dev,
                   zero_rows=zero_rows)
    x = torch.as_tensor(rng.normal(size=(8, k)), dtype=torch.bfloat16,
                        device=dev)
    plan = SK.skip_plan(tuple(p.row_start.tolist()), 8, (128, 128),
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    return SK, p, x, plan


SKIP_SPLIT = [(2048, 2048), (2048, 8192)]


@pytest.mark.parametrize("n,k", SKIP_SPLIT)
def test_skip_split_path_is_deterministic(cuda, n, k):
    SK, p, x, plan = _skip_split_case(np.random.default_rng(17), cuda, n, k)
    assert plan.parts > 0 and plan.grid >= torch.cuda.get_device_properties(
        cuda).multi_processor_count
    first, second = SK.bcr_spmm_skip(x, p), SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    # the last split of a row sums the partials in split order
    assert torch.equal(first, second)
    _close(first, ref.bcr_spmm_skip_ref(x, p), torch.bfloat16)


@pytest.mark.parametrize("n,k", SKIP_SPLIT)
def test_skip_split_path_over_nan_buffers(cuda, n, k):
    SK, p, x, plan = _skip_split_case(np.random.default_rng(18), cuda, n, k,
                                      zero_rows=256)
    assert int(p.row_start[2]) == 0           # two empty block rows
    ws = torch.full((plan.workspace_floats,), float("nan"),
                    dtype=torch.float32, device=cuda)
    y = torch.full((8, n), float("nan"), dtype=torch.bfloat16, device=cuda)
    del ws, y              # the allocator hands these blocks back next
    got = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[:, :256], torch.zeros_like(got[:, :256]))
    _close(got, ref.bcr_spmm_skip_ref(x, p), torch.bfloat16)


@pytest.mark.parametrize("n,k", SKIP_SPLIT)
def test_skip_split_counters_back_at_zero(cuda, n, k):
    SK, p, x, plan = _skip_split_case(np.random.default_rng(19), cuda, n, k)
    SK.bcr_spmm_skip(x, p)
    SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    counters = K.split_counters(cuda, plan.counters)[:plan.counters]
    assert int(torch.count_nonzero(counters)) == 0


def test_bcr_spmm_skip_rejects_bad_inputs(cuda):
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    rng = np.random.default_rng(13)
    p = _skip_pack(rng, 128, 128, (32, 32), 0.5, torch.bfloat16, cuda)
    x = torch.zeros((4, 128), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        SK.bcr_spmm_skip(x, p)                     # tiles dtype != x dtype
    with pytest.raises(ValueError):
        SK.bcr_spmm_skip(torch.zeros((4, 64), dtype=torch.bfloat16,
                                     device=cuda), p)
    bad = dataclasses.replace(p, bi=p.bi.flip(0).contiguous(),
                              row_mask=None, row_start=None)
    with pytest.raises(ValueError):
        SK.bcr_spmm_skip(x.bfloat16(), bad)        # unsorted bi


# -- paged attention: the one-launch split over pages ----------------------


SPLIT_LENS = [4096, 0, 1, 1000, 17, 2053]   # an empty slot; long and short


def _paged_split_inputs(rng, dev, dtype, ps, d, g, int8, s=1, hkv=2,
                        lens=SPLIT_LENS):
    """Slots over ``lens`` cached positions (decode: ``s`` = 1 at
    ``len - 1``; prefill-append: the last ``s`` positions of each slot are
    the suffix), fp or int8 pages; returns the call's arguments and the
    plan the wrapper takes for them."""
    kp, vp, bt = _pages(rng, lens, ps, hkv, d,
                        torch.float32 if int8 else dtype, dev)
    scales = {}
    if int8:
        kp, vp, ks, vs = _int8_pages(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    q = torch.as_tensor(rng.normal(size=(len(lens), s, hkv * g, d)),
                        dtype=dtype, device=dev)
    tl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    pl = torch.clamp(tl - s, min=0)
    plan = PA.launch_plan(
        dtype if int8 else kp.dtype, kp.dtype, len(lens), hkv, s * g,
        bt.shape[1], ps, d,
        torch.cuda.get_device_properties(dev).multi_processor_count).plan
    return q, kp, vp, bt, pl, tl, scales, plan


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_paged_split_decode_matches_plain(cuda, int8, dtype, ps, d, g):
    """Lengths up to 4096 split over CTAs (tensor-core body at bf16 q and
    pages of 16/32, CUDA-core body at fp32 or page 8)."""
    q, kp, vp, bt, pl, tl, sc, plan = _paged_split_inputs(
        np.random.default_rng(20), cuda, dtype, ps, d, g, int8)
    assert plan.splits > 1
    key = "paged_attention_int8" if int8 else "paged_attention"
    before = PA.LAUNCHES[key]
    got = PA.paged_decode_attention(q, kp, vp, bt, tl, **sc)
    torch.cuda.synchronize()
    assert PA.LAUNCHES[key] == before + 1
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, tl, **sc)
    live = tl > 0
    _close(got[live], want[live], dtype)
    assert torch.count_nonzero(got[~live]) == 0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s", [16, 40])
def test_paged_split_prefill_append_matches_plain(cuda, int8, s):
    q, kp, vp, bt, pl, tl, sc, plan = _paged_split_inputs(
        np.random.default_rng(21), cuda, torch.bfloat16, 16, 64, 4, int8,
        s=s, lens=[4096, 100 + s, s, 2053])
    assert plan.splits > 1
    got = PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl, **sc)
    torch.cuda.synchronize()
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl, **sc)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s", [16, 40])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_split_prefill_append_fp32_matches_plain(cuda, int8, s, d):
    """fp32 q over fp32 and over int8 pages: the fp32 body, split over
    pages (one slot at 4096 positions), each launch counted under
    ``paged_attention_f32`` as well as its form's keys."""
    q, kp, vp, bt, pl, tl, sc, plan = _paged_split_inputs(
        np.random.default_rng(24), cuda, torch.float32, 16, d, 4, int8,
        s=s, lens=[4096, 100 + s, s, 2053])
    assert plan.splits > 1
    assert PA.paged_body(torch.float32, kp.dtype, d, 16) == "f32"
    key = "paged_attention_int8" if int8 else "paged_attention"
    before = dict(PA.LAUNCHES)
    got = PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl, **sc)
    again = PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl, **sc)
    torch.cuda.synchronize()
    want = dict(before)
    for k in (key, key + "_append", "paged_attention_f32"):
        want[k] += 2
    assert PA.LAUNCHES == want
    assert torch.equal(got, again)
    _close(got, ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl, **sc),
           torch.float32)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_counts_each_form_at_its_launch(cuda, int8):
    """A decode launch adds one to its form's count only; a prefill-append
    launch adds one to that count and one to its ``_append`` count; an
    empty suffix launches nothing and counts nothing."""
    q, kp, vp, bt, pl, tl, sc, _ = _paged_split_inputs(
        np.random.default_rng(23), cuda, torch.bfloat16, 16, 64, 4, int8,
        s=16, lens=[200, 116])
    key = "paged_attention_int8" if int8 else "paged_attention"
    before = dict(PA.LAUNCHES)
    PA.paged_decode_attention(q[:, :1].contiguous(), kp, vp, bt, tl, **sc)
    PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl, **sc)
    PA.paged_prefill_append_attention(q[:, :0].contiguous(), kp, vp, bt, tl,
                                      tl, **sc)
    torch.cuda.synchronize()
    want = dict(before)
    want[key] += 2
    want[key + "_append"] += 1
    assert PA.LAUNCHES == want


def _serving_split_case(dev, int8, s):
    """llama3.2-1b's attention (8 kv-heads, G = 4, head_dim 64, page 16) over
    8 slots, one of them empty."""
    return _paged_split_inputs(
        np.random.default_rng(22 + s), dev, torch.bfloat16, 16, 64, 4, int8,
        s=s, hkv=8, lens=[1, 37, 128, 200, 333, 511, 4096, 0])


def _paged_call(q, kp, vp, bt, pl, tl, sc):
    if q.shape[1] == 1:
        return PA.paged_decode_attention(q, kp, vp, bt, tl, **sc)
    return PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl, **sc)


SPLIT_CALLS = [(False, 1), (True, 1), (False, 16), (True, 16)]


@pytest.mark.parametrize("int8,s", SPLIT_CALLS)
def test_paged_split_is_deterministic(cuda, int8, s):
    *args, plan = _serving_split_case(cuda, int8, s)
    assert plan.splits > 1
    first, second = _paged_call(*args), _paged_call(*args)
    torch.cuda.synchronize()
    # the last split merges the partials in split order: bit-equal launches
    assert torch.equal(first, second)


@pytest.mark.parametrize("int8,s", SPLIT_CALLS)
def test_paged_split_over_nan_buffers(cuda, int8, s):
    q, kp, vp, bt, pl, tl, sc, plan = _serving_split_case(cuda, int8, s)
    # freed NaN-filled blocks of the workspace's and the output's sizes: the
    # allocator hands them back to the call
    ws = torch.full((plan.workspace_floats(64),), float("nan"),
                    dtype=torch.float32, device=cuda)
    out = torch.full(q.shape, float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    del ws, out
    got = _paged_call(q, kp, vp, bt, pl, tl, sc)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    # the empty slot: exact zeros
    assert torch.count_nonzero(got[-1]) == 0
    want = (ref.paged_decode_attention_ref(q, kp, vp, bt, tl, **sc)
            if s == 1 else
            ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl, **sc))
    _close(got[:-1], want[:-1], torch.bfloat16)


@pytest.mark.parametrize("int8,s", SPLIT_CALLS)
def test_paged_split_counters_back_at_zero(cuda, int8, s):
    *args, plan = _serving_split_case(cuda, int8, s)
    _paged_call(*args)
    _paged_call(*args)
    torch.cuda.synchronize()
    counters = K.split_counters(cuda, plan.units)[:plan.units]
    assert int(torch.count_nonzero(counters)) == 0


# -- expert-batched forms (MoE: E stacked experts, one launch) --------------


def _stacked_packed(rng, e, n, k, dtype, dev, int8=False):
    w = torch.as_tensor(rng.normal(size=(e, n, k)) * k ** -0.5,
                        dtype=torch.float32, device=dev)
    p = tbcrc_pack(w, BCRSpec(block_shape=(128, 128), keep_frac=0.25,
                              align=8))
    if int8:
        return quantize_packed(p)
    p.vals = p.vals.to(dtype)
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m", [1, 4, 37, 240])
def test_expert_batched_bcr_spmm_matches_plain(cuda, dtype, int8, m):
    """E = 5 experts of deepseek's down projection shape cut to 2 block
    columns (256 x 384): one launch, each expert against its plain
    version."""
    rng = np.random.default_rng(12)
    p = _stacked_packed(rng, 5, 256, 384, dtype, cuda, int8)
    x = torch.as_tensor(rng.normal(size=(5, m, 384)), dtype=dtype,
                        device=cuda)
    key = "bcr_spmm_int8" if int8 else "bcr_spmm"
    before = K.LAUNCHES[key]
    got = K.bcr_spmm(x, p)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == before + 1
    assert got.shape == (5, m, 256)
    _close(got, ref.bcr_spmm_packed_ref(x, p), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("epilogue,bias", [(None, False), ("swiglu", True)])
@pytest.mark.parametrize("m", [4, 240])
def test_expert_batched_bcr_spmm_grouped_matches_plain(cuda, dtype, int8,
                                                       epilogue, bias, m):
    rng = np.random.default_rng(13)
    g = pack_group([_stacked_packed(rng, 5, 384, 256, torch.float32, cuda)
                    for _ in range(2)])
    if int8:
        g = quantize_grouped(g)
    else:
        g.vals = g.vals.to(dtype)
    x = torch.as_tensor(rng.normal(size=(5, m, 256)), dtype=dtype,
                        device=cuda)
    b = (torch.as_tensor(rng.normal(size=(5, 2, 384)), dtype=torch.float32,
                         device=cuda) if bias else None)
    key = "bcr_spmm_grouped_int8" if int8 else "bcr_spmm_grouped"
    before = K.LAUNCHES[key]
    got = K.bcr_spmm_grouped(x, g, bias=b, epilogue=epilogue)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == before + 1
    want = ref.bcr_spmm_grouped_ref(x, g, bias=b, epilogue=epilogue)
    if epilogue is None:
        want = want.transpose(1, 2)
    _close(got, want, dtype)


@pytest.mark.parametrize("int8", [False, True])
def test_expert_batched_split_path(cuda, int8):
    """Two experts of deepseek's gate/up at M = 4 take the one-launch split
    (64 would fill the card unsplit): two launches bit-equal, right, and
    every expert's counters back at zero."""
    rng = np.random.default_rng(14)
    g = pack_group([_stacked_packed(rng, 2, 1408, 2048, torch.float32, cuda)
                    for _ in range(2)])
    g = quantize_grouped(g) if int8 else g
    if not int8:
        g.vals = g.vals.to(torch.bfloat16)
    x = torch.as_tensor(rng.normal(size=(2, 4, 2048)), dtype=torch.bfloat16,
                        device=cuda)
    plan = K.launch_plan(4, 1408, 2048, 2, (128, 128), (64, 64),
                         torch.cuda.get_device_properties(
                             cuda).multi_processor_count, int8, experts=2)
    assert plan.splits > 1
    first = K.bcr_spmm_grouped(x, g, epilogue="swiglu")
    second = K.bcr_spmm_grouped(x, g, epilogue="swiglu")
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _close(first, ref.bcr_spmm_grouped_ref(x, g, epilogue="swiglu"),
           torch.bfloat16)
    counters = K.split_counters(cuda, plan.tiles)[:plan.tiles]
    assert int(torch.count_nonzero(counters)) == 0


def test_expert_batched_wrappers_reject_bad_inputs(cuda):
    rng = np.random.default_rng(15)
    p = _stacked_packed(rng, 3, 256, 256, torch.bfloat16, cuda)
    with pytest.raises(ValueError):          # 2-D x over stacked experts
        K.bcr_spmm(torch.zeros((4, 256), dtype=torch.bfloat16, device=cuda),
                   p)
    with pytest.raises(ValueError):          # expert counts differ
        K.bcr_spmm(torch.zeros((2, 4, 256), dtype=torch.bfloat16,
                               device=cuda), p)


# the plan tuner's genomes (kernels/plan.py): every legal one at two small
# shapes, one launch each against the plain version — the serving block at
# decode M (4 block rows, split) and the smoke block at a ragged M
GENOME_SHAPES = [  # (N, K, block, keep, align, M, G)
    (512, 1024, (128, 128), 0.25, 8, 8, 2),
    (64, 96, (16, 16), 0.25, 4, 20, 3),
    # whisper's lm_head blocks: G = 1 genomes index the short-block body's
    # configurations (259 block rows: a ragged last group at every P)
    (518, 1280, (2, 128), 0.25, 1, 8, 1),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", GENOME_SHAPES)
def test_every_legal_genome_matches_plain(cuda, int8, shape):
    import itertools

    from repro_torch.core.tuner import genome_knobs
    from repro_torch.kernels.plan import attach_plan, plan_search_space
    n, k, block, keep, align, m, g = shape
    rng = np.random.default_rng(7)
    members = [_packed(rng, n, k, block, keep, torch.bfloat16, cuda, align)
               for _ in range(g)]
    if int8:
        members = [quantize_packed(p) for p in members]
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.bfloat16,
                        device=cuda)
    space = plan_search_space(m, g, block)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    legal = 0
    for values in itertools.product(*(space[key] for key in sorted(space))):
        genome = dict(zip(sorted(space), values))
        grp = genome["group_size"]
        try:
            K.launch_plan(m, n, k, grp, block, members[0].kept_counts, sms,
                          int8, True, 1, genome_knobs(genome))
        except ValueError:
            continue
        legal += 1
        if grp > 1:
            grouped = pack_group(members[:grp], genome, m=m)
            got = K.bcr_spmm_grouped(x, grouped)
            want = ref.bcr_spmm_grouped_ref(x, grouped).transpose(-3, -2)
        else:
            planned = attach_plan(members[0], genome, m=m)
            got, want = K.bcr_spmm(x, planned), ref.bcr_spmm_packed_ref(
                x, planned)
        _close(got, want, torch.bfloat16)
    assert legal >= 4


# the short-block body (blocks under 16 rows, G = 1, bf16 x): the GRU's
# shape at M = 1 (a split over 3 CTAs), whisper's lm_head blocks at a ragged
# M and a last group of fewer block rows, the CNN's blocks at M = 33
SHORT_CASES = [((1024, 1024, (8, 8), 0.1, 2), 1),
               ((518, 1280, (2, 128), 0.25, 1), 5),
               ((200, 2304, (8, 16), 0.25, 2), 33)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case,m", SHORT_CASES)
def test_short_body_matches_plain_and_counts_apart(cuda, int8, case, m):
    """Each launch counts once under its form and once under the form's
    ``_short`` key; two launches are bit-equal (a split sums its partials
    in split order), right over freed NaN-filled buffers, and leave the
    split counters at 0."""
    n, k, block, keep, align = case
    rng = np.random.default_rng(29)
    p = _packed(rng, n, k, block, keep, torch.bfloat16, cuda, align)
    if int8:
        p = quantize_packed(p)
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.bfloat16,
                        device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = K.launch_plan(m, n, k, 1, block, p.kept_counts, sms, int8)
    assert plan.body == "short"
    key = "bcr_spmm_int8" if int8 else "bcr_spmm"
    before = dict(K.LAUNCHES)
    poison = (torch.full((max(plan.workspace_floats, 1),), float("nan"),
                         device=cuda),
              torch.full((m, n), float("nan"), dtype=torch.bfloat16,
                         device=cuda))
    del poison
    first = K.bcr_spmm(x, p)
    second = K.bcr_spmm(x, p)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] - before[key] == 2
    assert K.LAUNCHES[key + "_short"] - before[key + "_short"] == 2
    assert torch.equal(first, second) and bool(torch.isfinite(first).all())
    _close(first, ref.bcr_spmm_packed_ref(x, p), torch.bfloat16)
    left = K.split_counters(cuda, plan.tiles)[:plan.tiles]
    assert int(torch.count_nonzero(left)) == 0

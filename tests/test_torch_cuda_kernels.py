"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one.

Run them on the machine with the card (its Python has no JAX, and the
suite-wide conftest imports it, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-4 (the kernel sums in another order than the plain
einsum); bf16 2e-2 relative to the output scale (both round one fp32 sum to
bf16, which can differ by one bf16 ulp, ~0.4%, plus the order difference).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bcr import BCRSpec
from repro_torch.core.bcrc import tbcrc_pack
from repro_torch.kernels import bcr_spmm as K
from repro_torch.kernels import paged_decode_attention as PA
from repro_torch.kernels import ref
from repro_torch.kernels.plan import pack_group

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
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", [1, 8, 37, 300])
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
@pytest.mark.parametrize("m", [1, 8, 130])
def test_bcr_spmm_grouped_matches_plain(cuda, dtype, g, epilogue, bias, m):
    rng = np.random.default_rng(1)
    members = [_packed(rng, 256, 256, (128, 128), 0.25, dtype, cuda)
               for _ in range(g)]
    grouped = pack_group(members)
    x = torch.as_tensor(rng.normal(size=(m, 256)), dtype=dtype, device=cuda)
    b = (torch.as_tensor(rng.normal(size=(g, 256)), dtype=torch.float32,
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

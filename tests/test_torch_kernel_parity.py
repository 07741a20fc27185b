"""Port vs reference, per kernel: the port's kernel wrappers on CPU tensors
(their plain PyTorch versions) against the reference's Pallas kernels run in
interpret mode, on the same numpy inputs.

Tolerance: fp32 ``atol = rtol = 1e-5`` — the two sides sum in different
orders."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bcr as jbcr  # noqa: E402
from repro.core import bcrc as jbcrc  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels.ops import bcr_matmul as jbcr_matmul  # noqa: E402
from repro.kernels.ops import bcr_matmul_grouped as jbcr_matmul_grouped  # noqa: E402,E501
from repro.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention as jpaged_decode,
    paged_prefill_append_attention as jpaged_append)

from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.core import bcrc as tbcrc  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels.ops import bcr_matmul, bcr_matmul_grouped  # noqa: E402,E501
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention, paged_prefill_append_attention)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pack_both(w, block, keep, align):
    jspec = jbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align)
    tspec = tbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align)
    return (jbcrc.tbcrc_pack(jnp.asarray(w), jspec),
            tbcrc.tbcrc_pack(torch.as_tensor(w), tspec))


@pytest.mark.parametrize("m", [1, 5, 24])
@pytest.mark.parametrize("shape,block,keep,align", [
    ((64, 96), (16, 32), 0.25, 4),
    ((48, 40), (8, 8), 0.1, 2),          # kept counts of 1..2
])
def test_bcr_spmm_plain_matches_interpret_kernel(m, shape, block, keep,
                                                 align):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(m, shape[1])).astype(np.float32)
    jp, tp = _pack_both(w, block, keep, align)
    want = np.asarray(jbcr_matmul(jnp.asarray(x), jp, impl="interpret"))
    got = bcr_matmul(torch.as_tensor(x), tp).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("g,epilogue,bias", [
    (2, None, True), (3, None, False), (2, "swiglu", True),
    (2, "swiglu", False)])
def test_bcr_spmm_grouped_plain_matches_interpret_kernel(g, epilogue, bias):
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=(32, 64)).astype(np.float32) for _ in range(g)]
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    packs = [_pack_both(w, (16, 16), 0.25, 4) for w in ws]
    jg = jplan.pack_group([p[0] for p in packs])
    tg = tplan.pack_group([p[1] for p in packs])
    b = rng.normal(size=(g, 32)).astype(np.float32) if bias else None
    want = np.asarray(jbcr_matmul_grouped(
        jnp.asarray(x), jg, impl="interpret",
        bias=None if b is None else jnp.asarray(b), epilogue=epilogue))
    got = bcr_matmul_grouped(
        torch.as_tensor(x), tg, bias=None if b is None else torch.as_tensor(b),
        epilogue=epilogue).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _paged_inputs(rng, tlens, page_size, hkv, g, d, s):
    b = len(tlens)
    max_pages = max(-(-int(l) // page_size) for l in tlens) + 1
    n_pages = 1 + b * max_pages
    kp = rng.normal(size=(n_pages, page_size, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page_size, hkv, d)).astype(np.float32)
    kp[0] = vp[0] = 0.0                       # the zeroed null page
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, max_pages), np.int32)
    nxt = 0
    for i, l in enumerate(tlens):
        for p in range(-(-int(l) // page_size)):
            bt[i, p] = perm[nxt]
            nxt += 1
    q = rng.normal(size=(b, s, hkv * g, d)).astype(np.float32)
    return q, kp, vp, bt


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("page_size", [4, 8])
def test_paged_decode_plain_matches_interpret_kernel(g, page_size):
    rng = np.random.default_rng(2)
    lens = np.asarray([13, 1, 8, 25], np.int32)   # ragged, partial pages
    q, kp, vp, bt = _paged_inputs(rng, lens, page_size, 2, g, 16, 1)
    want = np.asarray(jpaged_decode(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(bt),
                                    jnp.asarray(lens), interpret=True))
    got = paged_decode_attention(torch.as_tensor(q), torch.as_tensor(kp),
                                 torch.as_tensor(vp), torch.as_tensor(bt),
                                 torch.as_tensor(lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_decode_inactive_slot_is_finite():
    """An inactive slot (length 1 over its zeroed table row: the engine
    hands ``len + 1``) reads the null page; both sides stay finite."""
    rng = np.random.default_rng(3)
    lens = np.asarray([9, 1], np.int32)
    q, kp, vp, bt = _paged_inputs(rng, lens, 4, 2, 2, 16, 1)
    bt[1] = 0
    got = paged_decode_attention(torch.as_tensor(q), torch.as_tensor(kp),
                                 torch.as_tensor(vp), torch.as_tensor(bt),
                                 torch.as_tensor(lens)).numpy()
    want = np.asarray(jpaged_decode(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(bt),
                                    jnp.asarray(lens), interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s", [1, 5, 12])
def test_paged_append_plain_matches_interpret_kernel(s):
    rng = np.random.default_rng(4)
    plens = np.asarray([17, 0, 6], np.int32)        # prefix over pages
    slens = np.asarray([s, max(1, s - 2), min(s, 3)], np.int32)
    tlens = plens + slens
    q, kp, vp, bt = _paged_inputs(rng, tlens, 4, 2, 2, 16, s)
    args = (q, kp, vp, bt, plens, tlens)
    want = np.asarray(jpaged_append(*map(jnp.asarray, args), interpret=True))
    got = paged_prefill_append_attention(*map(torch.as_tensor, args)).numpy()
    for b, sl in enumerate(slens):                  # rows past slen: garbage
        np.testing.assert_allclose(got[b, :sl], want[b, :sl], **TOL)

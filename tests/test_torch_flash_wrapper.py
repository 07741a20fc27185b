"""The flash wrapper on the CPU, against the reference's Pallas kernel in
interpret mode: the same numpy inputs at every head dim the CUDA kernel
takes (16, 32, 64, 128) and at ragged lengths that no CUDA tile divides
(77, 30 over 40, 200), causal, non-causal and with a ``q_offset``. The
wrapper's shape checks raise as on the card, and a CPU call launches no
kernel.

Tolerance: fp32 ``atol = rtol = 1e-5`` (the two sides sum in different
orders), as in ``test_torch_quant.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import \
    flash_attention_fused as jflash  # noqa: E402

from repro_torch.kernels import flash_attention as FA  # noqa: E402

torch.set_num_threads(2)
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal,q_offset", [
    (77, 77, True, 0), (77, 77, False, 0), (30, 40, True, 10),
    (40, 40, False, 0), (200, 200, True, 0), (16, 200, True, 184)])
def test_wrapper_matches_interpret_kernel(sq, skv, causal, q_offset, d):
    rng = np.random.default_rng(sq * 1000 + skv + d)
    q = rng.normal(size=(2, sq, d)).astype(np.float32)
    k = rng.normal(size=(2, skv, d)).astype(np.float32)
    v = rng.normal(size=(2, skv, d)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=sq, kv_chunk=skv, q_offset=q_offset)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), interpret=True,
                             **kw))
    got = FA.flash_attention_fused(*map(torch.as_tensor, (q, k, v)), **kw)
    assert got.shape == (2, sq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("qs,ks,kw", [
    ((2, 8, 16), (2, 8, 32), {}),          # head dims differ
    ((2, 8, 16), (3, 8, 16), {}),          # B·H differs
    ((2, 8, 16), (2, 8, 16), {"q_offset": -1}),
])
def test_wrapper_rejects_bad_calls(qs, ks, kw):
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError):
        FA.flash_attention_fused(q, k, k, **kw)


def test_cpu_call_launches_no_kernel():
    q = torch.zeros(2, 8, 16)
    before = FA.LAUNCHES["flash_attention_fused"]
    FA.flash_attention_fused(q, q, q)
    assert FA.LAUNCHES["flash_attention_fused"] == before

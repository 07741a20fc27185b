"""Port vs reference, the chunked online-softmax attention
(``models/layers.flash_attention``, the reference's XLA code and the
port's plain torch chunk loop), at fp32 on the CPU: outputs and gradients
against the reference's, the chunk assertion both keep, the 1500-frame rule
of the encdec callers (a whole-length chunk where the configured one does
not divide the length), and the engine under ``attn_impl="flash"`` against
the naive ``generate``.

Tolerances: ``1e-5 x max(1, max |reference|)`` on attention outputs and
gradients (both sum the same fp32 products per tile, in another order);
``1e-4`` on whisper's logits through 4 layers; tokens exactly."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch.serve import build_params, generate  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402

torch.set_num_threads(2)


def _close(got, want, tol, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _qkv(rng, b, sq, skv, h, hkv, d):
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


# (B, Sq, Skv, H, Hkv, D, q_chunk, kv_chunk, q_offset): G = 1 and 4; Sq
# below q_chunk (clamped), equal to it and several chunks; q_offset past
# 0 (a suffix over a longer key range)
CASES = [(2, 64, 64, 4, 4, 16, 16, 32, 0),
         (2, 64, 64, 8, 2, 16, 16, 16, 0),
         (1, 12, 12, 4, 1, 8, 512, 1024, 0),
         (2, 48, 48, 4, 1, 16, 48, 16, 0),
         (1, 32, 96, 8, 2, 16, 8, 32, 64),
         (1, 16, 64, 4, 4, 8, 16, 64, 48)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_reference(case, causal):
    b, sq, skv, h, hkv, d, qc, kc, off = case
    q, k, v = _qkv(np.random.default_rng(sum(case)), b, sq, skv, h, hkv, d)
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, q_chunk=qc,
                                   kv_chunk=kc, q_offset=off)
    got = tlayers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  q_chunk=qc, kv_chunk=kc, q_offset=off)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, want, 1e-5, f"flash {case} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_flash_attention_gradients_match_reference(case, causal):
    """d/dq, d/dk, d/dv of a weighted sum of the output against
    ``jax.grad`` of the reference; the port's q-chunk bodies run under
    ``torch.utils.checkpoint`` and recompute in the backward pass."""
    b, sq, skv, h, hkv, d, qc, kc, off = case
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, b, sq, skv, h, hkv, d)
    w = rng.normal(size=(b, sq, h, d)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jlayers.flash_attention(
            q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc,
            q_offset=off) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tlayers.flash_attention(tq, tk, tv, causal=causal, q_chunk=qc,
                                  kv_chunk=kc, q_offset=off)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _close(got, ref, 1e-5, f"d/d{name}")


def test_both_packages_assert_on_1500_over_1024():
    """The reference's chunk rule, kept: 1500 key rows do not split into
    kv chunks of 1024 (whisper's frames under the default chunks)."""
    q, k, v = _qkv(np.random.default_rng(0), 1, 4, 1500, 2, 2, 8)
    with pytest.raises(AssertionError):
        jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False)
    with pytest.raises(AssertionError):
        tlayers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False)
    # the encdec callers' rule: a whole-length chunk where 1024 does not
    # divide 1500, the configured one where it does
    assert tlayers.whole_length_chunk(1024, 1500) == 1500
    assert tlayers.whole_length_chunk(512, 1500) == 1500
    assert tlayers.whole_length_chunk(512, 4) == 512
    assert tlayers.whole_length_chunk(512, 2048) == 512


def test_encdec_at_1500_frames_under_flash_equals_dense():
    """whisper's SMOKE widths at its 1500 frames: ``prefill`` and
    ``decode_train`` under ``"flash"`` (the encoder's and the cross
    attention's chunks clamped to the whole 1500) against ``"dense"``."""
    base = dataclasses.replace(tcfgs.get_smoke_config("whisper-large-v3"),
                               encoder_seq=1500, num_layers=2,
                               encoder_layers=2)
    flash = dataclasses.replace(base, attn_impl="flash")
    dense = dataclasses.replace(base, attn_impl="dense")
    params = model_fns(dense).init_params(0, device="cpu")
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.normal(size=(2, 1500, base.d_model))
                              .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, base.vocab_size, size=(2, 6))
                              .astype(np.int32))
    with torch.no_grad():
        want_logits, want_cross = model_fns(dense).prefill(
            params, {"frames": frames, "tokens": tokens})
        got_logits, got_cross = model_fns(flash).prefill(
            params, {"frames": frames, "tokens": tokens})
        _close(got_logits, want_logits.numpy(), 1e-4, "prefill logits")
        for key in want_cross:
            for g, w in zip(got_cross[key], want_cross[key]):
                _close(g, w.numpy(), 1e-4, f"cross {key}")
        enc = ted.encode(dense, params, frames)
        want = ted.decode_train(dense, params, tokens, enc)
        got = ted.decode_train(flash, params, tokens, enc)
        _close(got, want.numpy(), 1e-4, "decode_train")


def _cfg(**over):
    return dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=0.25, bcr_block=(16, 16),
                               attn_impl="flash", **over)


def test_engine_under_flash_equals_naive_generate():
    """The engine's padded cold prefills run the chunked attention
    (``q_chunk = kv_chunk = 8``): tokens equal the naive ``generate``'s
    exact-length prefills bit for bit. Capacity 52 is no multiple of 8, so
    the 40-token prompt's bucket stays the uncapped 64 (``flash_chunks``
    into ``prefill_bucket``), whose pad rows the pool drops."""
    cfg = _cfg(q_chunk=8, kv_chunk=8)
    params = build_params(cfg, log=lambda *_: None, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 40, 16, 4)]
    gen = 6
    want = [generate(cfg, params, torch.as_tensor(p)[None], gen_tokens=gen,
                     page_size=4)["tokens"][0].tolist() for p in prompts]
    eng = InferenceEngine(cfg, params, EngineConfig(n_slots=2, capacity=52,
                                                    page_size=4),
                          device="cpu")
    assert eng._bucket(40) == 64 and eng._bucket(9) == 16
    assert eng.generate(prompts, max_new_tokens=gen) == want
    eng.pool.check_consistency()


def test_engine_refuses_buckets_the_chunks_cannot_split():
    """Under ``"flash"`` as under the fused kernel, an engine whose prefill
    buckets would not split into the chunks is refused at build."""
    cfg = _cfg(q_chunk=24, kv_chunk=24)
    params = build_params(cfg, log=lambda *_: None, device="cpu")
    with pytest.raises(ValueError, match="flash chunks"):
        InferenceEngine(cfg, params, EngineConfig(n_slots=2, capacity=64,
                                                  page_size=4), device="cpu")

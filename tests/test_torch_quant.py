"""Port vs reference, quantized serving and the fused flash prefill, on the
CPU at smoke size: the same numpy inputs go through the reference (its
Pallas kernels in interpret mode) and the port (its kernel wrappers on CPU
tensors, i.e. their plain PyTorch versions).

Tolerances, each with its reason:

* quantization codes and scales: exact (both round fp32 the same way, ties
  to even);
* int8 spmm, int8 paged attention, flash attention: fp32 ``atol = rtol =
  1e-5`` (the two sides sum in different orders; the int8 paged kernel also
  applies the scales after the product where the plain version dequantizes
  first);
* model logits: ``atol = rtol = 1e-4`` (summation order across two layers,
  as in ``test_torch_model.py``); K/V rows are quantized on both sides from
  fp32 values that differ only by that order, so a code can differ by one
  at a rounding tie — with the seed below none does;
* engine tokens: equal greedy tokens (fp32 logits, no near-ties at this
  seed);
* int8 against fp serving on one model: the reference's own bound, a
  first-divergence share of at most 0.25 (``tests/test_quantized.py``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core import bcr as jbcr  # noqa: E402
from repro.core import bcrc as jbcrc  # noqa: E402
from repro.kernels import plan as jplan  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_fused as jflash  # noqa: E402
from repro.kernels.ops import bcr_matmul as jbcr_matmul  # noqa: E402
from repro.kernels.ops import bcr_matmul_grouped as jbcr_matmul_grouped  # noqa: E402,E501
from repro.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention as jpaged_decode,
    paged_kv_bytes as jpaged_kv_bytes,
    paged_prefill_append_attention as jpaged_append)
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.core import bcrc as tbcrc  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_fused  # noqa: E402
from repro_torch.kernels.ops import bcr_matmul, bcr_matmul_grouped  # noqa: E402,E501
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention, paged_kv_bytes, paged_prefill_append_attention)
from repro_torch.launch.serve import (build_params, generate,  # noqa: E402
                                      pack_params)
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402

torch.set_num_threads(2)
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# Quantization: codes and scales bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((33, 5, 64), 3.0), ((7, 16), 0.02),
                                         ((4, 2, 16), 0.0)])
def test_quantize_rows_matches_reference_exactly(shape, scale):
    x = (np.random.default_rng(0).normal(size=shape) * scale).astype(
        np.float32)
    x.reshape(-1)[::7] = 0.5 * np.round(2 * x.reshape(-1)[::7])  # ties
    jc, js = jquant.quantize_rows(jnp.asarray(x))
    tc, ts = tquant.quantize_rows(torch.as_tensor(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_rows(tc, ts).numpy(),
        np.asarray(jquant.dequantize_rows(jc, js)))


@pytest.mark.parametrize("shape", [(3, 2, 16, 8), (2, 2, 3, 4, 4)])
def test_quantize_blocks_matches_reference_exactly(shape):
    vals = (np.random.default_rng(1).normal(size=shape) * 0.2).astype(
        np.float32)
    jc, js = jquant.quantize_blocks(jnp.asarray(vals))
    tc, ts = tquant.quantize_blocks(torch.as_tensor(vals))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_blocks(tc, ts).numpy(),
        np.asarray(jquant.dequantize_blocks(jc, js)))


# ---------------------------------------------------------------------------
# int8 BCR spmm: plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def _quantized_pack_both(w, block, keep, align):
    jspec = jbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align)
    tspec = tbcr.BCRSpec(block_shape=block, keep_frac=keep, align=align)
    jp = jplan.quantize_packed(jbcrc.tbcrc_pack(jnp.asarray(w), jspec))
    tp = tplan.quantize_packed(tbcrc.tbcrc_pack(torch.as_tensor(w), tspec))
    np.testing.assert_array_equal(tp.vals.numpy(), np.asarray(jp.vals))
    np.testing.assert_array_equal(tp.plan.block_scales.numpy(),
                                  np.asarray(jp.plan.block_scales))
    return jp, tp


@pytest.mark.parametrize("m", [1, 5, 24])
@pytest.mark.parametrize("shape,block,keep,align", [
    ((64, 96), (16, 32), 0.25, 4),
    ((48, 40), (8, 8), 0.1, 2),          # kept counts of 1..2
])
def test_int8_bcr_spmm_plain_matches_interpret_kernel(m, shape, block, keep,
                                                      align):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(m, shape[1])).astype(np.float32)
    jp, tp = _quantized_pack_both(w, block, keep, align)
    want = np.asarray(jbcr_matmul(jnp.asarray(x), jp, impl="interpret"))
    got = bcr_matmul(torch.as_tensor(x), tp).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    # the dense oracle reconstructs the dequantized weight in both packages
    np.testing.assert_allclose(tbcrc.tbcrc_unpack(tp).numpy(),
                               np.asarray(jbcrc.tbcrc_unpack(jp)),
                               **KERNEL_TOL)
    np.testing.assert_allclose(tref.bcr_spmm_ref(torch.as_tensor(x),
                                                 tp).numpy(), want, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("g,epilogue,bias", [
    (2, None, True), (3, None, False), (2, "swiglu", True)])
def test_int8_bcr_spmm_grouped_plain_matches_interpret_kernel(g, epilogue,
                                                              bias):
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=(32, 64)).astype(np.float32) for _ in range(g)]
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    packs = [_quantized_pack_both(w, (16, 16), 0.25, 4) for w in ws]
    jg = jplan.pack_group([p[0] for p in packs])
    tg = tplan.pack_group([p[1] for p in packs])
    assert tuple(tg.plan.block_scales.shape) == tuple(tg.vals.shape[:3])
    b = rng.normal(size=(g, 32)).astype(np.float32) if bias else None
    want = np.asarray(jbcr_matmul_grouped(
        jnp.asarray(x), jg, impl="interpret",
        bias=None if b is None else jnp.asarray(b), epilogue=epilogue))
    got = bcr_matmul_grouped(
        torch.as_tensor(x), tg, bias=None if b is None else torch.as_tensor(b),
        epilogue=epilogue).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


def test_quantize_grouped_equals_grouping_quantized_members():
    """Per-tile scales: quantizing after fusion (the port's pack order)
    gives the codes and scales of quantizing each member first."""
    rng = np.random.default_rng(2)
    spec = tbcr.BCRSpec(block_shape=(16, 16), keep_frac=0.25, align=4)
    members = [tbcrc.tbcrc_pack(torch.as_tensor(
        rng.normal(size=(32, 64)).astype(np.float32)), spec) for _ in range(2)]
    after = tplan.quantize_grouped(tplan.pack_group(members))
    before = tplan.pack_group([tplan.quantize_packed(m) for m in members])
    assert torch.equal(after.vals, before.vals)
    assert torch.equal(after.plan.block_scales, before.plan.block_scales)
    assert tplan._scale_bytes(after) == 4
    assert after.nbytes() < tplan.pack_group(members).nbytes()


# ---------------------------------------------------------------------------
# int8 paged attention: plain versions against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------


def _int8_paged_inputs(rng, tlens, page_size, hkv, g, d, s):
    b = len(tlens)
    max_pages = max(-(-int(l) // page_size) for l in tlens) + 1
    n_pages = 1 + b * max_pages
    kf = rng.normal(size=(n_pages, page_size, hkv, d)).astype(np.float32)
    vf = rng.normal(size=(n_pages, page_size, hkv, d)).astype(np.float32)
    kc, ks = (np.array(a) for a in jquant.quantize_rows(jnp.asarray(kf)))
    vc, vs = (np.array(a) for a in jquant.quantize_rows(jnp.asarray(vf)))
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, max_pages), np.int32)
    nxt = 0
    for i, l in enumerate(tlens):
        for p in range(-(-int(l) // page_size)):
            bt[i, p] = perm[nxt]
            nxt += 1
    q = rng.normal(size=(b, s, hkv * g, d)).astype(np.float32)
    return q, kc, vc, ks, vs, bt


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("page_size", [4, 8])
def test_int8_paged_decode_plain_matches_interpret_kernel(g, page_size):
    rng = np.random.default_rng(3)
    lens = np.asarray([13, 1, 8, 25], np.int32)
    q, kc, vc, ks, vs, bt = _int8_paged_inputs(rng, lens, page_size, 2, g,
                                               16, 1)
    want = np.asarray(jpaged_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(lens), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        interpret=True))
    got = paged_decode_attention(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(bt), torch.as_tensor(lens),
        k_scale=torch.as_tensor(ks), v_scale=torch.as_tensor(vs)).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("s", [1, 5, 12])
def test_int8_paged_append_plain_matches_interpret_kernel(s):
    rng = np.random.default_rng(4)
    plens = np.asarray([17, 0, 6], np.int32)
    slens = np.asarray([s, max(1, s - 2), min(s, 3)], np.int32)
    tlens = plens + slens
    q, kc, vc, ks, vs, bt = _int8_paged_inputs(rng, tlens, 4, 2, 2, 16, s)
    args = (q, kc, vc, bt, plens, tlens)
    want = np.asarray(jpaged_append(*map(jnp.asarray, args),
                                    k_scale=jnp.asarray(ks),
                                    v_scale=jnp.asarray(vs), interpret=True))
    got = paged_prefill_append_attention(
        *map(torch.as_tensor, args), k_scale=torch.as_tensor(ks),
        v_scale=torch.as_tensor(vs)).numpy()
    for b, sl in enumerate(slens):                  # rows past slen: garbage
        np.testing.assert_allclose(got[b, :sl], want[b, :sl], **KERNEL_TOL)


def test_paged_kv_bytes_counts_scales_as_the_reference():
    lens = np.asarray([16, 5, 0, 33])
    for kw in (dict(dtype_bytes=2), dict(dtype_bytes=1, scale_bytes=4)):
        assert paged_kv_bytes(lens, 16, 8, 64, **kw) == \
            jpaged_kv_bytes(lens, 16, 8, 64, **kw)
    # per row per layer per K or V: 1024 bytes in bf16, 544 under int8
    assert paged_kv_bytes([16], 16, 8, 64, 2) // 32 == 1024
    assert paged_kv_bytes([16], 16, 8, 64, 1, 4) // 32 == 544


# ---------------------------------------------------------------------------
# Fused flash attention: plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,q_offset,sq,skv", [
    (True, 0, 32, 32), (False, 0, 16, 48), (True, 16, 16, 32),
    (True, 5, 8, 24)])
def test_flash_attention_plain_matches_interpret_kernel(causal, q_offset, sq,
                                                        skv):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, sq, 16)).astype(np.float32)
    k = rng.normal(size=(3, skv, 16)).astype(np.float32)
    v = rng.normal(size=(3, skv, 16)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=8, kv_chunk=8, q_offset=q_offset)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), interpret=True,
                             **kw))
    got = flash_attention_fused(*map(torch.as_tensor, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_flash_attention_keeps_the_reference_divisibility_rule():
    q = np.zeros((1, 12, 16), np.float32)
    with pytest.raises(ValueError):
        jflash(*map(jnp.asarray, (q, q, q)), q_chunk=8, interpret=True)
    with pytest.raises(ValueError):
        flash_attention_fused(*map(torch.as_tensor, (q, q, q)), q_chunk=8)


# ---------------------------------------------------------------------------
# Model: int8 KV + int8 weights + the flash cold prefill, logits
# ---------------------------------------------------------------------------

PS = 4
B, S, S2 = 2, 7, 5


def _quant_cfgs(**over):
    over = dict(bcr_keep_frac=0.25, bcr_block=(16, 16), kv_dtype="int8",
                **over)
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               attn_impl="pallas_interpret",
                               kernel_impl="interpret", **over)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               attn_impl="pallas", **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def quant_models():
    jcfg, tcfg = _quant_cfgs()
    params = jpack_params(jcfg, jmodel_fns(jcfg).init_params(
        jax.random.PRNGKey(0)), weight_dtype="int8")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def test_convert_carries_int8_codes_and_scales(quant_models):
    _, jparams, tcfg, tparams = quant_models
    lm = tparams["lm_head"]["w_packed"]
    jlm = jparams["lm_head"]["w_packed"]
    assert lm.vals.dtype == torch.int8
    np.testing.assert_array_equal(lm.vals.numpy(), np.asarray(jlm.vals))
    np.testing.assert_array_equal(lm.plan.block_scales.numpy(),
                                  np.asarray(jlm.plan.block_scales))
    # scanned layers: layer 1's scales are the stack's second row
    jst = jparams["stack"][0]["ffn"]["wo"]["w_packed"]
    np.testing.assert_array_equal(
        tparams["layers"][1]["ffn"]["wo"]["w_packed"].plan.block_scales
        .numpy(), np.asarray(jst.plan.block_scales)[1])
    # the port packing the same weights quantizes to the same codes
    dense = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jmodel_fns(quant_models[0]).init_params(
            jax.random.PRNGKey(0))), dataclasses.replace(
        tcfg, bcr_keep_frac=0.0), device="cpu")
    own = pack_params(tcfg, dense, weight_dtype="int8")["lm_head"]["w_packed"]
    assert torch.equal(own.vals, lm.vals)
    assert torch.equal(own.plan.block_scales, lm.plan.block_scales)


def _seat_jax(cache, pcache, dest):
    def put(pool, new):
        l = pool.shape[0]
        flat = pool.reshape(l, -1, *pool.shape[3:])
        rows = new.reshape(l, -1, *new.shape[3:])
        return flat.at[:, dest].set(rows.astype(pool.dtype)).reshape(
            pool.shape)
    st, pst = cache["stack"][0]["mixer"], pcache["stack"][0]["mixer"]
    cache["stack"][0]["mixer"] = {key: put(st[key], pst[key]) for key in st}
    return cache


def test_int8_flash_model_logits_match_reference(quant_models):
    jcfg, jparams, tcfg, tparams = quant_models
    jfns = jmodel_fns(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    length = np.asarray([S, S - 3], np.int32)

    from repro_torch.kernels.flash_attention import LAUNCHES
    jl, jpc = jax.jit(jfns.prefill)(jparams, {"tokens": jnp.asarray(toks),
                                              "length": jnp.asarray(length)})
    tl, tpc = causal_lm.prefill(tcfg, tparams, torch.as_tensor(toks),
                                length=torch.as_tensor(length))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert set(tpc[0]) == {"k", "v", "k_scale", "v_scale"}
    assert tpc[0]["k"].dtype == torch.int8
    jk = np.asarray(jpc["stack"][0]["mixer"]["k"])
    np.testing.assert_array_equal(tpc[1]["k"].numpy(), jk[1])
    assert LAUNCHES["flash_attention_fused"] == 0    # CPU: the plain version

    n_cols = -(-(S + 1 + S2) // PS)
    bt = (1 + np.arange(n_cols)[None, :] * B
          + np.arange(B)[:, None]).astype(np.int32)
    n_pages = 1 + B * n_cols
    pos = np.arange(S)
    dest = (bt[:, pos // PS] * PS + pos % PS).reshape(-1)
    jcache = _seat_jax(jfns.init_cache(B, 64, kv_pages=n_pages, page_size=PS),
                       jpc, jnp.asarray(dest))
    tcache = causal_lm.init_cache(tcfg, kv_pages=n_pages, page_size=PS,
                                  device="cpu")
    dt = torch.as_tensor(dest)
    for pool, new in zip(tcache, tpc):
        for key, leaf in pool.items():
            leaf.view(-1, *leaf.shape[2:]).index_copy_(
                0, dt, new[key].reshape(-1, *leaf.shape[2:]))

    step = rng.integers(0, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jcache = jax.jit(jfns.decode_step)(
        jparams, {"tokens": jnp.asarray(step),
                  "cache_len": jnp.asarray(length),
                  "block_tables": jnp.asarray(bt)}, jcache)
    tl, tcache = causal_lm.decode_step(
        tcfg, tparams, torch.as_tensor(step), tcache, torch.as_tensor(length),
        block_tables=torch.as_tensor(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)

    suffix = rng.integers(0, tcfg.vocab_size, size=(B, S2)).astype(np.int32)
    plen = length + 1
    slen = np.asarray([S2, 2], np.int32)
    jl, _ = jfns.prefill_append(
        jparams, {"tokens": jnp.asarray(suffix),
                  "prefix_len": jnp.asarray(plen),
                  "length": jnp.asarray(slen),
                  "block_tables": jnp.asarray(bt), "all_logits": True},
        jcache)
    tl, _ = causal_lm.prefill_append(
        tcfg, tparams, torch.as_tensor(suffix), tcache,
        torch.as_tensor(plen), torch.as_tensor(bt),
        length=torch.as_tensor(slen), all_logits=True)
    for b, sl in enumerate(slen):
        np.testing.assert_allclose(tl[b, :sl].numpy(),
                                   np.asarray(jl)[b, :sl], **MODEL_TOL)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 16, 9, 12)
GEN = 8


def _prompts(vocab, lens=PROMPT_LENS, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


def test_int8_engine_matches_reference_int8_engine():
    """Both engines paged, int8 KV and int8 tiles on the same quantized
    weights (converted): the same greedy tokens. The port's cold prefill
    runs through the fused flash path."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=0.25, bcr_block=(16, 16))
    jparams = jpack_params(jcfg, jmodel_fns(jcfg).init_params(
        jax.random.PRNGKey(0)), weight_dtype="int8")
    prompts = _prompts(jcfg.vocab_size)
    jeng = JInferenceEngine(jcfg, jparams, JEngineConfig(
        n_slots=2, capacity=64, page_size=8, kv_dtype="int8",
        weight_dtype="int8"))
    want = jeng.generate(prompts, max_new_tokens=GEN)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=0.25, bcr_block=(16, 16),
                               attn_impl="pallas")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jeng.params),
                              tcfg, device="cpu")
    teng = InferenceEngine(tcfg, tparams, EngineConfig(
        n_slots=2, capacity=64, page_size=8, kv_dtype="int8",
        weight_dtype="int8"), device="cpu")
    assert teng.generate(prompts, max_new_tokens=GEN) == want
    teng.pool.check_consistency()


def test_int8_engine_matches_naive_generate():
    """The reference's bit-identity invariant inside the port, quantized:
    engine tokens equal the naive oracle's on int8 tiles and int8 KV."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                              bcr_keep_frac=0.25, bcr_block=(16, 16),
                              attn_impl="pallas", kv_dtype="int8")
    params = build_params(cfg, log=lambda *_: None, device="cpu",
                          weight_dtype="int8")
    prompts = _prompts(cfg.vocab_size)
    want = [generate(cfg, params, torch.as_tensor(p)[None], gen_tokens=GEN,
                     page_size=4)["tokens"][0].tolist() for p in prompts]
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=64, page_size=4, kv_dtype="int8"), device="cpu")
    assert eng.generate(prompts, max_new_tokens=GEN) == want
    eng.pool.check_consistency()


def _divergence(a_seqs, b_seqs):
    """The reference's first-divergence share (tests/test_quantized.py)."""
    div = tot = 0
    for a, b in zip(a_seqs, b_seqs):
        n = max(len(a), len(b))
        tot += n
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)) if len(a) != len(b) else None)
        if first is not None:
            div += n - first
    return div / max(tot, 1)


def test_engine_int8_greedy_divergence():
    """Mirror of the reference's test_engine_int8_greedy_divergence (paged
    case): int8 KV against fp KV on one dense smoke model."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                              attn_impl="flash", bcr_keep_frac=0.0)
    params = build_params(cfg, log=lambda *_: None, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(l)).astype(np.int32)
               for l in (7, 12, 5, 9)]
    outs = {}
    for name, kvd in (("fp", ""), ("q", "int8")):
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, capacity=64, page_size=8, seed=0, kv_dtype=kvd),
            device="cpu")
        outs[name] = eng.generate(prompts, max_new_tokens=12)
    assert _divergence(outs["fp"], outs["q"]) <= 0.25


def test_engine_kv_row_bytes_reflect_int8():
    """Mirror of the reference's test: per layer per K/V, head_dim codes
    plus one fp32 scale per kv head."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                              bcr_keep_frac=0.0)
    params = build_params(cfg, log=lambda *_: None, device="cpu")
    rows = {}
    for name, kvd in (("fp", ""), ("q", "int8")):
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=2, capacity=32, page_size=8, kv_dtype=kvd), device="cpu")
        rows[name] = eng._kv_row_bytes
    assert rows["q"] < rows["fp"]
    d, hkv, n_l = cfg.head_dim, cfg.num_kv_heads, cfg.num_layers
    assert rows["q"] == n_l * 2 * hkv * (d + 4)


def test_flash_prefill_buckets_meet_the_chunk_rule():
    """Under attn_impl="pallas" every prefill bucket splits into the flash
    chunks: a capacity that does not is not used as a bucket, and chunks no
    power-of-two bucket fits are refused at build."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                              attn_impl="pallas", q_chunk=16, kv_chunk=32)
    params = build_params(cfg, log=lambda *_: None, device="cpu")
    eng = InferenceEngine(cfg, params, EngineConfig(n_slots=1, capacity=40),
                          device="cpu")
    assert eng._buckets() == [8, 16, 32, 64]      # 40 % 16 != 0: keep 64
    plain = InferenceEngine(dataclasses.replace(cfg, attn_impl="dense"),
                            params, EngineConfig(n_slots=1, capacity=40),
                            device="cpu")
    assert plain._buckets() == [8, 16, 32, 40]
    out = eng.generate([np.arange(35) % cfg.vocab_size], max_new_tokens=4)
    assert len(out[0]) == 4
    with pytest.raises(ValueError):
        InferenceEngine(dataclasses.replace(cfg, q_chunk=24), params,
                        EngineConfig(n_slots=1, capacity=64), device="cpu")


def test_pool_moves_scales_with_codes_and_audits_them():
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                              kv_dtype="int8")
    from repro_torch.serving.kv_slots import PagedSlotPool
    pool = PagedSlotPool(lambda **kw: causal_lm.init_cache(cfg, **kw), 2, 32,
                         page_size=4, device="cpu")
    rng = np.random.default_rng(6)
    kf = torch.as_tensor(rng.normal(size=(1, 6, cfg.num_kv_heads,
                                          cfg.head_dim)), dtype=torch.float32)
    kc, ks = tquant.quantize_rows(kf)
    pc = [{"k": kc, "v": kc, "k_scale": ks, "v_scale": ks}
          for _ in range(cfg.num_layers)]
    pool.reserve(1, 10)
    pool.insert_rows(pc, np.asarray([1]), np.asarray([6]))
    pool.check_consistency()
    layer = pool.cache[0]
    for pos in range(6):
        page = pool.table[1, pos // 4]
        assert torch.equal(layer["k"][page, pos % 4], kc[0, pos])
        assert torch.equal(layer["k_scale"][page, pos % 4], ks[0, pos])
    layer["v_scale"][pool.table[1, 0], 2].zero_()   # a live row loses its scale
    with pytest.raises(AssertionError):
        pool.check_consistency()
    with pytest.raises(ValueError):                  # codes without scales
        pool.insert_rows([{"k": kc, "v": kc}] * cfg.num_layers,
                         np.asarray([1]), np.asarray([6]))

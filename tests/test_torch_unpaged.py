"""The port's capacity-dense decode cache on the CPU, held to the reference:
``SlotPool`` operation by operation against the reference's (insert,
grouped ``insert_rows`` with pad rows aliasing ``slots[0]``, advance,
truncate, release), the plain ``decode_attention`` and the dense
``decode_step`` logits (atol 1e-5, fp32), and the ``page_size=0`` engine's
greedy tokens and counters against the reference engine's on converted
weights, plus the engine's lifecycle on that pool."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.kv_slots import SlotPool as JSlotPool  # noqa: E402
from repro.serving.kv_slots import seat_prefill as jseat_prefill  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch.serve import build_params, generate  # noqa: E402
from repro_torch.models import causal_lm, layers  # noqa: E402
from repro_torch.serving import (EngineConfig, InferenceEngine,  # noqa: E402
                                 SlotPool, seat_prefill)

torch.set_num_threads(2)

GEN = 8


def _cfg(**kw):
    return dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"), **kw)


def _jcfg(**kw):
    return dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"), **kw)


def _prompts(vocab, lens=(5, 16, 9, 12), seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def converted():
    """Reference weights (seed 0, fp32 KV), dense and packed at keep 0.25
    with 16x16 blocks, each converted for the port."""
    out = {}
    for keep in (0.0, 0.25):
        jcfg = _jcfg(cache_dtype="float32", bcr_keep_frac=keep,
                     bcr_block=(16, 16))
        jparams = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
        if keep:
            jparams = JInferenceEngine(jcfg, jpack_params(jcfg, jparams),
                                       JEngineConfig(n_slots=2,
                                                     capacity=64)).params
        tcfg = _cfg(cache_dtype="float32", bcr_keep_frac=keep,
                    bcr_block=(16, 16))
        tparams = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tcfg, device="cpu")
        out[keep] = (jcfg, jparams, tcfg, tparams)
    return out


# ---------------------------------------------------------------------------
# SlotPool against the reference's, operation by operation
# ---------------------------------------------------------------------------


def _ref_leaves(cache):
    """The reference's scanned-stack cache → {key: (layers, B, ...)}."""
    return {k: np.asarray(v) for k, v in cache["stack"][0]["mixer"].items()}


def _port_leaves(cache):
    return {k: np.stack([layer[k].numpy() for layer in cache])
            for k in cache[0]}


def _random_prefill(rng, k, seq, kv_dtype):
    """One random prefill cache (k rows, seq positions) in both layouts."""
    cfg = _cfg()
    shape = (cfg.num_layers, k, seq, cfg.num_kv_heads, cfg.head_dim)
    leaves = {"k": rng.standard_normal(shape).astype(np.float32),
              "v": rng.standard_normal(shape).astype(np.float32)}
    if kv_dtype == "int8":
        leaves = {key: rng.integers(-127, 128, size=shape).astype(np.int8)
                  for key in ("k", "v")}
        for key in ("k_scale", "v_scale"):
            leaves[key] = rng.random(shape[:-1]).astype(np.float32) + 0.1
    ref = {"prefix": [], "stack": [{"mixer": {
        key: jnp.asarray(v) for key, v in leaves.items()}, "ffn": {}}]}
    port = [{key: torch.as_tensor(v[i]) for key, v in leaves.items()}
            for i in range(cfg.num_layers)]
    return ref, port


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_slot_pool_matches_reference(kv_dtype):
    """insert, insert_rows (two real rows, two pad rows aliasing slots[0],
    whose garbage the real row 0 must overwrite), advance, truncate and
    release leave the same lengths and the same cache in both pools."""
    jcfg = _jcfg(kv_dtype=kv_dtype, cache_dtype="float32")
    tcfg = _cfg(kv_dtype=kv_dtype, cache_dtype="float32")
    ref = JSlotPool(jmodel_fns(jcfg).init_cache, 4, 16)
    port = SlotPool(lambda b, c, **kw: causal_lm.init_cache(tcfg, b, c,
                                                            **kw),
                    4, 16, device="cpu")
    rng = np.random.default_rng(0)

    def same():
        assert port.lens.tolist() == ref.lens.tolist()
        want, got = _ref_leaves(ref.cache), _port_leaves(port.cache)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])

    jc, tc = _random_prefill(rng, 1, 6, kv_dtype)
    ref.insert(jc, 1, 6)
    port.insert(tc, 1, 6)
    same()
    jc, tc = _random_prefill(rng, 4, 8, kv_dtype)
    slots = np.asarray([2, 0, 2, 2], np.int32)      # rows 2, 3 are pads
    lens = np.asarray([7, 8], np.int32)
    ref.insert_rows(jc, slots, lens)
    port.insert_rows(tc, slots, lens)
    same()
    got = _port_leaves(port.cache)
    for key, leaf in tc[0].items():                 # real row 0 won slot 2
        np.testing.assert_array_equal(got[key][0, 2, :8], leaf[0].numpy())
    for op, args in (("advance", (2,)), ("advance", (2,)),
                     ("truncate", (2, 5)), ("release", (1,)),
                     ("truncate", (0, 0))):
        getattr(ref, op)(*args)
        getattr(port, op)(*args)
        same()
    with pytest.raises(ValueError):
        port.truncate(0, 17)
    with pytest.raises(ValueError):
        port.insert(tc, 0, 17)


def test_seat_prefill_matches_reference():
    jcfg, tcfg = _jcfg(cache_dtype="float32"), _cfg(cache_dtype="float32")
    rng = np.random.default_rng(1)
    jc, tc = _random_prefill(rng, 2, 5, "")
    want = _ref_leaves(jseat_prefill(jmodel_fns(jcfg).init_cache, jc, 2, 12))
    got = _port_leaves(seat_prefill(
        lambda b, c, **kw: causal_lm.init_cache(tcfg, b, c, **kw), tc, 2,
        12, device="cpu"))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# decode_attention and decode_step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("scalar_len", [False, True])
def test_decode_attention_matches_reference(kv_dtype, scalar_len):
    """Per-slot length masking (one empty slot), GQA grouping, the fp32
    softmax and the int8 dequantize fallback: atol 1e-5."""
    rng = np.random.default_rng(2)
    b, l, h, hkv, d = 4, 12, 4, 2, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    if kv_dtype:
        kc = rng.integers(-127, 128, size=(b, l, hkv, d)).astype(np.int8)
        vc = rng.integers(-127, 128, size=(b, l, hkv, d)).astype(np.int8)
        ks = (rng.random((b, l, hkv)) * 0.02).astype(np.float32)
        vs = (rng.random((b, l, hkv)) * 0.02).astype(np.float32)
        scales = (ks, vs)
    else:
        kc = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
        vc = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
        scales = (None, None)
    lens = np.asarray(7, np.int32) if scalar_len else \
        np.asarray([1, 5, 12, 0], np.int32)
    want = jlayers.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        *(None if s is None else jnp.asarray(s) for s in scales))
    got = layers.decode_attention(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(lens),
        *(None if s is None else torch.as_tensor(s) for s in scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("keep", [0.0, 0.25])
@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_decode_step_matches_reference(converted, keep, kv_dtype):
    """A ragged batch (prompts 5, 9, 3 right-padded to 9, seated at their
    own lengths) decoded four steps over the capacity-dense cache: logits
    equal the reference's at atol 1e-5 every step, fp32."""
    jcfg, jparams, tcfg, tparams = converted[keep]
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
    jfns = jmodel_fns(jcfg)
    prompts = _prompts(jcfg.vocab_size, lens=(5, 9, 3), seed=3)
    toks = np.zeros((3, 9), np.int32)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    jlog, jpc = jfns.prefill(jparams, {"tokens": jnp.asarray(toks),
                                       "length": jnp.asarray(lens)})
    jpool = JSlotPool(jfns.init_cache, 3, 24)
    jpool.insert_rows(jpc, np.arange(3), lens)
    tlog, tpc = causal_lm.prefill(tcfg, tparams, torch.as_tensor(toks),
                                  length=torch.as_tensor(lens))
    tpool = SlotPool(lambda b, c, **kw: causal_lm.init_cache(tcfg, b, c,
                                                             **kw),
                     3, 24, device="cpu")
    tpool.insert_rows(tpc, np.arange(3), lens)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=0)
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(4):
        jlog, jpool.cache = jfns.decode_step(
            jparams, {"tokens": jnp.asarray(nxt),
                      "cache_len": jnp.asarray(jpool.lens)}, jpool.cache)
        tlog, tpool.cache = causal_lm.decode_step(
            tcfg, tparams, torch.as_tensor(nxt), tpool.cache,
            torch.as_tensor(tpool.lens))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-5, rtol=0)
        for s in range(3):
            jpool.advance(s)
            tpool.advance(s)
        nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
    np.testing.assert_allclose(_port_leaves(tpool.cache)["k"],
                               _ref_leaves(jpool.cache)["k"], atol=1e-5)


def test_dense_cache_rejects_multi_token_steps():
    cfg = _cfg()
    params = build_params(cfg, device="cpu")
    cache = causal_lm.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError):
        layers.attention_apply(
            params["layers"][0]["mixer"], torch.zeros(2, 3, cfg.d_model),
            n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_cs=None, cache=cache[0],
            cache_len=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        causal_lm.init_cache(cfg, device="cpu")


# ---------------------------------------------------------------------------
# The page_size=0 engine against the reference engine
# ---------------------------------------------------------------------------

COUNTERS = ("decode_steps", "prefills", "prefill_rows", "tokens_generated",
            "kv_bytes_read", "kv_bytes_read_live", "deferred_admissions")


def _both(converted, keep, prompts, stagger=(), **ec):
    """Serve ``prompts`` on the reference engine and the port's, both on a
    capacity-dense pool; requests in ``stagger`` arrive after two steps.
    Returns each engine's tokens (submission order) and counters."""
    jcfg, jparams, tcfg, tparams = converted[keep]
    engines = (JInferenceEngine(jcfg, jparams, JEngineConfig(
                   page_size=0, plan_packed=False, **ec)),
               InferenceEngine(tcfg, tparams, EngineConfig(
                   page_size=0, **ec), device="cpu"))
    out = []
    for eng in engines:
        rids = [eng.submit(p, max_new_tokens=GEN)
                for i, p in enumerate(prompts) if i not in stagger]
        eng.step()
        eng.step()
        rids += [eng.submit(prompts[i], max_new_tokens=GEN)
                 for i in stagger]
        done = {r.rid: r for r in eng.run()}
        eng.check_conservation()
        out.append(([done[r].generated for r in rids],
                    {k: eng.stats[k] for k in COUNTERS}))
    return out


@pytest.mark.parametrize("keep", [0.0, 0.25])
def test_unpaged_engine_matches_reference_engine(converted, keep):
    """Staggered traffic over 2 slots: equal greedy tokens and equal step,
    prefill and KV-byte counters in both packages, dense and packed."""
    prompts = _prompts(converted[keep][0].vocab_size,
                       lens=(5, 16, 9, 12, 3))
    (jt, js), (tt, ts) = _both(converted, keep, prompts, stagger=(3, 4),
                               n_slots=2, capacity=64)
    assert tt == jt
    assert ts == js


def test_unpaged_int8_kv_engine_matches_reference_engine(converted):
    prompts = _prompts(converted[0.0][0].vocab_size)
    (jt, js), (tt, ts) = _both(converted, 0.0, prompts, n_slots=2,
                               capacity=64, kv_dtype="int8")
    assert tt == jt
    assert ts == js


# ---------------------------------------------------------------------------
# The page_size=0 engine on its own
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    cfg = _cfg()
    return cfg, build_params(cfg, device="cpu")


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("capacity", 64)
    return InferenceEngine(cfg, params, EngineConfig(page_size=0, **kw),
                           device="cpu")


def test_unpaged_engine_equals_paged_and_naive(dense):
    cfg, params = dense
    prompts = _prompts(cfg.vocab_size)
    got = _engine(cfg, params).generate(prompts, max_new_tokens=GEN)
    paged = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=64, page_size=8), device="cpu")
    assert got == paged.generate(prompts, max_new_tokens=GEN)
    for p, toks in zip(prompts, got):
        naive = generate(cfg, params, torch.as_tensor(p)[None],
                         gen_tokens=GEN)["tokens"][0].tolist()
        assert toks == naive


def test_unpaged_engine_lifecycle(dense):
    """Pause, cancel and recover on the capacity-dense pool: the folded
    and requeued requests give the uninterrupted tokens, lengths return to
    0, and the paged-only options stay off (no preemption, no prefix
    cache)."""
    cfg, params = dense
    prompts = _prompts(cfg.vocab_size)
    want = _engine(cfg, params).generate(prompts, max_new_tokens=GEN)
    eng = _engine(cfg, params, prefix_cache=True, preempt_after_stalls=1)
    assert not eng.prefix_cache and not eng.paged
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
    extra = eng.submit(prompts[0], max_new_tokens=GEN)
    for _ in range(3):
        eng.step()
    assert eng.pause(rids[0])
    assert eng.cancel(extra) is not None
    eng.step()
    assert eng.recover() >= 1
    assert eng.resume(rids[0])
    done = {r.rid: r for r in eng.run()}
    assert [done[r].generated for r in rids] == want
    assert eng.stats["preemptions"] == 0 and eng.stats["recoveries"] == 1
    eng.check_conservation()
    assert not eng.pool.lens.any()


def test_unpaged_engine_rejects_over_capacity(dense):
    cfg, params = dense
    eng = _engine(cfg, params, capacity=16)
    rid = eng.submit(np.zeros(10, np.int32), max_new_tokens=7)
    rej = eng.sched.finished[-1]
    assert rej.rid == rid and rej.status == "REJECTED"
    assert "capacity" in rej.error

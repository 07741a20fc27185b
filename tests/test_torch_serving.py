"""The port's serving stack on the CPU: the paged pool's allocator, the
engine against the port's naive ``generate`` (bit-identical greedy tokens,
the reference's own invariant), and the engine against the reference
engine's greedy tokens on converted params."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch.serve import build_params, generate  # noqa: E402
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.serving import (EngineConfig, InferenceEngine,  # noqa: E402
                                 sample_tokens)
from repro_torch.serving.kv_slots import PagedSlotPool  # noqa: E402

torch.set_num_threads(2)

PROMPT_LENS = (5, 16, 9, 12)
GEN = 8


def _cfg(keep=0.25, **kw):
    return dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=keep, bcr_block=(16, 16), **kw)


def _prompts(vocab):
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, size=p).astype(np.int32)
            for p in PROMPT_LENS]


def _pool(n_slots=2, capacity=32, page_size=4, n_pages=None):
    cfg = _cfg()
    return PagedSlotPool(
        lambda **kw: causal_lm.init_cache(cfg, **kw), n_slots, capacity,
        page_size=page_size, n_pages=n_pages, device="cpu")


class TestPagedSlotPool:
    def test_reserve_ensure_release_reuse(self):
        pool = _pool(n_pages=9)               # 8 allocatable pages
        assert pool.reserve(0, 20)            # 5 pages reserved
        assert not pool.reserve(1, 16)        # 4 more do not fit
        assert pool.reserve(1, 12)            # 3 do
        pool.ensure(0, 6)                     # 2 pages drawn lazily
        assert pool._n_alloc[0] == 2 and pool.free_pages() == 0
        pool.lens[0] = 6
        pool.check_consistency()
        held = set(pool.table[0, :2].tolist())
        pool.release(0)
        pool.check_consistency()
        assert pool.free_pages() == 5 and not pool.table[0].any()
        assert held <= set(pool._free)        # freed pages are allocatable
        pool.ensure(1, 12)
        pool.check_consistency()

    def test_insert_rows_seats_prefill_into_table_pages(self):
        pool = _pool()
        cfg = _cfg()
        k = torch.randn(3, 6, cfg.num_kv_heads, cfg.head_dim)
        pc = [{"k": k, "v": -k} for _ in range(cfg.num_layers)]
        slots = np.asarray([1, 0, 1])          # row 2 pads, aliases slot 1
        pool.reserve(1, 10)
        pool.reserve(0, 10)
        pool.insert_rows(pc, slots, np.asarray([6, 3]))
        assert list(pool.lens) == [3, 6]
        kp = pool.cache[0]["k"]
        for pos in range(6):                   # slot 1 holds row 0, all 6
            page = pool.table[1, pos // 4]
            torch.testing.assert_close(kp[page, pos % 4], k[0, pos].to(kp.dtype))
        pool.check_consistency()

    def test_table_width_buckets_to_pow2(self):
        pool = _pool(capacity=64)
        pool.lens[:] = [9, 0]
        assert pool.table_width(extra=1) == 4    # 10 tokens → 3 pages → 4

    def test_check_consistency_catches_a_leak(self):
        pool = _pool()
        pool.reserve(0, 8)
        pool.ensure(0, 8)
        pool._free.append(int(pool.table[0, 0]))   # page both free and held
        with pytest.raises(AssertionError):
            pool.check_consistency()


def test_engine_matches_naive_generate():
    """Fewer slots than requests: slot reuse, mixed-age decode batches,
    bucketed merged prefills — greedy tokens equal the naive oracle's."""
    cfg = _cfg()
    params = build_params(cfg, log=lambda *_: None, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    want = [generate(cfg, params, torch.as_tensor(p)[None], gen_tokens=GEN,
                     page_size=4)["tokens"][0].tolist() for p in prompts]
    eng = InferenceEngine(cfg, params, EngineConfig(n_slots=2, capacity=64,
                                                    page_size=4),
                          device="cpu")
    assert eng.generate(prompts, max_new_tokens=GEN) == want
    assert max(eng.stats["slot_occupancy"]) == 2
    assert eng.stats["nonfinite_rows"] == 0
    assert eng.pool.idle_pages() == eng.pool.n_pages - 1
    eng.pool.check_consistency()


def test_oversubscribed_pool_stalls_then_completes():
    cfg = _cfg(keep=0.0)
    params = build_params(cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    ec = EngineConfig(n_slots=4, capacity=64, page_size=4, kv_pages=9)
    eng = InferenceEngine(cfg, params, ec, device="cpu")
    got = eng.generate(prompts, max_new_tokens=GEN)
    assert [len(g) for g in got] == [GEN] * len(prompts)
    assert eng.stats["page_stalls"] > 0
    eng.pool.check_consistency()
    want = [generate(cfg, params, torch.as_tensor(p)[None],
                     gen_tokens=GEN)["tokens"][0].tolist() for p in prompts]
    assert got == want


def test_oversized_request_is_rejected():
    cfg = _cfg(keep=0.0)
    eng = InferenceEngine(cfg, build_params(cfg, device="cpu"),
                          EngineConfig(n_slots=1, capacity=16),
                          device="cpu")
    assert eng.generate([np.zeros(12, np.int32)], max_new_tokens=8) == [[]]
    assert eng.stats["rejected"] == 1


def test_sample_tokens_greedy_and_topk():
    g = torch.Generator().manual_seed(0)
    logits = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 50)),
                             dtype=torch.float32)
    temps = torch.as_tensor([0.0, 1.0, 1.0])
    topks = torch.as_tensor([0, 3, 0], dtype=torch.int32)
    for _ in range(20):
        tok = sample_tokens(logits, g, temps, topks)
        assert tok[0] == torch.argmax(logits[0])
        assert tok[1] in torch.topk(logits[1], 3).indices
        assert 0 <= tok[2] < 50


def test_engine_matches_reference_engine_tokens():
    """The reference engine and the port's, both paged, on the same packed
    weights (converted), give the same greedy tokens (fp32 KV pages)."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=0.25, bcr_block=(16, 16),
                               cache_dtype="float32")
    jparams = jpack_params(jcfg, jmodel_fns(jcfg).init_params(
        jax.random.PRNGKey(0)))
    prompts = _prompts(jcfg.vocab_size)
    jeng = JInferenceEngine(jcfg, jparams, JEngineConfig(
        n_slots=2, capacity=64, page_size=8))
    want = jeng.generate(prompts, max_new_tokens=GEN)
    tcfg = _cfg(cache_dtype="float32")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jeng.params),
                              tcfg, device="cpu")
    teng = InferenceEngine(tcfg, tparams, EngineConfig(
        n_slots=2, capacity=64, page_size=8), device="cpu")
    assert teng.generate(prompts, max_new_tokens=GEN) == want

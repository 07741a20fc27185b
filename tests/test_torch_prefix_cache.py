"""The port's prefix cache on the CPU: the refcounted, copy-on-write, LRU
allocator held against the reference's ``PagedSlotPool`` operation by
operation, the reference's allocator and engine tests on the port, and the
port's engine against the reference engine (greedy tokens and prefix
counters) on converted weights. Shared-prefix serving must give exactly
the tokens of unshared serving and of the naive ``generate`` while
allocating fewer pages."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.kv_slots import PagedSlotPool as JPagedSlotPool  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch.serve import build_params, generate  # noqa: E402
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.serving.kv_slots import PagedSlotPool  # noqa: E402

torch.set_num_threads(2)

PS = 8
GEN = 6
SYSTEM = np.arange(100, 119, dtype=np.int32)      # 19 tokens: partial page


def _cfg(**kw):
    return dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"), **kw)


@pytest.fixture(scope="module")
def dense():
    """The smoke llama with random weights (seed 0), unpacked."""
    cfg = _cfg()
    return cfg, build_params(cfg, device="cpu")


@pytest.fixture(scope="module")
def converted():
    """Reference packed weights (keep 0.25, block 16, fp32 KV) and the same
    weights converted for the port: the cross-package engines share them."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               bcr_keep_frac=0.25, bcr_block=(16, 16),
                               cache_dtype="float32")
    jparams = jpack_params(jcfg, jmodel_fns(jcfg).init_params(
        jax.random.PRNGKey(0)))
    planned = JInferenceEngine(jcfg, jparams, JEngineConfig(
        n_slots=2, capacity=64, page_size=PS)).params
    tcfg = _cfg(bcr_keep_frac=0.25, bcr_block=(16, 16),
                cache_dtype="float32")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, planned),
                              tcfg, device="cpu")
    return jcfg, planned, tcfg, tparams


def naive(cfg, params, prompt, gen):
    return generate(cfg, params, torch.as_tensor(prompt)[None],
                    gen_tokens=gen, page_size=PS)["tokens"][0].tolist()


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 500, size=n).astype(np.int32)


def _requests(vocab, n=4, seed=5):
    """One system prompt plus per-request suffixes of page-misaligned
    lengths, as the reference's test builds them."""
    rng = np.random.default_rng(seed)
    return [np.concatenate([SYSTEM, rng.integers(
        0, vocab, size=int(l)).astype(np.int32)])
        for l in (5, 9, 2, 7)[:n]]


def _pool(n_slots=3, capacity=64, n_pages=None, **cfg_kw):
    cfg = _cfg(**cfg_kw)
    return PagedSlotPool(lambda **kw: causal_lm.init_cache(cfg, **kw),
                         n_slots, capacity, page_size=PS, n_pages=n_pages,
                         device="cpu")


# ---------------------------------------------------------------------------
# The allocator against the reference's, operation by operation
# ---------------------------------------------------------------------------


def _state(pool):
    return dict(table=pool.table.tolist(), lens=pool.lens.tolist(),
                refcount=pool._refcount.tolist(), free=list(pool._free),
                lru=list(pool._lru), n_alloc=pool._n_alloc.tolist(),
                reserved=pool._reserved.tolist(),
                page_key=sorted(pool._page_key.items()),
                free_pages=pool.free_pages(), idle=pool.idle_pages(),
                stats=dict(pool.stats))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_operation_sequence_matches_reference(seed):
    """A seeded random sequence of admit_prefix / ensure / ensure_writable /
    register_prefix / release / reserve / truncate / reset_prefix on the
    reference's pool and the port's: after every operation both return the
    same value and hold the same tables, refcounts, free list, LRU order,
    index and stats."""
    jcfg = jcfgs.get_smoke_config("llama3.2-1b")
    ref = JPagedSlotPool(jmodel_fns(jcfg).init_cache, 3, 32, page_size=PS,
                         n_pages=9)
    port = _pool(capacity=32, n_pages=9)
    rng = np.random.default_rng(seed)
    # prompts sharing prefixes (a common head plus per-prompt tails) and
    # unrelated ones, whose pages push the shared ones out of the LRU
    head = _prompt(20, seed=99)
    prompts = [np.concatenate([head[:int(rng.integers(4, 21))],
                               _prompt(int(rng.integers(1, 9)), seed=s)])
               for s in range(4)]
    prompts += [_prompt(int(rng.integers(12, 25)), seed=10 + s)
                for s in range(4)]
    held, seen = {}, set()
    for step in range(400):
        slot = int(rng.integers(0, 3))
        r = rng.random()
        if slot in held:
            p, _ = held[slot]
            if r < 0.45 and port.lens[slot] < 30:
                n = int(port.lens[slot]) + 1
                ops = [("ensure", (slot, n)),
                       ("ensure_writable", (slot, n - 1))]
                for pool in (ref, port):
                    pool.lens[slot] = n
            elif r < 0.55 and port.lens[slot] > len(p):
                ops = [("truncate", (slot, int(port.lens[slot]) - 1))]
            elif r < 0.6:
                ops = [("register_prefix", (slot, p))]
            else:
                ops = [("release", (slot,))]
                del held[slot]
        elif r < 0.03:
            ops = [("reset_prefix", ())]
        elif r < 0.15:
            total = int(rng.integers(1, 33))
            ops = [("reserve", (slot, total))]
        else:
            p = prompts[int(rng.integers(0, len(prompts)))]
            ops = [("admit_prefix", (slot, p, len(p) + 4))]
        for name, args in ops:
            got = getattr(port, name)(*args)
            want = getattr(ref, name)(*args)
            assert got == want, (step, name, got, want)
            assert _state(port) == _state(ref), (step, name)
            if got:
                seen.add(name)
            if name == "admit_prefix" and got is not None:
                # seat it as the engine does: copy a shared partial page,
                # allocate the suffix pages, publish the full prompt pages
                prompt = args[1]
                if got % PS:
                    assert (port.ensure_writable(slot, got)
                            == ref.ensure_writable(slot, got))
                for pool in (ref, port):
                    pool.ensure(slot, len(prompt))
                    pool.lens[slot] = len(prompt)
                    pool.register_prefix(slot, prompt)
                held[slot] = (prompt, got)
                assert _state(port) == _state(ref), (step, "seat")
            if name == "reserve" and got:
                # a bare reservation is dropped at once (release)
                for pool in (ref, port):
                    pool.release(slot)
        port.check_consistency()
        seen.update(k for k, v in port.stats.items() if v)
    ref.check_consistency()
    # the sequence reached eviction, copy-on-write and a prefix hit
    assert {"evictions", "cow_copies", "admit_prefix"} <= seen
    assert port.match_prefix(prompts[0]) == ref.match_prefix(prompts[0])


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_copy_pages_matches_reference(kv_dtype):
    """``copy_pages`` moves every page leaf, the int8 scale pools too, as
    the reference's batched gather and scatter does."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               kv_dtype=kv_dtype, cache_dtype="float32")
    ref = JPagedSlotPool(jmodel_fns(jcfg).init_cache, 2, 32, page_size=PS,
                         n_pages=7)
    port = _pool(n_slots=2, capacity=32, n_pages=7, kv_dtype=kv_dtype,
                 cache_dtype="float32")
    rng = np.random.default_rng(3)
    mixer = ref.cache["stack"][0]["mixer"]
    filled = {}
    for key, leaf in mixer.items():
        if leaf.dtype == jnp.int8:
            vals = rng.integers(-127, 128, size=leaf.shape).astype(np.int8)
        else:
            vals = rng.random(leaf.shape).astype(np.float32) + 0.5
        filled[key] = vals
        for layer in range(len(port.cache)):
            port.cache[layer][key].copy_(torch.as_tensor(vals[layer]))
    ref.cache["stack"][0]["mixer"] = {k: jnp.asarray(v)
                                      for k, v in filled.items()}
    src, dst = np.asarray([1, 4]), np.asarray([5, 2])
    ref.copy_pages(src, dst)
    port.copy_pages(src, dst)
    got_keys = set(port.cache[0])
    assert got_keys == set(filled) and (kv_dtype != "int8"
                                        or "k_scale" in got_keys)
    for key, leaf in ref.cache["stack"][0]["mixer"].items():
        want = np.asarray(leaf)
        for layer in range(len(port.cache)):
            np.testing.assert_array_equal(port.cache[layer][key].numpy(),
                                          want[layer])
        np.testing.assert_array_equal(want[:, 5], filled[key][:, 1])
        np.testing.assert_array_equal(want[:, 3], filled[key][:, 3])


# ---------------------------------------------------------------------------
# The reference's TestPrefixAllocator, on the port
# ---------------------------------------------------------------------------


class TestPrefixAllocator:
    def _admit_and_publish(self, pool, slot, prompt, total):
        hit = pool.admit_prefix(slot, prompt, total)
        assert hit is not None
        pool.ensure(slot, len(prompt))
        pool.lens[slot] = len(prompt)
        pool.register_prefix(slot, prompt)
        return hit

    def test_register_match_adopt_refcounts(self):
        pool = _pool()
        p = _prompt(20)                       # 2 full pages + partial
        assert self._admit_and_publish(pool, 0, p, 28) == 0   # cold
        hit, pages = pool.match_prefix(p)
        assert hit == 16 and len(pages) == 2
        assert pool.admit_prefix(1, p, 28) == 16
        for pid in pages:
            assert pool._refcount[pid] == 2
        pool.release(0)
        for pid in pages:
            assert pool._refcount[pid] == 1
        pool.release(1)
        for pid in pages:
            assert pool._refcount[pid] == 0
            assert pid in pool._lru           # registered → LRU, not free

    def test_partial_tail_match_and_cow(self):
        pool = _pool()
        long = _prompt(24)                    # 3 full pages, all registered
        self._admit_and_publish(pool, 0, long, 32)
        hit = pool.admit_prefix(1, long[:20], 28)
        assert hit == 19                      # capped at L-1, mid-page
        shared_pid = int(pool.table[1, 2])
        assert shared_pid == int(pool.table[0, 2])
        assert pool._refcount[shared_pid] == 2
        pair = pool.ensure_writable(1, 19)
        assert pair is not None and pair[0] == shared_pid
        assert pool._refcount[shared_pid] == 1
        assert int(pool.table[1, 2]) == pair[1] != shared_pid
        assert pool.stats["cow_copies"] == 1
        assert pool.ensure_writable(1, 19) is None

    def test_owner_write_into_registered_page_cows(self):
        pool = _pool()
        long = _prompt(16)                    # exactly 2 full pages
        self._admit_and_publish(pool, 0, long, 24)
        pool.release(0)
        assert pool.admit_prefix(1, long[:12], 20) == 11
        pid = int(pool.table[1, 1])
        assert pool._refcount[pid] == 1       # sole owner, but registered
        pair = pool.ensure_writable(1, 11)
        assert pair is not None and pair[0] == pid

    def test_partial_adoption_reserves_cow_page(self):
        pool = _pool(n_slots=3, capacity=32, n_pages=6)   # 5 usable
        long = _prompt(16)
        self._admit_and_publish(pool, 0, long, 16)
        free_before = pool.free_pages()
        assert pool.admit_prefix(1, long[:12], 16) == 11
        assert pool._reserved[1] == 1
        assert pool.free_pages() == free_before - 1
        assert not pool.reserve(2, PS * pool.free_pages() + 1)
        assert pool.ensure_writable(1, 11) is not None
        pool.ensure(1, 16)
        assert pool._reserved[1] == 0 and pool.free_pages() >= 0

    def test_lru_eviction_and_reclaim(self):
        pool = _pool(n_slots=2, capacity=32, n_pages=6)   # 5 usable
        a = _prompt(16, seed=1)
        self._admit_and_publish(pool, 0, a, 24)
        pool.release(0)
        assert pool.admit_prefix(0, a, 24) == 15
        assert pool.stats["evictions"] == 0
        pool.release(0)
        assert pool.reserve(1, 32)
        pool.ensure(1, 32)
        assert pool.stats["evictions"] >= 1
        hit, _ = pool.match_prefix(a)
        assert hit < 16
        pool.release(1)
        pool.check_consistency()

    def test_free_pages_scalar_counter_stays_consistent(self):
        pool = _pool(n_slots=3, capacity=32, n_pages=10)
        rng = np.random.default_rng(0)
        prompts = {s: _prompt(rng.integers(9, 25), seed=s) for s in range(3)}
        held = set()
        for _ in range(200):
            truth = (len(pool._free) + len(pool._lru)
                     - int(pool._reserved.sum()))
            assert pool.free_pages() == truth >= 0
            slot = int(rng.integers(0, 3))
            if slot in held:
                if rng.random() < 0.5 and pool.lens[slot] < 30:
                    pool.ensure(slot, int(pool.lens[slot]) + 1)
                    pool.ensure_writable(slot, int(pool.lens[slot]))
                    pool.lens[slot] += 1
                else:
                    pool.register_prefix(slot, prompts[slot])
                    pool.release(slot)
                    held.discard(slot)
            else:
                p = prompts[slot]
                if pool.admit_prefix(slot, p, len(p) + 6) is not None:
                    pool.ensure(slot, len(p))
                    pool.lens[slot] = len(p)
                    held.add(slot)

    def test_reset_prefix_returns_lru_to_free(self):
        pool = _pool()
        p = _prompt(16)
        self._admit_and_publish(pool, 0, p, 24)
        pool.release(0)
        assert pool._lru
        before = len(pool._free)
        pool.reset_prefix()
        assert not pool._lru and not pool._page_key
        assert len(pool._free) == before + 2

    def test_check_consistency_catches_a_bad_refcount(self):
        pool = _pool()
        p = _prompt(16)
        self._admit_and_publish(pool, 0, p, 24)
        pool._refcount[int(pool.table[0, 0])] += 1
        with pytest.raises(AssertionError):
            pool.check_consistency()


# ---------------------------------------------------------------------------
# The reference's TestPrefixEngine, on the port: shared == unshared == naive
# ---------------------------------------------------------------------------


def _engine(cfg, params, shared, **kw):
    ec = dict(n_slots=2, capacity=64, page_size=PS, prefix_cache=shared)
    ec.update(kw)
    return InferenceEngine(cfg, params, EngineConfig(**ec), device="cpu")


class TestPrefixEngine:
    @pytest.mark.parametrize("kv_dtype", ["", "int8"])
    def test_shared_matches_unshared_and_naive(self, dense, kv_dtype):
        cfg, params = dense
        prompts = _requests(cfg.vocab_size)
        ref = [naive(_cfg(kv_dtype=kv_dtype), params, p, GEN)
               for p in prompts]
        cold = _engine(cfg, params, False, kv_dtype=kv_dtype)
        hot = _engine(cfg, params, True, kv_dtype=kv_dtype)
        assert cold.generate(prompts, max_new_tokens=GEN) == ref
        assert hot.generate(prompts, max_new_tokens=GEN) == ref
        assert hot.stats["prefix_hit_tokens"] > 0
        assert hot.stats["pages_shared"] > 0
        assert (hot.stats["pages_allocated"]
                < cold.stats["pages_allocated"])
        hot.check_conservation()

    def test_shared_matches_naive_packed(self):
        cfg = _cfg(bcr_keep_frac=0.25, bcr_block=(16, 16))
        packed = build_params(cfg, log=lambda *_: None, device="cpu")
        prompts = _requests(cfg.vocab_size)[:3]
        ref = [naive(cfg, packed, p, GEN) for p in prompts]
        eng = _engine(cfg, packed, True)
        assert eng.generate(prompts, max_new_tokens=GEN) == ref
        assert eng.stats["prefix_hit_tokens"] > 0

    @pytest.mark.parametrize("kv_dtype", ["", "int8"])
    def test_full_prompt_hit_cow(self, dense, kv_dtype):
        """A strict prefix of a cached prompt hits L-1 tokens through the
        partial-tail match; its 1-token suffix lands mid-page in a shared
        page, which is copied first (under int8 KV with its scales: the
        pool's scale check runs after the copy)."""
        cfg, params = dense
        long = np.arange(200, 224, dtype=np.int32)     # 3 full pages
        short = long[:20]
        ncfg = _cfg(kv_dtype=kv_dtype)
        ref = [naive(ncfg, params, p, 4) for p in (long, short)]
        eng = _engine(cfg, params, True, kv_dtype=kv_dtype)
        [got_long] = eng.generate([long], max_new_tokens=4)
        rid = eng.submit(short, max_new_tokens=4)
        eng.step()                           # admission + first decode
        eng.pool.check_consistency()         # the copied page's scales
        got_short = {r.rid: r for r in eng.run()}[rid].generated
        assert [got_long, got_short] == ref
        assert eng.stats["cow_copies"] >= 1
        assert eng.stats["prefix_hit_tokens"] == 19    # capped at L-1
        eng.check_conservation()

    @pytest.mark.parametrize("kv_dtype", ["", "int8"])
    def test_staggered_sharing_while_owner_decodes(self, dense, kv_dtype):
        cfg, params = dense
        prompts = _requests(cfg.vocab_size)[:2]
        ref = [naive(_cfg(kv_dtype=kv_dtype), params, p, GEN)
               for p in prompts]
        eng = _engine(cfg, params, True, kv_dtype=kv_dtype)
        ra = eng.submit(prompts[0], max_new_tokens=GEN)
        for _ in range(2):
            eng.step()
        rb = eng.submit(prompts[1], max_new_tokens=GEN)
        done = {r.rid: r for r in eng.run()}
        assert done[ra].generated == ref[0]
        assert done[rb].generated == ref[1]
        assert eng.stats["prefix_hit_tokens"] > 0
        eng.check_conservation()

    def test_oversubscribed_fcfs_no_queue_jumping(self, dense):
        cfg, params = dense
        sys_p = _requests(cfg.vocab_size)[0]
        fat = np.random.default_rng(9).integers(
            0, cfg.vocab_size, size=40).astype(np.int32)
        want = {p.tobytes(): naive(cfg, params, p, 4) for p in (sys_p, fat)}
        eng = _engine(cfg, params, True, n_slots=3, kv_pages=9)
        eng.submit(sys_p, max_new_tokens=4)        # seeds the cache
        eng.step()
        r1 = eng.submit(fat, max_new_tokens=4)      # stalls on pages
        r2 = eng.submit(sys_p, max_new_tokens=4)    # hit, would fit
        eng.run()
        assert eng.stats["page_stalls"] > 0
        done = {r.rid: r for r in eng.sched.finished}
        assert done[r1].generated == want[fat.tobytes()]
        assert done[r2].generated == want[sys_p.tobytes()]
        assert done[r1].admit_time <= done[r2].admit_time
        eng.check_conservation()

    def test_one_step_runs_append_and_cold_admissions(self, dense):
        """A step whose admissions hold both a prefix hit and a cold prompt
        runs one suffix-only dispatch and one cold prefill."""
        cfg, params = dense
        prompts = _requests(cfg.vocab_size)[:2]
        other = _prompt(11, seed=7)
        eng = _engine(cfg, params, True)
        [first] = eng.generate([prompts[0]], max_new_tokens=GEN)
        eng.reset_stats()
        got = eng.generate([prompts[1], other], max_new_tokens=GEN)
        assert eng.stats["prefills"] == 2 and eng.stats["prefill_rows"] == 2
        assert eng.stats["prefix_hit_tokens"] == 16
        assert got == [naive(cfg, params, p, GEN)
                       for p in (prompts[1], other)]


# ---------------------------------------------------------------------------
# Across packages: the reference engine and the port's on the same weights
# ---------------------------------------------------------------------------

COUNTERS = ("prefix_hit_tokens", "pages_shared", "cow_copies",
            "pages_allocated", "preemptions", "page_stalls", "evictions")


def _both(converted, prompts, gen, stagger=(), **ec):
    """Serve ``prompts`` on the reference engine and the port's under the
    same config; requests in ``stagger`` are submitted after two steps.
    Returns each engine's tokens (submission order) and counters."""
    jcfg, jparams, tcfg, tparams = converted
    engines = (JInferenceEngine(jcfg, jparams, JEngineConfig(
                   page_size=PS, plan_packed=False, **ec)),
               InferenceEngine(tcfg, tparams, EngineConfig(
                   page_size=PS, **ec), device="cpu"))
    out = []
    for eng in engines:
        rids = [eng.submit(p, max_new_tokens=gen)
                for i, p in enumerate(prompts) if i not in stagger]
        eng.step()
        eng.step()
        rids += [eng.submit(prompts[i], max_new_tokens=gen)
                 for i in stagger]
        done = {r.rid: r for r in eng.run()}
        eng.check_conservation()
        out.append(([done[r].generated for r in rids],
                    {k: eng.stats[k] for k in COUNTERS}))
    return out


def test_prefix_engine_matches_reference_engine(converted):
    """Prefix-cache serving with a staggered second wave (hits on live and
    LRU-parked pages, a full-prompt hit with its CoW copy): equal greedy
    tokens and equal prefix counters in both packages."""
    jcfg = converted[0]
    prompts = _requests(jcfg.vocab_size) + [SYSTEM[:13],
                                            _requests(jcfg.vocab_size)[1]]
    (jt, jstats), (tt, tstats) = _both(converted, prompts, GEN,
                                       stagger=(3, 4, 5), n_slots=2,
                                       capacity=64, prefix_cache=True)
    assert tt == jt
    assert tstats == jstats
    assert tstats["prefix_hit_tokens"] > 0 and tstats["cow_copies"] >= 1


def test_preempting_engine_matches_reference_engine(converted):
    """An oversubscribed pool with page-pressure preemption (and the prefix
    cache, so a preempted request re-prefills over its own pages): equal
    greedy tokens and equal preemption and page counters."""
    jcfg = converted[0]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (16, 24, 16, 9)]
    (jt, jstats), (tt, tstats) = _both(
        converted, prompts, 8, stagger=(2, 3), n_slots=3, capacity=64,
        kv_pages=8, preempt_after_stalls=1, prefix_cache=True)
    assert tt == jt
    assert tstats == jstats
    assert tstats["preemptions"] > 0


def test_serve_cli_drives_the_prefix_cache_and_lifecycle(monkeypatch,
                                                         capsys):
    """The CLI's shared-prefix workload reports prefix hits and the status
    line; a bounded queue sheds the excess at submit."""
    from repro_torch.launch import serve as tserve
    base = ["serve", "--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--requests", "6", "--gen", "4"]
    monkeypatch.setattr("sys.argv", base + [
        "--slots", "2", "--capacity", "96", "--prefix-cache",
        "--system-prompts", "1", "--system-len", "24"])
    tserve.main()
    out = capsys.readouterr().out
    assert "status: finished 6 / timeout 0" in out
    hit = int(out.split("hit tokens ")[1].split("/")[0])
    assert hit > 0 and "pages_shared" in out
    monkeypatch.setattr("sys.argv", base + [
        "--max-waiting", "2", "--kv-pages", "8", "--preempt-after-stalls",
        "1", "--deadline-s", "60"])
    tserve.main()
    out = capsys.readouterr().out
    assert "rejected 4" in out and "shed 4" in out

"""The port's speculative decoding on the CPU, held to the reference:
acceptance (``transform_probs``, ``accept_greedy``, ``accept_draft``)
exactly equal to the reference's on the same inputs and the same
``np.random.Generator`` seed; the reference's acceptance and rollback
(``truncate``) units on the port; all-positions ``prefill_append`` logits;
the speculative engine's greedy tokens and acceptance counters against the
reference engine's on converted weights; and, inside the port, greedy
speculative output exactly equal to plain greedy and to the naive oracle
(dense and packed targets, the oracle drafter, the prefix cache, EOS inside
an accepted draft, staggered traffic on an oversubscribed pool), the submit
headroom, drafter-fault containment, NaN containment at verify, and cancel,
preemption and ``recover()`` with a model drafter attached."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch.serve import (build_draft, build_params,  # noqa: E402
                                      generate)
from repro_torch.models import causal_lm  # noqa: E402
from repro_torch.serving import (EngineConfig, FaultInjector,  # noqa: E402
                                 InferenceEngine, OracleDraft,
                                 PagedSlotPool)
from repro_torch.serving import speculative as tspec  # noqa: E402

torch.set_num_threads(2)

PS = 8
GEN = 8


def _cfg(**kw):
    return dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"), **kw)


def _draft_cfg(cfg):
    """The reference test's drafter: 1 layer, d_model 32, sharing the
    target's vocab (its acceptance is near zero: tokens must not care)."""
    return dataclasses.replace(cfg, num_layers=1, d_model=32, num_heads=2,
                               num_kv_heads=2, head_dim=16, d_ff=64,
                               bcr_keep_frac=0.0)


def _prompts(vocab, lens=(5, 16, 9, 12), seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p).astype(np.int32) for p in lens]


@pytest.fixture(scope="module")
def llama():
    """The smoke llama (seed 0), dense and BCR-packed at keep 0.25 / block
    16, and a random drafter (seed 1)."""
    cfg = _cfg(bcr_keep_frac=0.25, bcr_block=(16, 16))
    dense = build_params(dataclasses.replace(cfg, bcr_keep_frac=0.0),
                         device="cpu")
    packed = build_params(cfg, log=lambda *_: None, device="cpu")
    dcfg = _draft_cfg(cfg)
    return cfg, dense, packed, dcfg, build_params(dcfg, seed=1,
                                                  device="cpu")


def _engine(llama, packed=False, spec_k=0, drafter=None, with_draft=False,
            **kw):
    cfg, dense, pk, dcfg, dparams = llama
    params = pk if packed else dense
    if not packed:
        cfg = dataclasses.replace(cfg, bcr_keep_frac=0.0)
    kw.setdefault("n_slots", 2)
    kw.setdefault("capacity", 64)
    kw.setdefault("page_size", PS)
    ec = EngineConfig(spec_k=spec_k, draft_cfg=dcfg if with_draft else None,
                      **kw)
    return InferenceEngine(cfg, params, ec, device="cpu",
                           draft_params=dparams if with_draft else None,
                           drafter=drafter)


def _naive(cfg, params, prompt, gen=GEN):
    return generate(cfg, params, torch.as_tensor(prompt)[None],
                    gen_tokens=gen, page_size=PS)["tokens"][0].tolist()


# ---------------------------------------------------------------------------
# Acceptance against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_acceptance_matches_reference_exactly(seed):
    """Random logit rows, proposals and drafter distributions (none or a
    softmax), greedy and sampled with and without top-k: the same
    ``(accepted, follow)`` and the same generator state after the call,
    and bit-equal ``transform_probs``."""
    rng = np.random.default_rng(seed)
    v, n = 32, int(rng.integers(0, 5))
    rows = (rng.standard_normal((n + 1, v)) * 2).astype(np.float32)
    # proposals that often match the target's argmax, so accepts happen
    props = [int(rows[j].argmax()) if rng.random() < 0.6
             else int(rng.integers(0, v)) for j in range(n)]
    q = None
    if rng.random() < 0.5 and n:
        z = rng.standard_normal((n, v))
        q = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    for temp, top_k in ((0.0, 0), (0.7, 0), (1.3, 5)):
        np.testing.assert_array_equal(
            tspec.transform_probs(rows[0], temp, top_k),
            jspec.transform_probs(rows[0], temp, top_k))
        ga, gb = (np.random.default_rng(seed + 100) for _ in range(2))
        got = tspec.accept_draft(rows, props, q, temp, top_k, ga)
        want = jspec.accept_draft(rows, props, q, temp, top_k, gb)
        assert got == want
        assert ga.random() == gb.random()
    amax = rows.argmax(-1)
    assert tspec.accept_greedy(amax, props) == jspec.accept_greedy(amax,
                                                                   props)


def _rows(argmaxes, v=16):
    rows = np.zeros((len(argmaxes), v), np.float32)
    for j, a in enumerate(argmaxes):
        rows[j, a] = 10.0
    return rows


@pytest.mark.parametrize("argmaxes,props,want", [
    ([3, 5, 7], [3, 5], (2, 7)),       # both drafts + the bonus row
    ([3, 5, 7], [4, 5], (0, 3)),       # correction from row 0
    ([3, 5, 7], [3, 6], (1, 5)),       # mid reject
    ([9], [], (0, 9)),                 # no proposals: plain decode
])
def test_greedy_acceptance_cases(argmaxes, props, want):
    rows = _rows(argmaxes)
    assert tspec.accept_draft(rows, props, None, 0.0, 0,
                              np.random.default_rng(0)) == want
    assert tspec.accept_greedy(np.asarray(argmaxes), props) == want


def test_sampled_acceptance_properties():
    """A certain target always accepts its match; a deterministic
    proposal is never resampled after its rejection; q concentrated where
    p is accepts about p(d); top-k keeps exactly k in the support."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        assert tspec.accept_draft(_rows([3, 5]), [3], None, 0.7, 0,
                                  rng) == (1, 5)
    rng = np.random.default_rng(1)
    outs = {nxt for a, nxt in (tspec.accept_draft(
        np.zeros((2, 8), np.float32), [2], None, 1.0, 0, rng)
        for _ in range(200)) if a == 0}
    assert outs and 2 not in outs
    rows = np.log(np.asarray([[0.7, 0.1, 0.1, 0.1]] * 2, np.float64))
    q = np.zeros((1, 4))
    q[0, 0] = 1.0
    rng = np.random.default_rng(0)
    assert sum(tspec.accept_draft(rows, [0], q, 1.0, 0, rng)[0]
               for _ in range(50)) >= 30
    p = tspec.transform_probs(np.asarray([0.1, 2.0, -1.0, 3.0, 0.5],
                                         np.float32), 0.8, 2)
    assert (p > 0).sum() == 2 and p[3] > p[1] > 0


# ---------------------------------------------------------------------------
# Rollback on the paged pool (the reference's TestTruncate, on the port)
# ---------------------------------------------------------------------------


def _pool(n_slots=2, capacity=64, n_pages=None):
    cfg = _cfg()
    return PagedSlotPool(lambda **kw: causal_lm.init_cache(cfg, **kw),
                         n_slots, capacity, page_size=PS, n_pages=n_pages,
                         device="cpu")


def test_truncate_returns_tail_pages_to_the_reservation():
    pool = _pool()
    assert pool.reserve(0, 40)                   # 5-page budget
    pool.ensure(0, 10)
    pool.lens[0] = 10
    free_before = pool.free_pages()
    pool.ensure(0, 14)                           # verify writes 4 drafts
    assert pool._n_alloc[0] == 2
    pool.truncate(0, 11)
    assert pool.lens[0] == 11 and pool._n_alloc[0] == 2
    pool.truncate(0, 9)
    assert pool._n_alloc[0] == 2                 # pos 8 lives in page 2
    pool.truncate(0, 8)
    assert pool._n_alloc[0] == 1
    assert pool.free_pages() == free_before and pool._reserved[0] == 4
    pool.truncate(0, 8)
    pool.ensure(0, 20)
    pool.truncate(0, 17)                         # mid third page: kept
    assert pool._n_alloc[0] == 3 and int(pool.table[0, 2]) != 0
    pool.release(0)
    assert pool.free_pages() == pool.n_pages - 1


def test_truncate_never_touches_shared_pages():
    pool = _pool()
    prompt = np.arange(16, dtype=np.int32)
    assert pool.admit_prefix(0, prompt, 24) == 0
    pool.ensure(0, 16)
    pool.lens[0] = 16
    pool.register_prefix(0, prompt)
    pool.ensure(0, 20)
    pool.truncate(0, 17)                         # private tail: fine
    with pytest.raises(AssertionError):
        pool.truncate(0, 8)                      # page 2 is registered
    pool.release(0)


def test_randomized_ensure_truncate_sweep():
    """200 steps of reserve / ensure / verify-and-commit / truncate /
    release: no page leaks or double frees, the reservation counters stay
    exact."""
    pool = _pool(n_slots=3, capacity=64, n_pages=16)
    rng = np.random.default_rng(0)
    held = {}
    for _ in range(200):
        truth = len(pool._free) + len(pool._lru) - int(pool._reserved.sum())
        assert pool.free_pages() == truth >= 0
        slot = int(rng.integers(0, 3))
        if slot in held:
            lo, hi = held[slot], int(pool.lens[slot])
            r = rng.random()
            if r < 0.35 and hi + 5 <= 56:
                k = int(rng.integers(1, 5))
                pool.ensure(slot, hi + k)
                pool.truncate(slot, hi + int(rng.integers(1, k + 1)))
            elif r < 0.55:
                pool.truncate(slot, int(rng.integers(lo, hi + 1)))
            else:
                pool.release(slot)
                del held[slot]
        else:
            plen = int(rng.integers(4, 20))
            if pool.reserve(slot, plen + 12):
                pool.ensure(slot, plen)
                pool.lens[slot] = plen
                held[slot] = plen
        pool.check_consistency()
    for slot in list(held):
        pool.release(slot)
    assert pool.free_pages() == pool.n_pages - 1


# ---------------------------------------------------------------------------
# All-positions verify logits
# ---------------------------------------------------------------------------


def test_prefill_append_all_logits_matches_forward_and_reference():
    """``all_logits`` rows of a cold paged prefill-append equal the
    full-sequence forward position by position (row j: the distribution
    for the token after position j), and the reference's rows (atol 1e-5,
    fp32 KV)."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               cache_dtype="float32")
    jparams = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = _cfg(cache_dtype="float32")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    toks = _prompts(cfg.vocab_size, lens=(13,))[0]
    s = len(toks)
    pool = _pool(n_slots=1, capacity=32)
    pool.cache = causal_lm.init_cache(cfg, kv_pages=pool.n_pages,
                                      page_size=PS, device="cpu")
    assert pool.reserve(0, s)
    pool.ensure(0, s)
    bt = torch.as_tensor(pool.table[:, :pool.pages_needed(s)])
    logits, _ = causal_lm.prefill_append(
        cfg, params, torch.as_tensor(toks)[None], pool.cache,
        torch.zeros(1, dtype=torch.int32), bt,
        length=torch.tensor([s], dtype=torch.int32), all_logits=True)
    assert logits.shape == (1, s, cfg.vocab_size)
    oracle = causal_lm.forward(cfg, params, torch.as_tensor(toks)[None])
    np.testing.assert_allclose(logits.numpy(), oracle.numpy(), atol=2e-4,
                               rtol=2e-4)
    from repro.models.causal_lm import forward as jforward
    want = jforward(jcfg, jparams, jnp.asarray(toks)[None])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# Across packages: the speculative engines on the same weights
# ---------------------------------------------------------------------------

SPEC_COUNTERS = ("decode_steps", "spec_steps", "draft_proposed",
                 "draft_accepted", "accepted_hist", "tokens_generated",
                 "drafter_failures", "pages_allocated")


@pytest.mark.parametrize("keep", [0.0, 0.25])
def test_spec_engine_matches_reference_engine(keep):
    """Target and drafter converted from the reference's weights (fp32
    KV), spec_k 3, a prefix-cache hit and a staggered arrival: equal
    greedy tokens and equal step, draft and page counters in both
    packages."""
    from repro.launch.serve import pack_params as jpack
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               cache_dtype="float32", bcr_keep_frac=keep,
                               bcr_block=(16, 16))
    jparams = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    if keep:
        jparams = JInferenceEngine(jcfg, jpack(jcfg, jparams), JEngineConfig(
            n_slots=2, capacity=64)).params
    jd = _draft_cfg(jcfg)
    jdparams = jmodel_fns(jd).init_params(jax.random.PRNGKey(1))
    tcfg = _cfg(cache_dtype="float32", bcr_keep_frac=keep,
                bcr_block=(16, 16))
    td = _draft_cfg(tcfg)
    conv = [from_jax_params(jax.tree_util.tree_map(np.asarray, p), c,
                            device="cpu")
            for p, c in ((jparams, tcfg), (jdparams, td))]
    rng = np.random.default_rng(5)
    system = np.arange(100, 119, dtype=np.int32)
    prompts = _prompts(jcfg.vocab_size) + [np.concatenate(
        [system, rng.integers(0, jcfg.vocab_size, size=5).astype(np.int32)])
        for _ in range(2)]
    ec = dict(n_slots=2, capacity=64, page_size=PS, spec_k=3,
              prefix_cache=True)
    engines = (JInferenceEngine(jcfg, jparams, JEngineConfig(
                   draft_cfg=jd, plan_packed=False, **ec),
                   draft_params=jdparams),
               InferenceEngine(tcfg, conv[0], EngineConfig(draft_cfg=td,
                                                           **ec),
                               device="cpu", draft_params=conv[1]))
    out = []
    for eng in engines:
        rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts[:4]]
        eng.step()
        eng.step()
        rids += [eng.submit(p, max_new_tokens=GEN) for p in prompts[4:]]
        done = {r.rid: r for r in eng.run()}
        eng.check_conservation()
        out.append(([done[r].generated for r in rids],
                    {k: eng.stats[k] for k in SPEC_COUNTERS}))
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    assert out[1][1]["spec_steps"] > 0


# ---------------------------------------------------------------------------
# Inside the port: speculative greedy == plain greedy == naive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed,spec_k", [(False, 2), (True, 3)])
def test_spec_matches_naive(llama, packed, spec_k):
    cfg, dense, pk, _, _ = llama
    params = pk if packed else dense
    ncfg = cfg if packed else dataclasses.replace(cfg, bcr_keep_frac=0.0)
    prompts = _prompts(cfg.vocab_size)
    want = [_naive(ncfg, params, p) for p in prompts]
    eng = _engine(llama, packed=packed, spec_k=spec_k, with_draft=True)
    assert eng.generate(prompts, max_new_tokens=GEN) == want
    assert eng.stats["spec_steps"] > 0 and eng.stats["drafter_failures"] == 0
    eng.check_conservation()


def test_packed_drafter_from_build_draft(llama):
    """``build_draft``'s drafter (target width // 4, 2 layers), BCR-packed,
    through the CLI's defaults: tokens equal plain greedy."""
    cfg, dense, *_ = llama
    dcfg, dparams = build_draft(dataclasses.replace(cfg, bcr_keep_frac=0.0),
                                bcr_keep=0.25, device="cpu",
                                log=lambda *_: None)
    assert dcfg.d_model == 16 and dcfg.num_layers == 2
    prompts = _prompts(cfg.vocab_size)
    want = _engine(llama).generate(prompts, max_new_tokens=GEN)
    eng = InferenceEngine(dataclasses.replace(cfg, bcr_keep_frac=0.0), dense,
                          EngineConfig(n_slots=2, capacity=64, page_size=PS,
                                       spec_k=3, draft_cfg=dcfg),
                          device="cpu", draft_params=dparams)
    assert eng.generate(prompts, max_new_tokens=GEN) == want


def test_oracle_drafter_full_acceptance_fewer_steps(llama):
    prompts = _prompts(llama[0].vocab_size)
    plain = _engine(llama)
    ref = plain.generate(prompts, max_new_tokens=GEN)
    oracle = OracleDraft()
    eng = _engine(llama, spec_k=3, drafter=oracle)
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
    oracle.continuations.update(dict(zip(rids, ref)))
    done = {r.rid: r for r in eng.run()}
    assert [done[r].generated for r in rids] == ref
    st = eng.stats
    assert st["draft_accepted"] == st["draft_proposed"] > 0
    assert st["decode_steps"] < plain.stats["decode_steps"]
    assert st["accepted_hist"][-1] > 0


def test_spec_with_prefix_cache_matches_plain(llama):
    rng = np.random.default_rng(5)
    system = np.arange(100, 119, dtype=np.int32)     # partial page
    prompts = [np.concatenate([system, rng.integers(
        0, llama[0].vocab_size, size=n).astype(np.int32)])
        for n in (5, 9, 2, 7)]
    ref = _engine(llama).generate(prompts, max_new_tokens=GEN)
    eng = _engine(llama, spec_k=2, with_draft=True, prefix_cache=True)
    assert eng.generate(prompts, max_new_tokens=GEN) == ref
    assert eng.stats["prefix_hit_tokens"] > 0
    eng.check_conservation()


def test_eos_mid_draft_stops_commit(llama):
    prompts = _prompts(llama[0].vocab_size)[:2]
    ref = _engine(llama).generate(prompts, max_new_tokens=GEN)
    eos = ref[0][2]
    ref_eos = _engine(llama).generate(prompts, max_new_tokens=GEN,
                                      eos_id=eos)
    oracle = OracleDraft()
    eng = _engine(llama, spec_k=3, drafter=oracle)
    rids = [eng.submit(p, max_new_tokens=GEN, eos_id=eos) for p in prompts]
    oracle.continuations.update(dict(zip(rids, ref)))
    done = {r.rid: r for r in eng.run()}
    assert [done[r].generated for r in rids] == ref_eos
    eng.check_conservation()


def test_sampling_runs_and_respects_budget(llama):
    prompts = _prompts(llama[0].vocab_size)
    eng = _engine(llama, spec_k=2, with_draft=True)
    got = eng.generate(prompts, max_new_tokens=GEN, temperature=0.9,
                       top_k=8)
    assert [len(g) for g in got] == [GEN] * len(prompts)
    assert all(0 <= t < llama[0].vocab_size for g in got for t in g)
    eng.check_conservation()


def test_submit_headroom_and_guards(llama):
    eng = _engine(llama, spec_k=4, with_draft=True)
    rid = eng.submit(np.zeros(40, np.int32), max_new_tokens=21)
    rej = eng.sched.finished[-1]
    assert rej.rid == rid and rej.status == "REJECTED"
    assert "spec_k" in rej.error
    with pytest.raises(ValueError, match="paged"):
        _engine(llama, spec_k=2, with_draft=True, page_size=0)
    with pytest.raises(ValueError, match="drafter"):
        _engine(llama, spec_k=2)
    cfg = llama[3]
    with pytest.raises(ValueError, match="token space"):
        InferenceEngine(dataclasses.replace(llama[0], bcr_keep_frac=0.0),
                        llama[1], EngineConfig(
                            page_size=PS, spec_k=2, draft_cfg=dataclasses
                            .replace(cfg, vocab_size=256)),
                        device="cpu", draft_params=llama[4])


def test_pool_consistent_after_staggered_spec_traffic(llama):
    """Rollback every step over an oversubscribed pool with staggered
    admissions and the prefix cache: the tokens match plain and every
    page and reservation is back after the drain."""
    prompts = _prompts(llama[0].vocab_size,
                       lens=(5, 16, 9, 12, 7, 11, 4, 14), seed=9)
    ref = _engine(llama, kv_pages=24).generate(prompts, max_new_tokens=GEN)
    eng = _engine(llama, spec_k=2, with_draft=True, kv_pages=24,
                  prefix_cache=True)
    rids, done = [], {}
    for p in prompts:
        rids.append(eng.submit(p, max_new_tokens=GEN))
        for _ in range(2):
            for r in eng.step():
                done[r.rid] = r
            eng.pool.check_consistency()
    for r in eng.run():
        done[r.rid] = r
    assert [done[r].generated for r in rids] == ref
    eng.check_conservation()
    assert eng.pool._reserved_total == 0 and not eng.pool._n_alloc.any()


def test_drafter_fault_degrades_to_single_token_steps(llama):
    """An injected ``drafter`` fault every step: each round verifies the
    pending token alone (a plain decode step), the failures are counted,
    and the tokens are plain greedy's."""
    prompts = _prompts(llama[0].vocab_size)
    plain = _engine(llama)
    want = plain.generate(prompts, max_new_tokens=GEN)
    faults = FaultInjector()
    for step in range(200):
        faults.at(step, "drafter")
    eng = _engine(llama, spec_k=3, with_draft=True, fault_injector=faults)
    assert eng.generate(prompts, max_new_tokens=GEN) == want
    st = eng.stats
    assert st["drafter_failures"] == st["spec_steps"] > 0
    assert st["draft_proposed"] == 0
    assert st["accepted_hist"][0] == st["tokens_generated"] - len(prompts)
    assert st["decode_steps"] == plain.stats["decode_steps"]
    eng.check_conservation()


def test_nan_at_verify_fails_only_the_victim(llama):
    prompts = _prompts(llama[0].vocab_size)[:2]
    want = _engine(llama).generate(prompts, max_new_tokens=GEN)
    faults = FaultInjector().at(1, "nan_logits")
    eng = _engine(llama, spec_k=2, with_draft=True, fault_injector=faults)
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
    done = {r.rid: r for r in eng.run()}
    assert [kind for _, kind, _ in faults.fired] == ["nan_logits"]
    statuses = [done[r].status for r in rids]
    assert statuses.count("FAILED") == 1
    for r, w in zip(rids, want):
        if done[r].status == "FINISHED":
            assert done[r].generated == w
        else:
            assert "verify" in done[r].error
    eng.check_conservation()


# a near-tie under a bf16 KV cache: two logits within 1e-2 relative, a
# little over one bf16 step (a step is 2^-8..2^-7 of the value) apart; the
# largest gap this test meets is 2.3e-3
BF16_TIE = 1e-2


def _hold_to_greedy(cfg, params, prompt, got, want, tie):
    """``got`` equals ``want`` (plain greedy), except at near-ties: from
    their first difference on, each token of ``got`` lies within ``tie``
    (relative) of the top logit of ``got``'s own teacher-forced
    trajectory (up to that difference the same as ``want``'s)."""
    if got == want:
        return
    assert len(got) == len(want)
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = generate(cfg, params, torch.as_tensor(prompt)[None],
                      gen_tokens=len(got), page_size=PS,
                      forced=torch.as_tensor([got]))["logits"][0]
    for j in range(i, len(got)):
        top = float(logits[j].max())
        gap = (top - float(logits[j, got[j]])) / max(abs(top), 1e-30)
        assert gap < tie, (j, got[j], int(logits[j].argmax()), gap)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_cancel_preempt_recover_with_model_drafter(llama, cache_dtype):
    """Cancel, preempt and recover with a model drafter attached: each
    frees the drafter's row with the slot's pages, so the slot's next
    tenants decode with no drafter failure (a stale drafter length would
    trip the catch-up check on the next propose), the tokens are plain
    greedy's, and every length is 0 after the drain. fp32 KV: exactly
    plain greedy's. bf16 KV: a re-prefill (tokens recomputed in another
    prefill batch shape) rounds K/V apart from the first prefill's, in
    the plain engine as much as here, which can move a near-tie token; the
    tokens are held to plain greedy under the ``BF16_TIE`` rule."""
    cfg = dataclasses.replace(llama[0], cache_dtype=cache_dtype)
    llama = (cfg,) + tuple(llama[1:3]) + (
        dataclasses.replace(llama[3], cache_dtype=cache_dtype), llama[4])
    prompts = _prompts(cfg.vocab_size, lens=(5, 16, 9, 12, 7, 11), seed=3)
    want = _engine(llama, n_slots=3).generate(prompts, max_new_tokens=GEN)
    eng = _engine(llama, spec_k=2, with_draft=True, n_slots=3, kv_pages=8,
                  preempt_after_stalls=1)
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts[:4]]
    for _ in range(2):
        eng.step()
    cancelled = eng.cancel(rids[0])
    assert cancelled is not None and cancelled.status == "CANCELLED"
    eng.step()
    assert eng.recover() >= 1
    rids += [eng.submit(p, max_new_tokens=GEN) for p in prompts[4:]]
    done = {r.rid: r for r in eng.run()}
    st = eng.stats
    assert st["drafter_failures"] == 0
    assert st["draft_proposed"] > 0
    assert st["preemptions"] > 0 and st["recoveries"] == 1
    ncfg = dataclasses.replace(cfg, bcr_keep_frac=0.0)
    for i, r in enumerate(rids[1:], start=1):
        if cache_dtype == "float32":
            assert done[r].generated == want[i]
        else:
            _hold_to_greedy(ncfg, llama[1], prompts[i], done[r].generated,
                            want[i], BF16_TIE)
    eng.check_conservation()
    assert not eng.drafter.pool.lens.any()


def test_drafter_catch_up_guard():
    """The drafter's state check: a target more than one position ahead
    (what a stale row would give) raises instead of drafting from the
    wrong history."""
    cfg = _draft_cfg(_cfg())
    d = tspec.DraftModel(cfg, build_params(cfg, device="cpu"), 2, 32,
                         device="cpu")
    from repro_torch.serving import Request
    req = Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=4)
    req.generated = [1]
    d.admit([(req, 0)])
    assert d.pool.lens.tolist() == [5, 0]
    props = d.propose([(0, req)], np.asarray([5, 0]), 2,
                      np.random.default_rng(0))
    assert len(props[0][0]) == 2 and d.pool.lens[0] == 7
    d.rollback(0, 6)
    assert d.pool.lens[0] == 6
    with pytest.raises(AssertionError):
        d.propose([(0, req)], np.asarray([8, 0]), 2,
                  np.random.default_rng(0))

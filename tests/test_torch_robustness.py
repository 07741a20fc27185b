"""The port's request lifecycle on the CPU, as the reference's
``test_robustness.py`` holds its own: seeded chaos sweeps (injected
page-alloc / NaN / cancel / slow-step faults) ending in conservation,
rejection and shedding, cancellation, deadlines on a fake clock,
page-pressure preemption (FCFS kept, tokens unchanged), NaN containment,
``recover()``, the fault injector and watchdog against the reference's, and
the same seeded fault schedule giving the same per-request statuses in the
reference engine and the port's."""

import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import FakeClock as JFakeClock  # noqa: E402
from repro.serving import FaultInjector as JFaultInjector  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import StepWatchdog as JStepWatchdog  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch.serve import build_params  # noqa: E402
from repro_torch.serving import (CANCELLED, FAILED, FINISHED,  # noqa: E402
                                 REJECTED, TERMINAL, TIMEOUT, EngineConfig,
                                 FakeClock, FaultInjector, InferenceEngine,
                                 StepWatchdog)

torch.set_num_threads(2)

N_SLOTS = 3
CAPACITY = 64
GEN = 8
VARIANTS = ("paged", "packed", "prefix")


@pytest.fixture(scope="module")
def llama():
    """The smoke llama (random weights, seed 0): dense and BCR-packed."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                              bcr_keep_frac=0.25, bcr_block=(16, 16))
    dense = build_params(dataclasses.replace(cfg, bcr_keep_frac=0.0),
                         device="cpu")
    packed = build_params(cfg, log=lambda *_: None, device="cpu")
    return cfg, dense, packed


def make_engine(variant, llama, *, faults=None, clock=None, preempt=0,
                max_waiting=None, **overrides):
    cfg, dense, packed = llama
    kw = dict(n_slots=N_SLOTS, capacity=CAPACITY, page_size=8,
              fault_injector=faults, preempt_after_stalls=preempt,
              max_waiting=max_waiting)
    params = packed if variant == "packed" else dense
    if variant != "packed":
        cfg = dataclasses.replace(cfg, bcr_keep_frac=0.0)
    if variant == "prefix":
        kw.update(prefix_cache=True)
    kw.update(overrides)
    return InferenceEngine(cfg, params, EngineConfig(**kw), device="cpu",
                           clock=clock)


def chaos_prompts(vocab, n, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 17)))
            .astype(np.int32) for _ in range(n)]


RATES = {"page_alloc": 0.06, "nan_logits": 0.02, "cancel": 0.03,
         "slow_step": 0.02}


def drive_chaos(eng, clk, prompts, n_steps=300):
    """The reference's chaos loop: a submission every third step (every
    fourth with a 2 s deadline), a 10 ms clock tick a step, then a drain.
    Returns the rids in submission order."""
    rids, submitted = [], 0
    for step in range(n_steps):
        if step % 3 == 0 and submitted < len(prompts):
            rids.append(eng.submit(
                prompts[submitted], max_new_tokens=GEN,
                deadline_s=2.0 if submitted % 4 == 0 else 0.0))
            submitted += 1
        if eng.sched.has_work():
            eng.step()
        clk.advance(0.01)
    for _ in range(500):
        if not eng.sched.has_work():
            break
        eng.step()
        clk.advance(0.01)
    assert not eng.sched.has_work(), "engine failed to drain"
    return rids


class TestChaosSweep:
    """A seeded 300-step fault schedule against each engine variant: every
    rid reaches exactly one terminal status, exactly the injected NaN
    victims fail, nothing leaks, and finished requests give the fault-free
    run's tokens."""

    N_REQ = 20

    @pytest.mark.parametrize("variant", VARIANTS)
    def test_conservation_under_chaos(self, variant, llama):
        prompts = chaos_prompts(llama[0].vocab_size, self.N_REQ)
        ref_eng = make_engine(variant, llama)
        ref = ref_eng.generate(prompts, max_new_tokens=GEN)
        ref_eng.check_conservation()

        clk = FakeClock()
        faults = FaultInjector(seed=13, sleep=clk.sleep).random_schedule(
            300, RATES, slow_s=0.3)
        eng = make_engine(variant, llama, faults=faults, clock=clk,
                          preempt=2, max_waiting=8)
        rids = drive_chaos(eng, clk, prompts)
        finished = eng.sched.finished
        assert Counter(r.rid for r in finished) == Counter(rids)
        assert all(r.status in TERMINAL for r in finished)
        by_status = Counter(r.status for r in finished)
        assert faults.fired and by_status[FINISHED] > 0, by_status
        # the failed requests are exactly the injected NaN victims
        assert by_status[FAILED] == sum(k == "nan_logits"
                                        for _, k, _ in faults.fired)
        assert eng.stats["failed"] == by_status[FAILED]
        eng.check_conservation()
        by_rid = {r.rid: r for r in finished}
        for i, rid in enumerate(rids):
            r = by_rid[rid]
            if r.status == FINISHED:
                assert r.generated == ref[i], (variant, rid, r.preemptions)


def test_fault_schedule_statuses_match_reference():
    """The same seeded fault schedule, traffic and fake clock on the
    reference engine and the port's (same fp32 weights, prefix cache,
    preemption, a bounded queue): equal per-rid statuses, tokens, fired
    faults and lifecycle counters."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               cache_dtype="float32")
    jparams = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               cache_dtype="float32")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    prompts = chaos_prompts(jcfg.vocab_size, 20)
    ec = dict(n_slots=N_SLOTS, capacity=CAPACITY, page_size=8,
              prefix_cache=True, preempt_after_stalls=2, max_waiting=8)
    runs = []
    for FI, Clock, make in (
            (JFaultInjector, JFakeClock,
             lambda f, c: JInferenceEngine(jcfg, jparams, JEngineConfig(
                 fault_injector=f, plan_packed=False, **ec), clock=c)),
            (FaultInjector, FakeClock,
             lambda f, c: InferenceEngine(tcfg, tparams, EngineConfig(
                 fault_injector=f, **ec), device="cpu", clock=c))):
        clk = Clock()
        faults = FI(seed=13, sleep=clk.sleep).random_schedule(
            300, RATES, slow_s=0.3)
        eng = make(faults, clk)
        rids = drive_chaos(eng, clk, prompts)
        eng.check_conservation()
        by_rid = {r.rid: r for r in eng.sched.finished}
        runs.append(([(by_rid[r].status, by_rid[r].generated) for r in rids],
                     faults.fired,
                     {k: eng.stats[k] for k in (
                         "failed", "cancelled", "timeouts", "shed",
                         "preemptions", "page_stalls", "prefix_hit_tokens")}))
    assert runs[1] == runs[0]
    statuses = Counter(s for s, _ in runs[1][0])
    assert statuses[FAILED] and statuses[FINISHED], statuses


class TestPreemption:
    @pytest.mark.parametrize("variant", ["paged", "prefix"])
    def test_fcfs_preserved_and_bit_identical(self, llama, variant):
        """A pool of 7 allocatable pages: A(3) and B(4) fill it, C(3)
        stalls, so the youngest runner (B) is evicted; C seats, B
        re-admits after C but before a later arrival D, and B's tokens
        survive evict → requeue → re-admit (its tokens fold into its
        prompt). The fake clock ticks once a step, so requests admitted in
        one step share an admit time (under the prefix cache C and B seat
        together: B's folded prompt hits its own parked pages)."""
        vocab = llama[0].vocab_size
        pa = (np.arange(16) * 5 + 1) % vocab
        pb = (np.arange(24) * 3 + 2) % vocab
        pc = (np.arange(16) * 7 + 3) % vocab
        ref = make_engine("paged", llama).generate([pa, pb, pc],
                                                   max_new_tokens=GEN)
        clk = FakeClock(now=100.0)     # 0.0 is "no first token yet"
        eng = make_engine(variant, llama, kv_pages=8, preempt=1, clock=clk)
        a = eng.submit(pa, max_new_tokens=GEN)
        b = eng.submit(pb, max_new_tokens=GEN)
        for _ in range(3):
            eng.step()
            clk.advance(1.0)
        assert len(eng.sched.active) == 2
        c = eng.submit(pc, max_new_tokens=GEN)
        d = eng.submit(pa.copy(), max_new_tokens=GEN)
        by = {}
        while eng.sched.has_work():
            by.update((r.rid, r) for r in eng.step())
            clk.advance(1.0)
        assert set(by) == {a, b, c, d}
        assert eng.stats["preemptions"] == 1
        assert by[b].preemptions == 1 and by[b].folded > 0
        assert by[c].admit_time <= by[b].admit_time <= by[d].admit_time
        # TTFT keeps the first admission's first token
        assert by[b].first_token_time < by[b].admit_time
        for rid, i in ((a, 0), (b, 1), (c, 2), (d, 0)):
            assert by[rid].status == FINISHED
            assert by[rid].generated == ref[i], (rid, i)
        eng.check_conservation()


class TestRecover:
    @pytest.mark.parametrize("variant", ["paged", "prefix"])
    def test_recover_mid_run_changes_no_output(self, llama, variant):
        """``recover()`` called mid-run folds, releases and requeues every
        running request (and resets the prefix index); the drained run
        gives the uninterrupted run's tokens."""
        prompts = chaos_prompts(llama[0].vocab_size, 5, seed=3)
        ref = make_engine(variant, llama).generate(prompts,
                                                   max_new_tokens=GEN)
        eng = make_engine(variant, llama)
        rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
        for _ in range(4):
            eng.step()
        n = len(eng.sched.active)
        assert eng.recover() == n > 0
        assert not eng.sched.active and eng.stats["recoveries"] == 1
        eng.pool.check_consistency()
        by = {r.rid: r for r in eng.run()}
        assert [by[r].generated for r in rids] == ref
        eng.check_conservation()

    def test_pause_resume_changes_no_output(self, llama):
        prompts = chaos_prompts(llama[0].vocab_size, 2, seed=4)
        ref = make_engine("prefix", llama).generate(prompts,
                                                    max_new_tokens=GEN)
        eng = make_engine("prefix", llama)
        ra, rb = (eng.submit(p, max_new_tokens=GEN) for p in prompts)
        eng.step()
        eng.step()
        assert eng.pause(ra) and not eng.pause(10_000)
        assert eng.sched.paused and len(eng.sched.active) == 1
        eng.step()
        assert eng.resume(ra)
        by = {r.rid: r for r in eng.run()}
        assert [by[ra].generated, by[rb].generated] == ref
        assert eng.stats["paused"] == eng.stats["resumed"] == 1
        eng.check_conservation()


class TestRejection:
    def test_over_pool_request_rejected_not_raised(self, llama):
        eng = make_engine("paged", llama, kv_pages=4)
        rid = eng.submit(np.arange(30, dtype=np.int32), max_new_tokens=8)
        rej = eng.sched.finished[-1]
        assert rej.rid == rid and rej.status == REJECTED
        assert "pages" in rej.error
        out = eng.generate([np.arange(8, dtype=np.int32)], max_new_tokens=4)
        assert len(out[0]) == 4
        eng.check_conservation()

    def test_shedding_drops_earliest_deadline(self, llama):
        clk = FakeClock()
        eng = make_engine("paged", llama, max_waiting=2, clock=clk,
                          backfill_chunk=1)
        for _ in range(N_SLOTS):
            eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=GEN)
            eng.step()
        assert len(eng.sched.active) == N_SLOTS
        tight = eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=4,
                           deadline_s=0.5)
        loose = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=4,
                           deadline_s=50.0)
        assert len(eng.sched.waiting) == 2
        trigger = eng.submit(np.arange(7, dtype=np.int32), max_new_tokens=4)
        shed = next(r for r in eng.sched.finished if r.rid == tight)
        assert shed.status == REJECTED and "shed" in shed.error
        assert eng.stats["shed"] == 1
        by = {r.rid: r for r in eng.run()}
        assert by[loose].status == FINISHED
        assert by[trigger].status == FINISHED
        eng.check_conservation()

    def test_shed_waiting_drains_the_queue(self, llama):
        eng = make_engine("paged", llama)
        for _ in range(N_SLOTS + 2):
            eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=4)
        eng.step()
        dropped = eng.shed_waiting("draining")
        assert len(dropped) == 2 and all(r.status == REJECTED
                                         for r in dropped)
        done = eng.run()
        assert len(done) == N_SLOTS and all(r.status == FINISHED
                                            for r in done)
        eng.check_conservation()


class TestCancellation:
    def test_cancel_waiting_and_running(self, llama):
        eng = make_engine("prefix", llama)
        run_rid = eng.submit(np.arange(4, dtype=np.int32),
                             max_new_tokens=GEN)
        fill = [eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=4)
                for _ in range(N_SLOTS - 1)]
        wait_rid = eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        eng.step()
        assert eng.sched.active and eng.sched.waiting
        got = eng.cancel(wait_rid)
        assert got is not None and got.status == CANCELLED
        got = eng.cancel(run_rid)
        assert got is not None and got.status == CANCELLED
        assert got.generated
        assert eng.cancel(run_rid) is None
        assert eng.cancel(10_000) is None
        done = eng.run()
        assert {r.rid for r in done} == set(fill)
        assert all(r.status == FINISHED for r in done)
        eng.check_conservation()
        assert eng.stats["cancelled"] == 2

    def test_cross_thread_submit_and_cancel(self, llama):
        """Submitters and cancellers on other threads against a stepping
        engine: the engine lock serializes them, every rid ends in exactly
        one terminal status and nothing leaks."""
        import sys
        eng = make_engine("prefix", llama)
        rids, lock = [], threading.Lock()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def submitter(seed):
                rng = np.random.default_rng(seed)
                for _ in range(4):
                    rid = eng.submit(rng.integers(0, 400, size=6),
                                     max_new_tokens=4)
                    with lock:
                        rids.append(rid)
                    if rng.random() < 0.5:
                        eng.cancel(rid)

            threads = [threading.Thread(target=submitter, args=(s,))
                       for s in range(4)]
            for t in threads:
                t.start()
            for _ in range(400):
                eng.step()
                if not any(t.is_alive() for t in threads) \
                        and not eng.sched.has_work():
                    break
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            eng.run()
        finally:
            sys.setswitchinterval(interval)
        assert Counter(r.rid for r in eng.sched.finished) == Counter(rids)
        assert len(rids) == 16
        snap = eng.stats_snapshot()
        assert snap["active"] == snap["waiting"] == 0
        eng.check_conservation()


class TestDeadlines:
    def test_timeout_waiting_and_running(self, llama):
        clk = FakeClock()
        eng = make_engine("paged", llama, clock=clk)
        run_rid = eng.submit(np.arange(4, dtype=np.int32),
                             max_new_tokens=CAPACITY - 4, deadline_s=1.0)
        fill = [eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=4)
                for _ in range(N_SLOTS - 1)]
        wait_rid = eng.submit(np.arange(6, dtype=np.int32),
                              max_new_tokens=4, deadline_s=1.0)
        eng.step()
        clk.advance(2.0)
        by = {r.rid: r for r in eng.step()}
        assert by[run_rid].status == TIMEOUT
        assert by[wait_rid].status == TIMEOUT
        assert eng.stats["timeouts"] == 2
        assert eng.stats["timeouts_running"] == 1
        done = eng.run()
        assert all(r.status == FINISHED for r in done)
        assert {r.rid for r in done} == set(fill)
        eng.check_conservation()

    def test_reap_expires_a_paused_request(self, llama):
        clk = FakeClock()
        eng = make_engine("paged", llama, clock=clk)
        rid = eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=8,
                         deadline_s=1.0)
        eng.step()
        assert eng.pause(rid)
        clk.advance(2.0)
        assert eng.reap() == 1
        assert eng.sched.finished[-1].status == TIMEOUT
        eng.check_conservation()


class TestNaNContainment:
    def test_injected_nan_fails_only_offender(self, llama):
        vocab = llama[0].vocab_size
        pa = (np.arange(6) + 1) % vocab
        pb = (np.arange(9) * 2 + 1) % vocab
        ref = make_engine("paged", llama).generate([pa, pb],
                                                   max_new_tokens=GEN)
        faults = FaultInjector(seed=0).at(3, "nan_logits")
        eng = make_engine("paged", llama, faults=faults)
        ra = eng.submit(pa, max_new_tokens=GEN)
        rb = eng.submit(pb, max_new_tokens=GEN)
        done = eng.run()
        assert Counter(r.status for r in done) == Counter({FAILED: 1,
                                                           FINISHED: 1})
        survivor = next(r for r in done if r.status == FINISHED)
        assert survivor.generated == ref[{ra: 0, rb: 1}[survivor.rid]]
        victim = next(r for r in done if r.status == FAILED)
        assert "non-finite" in victim.error
        # no token past the poisoned step (step 0 admits, steps 0-3 decode)
        assert len(victim.generated) == 4
        eng.check_conservation()

    @pytest.mark.parametrize("variant", ["paged", "prefix"])
    def test_real_nan_params_fail_cleanly(self, llama, variant):
        """A NaN weight makes every prefill row non-finite: each request
        retires FAILED at admission with no token, and a poisoned prompt
        never enters the prefix index."""
        cfg, dense, _ = llama
        bad = {**dense, "lm_head": {"w": dense["lm_head"]["w"].clone()}}
        bad["lm_head"]["w"][0, 0] = float("nan")
        eng = InferenceEngine(
            dataclasses.replace(cfg, bcr_keep_frac=0.0), bad, EngineConfig(
                n_slots=2, capacity=32, page_size=8,
                prefix_cache=variant == "prefix"), device="cpu")
        eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=4)
        eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=4)
        done = eng.run()
        assert len(done) == 2 and all(r.status == FAILED for r in done)
        assert all(not r.generated for r in done)
        assert "prefill" in done[0].error
        assert not eng.pool._page_key
        eng.check_conservation()


class TestFaultInjector:
    def test_schedule_and_draws_match_reference(self):
        """Same seed, same rates: the port's copy builds the reference's
        schedule and draws the same victims."""
        rates = {"cancel": 0.1, "nan_logits": 0.05, "slow_step": 0.05,
                 "page_alloc": 0.08}
        a = FaultInjector(seed=3).random_schedule(100, rates, slow_s=0.2)
        b = JFaultInjector(seed=3).random_schedule(100, rates, slow_s=0.2)
        for kind in rates:
            hits = [s for s in range(100) if a.fires(s, kind)]
            assert hits == [s for s in range(100) if b.fires(s, kind)]
            assert hits
            assert all(a.fires(s, kind) for s in hits)    # pure queries
            assert [a.arg(s, kind) for s in hits] == [b.arg(s, kind)
                                                      for s in hits]
        assert [a.choose(n) for n in range(1, 30)] == [b.choose(n)
                                                      for n in range(1, 30)]
        with pytest.raises(ValueError):
            a.at(0, "bogus_kind")

    def test_slow_step_uses_injected_sleep(self):
        clk = FakeClock()
        fi = FaultInjector(sleep=clk.sleep).at(2, "slow_step", 0.5)
        fi.maybe_sleep(1)
        assert clk.now == 0.0
        fi.maybe_sleep(2)
        assert clk.now == 0.5
        assert fi.fired == [(2, "slow_step", 0.5)]


class TestStepWatchdog:
    def test_matches_reference_on_a_trace(self):
        rng = np.random.default_rng(0)
        trace = list(rng.uniform(0.005, 0.015, 40)) + [0.2, 0.01, 0.5]
        a, b = StepWatchdog(), JStepWatchdog()
        assert [a.record(t) for t in trace] == [b.record(t) for t in trace]
        assert (a.ewma, a.slow_steps, a.n) == (b.ewma, b.slow_steps, b.n)
        assert a.slow_steps == 2

    def test_quiet_until_min_steps(self):
        wd = StepWatchdog(min_steps=5)
        assert not wd.record(10.0)
        for _ in range(3):
            assert not wd.record(0.01)

    def test_engine_surfaces_watchdog(self, llama):
        clk = FakeClock()
        faults = FaultInjector(seed=0, sleep=clk.sleep).at(
            9, "slow_step", 5.0)
        eng = make_engine("paged", llama, faults=faults, clock=clk)
        eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=12)
        eng.run()
        assert eng.stats["watchdog_slow_steps"] >= 1
        assert eng.stats["step_time_ewma"] > 0.0


class TestPriority:
    def test_engine_seats_high_tier_first(self, llama):
        eng = make_engine("paged", llama)
        blockers = [eng.submit(np.arange(4, dtype=np.int32),
                               max_new_tokens=4) for _ in range(N_SLOTS)]
        lo = eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=2,
                        priority=0)
        hi = eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=2,
                        priority=2)
        done = {r.rid: r for r in eng.run()}
        eng.check_conservation()
        assert done[hi].admit_time <= done[lo].admit_time
        assert all(done[r].status == FINISHED for r in blockers + [lo, hi])

    def test_shed_prefers_lowest_tier(self, llama):
        eng = make_engine("paged", llama, max_waiting=2)
        for _ in range(N_SLOTS):
            eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=8)
            eng.step()
        hi = eng.submit(np.arange(4, dtype=np.int32), priority=2)
        lo = eng.submit(np.arange(4, dtype=np.int32), priority=0)
        over = eng.submit(np.arange(4, dtype=np.int32), priority=1)
        shed = [r for r in eng.sched.finished if r.status == REJECTED]
        assert [r.rid for r in shed] == [lo]
        done = {r.rid: r for r in eng.run()}
        assert done[hi].status == FINISHED and done[over].status == FINISHED

    def test_preemption_victim_is_lowest_tier(self, llama):
        eng = make_engine("prefix", llama, preempt=1, backfill_chunk=1)
        lo = eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=8,
                        priority=0)
        eng.step()
        hi = eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=8,
                        priority=2)
        eng.step()
        assert len(eng.sched.active) == 2
        victim = eng._preempt_youngest()
        assert victim.rid == lo and victim.preemptions == 1
        done = {r.rid: r for r in eng.run()}
        eng.check_conservation()
        assert done[lo].status == FINISHED and done[hi].status == FINISHED

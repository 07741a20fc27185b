"""The port's SLO admission and tenancy on the CPU, held to the reference:
the seat-time estimator, the work-step cost and the token bucket exactly
equal to the reference's on the same inputs (the bucket on a fake clock);
the scheduler's weighted fair queueing against the reference's scheduler;
and the reference's engine scenarios (concurrent, rate, page and default
quotas, doomed and makeable deadlines, queue depth, an uncalibrated step
time, shedding, a victim tenant under an aggressor) replayed on the
reference engine and the port's under one fake clock, on a paged and a
capacity-dense pool: the same statuses, errors, ``retry_after_s``, tokens
and per-tenant counters."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import FakeClock as JFakeClock  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import TenantQuota as JTenantQuota  # noqa: E402
from repro.serving import TokenBucket as JTokenBucket  # noqa: E402
from repro.serving import admission as jadm  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (EngineConfig, FakeClock,  # noqa: E402
                                 InferenceEngine, Request, Scheduler,
                                 TenantQuota, TokenBucket)
from repro_torch.serving import admission as tadm  # noqa: E402

torch.set_num_threads(2)

N_SLOTS = 2
CAPACITY = 64


# ---------------------------------------------------------------------------
# Pure arithmetic against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_estimator_and_work_steps_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        free = int(rng.integers(0, 4))
        running = rng.integers(1, 40, size=int(rng.integers(0, 5))) * 1.0
        ahead = rng.integers(1, 40, size=int(rng.integers(0, 7))) * 1.0
        assert (tadm.estimate_seat_steps(free, list(running), list(ahead))
                == jadm.estimate_seat_steps(free, list(running),
                                            list(ahead)))
        args = tuple(int(a) for a in rng.integers(0, 20, size=4))
        assert (tadm.request_work_steps(*args)
                == jadm.request_work_steps(*args))


@pytest.mark.parametrize("free,running,ahead,want", [
    (2, [], [], 0.0), (0, [], [], 0.0), (0, [5.0, 3.0, 9.0], [], 3.0),
    (0, [3.0], [4.0, 4.0], 11.0), (2, [], [5.0, 5.0], 5.0)])
def test_seat_estimator_cases(free, running, ahead, want):
    assert tadm.estimate_seat_steps(free, running, ahead) == want
    assert tadm.request_work_steps(16, 0, 8, 0) == 9.0
    assert tadm.request_work_steps(16, 0, 8, 8) == 2.0


@pytest.mark.parametrize("rate,burst", [(2.0, 2), (0.0, 1), (10.0, 3),
                                        (0.5, 1)])
def test_token_bucket_matches_reference(rate, burst):
    """A seeded run of takes, backoff reads and clock advances on both
    buckets: every take, every ``next_free_s`` and the token level agree."""
    tc, jc = FakeClock(), JFakeClock()
    tb = TokenBucket(rate, burst, clock=tc)
    jb = JTokenBucket(rate, burst, clock=jc)
    rng = np.random.default_rng(int(rate * 10) + burst)
    for _ in range(60):
        r = rng.random()
        if r < 0.5:
            assert tb.try_take() == jb.try_take()
        elif r < 0.7:
            assert tb.next_free_s() == jb.next_free_s()
        else:
            dt = float(rng.random())
            tc.advance(dt)
            jc.advance(dt)
        assert tb.tokens == jb.tokens


def test_token_bucket_burst_starve_refill():
    clk = FakeClock()
    b = TokenBucket(rate=2.0, burst=2, clock=clk)
    assert b.try_take() and b.try_take() and not b.try_take()
    assert b.next_free_s() == pytest.approx(0.5)
    clk.advance(0.5)
    assert b.try_take() and not b.try_take()
    clk.advance(100.0)
    assert sum(b.try_take() for _ in range(10)) == 2


# ---------------------------------------------------------------------------
# Weighted fair queueing against the reference's scheduler
# ---------------------------------------------------------------------------


def _wfq_order(sched_cls, req_cls, weights, tenants, priorities=None,
               requeue_first=False):
    s = sched_cls(n_slots=1)
    s.weights = dict(weights)
    for i, t in enumerate(tenants):
        r = req_cls(prompt=np.zeros(4, np.int32), max_new_tokens=8,
                    priority=(priorities or [0] * len(tenants))[i])
        r.tenant = t
        s.submit(r)
    order = []
    if requeue_first:
        [(r, slot)] = s.admit()
        s.requeue(slot)
    while s.waiting:
        [(r, slot)] = s.admit()
        order.append((r.rid, r.tenant))
        s.retire(slot)
    return order, dict(s.service)


@pytest.mark.parametrize("weights,tenants,priorities,requeue", [
    ({}, ["a"] * 4, None, False),                         # FCFS kept
    ({"big": 2.0, "small": 1.0}, ["big", "small"] * 8, None, False),
    ({}, ["a"] * 3 + ["b"] * 3, None, False),             # alternation
    ({"lo": 100.0, "hi": 1.0}, ["lo", "hi"], [0, 1], False),
    ({}, ["a", "b"], None, True),                         # refund
])
def test_wfq_order_matches_reference(weights, tenants, priorities, requeue):
    got = _wfq_order(Scheduler, Request, weights, tenants, priorities,
                     requeue)
    want = _wfq_order(JScheduler, JRequest, weights, tenants, priorities,
                      requeue)
    assert got == want
    order = [t for _, t in got[0]]
    if weights.get("big"):
        assert order[:6].count("big") == 4
    if priorities:
        assert order[0] == "hi"


# ---------------------------------------------------------------------------
# Engine scenarios on both packages under one fake clock
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """The smoke llama (seed 0, fp32 KV) in both packages."""
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               cache_dtype="float32")
    jparams = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               cache_dtype="float32")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


class _Pkg:
    """One package's engine factory, clock and quota type."""

    def __init__(self, port, weights, page_size):
        jcfg, jparams, tcfg, tparams = weights
        self.port = port
        self.clock = FakeClock() if port else JFakeClock()
        self.Quota = TenantQuota if port else JTenantQuota
        self.page_size = page_size
        self._model = (tcfg, tparams) if port else (jcfg, jparams)

    def engine(self, **over):
        kw = dict(n_slots=N_SLOTS, capacity=CAPACITY,
                  page_size=self.page_size)
        kw.update(over)
        cfg, params = self._model
        if self.port:
            return InferenceEngine(cfg, params, EngineConfig(**kw),
                                   device="cpu", clock=self.clock)
        return JInferenceEngine(cfg, params, JEngineConfig(
            plan_packed=False, **kw), clock=self.clock)


def _prompt(vocab, n=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(
        np.int32)


def _concurrent_quota(pkg, vocab):
    eng = pkg.engine(tenant_quotas={"acme": pkg.Quota(max_concurrent=2)},
                     slo_step_time=0.1)
    rids = [eng.submit(_prompt(vocab), max_new_tokens=4, tenant="acme")
            for _ in range(3)]
    return eng, rids


def _rate_limit(pkg, vocab):
    eng = pkg.engine(tenant_quotas={"acme": pkg.Quota(rate=1.0, burst=1)})
    rids = [eng.submit(_prompt(vocab), max_new_tokens=2, tenant="acme")
            for _ in range(2)]
    pkg.clock.advance(1.0)                  # a token accrues
    rids.append(eng.submit(_prompt(vocab), max_new_tokens=2,
                           tenant="acme"))
    return eng, rids


def _page_quota(pkg, vocab):
    # 8 + 8 tokens = 2 pages of 8 a request (ignored on an unpaged pool)
    eng = pkg.engine(tenant_quotas={"acme": pkg.Quota(max_pages=5)},
                     slo_step_time=0.2)
    rids = [eng.submit(_prompt(vocab, seed=i), max_new_tokens=8,
                       tenant="acme") for i in range(3)]
    return eng, rids


def _default_quota_and_stats(pkg, vocab):
    eng = pkg.engine(default_tenant_quota=pkg.Quota(max_concurrent=1))
    rids = [eng.submit(_prompt(vocab, seed=i), max_new_tokens=2, tenant=t)
            for i, t in enumerate(["anyone", "anyone", "a", "b"])]
    return eng, rids


def _doomed_deadline(pkg, vocab):
    # 1 s a step pinned, idle engine: seat 0 + defer 2, prefill 1, 4 new
    # tokens → finish 7 s, past a 2 s deadline; Retry-After = 2 steps
    eng = pkg.engine(slo_admission=True, slo_step_time=1.0)
    rids = [eng.submit(_prompt(vocab), max_new_tokens=4, deadline_s=2.0),
            eng.submit(_prompt(vocab, seed=1), max_new_tokens=4,
                       deadline_s=30.0)]
    return eng, rids


def _queue_depth(pkg, vocab):
    eng = pkg.engine(slo_admission=True, slo_step_time=0.05,
                     backfill_chunk=1, backfill_max_defer=0)
    deadline = 0.05 * (1 + 1 + 8) * 1.5           # makeable when idle
    rids = [eng.submit(_prompt(vocab), max_new_tokens=8,
                       deadline_s=deadline)]
    rids += [eng.submit(_prompt(vocab, seed=i + 1), max_new_tokens=8)
             for i in range(8)]
    rids.append(eng.submit(_prompt(vocab, seed=99), max_new_tokens=8,
                           deadline_s=deadline))
    return eng, rids


def _uncalibrated(pkg, vocab):
    eng = pkg.engine(slo_admission=True)
    return eng, [eng.submit(_prompt(vocab), max_new_tokens=4,
                            deadline_s=1e-9)]


def _shed_retry_after(pkg, vocab):
    eng = pkg.engine(max_waiting=1, slo_step_time=0.5)
    return eng, [eng.submit(_prompt(vocab, seed=i), max_new_tokens=8)
                 for i in range(N_SLOTS + 2)]


def _victim_under_aggressor(pkg, vocab):
    """An aggressor floods (concurrency 2, 4 req/s, burst 2) while a
    victim trickles in at equal WFQ weight: the aggressor's excess is
    turned away with a computed Retry-After, the victim loses nothing."""
    eng = pkg.engine(slo_step_time=0.1, tenant_quotas={
        "aggressor": pkg.Quota(rate=4.0, burst=2, max_concurrent=2),
        "victim": pkg.Quota(max_concurrent=4)})
    rids = []
    for i in range(12):
        rids.append(eng.submit(_prompt(vocab, seed=i), max_new_tokens=6,
                               tenant="aggressor"))
        if i % 3 == 0:
            rids.append(eng.submit(_prompt(vocab, seed=50 + i),
                                   max_new_tokens=6, tenant="victim"))
        eng.step()
        pkg.clock.advance(0.1)
    return eng, rids


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _concurrent_quota, _rate_limit, _page_quota, _default_quota_and_stats,
    _doomed_deadline, _queue_depth, _uncalibrated, _shed_retry_after,
    _victim_under_aggressor)}
STATS = ("rejected", "quota_rejected", "slo_rejected", "shed", "timeouts",
         "wasted_prefill_tokens", "tenants")


def _replay(pkg, name, vocab):
    """Run a scenario to the drain; returns each rid's (status, error,
    retry_after_s, tokens) in submission order, the counters and the
    drained engine."""
    eng, rids = SCENARIOS[name](pkg, vocab)
    at_submit = {r.rid: (r.status, r.retry_after_s)
                 for r in eng.sched.finished}
    while eng.sched.has_work():
        eng.step()
        pkg.clock.advance(0.01)
    eng.check_conservation()
    fin = {}
    for r in eng.sched.finished:
        assert r.rid not in fin, f"rid {r.rid} reached two terminal states"
        fin[r.rid] = (r.status, r.error, r.retry_after_s, list(r.generated))
    assert set(fin) == set(rids), "a request never reached a terminal state"
    stats = {k: eng.stats[k] for k in STATS}
    return [fin[r] for r in rids], at_submit, stats


@pytest.mark.parametrize("page_size", [8, 0])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(weights, name, page_size):
    vocab = weights[0].vocab_size
    got, at_submit, stats = _replay(_Pkg(True, weights, page_size), name,
                                    vocab)
    want, _, jstats = _replay(_Pkg(False, weights, page_size), name, vocab)
    assert got == want
    assert stats == jstats
    statuses = [s for s, *_ in got]
    rejected = [(e, ra) for s, e, ra, _ in got if s == "REJECTED"]
    if name == "concurrent_quota":
        assert statuses == ["FINISHED", "FINISHED", "REJECTED"]
        assert "concurrent" in rejected[0][0] and rejected[0][1] > 0
    elif name == "rate_limit":
        assert statuses == ["FINISHED", "REJECTED", "FINISHED"]
        assert "rate-limited" in rejected[0][0]
        assert rejected[0][1] == pytest.approx(1.0)
    elif name == "page_quota":
        if page_size:
            assert statuses == ["FINISHED", "FINISHED", "REJECTED"]
            assert "page budget" in rejected[0][0] and rejected[0][1] > 0
        else:
            assert statuses == ["FINISHED"] * 3
    elif name == "default_quota_and_stats":
        assert statuses == ["FINISHED", "REJECTED", "FINISHED", "FINISHED"]
        assert stats["tenants"]["a"]["goodput_tokens"] == 2
    elif name == "doomed_deadline":
        assert statuses == ["REJECTED", "FINISHED"]
        assert "slo" in rejected[0][0] and rejected[0][1] == 2.0
        assert stats["slo_rejected"] == 1
        assert stats["wasted_prefill_tokens"] == 0
    elif name == "queue_depth":
        assert statuses[0] == "FINISHED" and statuses[-1] == "REJECTED"
        assert "slo" in rejected[-1][0]
    elif name == "uncalibrated":
        assert statuses == ["TIMEOUT"] and stats["slo_rejected"] == 0
    elif name == "shed_retry_after":
        assert rejected and all(ra > 0 for _, ra in rejected)
    elif name == "victim_under_aggressor":
        victim = stats["tenants"]["victim"]
        assert victim["finished"] == victim["submitted"] == 4
        assert victim["goodput_tokens"] == 4 * 6       # goodput 1.0
        agg = stats["tenants"]["aggressor"]
        assert agg["rejected"] > 0 and all(ra > 0 for _, ra in rejected)
    # every rejection (quota, SLO, shed) happened inside submit()
    assert sum(s == "REJECTED" for s, _ in at_submit.values()) \
        == len(rejected)


def test_step_time_calibrates_and_snapshot(weights):
    """Measured steps seed the estimator (real clock), so a later shed
    carries a computed ``retry_after_s``, which ``poll`` hands out; the
    snapshot carries the drain estimate and deep-copied tenant counters."""
    tcfg, tparams = weights[2], weights[3]
    eng = InferenceEngine(tcfg, tparams, EngineConfig(
        n_slots=N_SLOTS, capacity=CAPACITY, max_waiting=2), device="cpu")
    eng.submit(_prompt(tcfg.vocab_size), max_new_tokens=4, tenant="t")
    eng.run()
    assert eng._step_time > 0 and eng.retry_after_estimate() > 0.0
    for i in range(4):
        eng.submit(_prompt(tcfg.vocab_size, seed=i), max_new_tokens=4,
                   tenant="t")
    eng.run()
    snap = eng.stats_snapshot()
    assert snap["retry_after_est_s"] > 0
    snap["tenants"]["t"]["finished"] = -1
    assert eng.stats["tenants"]["t"]["finished"] == 3
    _, _, fin = eng.poll()
    assert sorted(f[2] for f in fin) == ["FINISHED"] * 3 + ["REJECTED"] * 2
    assert all(f[4] > 0 for f in fin if f[2] == "REJECTED")

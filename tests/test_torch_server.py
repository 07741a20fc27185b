"""The port's HTTP front end (``repro_torch.serving.server``) and
``InferenceEngine.warmup`` on the CPU.

Across packages, on the smoke llama at fp32 (fp32 cache) with the reference
weights carried across by ``repro_torch/convert.py``, both servers run side
by side: greedy SSE and buffered tokens agree with each other and with each
engine's ``generate``, a seeded corpus of malformed requests gets the same
status codes, an oversized request the same 429, and ``/metrics`` the same
keys. Within the port, the reference's server scenarios: HTTP routes,
disconnect, overload shedding, drain (pinned against the reference's drain
order), a computed Retry-After, keep-alive, slow clients, the supervisor and
a short seeded chaos soak; then ``warmup``."""

import contextlib
import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving import server as jserver  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serving import (CANCELLED, FINISHED,  # noqa: E402
                                 REJECTED, EngineConfig, FaultInjector,
                                 HttpSession, InferenceEngine, OracleDraft,
                                 ServerConfig, TenantQuota, http_request,
                                 start_in_thread, stream_completion)

torch.set_num_threads(2)

HOST = "127.0.0.1"
N_SLOTS = 3
CAPACITY = 128
PAGE = 8
GEN = 8
PROMPT = list(range(1, 9))
PROMPTS = [PROMPT, [int(t) for t in np.random.default_rng(3).integers(
    0, 500, size=6)]]


@pytest.fixture(scope="module")
def weights():
    """The reference smoke llama at fp32 (seed 0) and the same weights as
    the port's params."""
    jcfg = dataclasses.replace(jsmoke("llama3.2-1b"), dtype="float32",
                               cache_dtype="float32")
    jparams = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                               dtype="float32", cache_dtype="float32")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def make_engine(weights, **overrides):
    _, _, cfg, params = weights
    drafter = overrides.pop("drafter", None)
    kw = dict(n_slots=N_SLOTS, capacity=CAPACITY, page_size=PAGE)
    kw.update(overrides)
    return InferenceEngine(cfg, params, EngineConfig(**kw), device="cpu",
                           drafter=drafter)


def make_ref_engine(weights):
    jcfg, jparams, _, _ = weights
    return JInferenceEngine(jcfg, jparams, JEngineConfig(
        n_slots=N_SLOTS, capacity=CAPACITY, page_size=PAGE))


@pytest.fixture(scope="module")
def ref_tokens(weights):
    """The port engine's ``generate`` for PROMPTS: the parity target of
    every HTTP path (greedy decode is deterministic)."""
    eng = make_engine(weights)
    out = eng.generate(PROMPTS, max_new_tokens=GEN)
    eng.check_conservation()
    assert [len(o) for o in out] == [GEN] * len(PROMPTS)
    return out


@contextlib.contextmanager
def served(engine, sc=None, warmup=(8,)):
    h = start_in_thread(engine, sc, warmup_lens=warmup)
    try:
        yield h
    finally:
        if not h.server.draining:
            h.request_drain()
        h.wait_closed(60)


def wait_until(fn, timeout=20.0, interval=0.01):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if fn():
            return True
        time.sleep(interval)
    return False


def metrics(port):
    return http_request(HOST, port, "GET", "/metrics")[2]


def post(port, payload, timeout=60):
    return http_request(HOST, port, "POST", "/v1/completions", payload,
                        timeout=timeout)


def raw_status(port, payload, read=True, timeout=10.0):
    """Send raw bytes; the status code of the reply (0 if the server just
    closed the connection)."""
    with socket.create_connection((HOST, port), timeout=timeout) as s:
        s.sendall(payload)
        s.shutdown(socket.SHUT_WR)
        raw = b""
        while read:
            try:
                chunk = s.recv(65536)
            except ConnectionError:
                break
            if not chunk:
                break
            raw += chunk
    if not raw:
        return 0
    return int(raw.split(b"\r\n")[0].split()[1])


# -- across packages ---------------------------------------------------------


@pytest.fixture(scope="module")
def both(weights):
    """The reference's server and the port's, on the same weights, each
    over its own engine; drained (conservation held) at the end."""
    jeng = make_ref_engine(weights)
    want_ref = jeng.generate(PROMPTS, max_new_tokens=GEN)
    jh = jserver.start_in_thread(jeng, warmup_lens=None)
    th = start_in_thread(make_engine(weights), warmup_lens=None)
    yield jh, th, want_ref
    for h in (jh, th):
        h.request_drain()
        h.wait_closed(60)
        assert h.server.conservation_ok


@pytest.mark.parametrize("stream", [False, True], ids=["buffered", "sse"])
def test_greedy_tokens_equal_across_servers(both, ref_tokens, stream):
    jh, th, want_ref = both
    assert want_ref == ref_tokens          # the two engines' generate
    for prompt, want in zip(PROMPTS, ref_tokens):
        got = []
        for h in (jh, th):
            payload = {"prompt": prompt, "max_tokens": GEN}
            if stream:
                r = stream_completion(HOST, h.port, payload)
                assert r.status == 200 and r.final["status"] == FINISHED
                got.append(r.tokens)
            else:
                st, _, body = post(h.port, payload)
                assert st == 200 and body["status"] == FINISHED
                got.append(body["tokens"])
        assert got == [want, want]


def malformed_corpus():
    """The reference's malformed-HTTP cases, JSON-level bad bodies, and a
    seeded set of corrupted request heads."""
    cases = [
        b"GARBAGE\r\n\r\n",
        b"\r\n\r\n",
        b"POST /v1/completions HTTP/1.1\r\nContent-Length: abc\r\n\r\n",
        b"POST /v1/completions HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
        b"POST /v1/completions HTTP/1.1\r\nContent-Length: 100\r\n\r\n"
        + b"x" * 10,
        b"POST /v1/completions HTTP/1.1\r\nContent-Length: 2000000\r\n\r\n",
        b"POST /v1/completions HTTP/1.1\r\nX-Junk: " + b"a" * 100_000
        + b"\r\n",
        b"GET /nope HTTP/1.1\r\n\r\n",
        b"GET /v1/completions HTTP/1.1\r\n\r\n",
    ]
    for body in (b"{not json", b"\xff\xfe\x00", b'{"prompt": "text"}',
                 b'{"prompt": []}', b'{"prompt": [1.5, 2.5]}',
                 b'{"prompt": ["a"]}', b'{"max_tokens": 4}', b"[1, 2, 3]"):
        cases.append(b"POST /v1/completions HTTP/1.1\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
    rng = np.random.default_rng(0)
    good = (b"POST /v1/completions HTTP/1.1\r\nContent-Length: 30\r\n\r\n"
            b'{"prompt": [1], "max_tokens": 1}')
    for _ in range(6):
        cut = int(rng.integers(1, len(good) - 1))
        junk = bytes(rng.integers(0, 256, size=8).astype(np.uint8))
        cases.append(good[:cut] + junk + b"\r\n\r\n")
    return cases


@pytest.mark.parametrize("case", range(len(malformed_corpus())))
def test_malformed_requests_get_the_same_status(both, case):
    jh, th, _ = both
    payload = malformed_corpus()[case]
    got = [raw_status(h.port, payload) for h in (jh, th)]
    assert got[0] == got[1], (payload[:80], got)
    for h in (jh, th):                      # both servers stay up
        assert http_request(HOST, h.port, "GET", "/healthz")[0] == 200


def test_oversized_request_is_429_in_both(both):
    for h in both[:2]:
        st, hdrs, body = post(h.port, {"prompt": PROMPT,
                                       "max_tokens": CAPACITY + 64})
        assert st == 429 and body["status"] == REJECTED
        assert "capacity" in body["error"]
        assert int(hdrs["retry-after"]) >= h.server.sc.retry_after_s


def test_metrics_keys_agree(both):
    jm, tm = (metrics(h.port) for h in both[:2])
    assert set(jm) == set(tm)
    # the port's engine counters are the reference's, the per-device KV
    # read count (``kv_bytes_read_device``, tensor parallelism) included
    assert set(tm["engine"]) == set(jm["engine"])
    assert jm["requests_in_flight"] == tm["requests_in_flight"] == 0


# -- within the port ---------------------------------------------------------


class TestHTTP:
    def test_health_errors_and_metrics(self, weights):
        with served(make_engine(weights)) as h:
            st, _, body = http_request(HOST, h.port, "GET", "/healthz")
            assert st == 200 and body == {"ok": True}
            st, _, body = http_request(HOST, h.port, "GET", "/readyz")
            assert st == 200 and body["ready"]
            assert http_request(HOST, h.port, "GET", "/nope")[0] == 404
            assert http_request(HOST, h.port, "GET",
                                "/v1/completions")[0] == 405
            assert post(h.port, {"prompt": "not a token list"})[0] == 400
            assert post(h.port, {"prompt": []})[0] == 400
            m = metrics(h.port)
            assert m["ready"] and not m["draining"]
            assert m["requests_in_flight"] == 0 and m["restarts"] == 0
            assert "decode_steps" in m["engine"]

    def test_parity_stream_and_nonstream(self, weights, ref_tokens):
        with served(make_engine(weights)) as h:
            st, _, body = post(h.port, {"prompt": PROMPT, "max_tokens": GEN})
            assert st == 200 and body["status"] == FINISHED
            assert body["tokens"] == ref_tokens[0]
            assert body["n_tokens"] == GEN and body["error"] == ""
            r = stream_completion(HOST, h.port,
                                  {"prompt": PROMPT, "max_tokens": GEN})
            assert r.status == 200 and r.tokens == ref_tokens[0]
            assert [e["index"] for e in r.events if "token" in e] \
                == list(range(GEN))
            assert r.final["status"] == FINISHED
            assert r.final["n_tokens"] == GEN
        assert h.server.conservation_ok

    def test_readyz_is_503_until_warmup_ends(self, weights):
        """The listener opens first: ``/readyz`` answers 503 while warmup
        runs, then 200."""
        with socket.socket() as s:
            s.bind((HOST, 0))
            port = s.getsockname()[1]
        eng = make_engine(weights)
        gate, inner = threading.Event(), eng.warmup

        def gated_warmup(*a, **kw):
            assert gate.wait(20)
            inner(*a, **kw)

        eng.warmup = gated_warmup
        holder = {}
        t = threading.Thread(target=lambda: holder.setdefault(
            "h", start_in_thread(eng, ServerConfig(port=port),
                                 warmup_lens=[8])))
        t.start()

        def readyz():
            try:
                return http_request(HOST, port, "GET", "/readyz",
                                    timeout=2)[0]
            except OSError:
                return None

        assert wait_until(lambda: readyz() is not None)
        before = readyz()
        gate.set()
        t.join(30)
        h = holder["h"]
        after = readyz()
        h.request_drain()
        h.wait_closed(30)
        assert (before, after) == (503, 200)
        assert h.server.conservation_ok


class TestDisconnect:
    def test_midstream_disconnect_cancels_and_frees_slot(self, weights):
        eng = make_engine(weights, n_slots=1)
        with served(eng) as h:
            r = stream_completion(HOST, h.port,
                                  {"prompt": PROMPT, "max_tokens": 96},
                                  disconnect_after=2)
            assert r.closed_early and len(r.tokens) == 2
            # the cancel freed the only slot: a follow-up runs to the end
            st, _, body = post(h.port, {"prompt": PROMPT, "max_tokens": 4})
            assert st == 200 and body["status"] == FINISHED
            assert wait_until(
                lambda: metrics(h.port)["requests_in_flight"] == 0)
            m = metrics(h.port)
            assert m["terminal"].get("cancelled") == 1
            assert m["disconnects"] == 1
        assert h.server.conservation_ok

    def test_shed_under_overload_is_429(self, weights):
        eng = make_engine(weights, n_slots=1, max_waiting=1,
                          fault_injector=_slow_steps(200, 0.01))
        with served(eng, warmup=None) as h:
            results = {}

            def run(name, gen):
                results[name] = post(h.port, {"prompt": PROMPT,
                                              "max_tokens": gen}, 120)

            ta = threading.Thread(target=run, args=("a", 96))
            ta.start()
            assert wait_until(
                lambda: metrics(h.port)["engine"]["active"] == 1)
            tb = threading.Thread(target=run, args=("b", 96))
            tb.start()
            assert wait_until(
                lambda: metrics(h.port)["engine"]["waiting"] == 1)
            run("c", 4)                # overflows max_waiting: b is shed
            ta.join(120)
            tb.join(120)
            st, hdrs, body = results["b"]
            assert st == 429 and body["status"] == REJECTED
            assert "shed" in body["error"]
            assert int(hdrs["retry-after"]) >= 1
            assert results["a"][0] == 200 and results["c"][0] == 200
        assert h.server.conservation_ok


def _slow_steps(n, dur):
    """A fault schedule that sleeps ``dur`` s at each of the first ``n``
    engine steps: it holds a running request in its slot long enough for
    a test to act while it runs."""
    faults = FaultInjector(seed=0)
    for s in range(n):
        faults.at(s, "slow_step", dur)
    return faults


class TestDrain:
    def test_drain_sheds_the_queue_first_and_flushes_the_stream(self,
                                                                weights):
        """The reference's drain awaits ``wait_closed`` before shedding, and
        since Python 3.12.1 that waits for the queued request's open
        connection: the stream ends, the queued request takes the slot and
        answers 200. The port sheds first: the queued request gets 429
        "server draining", the stream flushes all 64 tokens."""
        eng = make_engine(weights, n_slots=1,
                          fault_injector=_slow_steps(400, 0.02))
        with served(eng, warmup=None) as h:
            results = {}

            def stream_a():
                results["a"] = stream_completion(
                    HOST, h.port, {"prompt": PROMPT, "max_tokens": 64})

            def post_b():
                results["b"] = post(h.port, {"prompt": PROMPT,
                                             "max_tokens": 8}, 120)

            ta = threading.Thread(target=stream_a)
            ta.start()
            assert wait_until(
                lambda: metrics(h.port)["engine"]["active"] == 1)
            tb = threading.Thread(target=post_b)
            tb.start()
            assert wait_until(
                lambda: metrics(h.port)["engine"]["waiting"] == 1)
            h.request_drain()
            ta.join(120)
            tb.join(120)
            assert results["a"].final["status"] == FINISHED
            assert len(results["a"].tokens) == 64
            assert results["b"][0] == 429
            assert "draining" in results["b"][2]["error"]
            h.wait_closed(60)
            with pytest.raises(OSError):
                http_request(HOST, h.port, "GET", "/healthz", timeout=2)
        assert h.server.conservation_ok

    def test_drain_closes_idle_keep_alive_connections(self, weights):
        """An idle keep-alive connection does not hold the drain open."""
        with served(make_engine(weights),
                    ServerConfig(keepalive_idle_s=30.0)) as h:
            with HttpSession(HOST, h.port) as sess:
                assert sess.request("GET", "/healthz")[0] == 200
                t0 = time.monotonic()
                h.request_drain()
                h.wait_closed(20)
                assert time.monotonic() - t0 < 10
        assert h.server.conservation_ok


class TestRetryAfterDynamic:
    """Retry-After on 429 and 503 is occupancy-derived; the configured
    constant is only the floor."""

    def _busy(self, h, results, gen):
        def run(name):
            results[name] = post(h.port, {"prompt": PROMPT,
                                          "max_tokens": gen}, 120)

        threads = []
        for name, key in (("a", "active"), ("b", "waiting")):
            threads.append(threading.Thread(target=run, args=(name,)))
            threads[-1].start()
            assert wait_until(lambda: metrics(h.port)["engine"][key] == 1)
        return threads

    @pytest.mark.parametrize("path", ["shed_429", "draining_503"])
    def test_retry_after_tracks_occupancy(self, weights, path):
        # 1 slot, a 96-token run and a queue at a pinned 2 s a step: the
        # drain estimate is minutes, far above the 1 s floor
        eng = make_engine(weights, n_slots=1, slo_step_time=2.0,
                          max_waiting=1 if path == "shed_429" else None,
                          fault_injector=_slow_steps(300, 0.005))
        with served(eng, warmup=None) as h:
            results = {}
            threads = self._busy(h, results, 96 if path == "shed_429"
                                 else 48)
            floor = h.server.sc.retry_after_s
            if path == "shed_429":
                post(h.port, {"prompt": PROMPT, "max_tokens": 4})
                for t in threads:
                    t.join(120)
                st, hdrs, body = results["b"]
                assert st == 429 and body["status"] == REJECTED
            else:
                h.server.draining = True
                st, hdrs, _ = post(h.port, {"prompt": PROMPT,
                                            "max_tokens": 4})
                assert st == 503
                h.server.draining = False
                for t in threads:
                    t.join(120)
                assert results["a"][0] == results["b"][0] == 200
            assert int(hdrs["retry-after"]) > 10 * floor
        assert h.server.conservation_ok


class TestKeepAlive:
    def test_session_reuses_one_connection(self, weights):
        with served(make_engine(weights)) as h:
            with HttpSession(HOST, h.port) as sess:
                for _ in range(3):
                    st, hdrs, body = sess.request("GET", "/healthz")
                    assert st == 200 and body == {"ok": True}
                    assert hdrs["connection"] == "keep-alive"
                st, _, body = sess.request(
                    "POST", "/v1/completions",
                    {"prompt": PROMPT, "max_tokens": 4})
                assert st == 200 and body["status"] == FINISHED
                assert sess.reconnects == 0
        assert h.server.conservation_ok

    @pytest.mark.parametrize("sc,pause,connections", [
        (ServerConfig(max_requests_per_conn=2), 0.0,
         ["keep-alive", "close", "keep-alive"]),
        (ServerConfig(keepalive_idle_s=0.3), 1.0,
         ["keep-alive", "keep-alive", "keep-alive"]),
        (ServerConfig(keep_alive=False), 0.0, ["close", "close", "close"]),
    ], ids=["max_requests", "idle_timeout", "keep_alive_off"])
    def test_connection_ends_and_session_reconnects(self, weights, sc, pause,
                                                    connections):
        with served(make_engine(weights), sc) as h:
            with HttpSession(HOST, h.port) as sess:
                got = []
                for i in range(3):
                    if i == 2:
                        time.sleep(pause)
                    st, hdrs, _ = sess.request("GET", "/healthz")
                    assert st == 200
                    got.append(hdrs["connection"])
                assert got == connections
                assert sess.reconnects == (2 if sc.keep_alive is False
                                           else 1)
        assert h.server.conservation_ok


class TestSlowClient:
    def test_cancel_policy_disconnects_stalled_reader(self, weights):
        faults = FaultInjector(seed=0).at(0, "slow_client", 30.0)
        eng = make_engine(weights, n_slots=1, fault_injector=faults)
        sc = ServerConfig(stream_queue_max=4, slow_client_policy="cancel")
        with served(eng, sc, warmup=None) as h:
            r = stream_completion(HOST, h.port,
                                  {"prompt": PROMPT, "max_tokens": 64},
                                  timeout=60)
            assert r.final["status"] == CANCELLED
            assert len(r.tokens) < 64
            m = metrics(h.port)
            assert m["slow_client_cancels"] == 1
            assert m["max_stream_depth"] <= 4 + 1
            st, _, body = post(h.port, {"prompt": PROMPT, "max_tokens": 4})
            assert st == 200 and body["status"] == FINISHED
        assert h.server.conservation_ok

    def test_pause_policy_parks_then_resumes_bit_identical(self, weights):
        want = make_engine(weights).generate([PROMPT], max_new_tokens=24)[0]
        faults = (FaultInjector(seed=0).at(0, "slow_client", 3.0)
                  .at(1, "slow_client", 3.0))
        eng = make_engine(weights, n_slots=1, fault_injector=faults)
        sc = ServerConfig(stream_queue_max=4, slow_client_policy="pause")
        with served(eng, sc, warmup=None) as h:
            results = {}

            def stream_a():
                results["a"] = stream_completion(
                    HOST, h.port, {"prompt": PROMPT, "max_tokens": 24},
                    timeout=120)

            ta = threading.Thread(target=stream_a)
            ta.start()
            assert wait_until(
                lambda: metrics(h.port)["slow_client_pauses"] >= 1)
            assert metrics(h.port)["engine"]["paused_now"] == 1
            # the parked request released its only slot: b runs now
            st, _, body = post(h.port, {"prompt": PROMPT, "max_tokens": 4})
            assert st == 200 and body["status"] == FINISHED
            ta.join(120)
            r = results["a"]
            assert r.final["status"] == FINISHED and r.tokens == want
            m = metrics(h.port)
            assert m["engine"]["resumed"] >= 1
            assert m["engine"]["paused_now"] == 0
            assert m["max_stream_depth"] <= 4 + 1
        assert h.server.conservation_ok


class TestSupervisor:
    def test_crash_restart_resumes_bit_identical(self, weights, ref_tokens):
        faults = FaultInjector(seed=0).at(4, "crash_step")
        eng = make_engine(weights, fault_injector=faults)
        with served(eng, ServerConfig(max_restarts=3), warmup=None) as h:
            r = stream_completion(HOST, h.port,
                                  {"prompt": PROMPT, "max_tokens": GEN})
            assert r.final["status"] == FINISHED
            assert r.tokens == ref_tokens[0]
            assert h.server.host.restarts == 1
            assert eng.stats["recoveries"] == 1
            assert http_request(HOST, h.port, "GET", "/readyz")[0] == 200
        assert h.server.conservation_ok

    @pytest.mark.parametrize("failure", ["crash_every_step",
                                         "recover_raises"])
    def test_exhausted_budget_fails_open_streams(self, weights, failure):
        """Every step crashes, or (an error the process cannot clear, as a
        sticky CUDA error) the step and then ``recover`` itself raise: the
        budget ends it with the open stream FAILED, readiness 503, liveness
        200, and no loop."""
        faults = FaultInjector(seed=0)
        for s in range(64):
            faults.at(s, "crash_step")
        eng = make_engine(weights, fault_injector=faults)
        if failure == "recover_raises":
            def broken(*a, **kw):
                raise RuntimeError("CUDA error: an illegal memory access")
            eng.recover = broken
        with served(eng, ServerConfig(max_restarts=2), warmup=None) as h:
            st, _, body = post(h.port, {"prompt": PROMPT, "max_tokens": GEN})
            assert st == 500 and "supervisor gave up" in body["error"]
            assert wait_until(lambda: h.server.host.crashed, timeout=10)
            assert h.server.host.restarts == (2 if failure ==
                                              "crash_every_step" else 0)
            st, _, body = http_request(HOST, h.port, "GET", "/readyz")
            assert st == 503 and body["crashed"]
            assert http_request(HOST, h.port, "GET", "/healthz")[0] == 200
            assert post(h.port, {"prompt": PROMPT})[0] == 503
            for req in list(eng.sched.active.values()) + list(
                    eng.sched.waiting):
                eng.cancel(req.rid)
        assert h.server.conservation_ok


def test_chaos_soak(weights):
    """A seeded soak through the HTTP server: injected NaN logits, drafter
    failures, engine-side cancels, step-loop crashes and slow-client
    stalls, a rate-limited bursty tenant and mid-stream disconnects. The
    server stays up, every request reaches exactly one terminal status,
    every stream's depth respects the bound, and nothing leaks."""
    n_req, stream_max, spec_k = 40, 8, 2
    faults = FaultInjector(seed=13).random_schedule(
        2000, {"nan_logits": 0.01, "drafter": 0.04, "cancel": 0.02,
               "crash_step": 0.01, "slow_client": 0.04})
    eng = make_engine(weights, capacity=64, spec_k=spec_k,
                      fault_injector=faults, drafter=OracleDraft(),
                      tenant_quotas={"burst": TenantQuota(rate=40.0,
                                                          burst=4)})
    rng = np.random.default_rng(5)
    tenants = ("", "alpha", "burst")
    plans = []
    for i in range(n_req):
        prompt = [int(x) for x in rng.integers(
            0, eng.cfg.vocab_size, size=int(rng.integers(4, 17)))]
        u = rng.random()
        plans.append((prompt, u < 0.75,
                      int(rng.integers(1, 6)) if u < 0.2 else None,
                      tenants[i % 3]))
    results = [None] * n_req

    def client(i):
        prompt, stream, disconnect, tenant = plans[i]
        payload = {"prompt": prompt, "max_tokens": 16, "tenant": tenant}
        try:
            if stream or disconnect:
                results[i] = stream_completion(
                    HOST, h.port, payload, timeout=120,
                    disconnect_after=disconnect)
            else:
                results[i] = post(h.port, payload, 120)
        except Exception as e:  # noqa: BLE001 — recorded, asserted below
            results[i] = e

    sc = ServerConfig(max_restarts=50, stream_queue_max=stream_max,
                      slow_client_policy="pause")
    with served(eng, sc, warmup=None) as h:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_req)]
        for t in threads:
            t.start()
            time.sleep(0.005)
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert http_request(HOST, h.port, "GET", "/healthz")[0] == 200
        host = h.server.host
        assert not host.crashed and host._host_step >= 100
        for i, r in enumerate(results):
            assert not isinstance(r, Exception), (i, r)
            if isinstance(r, tuple):
                assert r[0] in (200, 408, 429, 499, 500), (i, r[0])
            elif not r.closed_early:
                assert r.final is not None, i
        assert wait_until(
            lambda: sum(host.terminal_counts.values()) == n_req)
        m = metrics(h.port)
        assert m["requests_in_flight"] == 0
        assert m["max_stream_depth"] <= stream_max + spec_k + 1
        snap = eng.stats_snapshot()
        assert sum(t["submitted"] for t in snap["tenants"].values()) == n_req
        kinds = {k for _, k, _ in faults.fired}
        assert "crash_step" in kinds and host.restarts >= 1
        assert "slow_client" in kinds
    assert h.server.conservation_ok


# -- warmup ------------------------------------------------------------------


WARMUP_VARIANTS = {
    "paged": {},
    "dense_pool": dict(page_size=0),
    "prefix": dict(prefix_cache=True),
    "speculative": dict(spec_k=2),
}


@pytest.mark.parametrize("variant", list(WARMUP_VARIANTS))
def test_warmup_changes_no_token_and_resets_stats(weights, variant):
    """Tokens after ``warmup`` equal a fresh engine's, greedy and sampled
    (the sampled paths draw from a throwaway generator); warmup leaves no
    finished request, a zeroed stats dict and an uncalibrated step time."""
    def engine():
        kw = dict(WARMUP_VARIANTS[variant])
        if kw.get("spec_k"):
            kw["drafter"] = OracleDraft()
        return make_engine(weights, **kw)

    def traffic(eng):
        greedy = eng.generate(PROMPTS, max_new_tokens=GEN)
        sampled = eng.generate(PROMPTS, max_new_tokens=GEN, temperature=1.0,
                               top_k=5)
        return greedy, sampled

    want = traffic(engine())
    eng = engine()
    eng.warmup([8, 13], suffix_lens=[8] if eng.prefix_cache else None)
    assert eng.sched.finished == [] and eng._step_time == 0.0
    assert eng.stats["decode_steps"] == eng.stats["prefills"] == 0
    assert eng.stats["tokens_generated"] == 0
    eng.check_conservation()
    assert traffic(eng) == want


def test_warmup_refuses_a_busy_engine(weights):
    eng = make_engine(weights)
    eng.submit(PROMPT, max_new_tokens=4)
    with pytest.raises(AssertionError, match="idle engine"):
        eng.warmup([8])
    eng.run()
    eng.check_conservation()

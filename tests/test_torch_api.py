"""The port's serving entry points on the CPU: ``launch/api.py`` (tenant
quota parsing against the reference's, the flags, and the CLI's SIGTERM
drain in a subprocess) and ``launch/serve.py``'s open-loop traffic
(``TrafficConfig``, ``load_trace``, ``run_traffic`` and the CLI flags)."""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.launch.api import \
    parse_tenant_quotas as jparse_tenant_quotas  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import api, serve  # noqa: E402
from repro_torch.launch.serve import (TrafficConfig, build_params,  # noqa
                                      load_trace, run_traffic)
from repro_torch.serving import (FINISHED, EngineConfig,  # noqa: E402
                                 FakeClock, InferenceEngine, http_request,
                                 stream_completion)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRACE = ROOT / "examples" / "trace_heavy_tail.jsonl"
HOST = "127.0.0.1"


@pytest.mark.parametrize("specs", [
    [],
    ["acme,rate=5,burst=10,weight=2", "free,rate=1"],
    ["solo,concurrent=2,pages=40"],
    ["bare"],
])
def test_parse_tenant_quotas_matches_reference(specs):
    got = api.parse_tenant_quotas(specs)
    want = jparse_tenant_quotas(specs)
    assert sorted(got) == sorted(want)
    for name in got:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])


@pytest.mark.parametrize("spec", [",rate=1", "acme,speed=3"])
def test_parse_tenant_quotas_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        jparse_tenant_quotas([spec])
    with pytest.raises(ValueError):
        api.parse_tenant_quotas([spec])


def test_api_flags():
    args = api.parse_args(["--arch", "llama3.2-1b"])
    assert args.device == "cuda" and args.mesh_model == 1
    assert args.attn_impl == "" and not hasattr(args, "impl")
    # tensor parallelism needs its ranks' devices: one card a rank unless
    # a list is given, so on a machine with too few cards it raises before
    # any weight is built, never falling back to the CPU or to mesh 1
    args = api.parse_args(["--arch", "llama3.2-1b", "--smoke", "--device",
                           "cpu", "--page-size", "8", "--mesh-model", "2"])
    assert args.mesh_model == 2 and args.mesh_devices == ""
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA devices visible"):
            api.build_server(args)
    args = api.parse_args(["--arch", "llama3.2-1b", "--mesh-model", "2",
                           "--mesh-devices", "cuda:0,cuda:0"])
    assert args.mesh_devices == "cuda:0,cuda:0"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _wait(fn, timeout, interval=0.1):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if fn():
            return True
        time.sleep(interval)
    return False


def test_api_cli_sigterm_drains_and_exits_zero():
    """``python -m repro_torch.launch.api`` on the CPU: ready after warmup,
    a stream and a buffered completion served, then SIGTERM mid-stream:
    the stream flushes in full, the process prints ``drained; conservation
    ok`` and exits 0."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.api", "--arch",
         "llama3.2-1b", "--smoke", "--device", "cpu", "--slots", "2",
         "--page-size", "8", "--port", str(port), "--warmup-lens", "8"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def ready():
        try:
            return http_request(HOST, port, "GET", "/readyz",
                                timeout=2)[0] == 200
        except OSError:
            return False

    try:
        assert _wait(ready, timeout=25), "server never became ready"
        st, _, body = http_request(HOST, port, "POST", "/v1/completions",
                                   {"prompt": [1, 2, 3], "max_tokens": 4})
        assert st == 200 and body["n_tokens"] == 4
        result = {}
        ta = threading.Thread(target=lambda: result.setdefault(
            "a", stream_completion(HOST, port, {"prompt": [1, 2, 3],
                                                "max_tokens": 64},
                                   timeout=30)))
        ta.start()
        assert _wait(lambda: http_request(HOST, port, "GET", "/metrics")[2]
                     ["requests_in_flight"] >= 1, timeout=10, interval=0.01)
        proc.send_signal(signal.SIGTERM)
        ta.join(30)
        assert result["a"].final["status"] == FINISHED
        assert result["a"].tokens == body["tokens"] + result["a"].tokens[4:]
        assert len(result["a"].tokens) == 64
        out, _ = proc.communicate(timeout=20)
        assert proc.returncode == 0, out
        assert "drained; conservation ok" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- open-loop traffic -------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"),
                              bcr_keep_frac=0.25, bcr_block=(16, 16))
    return cfg, build_params(cfg, log=lambda *_: None, device="cpu")


def _engine(smoke, clock=None, **kw):
    cfg, params = smoke
    ec = dict(n_slots=4, capacity=64, page_size=8)
    ec.update(kw)
    return InferenceEngine(cfg, params, EngineConfig(**ec), device="cpu",
                           clock=clock)


# a step of the trace replay on the fake clock: the engine's work takes
# this long, whatever the machine's load
TRACE_STEP_S = 0.01


def test_load_trace_reads_the_example_and_rejects_bad_traces(tmp_path):
    trace = load_trace(str(TRACE))
    assert len(trace) == 36 and all("t" in r for r in trace)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"t": 1.0}\n{"t": 0.5}\n')
    with pytest.raises(ValueError, match="non-decreasing"):
        load_trace(str(bad))
    bad.write_text('# comment\n{"prompt_len": 4}\n')
    with pytest.raises(ValueError, match="needs 't'"):
        load_trace(str(bad))


@pytest.mark.parametrize("mode", ["poisson", "trace"])
def test_run_traffic_finishes_everything_and_leaks_nothing(smoke, mode):
    """Poisson arrivals at 2000 req/s (no idle sleep) on the wall clock, and
    the example trace replayed at its own offsets on a ``FakeClock`` that
    each engine step advances by ``TRACE_STEP_S`` (so the trace's 1.37–3.9
    s deadlines are met or missed by the schedule, not by the machine's
    load): every request FINISHED, every token counted, the percentiles
    filled in, no page leaked."""
    if mode == "poisson":
        eng = _engine(smoke)
    else:
        clk = FakeClock()
        eng = _engine(smoke, clock=clk)
        step = eng.step

        def timed_step():
            clk.advance(TRACE_STEP_S)
            return step()

        eng.step = timed_step
    if mode == "poisson":
        tc = TrafficConfig(n_requests=12, rate=2000.0, prompt_lens=(4, 9),
                           gen_tokens=6, tenants=("a", "b"))
    else:
        tc = TrafficConfig(trace=load_trace(str(TRACE)))
    m = run_traffic(eng, tc, log=lambda *_: None)
    n = 12 if mode == "poisson" else 36
    assert m["n_requests"] == n
    assert m["status_counts"]["finished"] == n
    assert sum(m["status_counts"].values()) == n
    want = (12 * 6 if mode == "poisson"
            else sum(r["max_new_tokens"] for r in tc.trace))
    assert m["total_tokens"] == want
    assert 0 < m["ttft_s"]["p50"] <= m["ttft_s"]["p99"]
    assert 0 < m["per_token_s"]["p50"] <= m["per_token_s"]["p99"]
    assert 0 < m["mean_slot_occupancy"] <= 4
    if mode == "poisson":
        assert m["tenants"]["a"]["finished"] == 6
        assert m["elapsed_s"] < 10
    eng.check_conservation()


def test_run_traffic_cancels_and_clamps(smoke):
    """Client-side cancels retire as CANCELLED — the run ends when a cancel
    empties the engine after the last arrival (the reference's loop then
    indexes past its arrivals) — and a trace record larger than its slot
    is clamped to fit instead of rejected."""
    eng = _engine(smoke, capacity=128)
    tc = TrafficConfig(n_requests=10, rate=2000.0, prompt_lens=(4,),
                       gen_tokens=120, cancel_rate=1.0)
    m = run_traffic(eng, tc, log=lambda *_: None)
    assert m["status_counts"]["cancelled"] + m["status_counts"][
        "finished"] == 10 and m["status_counts"]["cancelled"] > 0
    eng.check_conservation()
    eng = _engine(smoke, capacity=32)
    tc = TrafficConfig(trace=[{"t": 0.0, "prompt_len": 500,
                               "max_new_tokens": 8}], warmup=False)
    m = run_traffic(eng, tc, log=lambda *_: None)
    assert m["status_counts"]["finished"] == 1
    assert eng.sched.finished[-1].prompt_len == 32 - 8
    eng.check_conservation()


def test_serve_cli_open_loop_writes_json(tmp_path, monkeypatch, capsys):
    out = tmp_path / "metrics.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
        "--slots", "2", "--capacity", "64", "--requests", "6", "--gen", "4",
        "--prompt-len", "8", "--rate", "1000", "--json-out", str(out)])
    serve.main()
    m = json.loads(out.read_text())
    assert m["n_requests"] == 6 and m["status_counts"]["finished"] == 6
    assert "TTFT p50/p95/p99" in capsys.readouterr().out


# -- tensor parallelism through the entry points -------------------------


def _tp_smoke():
    cfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-3b"),
                              bcr_keep_frac=0.5, bcr_block=(16, 16))
    return cfg, build_params(cfg, log=lambda *_: None, device="cpu")


def test_serve_cli_mesh_model_starts_and_stops_its_ranks(monkeypatch,
                                                         capsys):
    """``--mesh-model 2 --mesh-devices cpu,cpu``: one command starts rank
    1, serves through both ranks and stops it (no process group left)."""
    import torch.distributed as dist
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
        "--requests", "4", "--gen", "4", "--bcr-keep", "0.5",
        "--page-size", "8", "--mesh-model", "2", "--mesh-devices",
        "cpu,cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "status: finished 4 / timeout 0" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("mesh 2:"))
    total, per_rank = [int(w) for w in line.split() if w.isdigit()]
    assert per_rank * 2 == total
    assert not dist.is_initialized()


def test_http_server_on_two_ranks_drains_and_stops_them():
    """The HTTP server over a mesh-2 engine on CPU ranks: the tokens of a
    completion equal the mesh-1 engine's, and the drain stops rank 1."""
    cfg, params = _tp_smoke()
    ec = dict(n_slots=2, capacity=32, page_size=8)
    want = InferenceEngine(cfg, params, EngineConfig(**ec),
                           device="cpu").generate([[1, 2, 3]],
                                                  max_new_tokens=6)[0]
    eng = InferenceEngine(cfg, params, EngineConfig(
        **ec, mesh_model=2, mesh_devices=("cpu", "cpu")), device="cpu")
    procs = list(eng.group._procs)
    from repro_torch.serving import start_in_thread
    h = start_in_thread(eng, warmup_lens=[3])    # warmup on both ranks
    try:
        st, _, body = http_request(HOST, h.port, "POST", "/v1/completions",
                                   {"prompt": [1, 2, 3], "max_tokens": 6})
        assert st == 200 and body["tokens"] == want
    finally:
        h.request_drain()
        h.wait_closed(60)
    assert h.server.conservation_ok
    for p in procs:
        p.join(30)
        assert not p.is_alive()
    assert eng.group is None

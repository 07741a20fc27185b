"""Fault-tolerant asyncio HTTP front end over the port's InferenceEngine.

Stdlib only (``asyncio`` streams and hand-parsed HTTP/1.1): a copy of the
reference package's ``serving/server.py``, which the port cannot import,
with the same routes, status codes, JSON bodies and ``/metrics`` keys, so
one client drives either package. Two halves:

``EngineHost`` — a supervised engine thread. Only it calls ``step()``;
``submit``/``cancel`` take the host lock, then the engine's reentrant lock,
and wake the loop. After every step the host pumps
``engine.poll(trim=True)`` once and fans tokens and terminal events out to
per-request ``asyncio.Queue``s through ``loop.call_soon_threadsafe``. A
step loop that raises (an injected ``crash_step``, or the ``StepWatchdog``
flagging it wedged via ``slow_steps_restart``) restarts in place through
``engine.recover()`` — running requests fold their tokens into their
prompts and requeue — up to ``max_restarts`` crashes per
``restart_window_s``; past that the host fails every open stream and stops.
A ``recover()`` that itself raises counts as a crash of the same budget, so
an error the process cannot clear (a sticky CUDA error) ends in FAILED
streams, not a loop. On the card the host thread makes the engine's device
its current one before its first step: kernels launch through ctypes on the
calling thread's current device and stream.

Slow-client backpressure: past ``stream_queue_max`` undelivered tokens a
stream is cancelled (``slow_client_policy="cancel"``) or parked out of its
slot (``"pause"``) until it drains below half the mark; re-prefill replays
the folded tokens bit-identically under greedy. The ``slow_client`` fault
withholds delivery to one stream to simulate such a reader.

``InferenceServer`` — the asyncio HTTP server:

==========================  ================================================
``POST /v1/completions``    JSON {prompt, max_tokens, temperature, top_k,
                            deadline_s, priority, tenant, eos_id, stream}.
                            With ``stream: true`` tokens arrive as SSE
                            events; otherwise one JSON body at the end.
``GET /healthz``            liveness — 200 while the process serves at all.
``GET /readyz``             readiness — 200 only after ``warmup()`` and
                            while not draining or crashed, else 503.
``GET /metrics``            one-lock snapshot of ``engine.stats`` plus
                            ``requests_in_flight``, ``uptime_s``, restart
                            and terminal-status counters.
==========================  ================================================

Terminal status → HTTP: FINISHED 200, REJECTED 429 (with ``Retry-After``),
TIMEOUT 408, FAILED 500, CANCELLED 499 (never sent: the client is gone).
Every ``Retry-After`` is the engine's occupancy-derived drain estimate
floored at ``ServerConfig.retry_after_s``. A mid-stream disconnect cancels
the request, so its slot and pages free within one step. Connections are
keep-alive (until ``Connection: close``, ``keepalive_idle_s`` idle, or
``max_requests_per_conn``); SSE responses close theirs.

Graceful drain (SIGTERM in ``serve_forever`` / ``launch/api.py``):
readiness flips false, the listener closes, the waiting queue is shed as
REJECTED (429 "server draining"), running requests finish and flush their
streams, idle keep-alive connections close, ``check_conservation()``
verifies nothing leaked, and ``engine.close()`` stops a tensor-parallel
engine's other ranks. The queue is shed before anything waits on open
connections: since Python 3.12.1 ``asyncio.Server.wait_closed`` also waits
for every open connection, so awaiting it first (as the reference's
``drain`` does) holds the queued request's connection open until the
running stream ends, and the queued request then takes the freed slot and
answers 200 instead of 429.

Blocking clients (``http_request``, ``stream_completion`` and the
connection-reusing ``HttpSession``), plain sockets, ship here too.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import signal
import socket
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import (CANCELLED, FAILED, FINISHED,
                                           REJECTED, TIMEOUT)

#: terminal Request.status → HTTP status code. CANCELLED's 499 (client
#: closed request, nginx convention) is bookkeeping only: by definition
#: nobody is left to receive it.
STATUS_HTTP = {FINISHED: 200, REJECTED: 429, TIMEOUT: 408, FAILED: 500,
               CANCELLED: 499}

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            413: "Payload Too Large", 429: "Too Many Requests",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}


@dataclasses.dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 0                      # 0 → ephemeral (tests/bench)
    max_body_bytes: int = 1 << 20
    default_max_tokens: int = 16
    # FLOOR for the computed Retry-After on 429/503: the actual header
    # value is the engine's occupancy-derived drain estimate, never less
    # than this (and exactly this when the estimator is uncalibrated)
    retry_after_s: int = 1
    # supervisor budget: more than max_restarts crashes inside any
    # restart_window_s window → give up (fail open streams, readyz 503)
    max_restarts: int = 3
    restart_window_s: float = 60.0
    # watchdog escalation: restart the step loop once this many NEW
    # watchdog-flagged slow steps accumulate (0 → off)
    slow_steps_restart: int = 0
    idle_sleep_s: float = 0.02         # mailbox poll interval when idle
    drain_grace_s: float = 30.0        # max wait for in-flight streams
    # slow-client backpressure: a stream whose undelivered-token depth
    # (queued + withheld) exceeds stream_queue_max triggers the policy —
    # "cancel" retires the request (disconnect-as-cancel), "pause" parks
    # it out of its slot until the queue drains below stream_queue_max/2.
    # 0 disables the bound (the pre-backpressure unbounded behavior).
    stream_queue_max: int = 256
    slow_client_policy: str = "cancel"   # "cancel" | "pause"
    # HTTP keep-alive: loop requests per connection until the client sends
    # Connection: close, keepalive_idle_s passes between requests, or
    # max_requests_per_conn are served. SSE responses always close.
    keep_alive: bool = True
    keepalive_idle_s: float = 5.0
    max_requests_per_conn: int = 100


class _Sub:
    """Per-request subscriber state: the event loop + queue tokens fan out
    to, how many tokens were delivered, and the slow-client bookkeeping
    (an injected stall deadline, and whether the request is parked)."""

    __slots__ = ("loop", "q", "emitted", "stall_until", "paused")

    def __init__(self, loop: asyncio.AbstractEventLoop, q: asyncio.Queue):
        self.loop = loop
        self.q = q
        self.emitted = 0
        self.stall_until = 0.0         # monotonic deadline of injected stall
        self.paused = False            # parked by the "pause" policy


class EngineHost:
    """Supervised engine thread + cross-thread mailbox.

    Lock order is host lock → engine lock, everywhere: ``submit`` holds the
    host lock across ``engine.submit`` *and* subscriber registration so the
    pump (which also takes the host lock) can never consume a synchronously
    REJECTED request's terminal event before its queue exists. The pump
    itself is the only consumer of ``engine.poll(trim=True)``, and is also
    where slow-client backpressure engages: per-stream depth is measured
    and the pause/cancel policy applied under the same host lock.
    """

    def __init__(self, engine: InferenceEngine, sc: ServerConfig):
        self.engine = engine
        self.sc = sc
        self._lock = threading.Lock()
        self._subs: Dict[int, _Sub] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.terminal_counts: Counter = Counter()
        self.restarts = 0
        self.crashed = False           # supervisor gave up
        self.slow_client_cancels = 0
        self.slow_client_pauses = 0
        self.max_stream_depth = 0      # high-water mark across all streams
        self._crash_times: List[float] = []
        self._host_step = 0            # step-attempt counter (crash_step idx)
        self._slow_mark = 0
        self._thread: Optional[threading.Thread] = None

    # -- mailbox (event-loop side) -----------------------------------------

    def submit(self, loop: asyncio.AbstractEventLoop, q: asyncio.Queue,
               **kw: Any) -> int:
        """Submit a request and register its subscriber queue atomically."""
        with self._lock:
            rid = self.engine.submit(**kw)
            self._subs[rid] = _Sub(loop, q)
        self._wake.set()
        return rid

    def cancel(self, rid: int) -> None:
        with self._lock:
            self.engine.cancel(rid)
        self._wake.set()

    def unsubscribe(self, rid: int) -> None:
        """Detach a disconnected client; the request's terminal event is
        still counted by the pump, just delivered to nobody."""
        with self._lock:
            self._subs.pop(rid, None)

    def open_streams(self) -> int:
        with self._lock:
            return len(self._subs)

    def begin_drain(self) -> int:
        """Shed the waiting queue as REJECTED (delivered through the normal
        pump path, so queued clients get their 429s) and wake the loop."""
        with self._lock:
            shed = self.engine.shed_waiting("server draining")
        self._wake.set()
        return len(shed)

    # -- engine thread ------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-host")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        if self.engine.device.type == "cuda":
            # kernels launch through ctypes on this thread's current device
            torch.cuda.set_device(self.engine.device)
        restart = False
        while not self._stop.is_set():
            try:
                if restart:
                    # in-place restart: the page pool survives, running
                    # requests fold and requeue, the prefix index resets
                    self.engine.recover()
                    self.restarts += 1
                    restart = False
                self._drive()
            except Exception as e:  # crashed step loop → supervisor
                if not self._note_crash():
                    self._fail_open_streams(
                        f"engine supervisor gave up: {e}")
                    self.crashed = True
                    return
                restart = True

    def _drive(self) -> None:
        """The supervised single-writer step loop."""
        while not self._stop.is_set():
            if not self.engine.sched.has_work():
                # idle housekeeping: parked (PAUSED) requests generate no
                # steps, so their deadlines are reaped here and the pump
                # still runs (a draining client can un-pause its request)
                self.engine.reap()
                self._pump()
                self._wake.wait(self.sc.idle_sleep_s)
                self._wake.clear()
                continue
            faults = self.engine.faults
            step_no = self._host_step
            self._host_step += 1       # pre-increment: a restart must not
            if faults is not None and faults.fires(step_no, "crash_step"):
                faults.record(step_no, "crash_step")  # re-fire the fault
                raise RuntimeError("injected step-loop crash")
            if faults is not None and faults.fires(step_no, "slow_client"):
                self._stall_one(step_no)
            self.engine.step()
            self._pump()
            if self.sc.slow_steps_restart > 0:
                slow = self.engine.stats.get("watchdog_slow_steps", 0)
                if slow - self._slow_mark >= self.sc.slow_steps_restart:
                    self._slow_mark = slow
                    raise RuntimeError(
                        "watchdog: step loop flagged wedged")
        self._pump()                   # flush events raced with stop()

    def _stall_one(self, step_no: int) -> None:
        """``slow_client`` fault: withhold delivery to one open stream for
        the scheduled duration, simulating a reader that stopped draining
        its socket — the per-stream depth then grows until the
        backpressure policy engages."""
        faults = self.engine.faults
        with self._lock:
            rids = sorted(self._subs)
            if not rids:
                return
            rid = rids[faults.choose(len(rids))]
            dur = faults.arg(step_no, "slow_client") or 0.25
            self._subs[rid].stall_until = time.monotonic() + dur
            faults.record(step_no, "slow_client", rid)

    def _pump(self) -> None:
        """Fan engine progress out to subscriber queues (one poll, one host
        lock). Terminal events are counted whether or not anyone is still
        listening — a disconnected client's request still resolves.

        Backpressure: per stream, depth = tokens sitting in the asyncio
        queue + tokens withheld by an (injected) stall. Depth past
        ``stream_queue_max`` triggers the slow-client policy; a paused
        stream resumes once depth drains to half the high-water mark.
        Depth can overshoot the mark by at most one step's token commit
        (spec_k + 1), since the policy runs after every step."""
        hw = self.sc.stream_queue_max
        with self._lock:
            now = time.monotonic()
            _, live, fin = self.engine.poll(trim=True)
            for rid, toks in live:
                sub = self._subs.get(rid)
                if sub is None:
                    continue
                if now >= sub.stall_until:
                    self._push(sub, toks)
                depth = sub.q.qsize() + (len(toks) - sub.emitted)
                if depth > self.max_stream_depth:
                    self.max_stream_depth = depth
                if hw <= 0:
                    continue
                if depth > hw and not sub.paused:
                    self._backpressure(rid, sub)
                elif sub.paused and depth <= hw // 2:
                    if self.engine.resume(rid):
                        sub.paused = False
            for rid, toks, status, error, retry_after in fin:
                self.terminal_counts[status] += 1
                sub = self._subs.pop(rid, None)
                if sub is None:
                    continue
                self._push(sub, toks)
                self._send(sub, ("done", status, error, retry_after))

    def _backpressure(self, rid: int, sub: _Sub) -> None:
        """Apply the slow-client policy to one over-watermark stream.
        Called under the host lock; engine calls below respect the
        host → engine lock order."""
        if self.sc.slow_client_policy == "pause":
            if self.engine.pause(rid):
                sub.paused = True
                self.slow_client_pauses += 1
        else:
            # disconnect-as-cancel: the request retires (slot + pages free
            # within a step); the sub stays registered so a reader that
            # eventually drains still sees the CANCELLED terminal event
            self.slow_client_cancels += 1
            self.engine.cancel(rid)

    @staticmethod
    def _push(sub: _Sub, toks: List[int]) -> None:
        for tok in toks[sub.emitted:]:
            try:
                sub.loop.call_soon_threadsafe(sub.q.put_nowait,
                                              ("token", tok))
            except RuntimeError:       # loop already closed (shutdown race)
                return
        sub.emitted = len(toks)

    @staticmethod
    def _send(sub: _Sub, item: Tuple) -> None:
        try:
            sub.loop.call_soon_threadsafe(sub.q.put_nowait, item)
        except RuntimeError:
            pass

    def _note_crash(self) -> bool:
        """Record a crash; True if the restart budget still allows one."""
        now = time.monotonic()
        self._crash_times = [t for t in self._crash_times
                             if now - t < self.sc.restart_window_s]
        self._crash_times.append(now)
        return len(self._crash_times) <= self.sc.max_restarts

    def _fail_open_streams(self, reason: str) -> None:
        with self._lock:
            for sub in self._subs.values():
                self._send(sub, ("done", FAILED, reason, 0.0))
            self._subs.clear()


class InferenceServer:
    """Asyncio HTTP server bridging clients to an :class:`EngineHost`."""

    def __init__(self, engine: InferenceEngine,
                 sc: Optional[ServerConfig] = None):
        self.engine = engine
        self.sc = sc or ServerConfig()
        self.host = EngineHost(engine, self.sc)
        self.ready = False
        self.draining = False
        self.port: Optional[int] = None
        self.disconnects = 0
        self.conservation_ok: Optional[bool] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._t0 = time.monotonic()
        self._closed: Optional[asyncio.Event] = None
        # connections waiting for their next request head (closed at drain)
        self._idle: Set[asyncio.StreamWriter] = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self, warmup_lens: Optional[Sequence[int]] = None
                    ) -> None:
        """Open the listener FIRST (so ``/readyz`` answers 503 during
        warmup instead of refusing connections), warm up off the event
        loop (kernel builds and first launches, on an executor thread that
        ``warmup`` points at the engine's card), then start the engine
        thread and flip readiness."""
        self._closed = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle, self.sc.host, self.sc.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if warmup_lens:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, lambda: self.engine.warmup(list(warmup_lens)))
        self.host.start()
        self._t0 = time.monotonic()
        self.ready = True

    async def drain(self) -> None:
        """Graceful shutdown: stop accepting, shed the queue, let running
        requests finish and their streams flush, close idle keep-alive
        connections and wait for the listener, verify conservation. The
        queue is shed before anything waits on open connections (see the
        module docstring)."""
        if self.draining:
            return
        self.draining = True
        self.ready = False
        if self._server is not None:
            self._server.close()
        self.host.begin_drain()
        deadline = time.monotonic() + self.sc.drain_grace_s
        while time.monotonic() < deadline:
            if (not self.engine.sched.has_work()
                    and self.host.open_streams() == 0):
                break
            await asyncio.sleep(0.01)
        self.host.stop()
        if self._server is not None:
            # wait_closed also waits for every open connection: close the
            # idle ones until it returns (a connection can turn idle after
            # its last response), within the drain grace
            closing = asyncio.ensure_future(self._server.wait_closed())
            while not closing.done() and time.monotonic() < deadline:
                for writer in list(self._idle):
                    writer.close()
                await asyncio.wait({closing}, timeout=0.05)
            if not closing.done():
                closing.cancel()
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, self.engine.check_conservation)
            self.conservation_ok = True
        except AssertionError:
            self.conservation_ok = False
            raise
        finally:
            # a tensor-parallel engine's other ranks stop with the server
            self.engine.close()
            if self._closed is not None:
                self._closed.set()

    async def serve_forever(self, warmup_lens: Optional[Sequence[int]] = None
                            ) -> None:
        """Start, install SIGTERM/SIGINT → graceful drain, block until
        drained. This is what ``launch/api.py`` runs."""
        await self.start(warmup_lens)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(
                sig, lambda: asyncio.ensure_future(self.drain()))
        await self._closed.wait()

    # -- HTTP plumbing ------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """Connection loop — hand-parsed HTTP/1.1 with keep-alive: serve
        requests off one connection until the client asks to close, the
        idle timeout fires, or ``max_requests_per_conn`` are served.
        Malformed input (truncated body, bad request line, oversized
        headers, non-integer Content-Length) gets a 4xx where a response
        is still possible, then the connection closes — the server itself
        never comes down."""
        try:
            served = 0
            while not (self.draining and served):
                idle = 10.0 if served == 0 else self.sc.keepalive_idle_s
                self._idle.add(writer)
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"), timeout=idle)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionError):
                    return             # idle close / client went away
                except asyncio.LimitOverrunError:
                    await self._respond(writer, 431,
                                        {"error": "headers too large"})
                    return
                finally:
                    self._idle.discard(writer)
                lines = head.decode("latin-1").split("\r\n")
                parts = lines[0].split()
                if len(parts) < 2:
                    await self._respond(writer, 400,
                                        {"error": "malformed request line"})
                    return
                method, path = parts[0].upper(), parts[1].split("?")[0]
                headers = {}
                for ln in lines[1:]:
                    if ":" in ln:
                        k, v = ln.split(":", 1)
                        headers[k.strip().lower()] = v.strip()
                try:
                    clen = int(headers.get("content-length", "0") or 0)
                    if clen < 0:
                        raise ValueError(clen)
                except ValueError:
                    await self._respond(writer, 400,
                                        {"error": "bad Content-Length"})
                    return
                if clen > self.sc.max_body_bytes:
                    await self._respond(writer, 413,
                                        {"error": "body too large"})
                    return
                try:
                    body = (await asyncio.wait_for(reader.readexactly(clen),
                                                   timeout=10.0)
                            if clen else b"")
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionError):
                    # premature EOF mid-body: framing is lost — answer if
                    # the socket still writes, then drop the connection
                    await self._respond(writer, 400,
                                        {"error": "truncated body"})
                    return
                served += 1
                keep = (self.sc.keep_alive and not self.draining
                        and headers.get("connection", "").lower() != "close"
                        and served < self.sc.max_requests_per_conn)
                if not await self._route(method, path, body, reader,
                                         writer, keep):
                    return
        except ConnectionError:
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter,
                     keep: bool = False) -> bool:
        """Dispatch one request; returns True iff the connection may serve
        another (keep-alive granted and the response was Content-Length
        framed — SSE streams always close)."""
        if path == "/healthz":
            await self._respond(writer, 200, {"ok": True}, keep=keep)
        elif path == "/readyz":
            up = self.ready and not self.draining and not self.host.crashed
            await self._respond(
                writer, 200 if up else 503,
                {"ready": up, "draining": self.draining,
                 "crashed": self.host.crashed}, keep=keep)
        elif path == "/metrics":
            await self._respond(writer, 200, await self._metrics(),
                                keep=keep)
        elif path == "/v1/completions":
            if method != "POST":
                await self._respond(writer, 405,
                                    {"error": "POST required"}, keep=keep)
                return keep
            return await self._completions(body, reader, writer, keep)
        else:
            await self._respond(writer, 404, {"error": "not found"},
                                keep=keep)
        return keep

    async def _metrics(self) -> Dict[str, Any]:
        loop = asyncio.get_running_loop()
        snap = await loop.run_in_executor(None, self.engine.stats_snapshot)
        return {
            "uptime_s": time.monotonic() - self._t0,
            "ready": self.ready,
            "draining": self.draining,
            "requests_in_flight": snap["active"] + snap["waiting"],
            "open_streams": self.host.open_streams(),
            "restarts": self.host.restarts,
            "disconnects": self.disconnects,
            "slow_client_cancels": self.host.slow_client_cancels,
            "slow_client_pauses": self.host.slow_client_pauses,
            "max_stream_depth": self.host.max_stream_depth,
            "terminal": {k.lower(): v
                         for k, v in self.host.terminal_counts.items()},
            "tenants": snap.get("tenants", {}),
            "engine": snap,
        }

    def _retry_after(self, est: float = 0.0) -> int:
        """Computed Retry-After: the occupancy-derived estimate (the
        request's own, or a fresh drain estimate when none rode along),
        floored at the configured constant."""
        if est <= 0:
            est = self.engine.retry_after_estimate()
        return max(int(self.sc.retry_after_s), int(math.ceil(est)))

    async def _completions(self, body: bytes,
                           reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           keep: bool = False) -> bool:
        if not self.ready or self.draining or self.host.crashed:
            loop = asyncio.get_running_loop()
            ra = await loop.run_in_executor(None, self._retry_after)
            await self._respond(
                writer, 503, {"error": "not ready"},
                extra={"Retry-After": str(ra)}, keep=keep)
            return keep
        try:
            req = json.loads(body.decode("utf-8"))
            prompt = req["prompt"]
            assert (isinstance(prompt, list) and prompt
                    and all(isinstance(t, int) for t in prompt))
        except Exception:
            await self._respond(
                writer, 400,
                {"error": "body must be JSON with a non-empty integer "
                          "list 'prompt'"}, keep=keep)
            return keep
        kw = dict(
            prompt=prompt,
            max_new_tokens=int(req.get("max_tokens",
                                       self.sc.default_max_tokens)),
            temperature=float(req.get("temperature", 0.0)),
            top_k=int(req.get("top_k", 0)),
            deadline_s=float(req.get("deadline_s", 0.0)),
            priority=int(req.get("priority", 0)),
            tenant=str(req.get("tenant", "")),
            eos_id=req.get("eos_id"))
        stream = bool(req.get("stream", False))
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        # off-loop: host.submit takes host+engine locks and the engine lock
        # can be held for a whole step
        rid = await loop.run_in_executor(
            None, lambda: self.host.submit(loop, q, **kw))
        if stream:
            await self._stream(rid, q, reader, writer)
            return False               # SSE responses close the connection
        await self._buffered(rid, q, writer, keep)
        return keep

    async def _buffered(self, rid: int, q: asyncio.Queue,
                        writer: asyncio.StreamWriter,
                        keep: bool = False) -> None:
        tokens: List[int] = []
        while True:
            item = await q.get()
            if item[0] == "token":
                tokens.append(item[1])
            else:
                _, status, error, retry_after = item
                break
        code = STATUS_HTTP.get(status, 500)
        extra = ({"Retry-After": str(self._retry_after(retry_after))}
                 if code == 429 else None)
        await self._respond(writer, code,
                            {"rid": rid, "status": status, "error": error,
                             "tokens": tokens, "n_tokens": len(tokens)},
                            extra=extra, keep=keep)

    async def _stream(self, rid: int, q: asyncio.Queue,
                      reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """SSE: one ``data:`` event per token, a final status event, then
        ``data: [DONE]``. A socket that goes readable-EOF mid-stream is a
        disconnected client → ``engine.cancel`` frees the slot and pages
        within one step."""
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        get = asyncio.ensure_future(q.get())
        watch = asyncio.ensure_future(reader.read(1))
        idx = 0
        try:
            while True:
                done, _ = await asyncio.wait(
                    {get, watch}, return_when=asyncio.FIRST_COMPLETED)
                if watch in done:       # EOF (or stray bytes) → disconnect
                    self._disconnect(rid)
                    return
                item = get.result()
                try:
                    if item[0] == "token":
                        self._sse(writer, {"rid": rid, "index": idx,
                                           "token": item[1]})
                        idx += 1
                        await writer.drain()
                        get = asyncio.ensure_future(q.get())
                    else:
                        _, status, error, retry_after = item
                        self._sse(writer, {"rid": rid, "status": status,
                                           "error": error,
                                           "retry_after": retry_after,
                                           "n_tokens": idx})
                        writer.write(b"data: [DONE]\n\n")
                        await writer.drain()
                        return
                except ConnectionError:
                    self._disconnect(rid)
                    return
        finally:
            for task in (get, watch):
                task.cancel()
                try:
                    task.exception()   # consume (e.g. ConnectionReset on
                except (asyncio.CancelledError,  # the watch read)
                        asyncio.InvalidStateError):
                    pass

    def _disconnect(self, rid: int) -> None:
        self.disconnects += 1
        # unsubscribe FIRST so the terminal event is counted but not
        # delivered to a dead queue, then cancel (idempotent if the
        # request already finished between the EOF and here)
        self.host.unsubscribe(rid)
        self.host.cancel(rid)

    @staticmethod
    def _sse(writer: asyncio.StreamWriter, obj: Dict[str, Any]) -> None:
        writer.write(b"data: " + json.dumps(obj).encode() + b"\n\n")

    async def _respond(self, writer: asyncio.StreamWriter, code: int,
                       obj: Dict[str, Any],
                       extra: Optional[Dict[str, str]] = None,
                       keep: bool = False) -> None:
        body = json.dumps(obj).encode()
        conn = "keep-alive" if keep else "close"
        head = (f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: {conn}\r\n")
        for k, v in (extra or {}).items():
            head += f"{k}: {v}\r\n"
        writer.write(head.encode() + b"\r\n" + body)
        try:
            await writer.drain()
        except ConnectionError:
            pass


# ---------------------------------------------------------------------------
# Thread harness (tests / benchmarks): run the server off the main thread
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServerHandle:
    """Handle to a server running in a background thread."""

    server: InferenceServer
    thread: threading.Thread
    loop: asyncio.AbstractEventLoop

    @property
    def port(self) -> int:
        return self.server.port  # type: ignore[return-value]

    def request_drain(self) -> None:
        """Trigger graceful drain from any thread (non-blocking)."""
        asyncio.run_coroutine_threadsafe(self.server.drain(), self.loop)

    def wait_closed(self, timeout: Optional[float] = None) -> None:
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise TimeoutError("server thread did not exit")


def start_in_thread(engine: InferenceEngine,
                    sc: Optional[ServerConfig] = None,
                    warmup_lens: Optional[Sequence[int]] = None
                    ) -> ServerHandle:
    """Start an :class:`InferenceServer` on a daemon thread and block until
    it is ready (listener open, warmup done, engine thread running)."""
    srv = InferenceServer(engine, sc)
    started = threading.Event()
    holder: Dict[str, Any] = {}

    def _main() -> None:
        async def amain() -> None:
            try:
                await srv.start(warmup_lens)
                holder["loop"] = asyncio.get_running_loop()
            except BaseException as e:  # surface startup failure to caller
                holder["error"] = e
                raise
            finally:
                started.set()
            await srv._closed.wait()    # drain() ends the thread

        try:
            asyncio.run(amain())
        except BaseException as e:
            holder.setdefault("error", e)
            started.set()

    t = threading.Thread(target=_main, daemon=True, name="http-server")
    t.start()
    started.wait(timeout=120.0)
    if "error" in holder:
        raise RuntimeError("server failed to start") from holder["error"]
    if "loop" not in holder:
        raise TimeoutError("server did not start within 120s")
    return ServerHandle(server=srv, thread=t, loop=holder["loop"])


# ---------------------------------------------------------------------------
# Blocking clients (tests, chip_smoke.py) — plain sockets, no deps
# ---------------------------------------------------------------------------


def http_request(host: str, port: int, method: str = "GET",
                 path: str = "/", body: Optional[Dict[str, Any]] = None,
                 timeout: float = 60.0
                 ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
    """One blocking HTTP exchange; returns (status, headers, parsed body)."""
    payload = json.dumps(body).encode() if body is not None else b""
    req = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
           f"Content-Length: {len(payload)}\r\nConnection: close\r\n"
           f"\r\n").encode() + payload
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(req)
        raw = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            raw += chunk
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    out = json.loads(rest.decode()) if rest else {}
    return status, headers, out


class HttpSession:
    """Keep-alive client: one socket reused across requests.

    Responses are Content-Length framed, so the session reads exactly one
    response per request and leaves the connection open for the next —
    unless the server answered ``Connection: close`` (or the socket died),
    in which case the next request transparently reconnects."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: Optional[socket.socket] = None
        self.reconnects = -1           # first connect is not a re-connect

    def _connect(self) -> socket.socket:
        self.close()
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        self.reconnects += 1
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "HttpSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def request(self, method: str = "GET", path: str = "/",
                body: Optional[Dict[str, Any]] = None
                ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
        payload = json.dumps(body).encode() if body is not None else b""
        req = (f"{method} {path} HTTP/1.1\r\nHost: {self.host}\r\n"
               f"Content-Length: {len(payload)}\r\n"
               f"Connection: keep-alive\r\n\r\n").encode() + payload
        sock = self._sock or self._connect()
        try:
            sock.sendall(req)
            return self._read_response(sock)
        except (ConnectionError, socket.timeout, OSError):
            # stale keep-alive (idle timeout / max-requests cap closed it
            # under us): one reconnect-and-retry, then let errors surface
            sock = self._connect()
            sock.sendall(req)
            return self._read_response(sock)

    def _read_response(self, sock: socket.socket
                       ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("EOF before response head")
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split()[1])
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        clen = int(headers.get("content-length", 0) or 0)
        while len(rest) < clen:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("EOF mid-body")
            rest += chunk
        if headers.get("connection", "").lower() == "close":
            self.close()
        out = json.loads(rest[:clen].decode()) if clen else {}
        return status, headers, out


@dataclasses.dataclass
class StreamResult:
    """Parsed SSE stream: token events, the final status event, timing."""

    status: int                        # HTTP status line code
    events: List[Dict[str, Any]]
    t_first: float = 0.0               # perf_counter at first token event
    closed_early: bool = False

    @property
    def tokens(self) -> List[int]:
        return [e["token"] for e in self.events if "token" in e]

    @property
    def final(self) -> Optional[Dict[str, Any]]:
        for e in reversed(self.events):
            if "status" in e:
                return e
        return None


def stream_completion(host: str, port: int, payload: Dict[str, Any],
                      timeout: float = 120.0,
                      disconnect_after: Optional[int] = None
                      ) -> StreamResult:
    """POST with ``stream: true`` and parse the SSE reply. With
    ``disconnect_after=k`` the socket is torn down right after the k-th
    token event (the misbehaving-client case the server must survive)."""
    payload = dict(payload, stream=True)
    body = json.dumps(payload).encode()
    req = (f"POST /v1/completions HTTP/1.1\r\nHost: {host}\r\n"
           f"Content-Length: {len(body)}\r\nConnection: close\r\n"
           f"\r\n").encode() + body
    events: List[Dict[str, Any]] = []
    t_first = 0.0
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(req)
        buf = b""
        # read the HTTP status line + headers first
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                return StreamResult(0, events, closed_early=True)
            buf += chunk
        head, _, buf = buf.partition(b"\r\n\r\n")
        status = int(head.decode("latin-1").split("\r\n")[0].split()[1])
        if status != 200:
            # error replies are plain JSON, not SSE
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
            ev = json.loads(buf.decode()) if buf else {}
            return StreamResult(status, [ev] if ev else [])
        n_tok = 0
        while True:
            while b"\n\n" in buf:
                frame, _, buf = buf.partition(b"\n\n")
                if not frame.startswith(b"data: "):
                    continue
                data = frame[len(b"data: "):]
                if data == b"[DONE]":
                    return StreamResult(status, events, t_first)
                ev = json.loads(data.decode())
                events.append(ev)
                if "token" in ev:
                    if n_tok == 0:
                        t_first = time.perf_counter()
                    n_tok += 1
                    if (disconnect_after is not None
                            and n_tok >= disconnect_after):
                        # hard disconnect mid-stream
                        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
                        s.close()
                        return StreamResult(status, events, t_first,
                                            closed_early=True)
            chunk = s.recv(65536)
            if not chunk:
                return StreamResult(status, events, t_first,
                                    closed_early=True)
            buf += chunk

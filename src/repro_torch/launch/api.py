"""HTTP serving entry point of the port: the InferenceEngine behind an
asyncio API, on the card.

Builds the same (BCR-packed, optionally paged, prefix-cached, speculative,
quantized) engine as ``launch/serve.py`` and serves it over
``serving/server.py``'s stdlib HTTP front end, with the reference
``launch/api.py``'s flags:

    PYTHONPATH=src python -m repro_torch.launch.api --arch llama3.2-1b \\
        --slots 8 --capacity 640 --page-size 16 --bcr-keep 0.25 \\
        --bcr-block 128 --port 8080 --warmup-lens 32 128 512

    curl -N localhost:8080/v1/completions -d \\
        '{"prompt": [1, 2, 3], "max_tokens": 8, "stream": true}'

``--device`` (default ``cuda``; raises when no card is visible) and
``--attn-impl`` (in place of the reference's JAX-only ``--impl``) are the
port's own, as is ``--num-layers`` (cut the depth; 0 keeps the config's).
Weights are random, from seed 0. ``--mesh-model N`` serves tensor-parallel
over N ranks that this command starts (``--mesh-devices``: each rank's
device, e.g. ``cuda:0,cuda:0`` to share one card or ``cpu,cpu``; default
one card a rank); the drain stops them. Before ``/readyz`` turns 200,
``warmup`` builds and loads every kernel library the configuration
launches and runs each dispatch shape once.

SIGTERM (or Ctrl-C) drains gracefully: readiness flips false, the waiting
queue is shed as 429, in-flight requests finish and flush their streams,
and ``check_conservation()`` verifies nothing leaked; the command then
prints ``drained; conservation ok`` and exits 0.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import sys

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import (add_mesh_args, build_draft,
                                      build_params, mesh_options)
from repro_torch.models.layers import FLASH_ATTN_IMPLS, PLAIN_ATTN_IMPLS
from repro_torch.serving import EngineConfig, InferenceEngine, TenantQuota
from repro_torch.serving.server import InferenceServer, ServerConfig

_QUOTA_KEYS = {"rate": "rate", "burst": "burst",
               "concurrent": "max_concurrent", "pages": "max_pages",
               "weight": "weight"}


def parse_tenant_quotas(specs) -> dict:
    """Parse repeated ``--tenant NAME,KEY=V[,KEY=V...]`` CLI specs.

    Keys: rate (admits/s), burst, concurrent, pages, weight — e.g.
    ``--tenant acme,rate=5,burst=10,weight=2 --tenant free,rate=1``.
    """
    quotas = {}
    for spec in specs or ():
        name, _, rest = spec.partition(",")
        if not name:
            raise ValueError(f"--tenant {spec!r}: empty tenant name")
        kw = {}
        for item in filter(None, rest.split(",")):
            k, _, v = item.partition("=")
            key = _QUOTA_KEYS.get(k.strip())
            if key is None:
                raise ValueError(f"--tenant {spec!r}: unknown key {k!r}")
            kw[key] = float(v) if key in ("rate", "weight") else int(v)
        quotas[name] = TenantQuota(**kw)
    return quotas


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--num-layers", type=int, default=0,
                   help="cut the config's depth to this many layers "
                        "(0 → the config's)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is visible) "
                        "or cpu for the plain PyTorch path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--page-size", type=int, default=0,
                   help="block-paged KV page size (tokens); 0 → the "
                        "capacity-dense slot pool")
    p.add_argument("--kv-pages", type=int, default=0)
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--spec-k", type=int, default=0)
    p.add_argument("--draft-d-model", type=int, default=0)
    p.add_argument("--draft-layers", type=int, default=2)
    p.add_argument("--draft-bcr-keep", type=float, default=0.0)
    p.add_argument("--bcr-keep", type=float, default=0.0)
    p.add_argument("--bcr-block", type=int, default=0)
    p.add_argument("--attn-impl", default="",
                   choices=["", *FLASH_ATTN_IMPLS, *PLAIN_ATTN_IMPLS],
                   help="cold-prefill attention; pallas: the fused flash "
                        "kernel; empty keeps the config's")
    p.add_argument("--kv-dtype", default="", choices=["", "int8"])
    p.add_argument("--weight-dtype", default="", choices=["", "int8"])
    add_mesh_args(p)
    p.add_argument("--max-waiting", type=int, default=0,
                   help="bound the waiting queue; overflow sheds the "
                        "lowest-tier earliest-deadline waiter as 429")
    p.add_argument("--preempt-after-stalls", type=int, default=0)
    p.add_argument("--slo-admission", action="store_true",
                   help="SLO-aware admission: 429 deadline-carrying "
                        "requests at submit when the seat-time estimator "
                        "says they cannot finish in time, with a computed "
                        "Retry-After")
    p.add_argument("--slo-slack", type=float, default=1.0,
                   help="admission slack: admit while estimated finish <= "
                        "slack x deadline")
    p.add_argument("--tenant", action="append", default=[],
                   metavar="NAME,KEY=V[,...]",
                   help="per-tenant quota (repeatable): keys rate "
                        "(admits/s), burst, concurrent, pages, weight — "
                        "e.g. --tenant acme,rate=5,burst=10,weight=2")
    p.add_argument("--default-tenant-quota", default="",
                   metavar="KEY=V[,...]",
                   help="quota applied to tenants without a --tenant "
                        "entry (same keys, no name)")
    p.add_argument("--stream-queue-max", type=int, default=256,
                   help="per-stream SSE high-water mark: past this many "
                        "undelivered tokens the slow-client policy "
                        "engages (0 → unbounded)")
    p.add_argument("--slow-client-policy", default="cancel",
                   choices=["cancel", "pause"],
                   help="a stalled SSE reader past the high-water mark: "
                        "cancel the request, or pause it out of its slot "
                        "and resume once the stream drains")
    p.add_argument("--no-keep-alive", action="store_true",
                   help="close every connection after one response")
    p.add_argument("--keepalive-idle-s", type=float, default=5.0,
                   help="drop keep-alive connections idle this long")
    p.add_argument("--max-conn-requests", type=int, default=100,
                   help="requests served per connection before the "
                        "server answers Connection: close")
    p.add_argument("--default-max-tokens", type=int, default=16)
    p.add_argument("--max-restarts", type=int, default=3,
                   help="supervisor budget: crashes tolerated per "
                        "--restart-window-s before giving up")
    p.add_argument("--restart-window-s", type=float, default=60.0)
    p.add_argument("--slow-steps-restart", type=int, default=0,
                   help="restart the step loop after this many NEW "
                        "watchdog-flagged slow steps (0 → off)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip warmup (readiness flips at once; the first "
                        "requests pay kernel builds and first launches)")
    p.add_argument("--warmup-lens", type=int, nargs="*", default=[16, 32],
                   help="prompt lengths to run ahead of readiness")
    return p.parse_args(argv)


def build_server(args: argparse.Namespace) -> InferenceServer:
    """The engine and server the flags describe."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, bcr_keep_frac=args.bcr_keep)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.bcr_block or args.smoke:
        b = args.bcr_block or 16
        cfg = dataclasses.replace(cfg, bcr_block=(b, b))
    if args.weight_dtype and args.bcr_keep <= 0:
        raise SystemExit("--weight-dtype int8 quantizes packed tiles: it "
                         "needs --bcr-keep")
    if (args.prefix_cache or args.spec_k) and not args.page_size:
        raise SystemExit("--prefix-cache and --spec-k need --page-size "
                         "(the paged KV pool)")
    # EngineConfig raises on what is not ported before any weight is built
    ec = EngineConfig(
        n_slots=args.slots, capacity=args.capacity,
        page_size=args.page_size, kv_pages=args.kv_pages or None,
        prefix_cache=args.prefix_cache, spec_k=args.spec_k, kv_dtype=args.kv_dtype,
        weight_dtype=args.weight_dtype,
        max_waiting=args.max_waiting or None,
        preempt_after_stalls=args.preempt_after_stalls,
        slo_admission=args.slo_admission, slo_slack=args.slo_slack,
        **mesh_options(args),
        tenant_quotas=parse_tenant_quotas(args.tenant) or None,
        default_tenant_quota=(
            parse_tenant_quotas(["_," + args.default_tenant_quota])["_"]
            if args.default_tenant_quota else None))
    dev = resolve_device(args.device)
    params = build_params(cfg, device=dev, weight_dtype=args.weight_dtype)
    draft_params = None
    if args.spec_k:
        ec.draft_cfg, draft_params = build_draft(
            cfg, d_model=args.draft_d_model, layers=args.draft_layers,
            bcr_keep=args.draft_bcr_keep, device=dev)
    engine = InferenceEngine(cfg, params, ec, device=dev,
                             draft_params=draft_params)
    return InferenceServer(engine, ServerConfig(
        host=args.host, port=args.port,
        default_max_tokens=args.default_max_tokens,
        max_restarts=args.max_restarts,
        restart_window_s=args.restart_window_s,
        slow_steps_restart=args.slow_steps_restart,
        stream_queue_max=args.stream_queue_max,
        slow_client_policy=args.slow_client_policy,
        keep_alive=not args.no_keep_alive,
        keepalive_idle_s=args.keepalive_idle_s,
        max_requests_per_conn=args.max_conn_requests))


def main(argv=None) -> int:
    args = parse_args(argv)
    server = build_server(args)
    warmup = None if args.no_warmup else args.warmup_lens
    engine = server.engine
    print(f"serving {engine.cfg.name} ({engine.cfg.num_layers} layers) on "
          f"{engine.device} at http://{args.host}:{args.port} "
          f"(slots={args.slots}, page_size={args.page_size}, "
          f"warmup={'off' if warmup is None else warmup})", flush=True)
    try:
        asyncio.run(server.serve_forever(warmup))
    except KeyboardInterrupt:
        pass
    print("drained; conservation "
          + ("ok" if server.conservation_ok else "FAILED"), flush=True)
    return 0 if server.conservation_ok else 1


if __name__ == "__main__":
    sys.exit(main())

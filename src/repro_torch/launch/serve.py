"""Serving entry point of the port: BCR-pack a dense causal LM and serve it
through the paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --slots 8 --capacity 640 --page-size 16 --bcr-keep 0.25 \\
        --bcr-block 128 --requests 16 --prompt-len 128 --gen 32

runs on the card (``--device cuda``, the default); ``--device cpu --smoke``
runs the plain PyTorch path at smoke size. ``--kv-dtype int8 --weight-dtype
int8`` serves the quantized path (int8 KV pages, int8 packed tiles) and
``--attn-impl pallas`` runs cold prefill through the fused flash kernel.
``--prefix-cache --system-prompts 2 --system-len 384`` serves a
shared-prefix workload (each prompt is one of N system prompts plus a user
suffix) through the prefix cache; ``--kv-pages``, ``--preempt-after-stalls``,
``--max-waiting`` and ``--deadline-s`` drive the request lifecycle (an
oversubscribed pool, preemption, shedding, deadlines). ``--page-size 0``
serves from the capacity-dense slot pool; ``--spec-k 3 --draft-bcr-keep
0.25`` decodes speculatively with a small drafter (``build_draft``);
``--slo-admission`` rejects doomed deadlines at submit, and ``--tenants
a,b`` tags requests round-robin for the per-tenant counters (quotas are set
through ``EngineConfig.tenant_quotas``).
Every decoder family runs through the same CLI: ``--arch pixtral-12b``
(vlm), ``rwkv6-3b`` (ssm: the capacity-dense pool, exact-length prefill),
``jamba-v0.1-52b`` (hybrid: mamba and MoE layers beside paged attention),
``deepseek-moe-16b``.
``--rate R`` (Poisson arrivals at R req/s) or ``--trace FILE.jsonl`` (the
reference's trace format, e.g. ``examples/trace_heavy_tail.jsonl``) drives
the engine open loop through :func:`run_traffic` instead, paced by the wall
clock, with ``--cancel-rate``, ``--temperature``, ``--top-k`` and
``--json-out``; without either every request is submitted at once (closed
loop). ``generate`` is the naive oracle the engine is held to: one batched
exact-length prefill, then step-by-step greedy decode over a fixed page
table.

``--mode static --batch B --prompt-len P --gen G`` runs the reference's
one-batch-at-a-time loop instead (:func:`generate_static`: one prefill at
the exact prompt length, then uniform greedy decode over a capacity-dense
cache), the baseline the reference's serving benchmark measures the engine
against. Packing is GRIM's compile step (:func:`pack_params`): every packed
weight's CUDA launch is tuned by the §4.5 GA tuner for the decode batch
(``--plan-fitness analytic``, a model of the kernel on an H100, or
``wallclock``, the kernel timed on the card), and ``--auto-block`` picks
each layer shape's block by Listing 1 first.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bcrc import TBCRC, tbcrc_pack
from repro_torch.core.bcr import BCRSpec, kept_align
from repro_torch.kernels.plan import (GroupedTBCRC, plan_params,
                                     quantize_packed_params)
from repro_torch.launch.train import default_prune_filter
from repro_torch.models import causal_lm
from repro_torch.models.api import model_fns
from repro_torch.models.layers import FLASH_ATTN_IMPLS, PLAIN_ATTN_IMPLS
from repro_torch.serving import (CANCELLED, FAILED, FINISHED, REJECTED,
                                 TIMEOUT, EngineConfig, InferenceEngine)

PyTree = Any


def _cast_vals(tree: Any, dtype: torch.dtype) -> Any:
    """Cast fp packed vals to ``dtype``; int8 codes stay int8."""
    if isinstance(tree, (TBCRC, GroupedTBCRC)):
        if tree.vals.dtype == torch.int8:
            return tree
        return dataclasses.replace(tree, vals=tree.vals.to(dtype))
    if isinstance(tree, dict):
        return {k: _cast_vals(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_vals(v, dtype) for v in tree]
    return tree


def _auto_block_spec(spec: BCRSpec, shape, keep_frac: float, decode_m: int,
                     run_layer=None, _cache={}) -> BCRSpec:
    """keep_frac-aware block-size selection (GRIM §5.1, Listing 1) at pack
    time: sweep the reference's candidate blocks with
    ``block_search.find_opt_blk`` for THIS layer's (M, K, N, keep_frac) and
    take its verdict instead of the config's block as is. ``run_layer`` is
    the latency backend (default :func:`~repro_torch.core.block_search.
    analytic_latency`, the model of the CUDA kernel on an H100; the CLI
    passes the card runner under ``--plan-fitness wallclock``). Memoized
    per unique layer geometry and backend."""
    from repro_torch.core.block_search import (analytic_latency,
                                               default_candidates,
                                               find_opt_blk)
    n, k = int(shape[0]), int(shape[1])
    run_layer = run_layer or analytic_latency
    key = (n, k, keep_frac, decode_m, run_layer)
    if key not in _cache:
        cands = set(default_candidates(n, k))
        cands |= {(b, b) for b in (16, 32, 64, 128, 256)
                  if n % b == 0 and k % b == 0}
        cands.add(tuple(spec.block_shape))
        best, _ = find_opt_blk(decode_m, k, n, keep_frac, sorted(cands),
                               run_layer=run_layer)
        _cache[key] = best
    block = _cache[key]
    return BCRSpec(block_shape=block, keep_frac=keep_frac,
                   align=kept_align(block))


def pack_params(cfg: ModelConfig, params: PyTree, *, plan: bool = True,
                decode_m: int = 8, auto_block: bool = False,
                block_runner=None, plan_fitness: str = "analytic",
                weight_dtype: str = "") -> PyTree:
    """Replace every prunable linear's ``{"w"}`` with ``{"w_packed": TBCRC}``.
    An MoE layer's stacked expert weights ``(E, N, K)`` pack in one batched
    pass to a TBCRC with a leading E axis (the reference's ``_pack_any``).
    An encdec tree packs every attention and MLP projection of both stacks
    and its ``lm_head``; its embeddings and ``dec_pos`` stay dense.

    The reference's order: prune → pack → quantize → tune and fuse, then
    the port's cast.

    * ``auto_block=True`` runs the paper's Listing-1 block search per layer
      geometry before packing (:func:`_auto_block_spec`; ``block_runner``
      overrides its latency backend); the config's block then only seeds
      the candidate set.
    * ``weight_dtype="int8"`` quantizes every packed tile to int8 codes with
      one fp32 scale per tile (from the param-dtype vals, as the reference
      does), before tuning, so the tuner prices the 1-byte tiles.
    * With ``plan=True`` (default) this is GRIM's full compile step
      (``kernels/plan.plan_params``): every packed weight gets a GA-tuned
      launch genome for decode batch ``decode_m`` (``plan_fitness``:
      "analytic", the model of the CUDA kernel on an H100, or "wallclock",
      the kernel timed on the card), and projections sharing one activation
      (Q/K/V or K/V, gate/up; an MoE layer's experts' gate/up as one
      stacked group; a cross attention's K/V only) fuse into grouped
      entries where the tuner votes to. ``plan=False`` neither tunes nor
      fuses, as in the reference.

    Afterwards fp packed ``vals`` are cast to the activation dtype
    ``cfg.dtype``: the reference's TPU kernel casts its tiles to the
    activation dtype on every grid step; here that cast happens once, at
    pack time, and the kernels stream tiles already in that dtype. int8
    codes stay int8."""
    if weight_dtype not in ("", "int8"):
        raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
    fil = default_prune_filter(cfg)

    def rewrite(node, path=""):
        if isinstance(node, dict) and isinstance(node.get("w"), torch.Tensor):
            spec = fil(path + "['w']", node["w"])
            if spec is not None:
                if auto_block:
                    spec = _auto_block_spec(
                        spec, node["w"].shape[-2:], cfg.bcr_keep_frac,
                        decode_m, block_runner)
                out = {"w_packed": tbcrc_pack(node["w"], spec)}
                if "b" in node:
                    out["b"] = node["b"]
                return out
        if isinstance(node, dict):
            return {k: rewrite(v, f"{path}['{k}']") for k, v in node.items()}
        if isinstance(node, list):
            return [rewrite(v, f"{path}[{i}]") for i, v in enumerate(node)]
        return node

    packed = rewrite(params)
    if weight_dtype:
        packed = quantize_packed_params(packed)
    if plan:
        packed = plan_params(packed, m=decode_m, fitness=plan_fitness)
    return _cast_vals(packed, cfg.act_dtype)


def tree_bytes(tree: Any) -> int:
    if isinstance(tree, (TBCRC, GroupedTBCRC)):
        return tree.nbytes()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return 0


def packed_fraction(params: PyTree, packed: PyTree) -> float:
    """Bytes of the packed tree (tiles + indices + plan vectors) over the
    bytes of the dense tree it came from."""
    return tree_bytes(packed) / tree_bytes(params)


def build_params(cfg: ModelConfig, log=print, *, seed: int = 0,
                 device="cuda", weight_dtype: str = "", decode_m: int = 8,
                 auto_block: bool = False, block_runner=None,
                 plan_fitness: str = "analytic") -> PyTree:
    """Random weights from a seeded generator on ``device``, BCR-packed when
    ``cfg.bcr_keep_frac > 0`` (int8 tiles with ``weight_dtype="int8"``),
    their launches tuned for the batch this server decodes at
    (``decode_m``; the engine keeps plans the packer tuned)."""
    params = model_fns(cfg).init_params(seed, device=resolve_device(device))
    if cfg.bcr_keep_frac > 0:
        packed = pack_params(cfg, params, decode_m=decode_m,
                             auto_block=auto_block, block_runner=block_runner,
                             plan_fitness=plan_fitness,
                             weight_dtype=weight_dtype)
        log(f"packed weight bytes: {packed_fraction(params, packed):.3f}x "
            f"dense")
        params = packed
    return params


def build_draft(cfg: ModelConfig, *, d_model: int = 0, layers: int = 2,
                bcr_keep: float = 0.0, device="cuda", log=print
                ) -> Tuple[ModelConfig, PyTree]:
    """The drafter of ``--spec-k``, as the reference's ``build_draft``
    builds it: the target's stack at ``d_model`` (0 → the target's // 4,
    rounded down to a multiple of the head count so head_dim stays exact),
    ``d_ff = 2 · d_model``, ``layers`` deep, sharing the target's vocab and
    head counts; random weights from seed 1, BCR-packed at ``bcr_keep``
    when > 0."""
    dm = d_model or cfg.d_model // 4
    dm = max(cfg.num_heads, dm // cfg.num_heads * cfg.num_heads)
    if d_model and dm != d_model:
        log(f"--draft-d-model {d_model} rounded to {dm} "
            f"({cfg.num_heads} heads)")
    draft_cfg = dataclasses.replace(
        cfg, name=cfg.name + "-draft", num_layers=layers, d_model=dm,
        head_dim=dm // cfg.num_heads, d_ff=max(8, dm * 2),
        bcr_keep_frac=bcr_keep)
    dparams = build_params(draft_cfg, log=log, seed=1, device=device)
    log(f"drafter: {layers}L d_model={dm} (keep_frac={bcr_keep})")
    return draft_cfg, dparams


def generate(cfg: ModelConfig, params: PyTree, prompts: torch.Tensor, *,
             gen_tokens: int, page_size: int = 16,
             forced: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Naive greedy oracle: prefill a batch of equal-length prompts at their
    exact length, seat the KV (codes and scales under ``kv_dtype="int8"``)
    into a fixed page table (slot b owns pages ``1 + b·max_pages ...``) and
    a recurrent layer's state into row b, then decode ``gen_tokens - 1``
    steps.

    Returns ``tokens`` (B, gen_tokens) and ``logits`` (B, gen_tokens, V):
    the distribution each emitted token was taken from. With ``forced``
    (B, gen_tokens) each step is fed ``forced[:, i]`` instead of its own
    argmax (teacher forcing), so ``tokens`` holds this model's greedy pick
    at every position of a fixed trajectory."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "generate() serves decoder-only families; encdec prefill needs "
            "encoder frames and primes a different cache tree")
    prompts = torch.as_tensor(prompts)
    dev = params["embed"]["table"].device
    prompts = prompts.to(device=dev, dtype=torch.int32)
    b, p = prompts.shape
    logits, pcache = causal_lm.prefill(cfg, params, prompts)
    max_pages = -(-(p + gen_tokens) // page_size)
    cache = causal_lm.init_cache(cfg, b, p + gen_tokens,
                                 kv_pages=b * max_pages + 1,
                                 page_size=page_size, device=dev)
    table = (1 + torch.arange(b * max_pages, device=dev,
                              dtype=torch.int32)).reshape(b, max_pages)
    pos = torch.arange(p, device=dev)
    dest = (table[:, pos // page_size].long() * page_size + pos % page_size)
    for pool, new, keys in zip(cache, pcache,
                               causal_lm.position_keys(cache)):
        for key, leaf in pool.items():
            if key not in keys:           # recurrent state: row b, whole
                leaf.copy_(new[key])
                continue
            leaf.view(-1, *leaf.shape[2:]).index_copy_(
                0, dest.reshape(-1),
                new[key].reshape(-1, *leaf.shape[2:]).to(leaf.dtype))
    lens = torch.full((b,), p, dtype=torch.int32, device=dev)
    step_logits = [logits[:, -1].float()]
    toks = [torch.argmax(step_logits[-1], dim=-1).to(torch.int32)]
    if forced is not None:
        forced = torch.as_tensor(forced).to(device=dev, dtype=torch.int32)
    for i in range(gen_tokens - 1):
        feed = toks[-1] if forced is None else forced[:, i]
        logits, cache = causal_lm.decode_step(
            cfg, params, feed[:, None], cache, lens + i, block_tables=table)
        step_logits.append(logits[:, -1].float())
        toks.append(torch.argmax(step_logits[-1], dim=-1).to(torch.int32))
    return {"tokens": torch.stack(toks, dim=1),
            "logits": torch.stack(step_logits, dim=1)}


@dataclasses.dataclass
class ServeConfig:
    """The static loop's batch (the reference's ``ServeConfig``)."""

    batch: int = 4
    prompt_len: int = 16
    gen_tokens: int = 16
    capacity: int = 128
    seed: int = 0


def generate_static(cfg: ModelConfig, params: PyTree, sc: ServeConfig, *,
                    prompts: Optional[torch.Tensor] = None, log=print
                    ) -> Dict[str, Any]:
    """The reference's static ``generate``: prefill one uniform batch at
    the exact prompt length, seat its cache into a capacity-dense decode
    cache (``serving/kv_slots.seat_prefill``), then greedy-decode
    ``sc.gen_tokens`` steps for every row together — the baseline the
    engine is measured against (the naive oracle is :func:`generate`).

    Prompts ``(batch, prompt_len)`` come from a ``torch.Generator`` seeded
    by ``sc.seed`` unless ``prompts`` is given. Returns ``tokens`` (batch,
    gen_tokens) and the prefill and decode seconds (the card synchronized
    before each clock read)."""
    from repro_torch.serving.kv_slots import seat_prefill
    if cfg.family == "encdec":
        raise NotImplementedError(
            "generate() serves decoder-only families; encdec prefill needs "
            "encoder frames and primes a different cache tree")
    dev = params["embed"]["table"].device
    if prompts is None:
        gen = torch.Generator()
        gen.manual_seed(sc.seed)
        prompts = torch.randint(0, cfg.vocab_size, (sc.batch, sc.prompt_len),
                                generator=gen, dtype=torch.int32)
    prompts = torch.as_tensor(prompts).to(device=dev, dtype=torch.int32)
    b, p = prompts.shape

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, pcache = causal_lm.prefill(cfg, params, prompts)
    cache = seat_prefill(
        lambda batch, capacity, device: causal_lm.init_cache(
            cfg, batch, capacity, device=device),
        pcache, b, sc.capacity, device=dev)
    sync()
    prefill_t = time.perf_counter() - t0
    lens = torch.full((b,), p, dtype=torch.int32, device=dev)
    out_tokens = []
    t0 = time.perf_counter()
    next_tok = torch.argmax(logits[:, -1].float(), dim=-1).to(
        torch.int32)[:, None]
    for i in range(sc.gen_tokens):
        out_tokens.append(next_tok)
        logits, cache = causal_lm.decode_step(cfg, params, next_tok, cache,
                                              lens + i)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1).to(
            torch.int32)[:, None]
    sync()
    decode_t = time.perf_counter() - t0
    log(f"prefill {p} tok x{b}: {prefill_t * 1e3:.1f} ms; decode "
        f"{sc.gen_tokens} tok x{b}: {decode_t * 1e3:.1f} ms "
        f"({decode_t / max(sc.gen_tokens, 1) * 1e3:.2f} ms/step)")
    return {"tokens": torch.cat(out_tokens, dim=1).cpu(),
            "prefill_s": prefill_t, "decode_s": decode_t}


@dataclasses.dataclass
class TrafficConfig:
    """Open-loop traffic for :func:`run_traffic`, as the reference's."""

    n_requests: int = 32
    rate: float = 8.0                # mean arrivals per second
    prompt_lens: tuple = (8, 16, 24)
    gen_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    warmup: bool = True
    # shared-prefix workload: each prompt is one of `system_prompts` fixed
    # system prompts of `system_len` tokens plus a user suffix drawn from
    # prompt_lens (0 → fully random prompts)
    system_prompts: int = 0
    system_len: int = 32
    # deadline_s > 0 arms a per-request deadline; cancel_rate > 0 cancels
    # that fraction of requests at a random point after their arrival
    deadline_s: float = 0.0
    cancel_rate: float = 0.0
    # trace replay: records from load_trace drive arrivals, prompt lengths,
    # budgets, priorities, deadlines and tenants instead of Poisson
    trace: Any = None
    # Poisson requests are tagged round-robin from these (empty → none)
    tenants: tuple = ()


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a jsonl request trace for :func:`run_traffic`: one object a
    line, ``{"t": 0.12, "prompt_len": 16, "max_new_tokens": 16,
    "priority": 1, "deadline_s": 2.0, "tenant": "acme"}``. ``t`` (arrival
    offset in seconds from the run's start) is required and non-decreasing;
    the rest default (prompt_len 16, the TrafficConfig's budget and
    deadline, priority 0). Lines starting with ``#`` are comments."""
    trace: List[Dict[str, Any]] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rec = json.loads(line)
            if "t" not in rec:
                raise ValueError(f"{path}:{ln}: trace record needs 't' "
                                 f"(arrival offset in seconds)")
            trace.append(rec)
    if any(b["t"] < a["t"] for a, b in zip(trace, trace[1:])):
        raise ValueError(f"{path}: arrival offsets must be non-decreasing")
    return trace


def _pct(a, q) -> float:
    return float(np.percentile(a, q)) if len(a) else 0.0


def run_traffic(engine: InferenceEngine, tc: TrafficConfig, log=print
                ) -> Dict[str, Any]:
    """Open-loop arrivals against a live engine, as the reference's
    ``run_traffic``: Poisson gaps at ``tc.rate`` (or a trace's offsets, each
    record clamped to fit its slot), submissions as they fall due,
    client-side cancels, one ``step`` at a time, and a sleep only while the
    engine is idle ahead of the next arrival. Paced by the engine's clock
    (``engine.clock``: the wall clock unless the engine was built with
    another) and that clock's ``sleep`` when it has one (a ``FakeClock``),
    else ``time.sleep``; arrivals fall due at absolute times on that
    clock, so a fake clock's sleep lands on them exactly. Returns the
    metrics dict (throughput, goodput, per-status counts, TTFT and
    per-token p50/p95/p99 over FINISHED requests, mean occupancy, prefix,
    speculative and admission counters)."""
    rng = np.random.default_rng(tc.seed)
    if tc.trace is not None:
        n_requests = len(tc.trace)
        arrivals = np.asarray([float(r["t"]) for r in tc.trace])
        gens = [int(r.get("max_new_tokens", tc.gen_tokens))
                for r in tc.trace]
        prios = [int(r.get("priority", 0)) for r in tc.trace]
        deadlines = [float(r.get("deadline_s", tc.deadline_s))
                     for r in tc.trace]
        tenants = [str(r.get("tenant", "")) for r in tc.trace]
        # a trace is a workload shape, not a rejection test: no record may
        # exceed its slot (prompt + budget + speculative headroom)
        cap = engine.ec.capacity - engine._headroom()
        plens = np.asarray([max(1, min(int(r.get("prompt_len", 16)), cap - g))
                            for r, g in zip(tc.trace, gens)])
    else:
        n_requests = tc.n_requests
        arrivals = np.cumsum(rng.exponential(1.0 / tc.rate, size=n_requests))
        plens = rng.choice(tc.prompt_lens, size=n_requests)
        gens = [tc.gen_tokens] * n_requests
        prios = [0] * n_requests
        deadlines = [tc.deadline_s] * n_requests
        tenants = ([tc.tenants[i % len(tc.tenants)]
                    for i in range(n_requests)] if tc.tenants
                   else [""] * n_requests)
    vocab = engine.cfg.vocab_size
    if tc.system_prompts > 0:
        systems = [rng.integers(0, vocab, size=tc.system_len).astype(np.int32)
                   for _ in range(tc.system_prompts)]
        prompts = [np.concatenate([
            systems[int(rng.integers(tc.system_prompts))],
            rng.integers(0, vocab, size=int(p)).astype(np.int32)])
            for p in plens]
    else:
        prompts = [rng.integers(0, vocab, size=int(p)).astype(np.int32)
                   for p in plens]
    if tc.warmup:
        # first launches outside the measured window; at a prefix hit the
        # suffix is the user part plus up to a page of unmatched system
        # tail (or 1 token on a full hit)
        sfx = (tuple(int(p) + engine.ec.page_size for p in plens) + (1,)
               if tc.system_prompts else None)
        engine.warmup([len(p) for p in prompts], suffix_lens=sfx)

    # each request independently gets a cancel at a random point after its
    # arrival (within its deadline window when one is set); a cancel
    # racing completion is a no-op
    cancel_at = np.full(n_requests, np.inf)
    if tc.cancel_rate > 0:
        hit = rng.random(n_requests) < tc.cancel_rate
        span = tc.deadline_s if tc.deadline_s > 0 else 0.5
        cancel_at[hit] = arrivals[hit] + rng.uniform(
            0.01, max(span, 0.02), size=int(hit.sum()))

    clock = engine.clock
    sleep = getattr(clock, "sleep", time.sleep)
    t0 = clock()
    due = t0 + arrivals
    cancel_at = t0 + cancel_at
    submitted = 0
    rids: List[int] = []
    while submitted < n_requests or engine.sched.has_work():
        now = clock()
        while submitted < n_requests and due[submitted] <= now:
            rids.append(engine.submit(
                prompts[submitted], max_new_tokens=gens[submitted],
                temperature=tc.temperature, top_k=tc.top_k,
                arrival_time=arrivals[submitted],
                deadline_s=deadlines[submitted], priority=prios[submitted],
                tenant=tenants[submitted]))
            submitted += 1
        for i in np.nonzero(cancel_at <= now)[0]:
            if i < submitted:
                engine.cancel(rids[i])
                cancel_at[i] = np.inf
        if not engine.sched.has_work():
            # idle until the next arrival (none left once a cancel has
            # emptied the engine after the last submission)
            if submitted < n_requests:
                sleep(max(0.0, due[submitted] - now))
            continue
        engine.step()                # ends in a device→host token copy
    elapsed = clock() - t0

    reqs = engine.sched.finished
    fin = [r for r in reqs if r.status == FINISHED]
    # latency percentiles cover FINISHED requests only: a shed or timed-out
    # request has no meaningful TTFT
    ttft = [(r.first_token_time - t0) - r.arrival_time for r in fin]
    itl: List[float] = []
    for r in fin:
        itl.extend(np.diff(r.token_times))
    total_tokens = sum(len(r.generated) for r in reqs)
    good_tokens = sum(len(r.generated) for r in fin)
    prompt_tokens = sum(r.prompt_len for r in reqs)
    status_counts = {s.lower(): sum(1 for r in reqs if r.status == s)
                     for s in (FINISHED, TIMEOUT, CANCELLED, REJECTED,
                               FAILED)}
    st = engine.stats
    occ = st["slot_occupancy"]
    metrics = {
        "n_requests": len(reqs),
        "total_tokens": total_tokens,
        "elapsed_s": elapsed,
        "throughput_tok_s": total_tokens / elapsed,
        "goodput_tok_s": good_tokens / elapsed,
        "status_counts": status_counts,
        "preempted": st["preemptions"],
        "shed": st["shed"],
        "decode_steps": st["decode_steps"],
        # each request's first token is prefill-sampled, never a decode
        # step's: with speculation this is the payoff figure
        "decode_tokens_per_step": (max(total_tokens - len(reqs), 0)
                                   / max(st["decode_steps"], 1)),
        "mean_slot_occupancy": float(np.mean(occ)) if occ else 0.0,
        "ttft_s": {f"p{q}": _pct(ttft, q) for q in (50, 95, 99)},
        "per_token_s": {f"p{q}": _pct(itl, q) for q in (50, 95, 99)},
        "page_stalls": st["page_stalls"],
        "prefix_hit_rate": (st["prefix_hit_tokens"] / prompt_tokens
                            if prompt_tokens else 0.0),
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "pages_shared": st["pages_shared"],
        "cow_copies": st["cow_copies"],
        "evictions": st["evictions"],
        "spec_steps": st["spec_steps"],
        "draft_proposed": st["draft_proposed"],
        "draft_accepted": st["draft_accepted"],
        "acceptance_rate": (st["draft_accepted"] / st["draft_proposed"]
                            if st["draft_proposed"] else 0.0),
        "slo_rejected": st["slo_rejected"],
        "quota_rejected": st["quota_rejected"],
        "timeouts_waiting": st["timeouts_waiting"],
        "timeouts_running": st["timeouts_running"],
        "wasted_prefill_tokens": st["wasted_prefill_tokens"],
        "tenants": {t: dict(v) for t, v in st["tenants"].items()},
    }
    log(f"{len(reqs)} requests, {total_tokens} tokens in {elapsed:.2f}s "
        f"→ {metrics['throughput_tok_s']:.1f} tok/s; mean occupancy "
        f"{metrics['mean_slot_occupancy']:.2f}/{engine.ec.n_slots} slots")
    log(f"status: finished {status_counts['finished']} / timeout "
        f"{status_counts['timeout']} / cancelled "
        f"{status_counts['cancelled']} / rejected "
        f"{status_counts['rejected']} / preempted {st['preemptions']} / "
        f"failed {status_counts['failed']}; goodput "
        f"{metrics['goodput_tok_s']:.1f} tok/s (FINISHED only)")
    t, pt = metrics["ttft_s"], metrics["per_token_s"]
    log(f"TTFT p50/p95/p99: {t['p50'] * 1e3:.1f}/{t['p95'] * 1e3:.1f}/"
        f"{t['p99'] * 1e3:.1f} ms; per-token p50/p95/p99: "
        f"{pt['p50'] * 1e3:.2f}/{pt['p95'] * 1e3:.2f}/"
        f"{pt['p99'] * 1e3:.2f} ms")
    log(f"prefix_hit_rate {metrics['prefix_hit_rate']:.2f} (hit tokens "
        f"{st['prefix_hit_tokens']}/{prompt_tokens}); pages_shared "
        f"{st['pages_shared']}; cow_copies {st['cow_copies']}; evictions "
        f"{st['evictions']}; page_stalls {st['page_stalls']}")
    if st["spec_steps"]:
        log(f"speculative: {metrics['acceptance_rate']:.2f} acceptance "
            f"({st['draft_accepted']}/{st['draft_proposed']} drafts), "
            f"{metrics['decode_tokens_per_step']:.2f} committed tokens/decode "
            f"step; accepted-length histogram {st['accepted_hist']}")
    return metrics


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """``--mesh-model`` and ``--mesh-devices``, shared by the serving
    CLIs."""
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh size: every projection "
                        "column-parallel and attention head-parallel, one "
                        "process a rank started by this command (greedy "
                        "tokens equal --mesh-model 1's). Needs the paged "
                        "pool (--page-size > 0), a dense or vlm arch and "
                        "head counts that divide the mesh")
    p.add_argument("--mesh-devices", default="",
                   help="each rank's device, comma-separated, rank 0's (the "
                        "engine's --device) first: cuda:0,cuda:0 shares one "
                        "card, cpu,cpu runs on the CPU; empty → one card a "
                        "rank")


def mesh_options(args: argparse.Namespace) -> Dict[str, Any]:
    """The ``EngineConfig`` fields of :func:`add_mesh_args`' flags."""
    devices = tuple(d for d in args.mesh_devices.split(",") if d)
    return dict(mesh_model=args.mesh_model, mesh_devices=devices)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--mode", default="traffic", choices=["traffic", "static"],
                   help="traffic: the continuous-batching engine; static: "
                        "the one-batch-at-a-time baseline loop")
    p.add_argument("--batch", type=int, default=4, help="static-mode batch")
    p.add_argument("--num-layers", type=int, default=0,
                   help="cut the model's depth to this many layers (0 → "
                        "the config's)")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--page-size", type=int, default=16,
                   help="block-paged KV page size (tokens); 0 → the "
                        "capacity-dense slot pool")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="total KV pages per layer (0 → full provisioning); "
                        "fewer oversubscribe the pool under page-budget "
                        "admission control")
    p.add_argument("--prefix-cache", action="store_true",
                   help="share KV pages across requests: admissions adopt "
                        "cached full-page prompt prefixes (refcounted, CoW) "
                        "and prefill only the uncached suffix")
    p.add_argument("--system-prompts", type=int, default=0,
                   help="shared-prefix workload: N fixed system prompts; "
                        "each request = one of them + a random user suffix "
                        "(0 → fully random prompts)")
    p.add_argument("--system-len", type=int, default=32,
                   help="system-prompt length (tokens) for --system-prompts")
    p.add_argument("--preempt-after-stalls", type=int, default=0,
                   help="page-pressure preemption: after this many "
                        "consecutive fully stalled admission steps, evict "
                        "the youngest running request (0 → off)")
    p.add_argument("--max-waiting", type=int, default=0,
                   help="bound the waiting queue: beyond it submit sheds "
                        "the earliest-deadline waiting request as REJECTED "
                        "(0 → unbounded)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="per-request deadline (seconds from submit): past "
                        "it requests retire as TIMEOUT, waiting or "
                        "mid-decode (0 → no deadlines)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: a small drafter proposes up "
                        "to k tokens a slot and ONE prefill_append dispatch "
                        "verifies them (needs --page-size > 0; 0 → plain "
                        "decode)")
    p.add_argument("--draft-d-model", type=int, default=0,
                   help="drafter width (0 → target d_model // 4, rounded "
                        "to the head count)")
    p.add_argument("--draft-layers", type=int, default=2,
                   help="drafter depth")
    p.add_argument("--draft-bcr-keep", type=float, default=0.0,
                   help="BCR-pack the drafter at this keep fraction (0 → "
                        "dense drafter)")
    p.add_argument("--slo-admission", action="store_true",
                   help="reject at submit a deadline-carrying request the "
                        "seat-time estimator says cannot finish in time")
    p.add_argument("--slo-slack", type=float, default=1.0,
                   help="admit while the estimated finish <= slack x "
                        "deadline")
    p.add_argument("--tenants", default="",
                   help="comma-separated tenant names; requests are tagged "
                        "round-robin and the per-tenant counters are "
                        "printed")
    p.add_argument("--bcr-keep", type=float, default=0.0)
    p.add_argument("--bcr-block", type=int, default=0,
                   help="BCR block side; 0 → 16 for --smoke configs, else "
                        "the config default")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rate", type=float, default=None,
                   help="open loop: Poisson arrivals at this many req/s, "
                        "paced by the wall clock (absent: every request "
                        "is submitted at once)")
    p.add_argument("--trace", default=None, metavar="FILE.jsonl",
                   help="open loop: replay a jsonl request trace (arrival "
                        "offset 't', prompt_len, max_new_tokens, priority, "
                        "deadline_s, tenant; see "
                        "examples/trace_heavy_tail.jsonl)")
    p.add_argument("--cancel-rate", type=float, default=0.0,
                   help="open loop: fraction of requests cancelled "
                        "client-side at a random point after arrival")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--json-out", default=None,
                   help="write the run's metrics (static mode: its tokens "
                        "and times) here as JSON")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kv-dtype", default="", choices=["", "int8"],
                   help="int8: KV pages as int8 codes + per-row, per-kv-head "
                        "fp32 scales, read by the paged kernel's int8 form")
    p.add_argument("--weight-dtype", default="", choices=["", "int8"],
                   help="int8: packed BCR tiles as int8 codes + one fp32 "
                        "scale per tile (needs --bcr-keep)")
    p.add_argument("--auto-block", action="store_true",
                   help="Listing-1 block-size search per layer geometry at "
                        "pack time instead of taking the config block")
    p.add_argument("--plan-fitness", default="analytic",
                   choices=["analytic", "wallclock"],
                   help="GA plan-tuner fitness backend: analytic (a model of "
                        "the CUDA kernel on an H100) or wallclock (the "
                        "kernel timed on the card; also the --auto-block "
                        "runner)")
    p.add_argument("--attn-impl", default="",
                   choices=["", *FLASH_ATTN_IMPLS, *PLAIN_ATTN_IMPLS],
                   help="cold-prefill attention; pallas: the fused flash "
                        "kernel; empty keeps the config's")
    add_mesh_args(p)
    args = p.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, bcr_keep_frac=args.bcr_keep)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.weight_dtype and args.bcr_keep <= 0:
        p.error("--weight-dtype int8 quantizes packed tiles: it needs "
                "--bcr-keep")
    if args.bcr_block or args.smoke:
        b = args.bcr_block or 16
        cfg = dataclasses.replace(cfg, bcr_block=(b, b))
    if args.page_size <= 0 and (args.prefix_cache or args.spec_k):
        p.error("--prefix-cache and --spec-k need --page-size > 0 (the "
                "paged KV pool)")
    dev = resolve_device(args.device)
    block_runner = None
    if args.auto_block and args.plan_fitness == "wallclock":
        from repro_torch.core.block_search import wallclock_runner
        block_runner = functools.partial(wallclock_runner, device=dev)
    static = args.mode == "static"
    params = build_params(cfg, seed=args.seed, device=dev,
                          weight_dtype=args.weight_dtype,
                          decode_m=args.batch if static else args.slots,
                          auto_block=args.auto_block,
                          block_runner=block_runner,
                          plan_fitness=args.plan_fitness)
    if static:
        if args.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_dtype=args.kv_dtype)
        out = generate_static(cfg, params, ServeConfig(
            batch=args.batch, prompt_len=args.prompt_len,
            gen_tokens=args.gen, capacity=args.capacity, seed=args.seed))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump({"tokens": out["tokens"].tolist(),
                           "prefill_s": out["prefill_s"],
                           "decode_s": out["decode_s"]}, f)
        return
    draft_cfg = draft_params = None
    if args.spec_k:
        draft_cfg, draft_params = build_draft(
            cfg, d_model=args.draft_d_model, layers=args.draft_layers,
            bcr_keep=args.draft_bcr_keep, device=dev)
    tenants = [t for t in args.tenants.split(",") if t]
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=args.slots, capacity=args.capacity,
        page_size=args.page_size, kv_pages=args.kv_pages or None,
        prefix_cache=args.prefix_cache, seed=args.seed,
        kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
        max_waiting=args.max_waiting or None,
        preempt_after_stalls=args.preempt_after_stalls,
        spec_k=args.spec_k, draft_cfg=draft_cfg,
        slo_admission=args.slo_admission, slo_slack=args.slo_slack,
        **mesh_options(args)),
        device=dev, draft_params=draft_params)
    try:
        _serve(p, args, cfg, engine, tenants)
    finally:
        engine.close()              # stops the other ranks under a mesh


def _serve(p: argparse.ArgumentParser, args: argparse.Namespace,
           cfg: ModelConfig, engine: InferenceEngine, tenants: List[str]
           ) -> None:
    """The serve CLI's traffic through a built engine, and its report."""
    dev = engine.device
    sys_len = args.system_len if args.system_prompts else 0
    pmax = args.capacity - args.gen - args.spec_k - sys_len
    if pmax < 1:
        p.error(f"--capacity {args.capacity} leaves no room for prompts "
                f"after --gen {args.gen}"
                + (f" + --system-len {sys_len}" if sys_len else ""))
    plens = sorted({min(max(x, 1), pmax) for x in
                    (max(4, args.prompt_len // 2), args.prompt_len,
                     args.prompt_len * 2)})
    if args.rate is not None or args.trace:
        metrics = run_traffic(engine, TrafficConfig(
            n_requests=args.requests, rate=args.rate or 8.0,
            prompt_lens=tuple(plens), gen_tokens=args.gen,
            temperature=args.temperature, top_k=args.top_k, seed=args.seed,
            system_prompts=args.system_prompts, system_len=args.system_len,
            deadline_s=args.deadline_s, cancel_rate=args.cancel_rate,
            trace=load_trace(args.trace) if args.trace else None,
            tenants=tuple(tenants)))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(metrics, f, indent=2)
        return
    rng = np.random.default_rng(args.seed)
    systems = [rng.integers(0, cfg.vocab_size, size=sys_len)
               for _ in range(args.system_prompts)]
    for i in range(args.requests):
        user = rng.integers(0, cfg.vocab_size, size=int(rng.choice(plens)))
        if systems:
            user = np.concatenate(
                [systems[int(rng.integers(len(systems)))], user])
        engine.submit(user, max_new_tokens=args.gen,
                      temperature=args.temperature, top_k=args.top_k,
                      deadline_s=args.deadline_s,
                      tenant=tenants[i % len(tenants)] if tenants else "")
    t0 = time.perf_counter()
    engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    done = engine.sched.finished          # rejected at submit ones too
    fin = [r for r in done if r.status == FINISHED]
    ttft = np.array([r.first_token_time - r.submit_time for r in fin])
    st = engine.stats
    toks = st["tokens_generated"]
    counts = {s: sum(r.status == s for r in done)
              for s in (FINISHED, TIMEOUT, CANCELLED, REJECTED, FAILED)}
    print(f"{len(done)} requests, {toks} tokens in {wall:.3f} s: "
          f"{toks / wall:.1f} tokens/s; {st['decode_steps']} decode "
          f"steps, {st['prefills']} prefills")
    print(f"status: finished {counts[FINISHED]} / timeout {counts[TIMEOUT]} "
          f"/ cancelled {counts[CANCELLED]} / rejected {counts[REJECTED]} / "
          f"preempted {st['preemptions']} / failed {counts[FAILED]}; shed "
          f"{st['shed']}, page stalls {st['page_stalls']}")
    prompt_tokens = sum(r.prompt_len for r in done)
    print(f"prefix_hit_rate "
          f"{st['prefix_hit_tokens'] / max(prompt_tokens, 1):.2f} (hit "
          f"tokens {st['prefix_hit_tokens']}/{prompt_tokens}); pages_shared "
          f"{st['pages_shared']}; cow_copies {st['cow_copies']}; evictions "
          f"{st['evictions']}; pages_allocated {st['pages_allocated']}")
    if args.spec_k:
        print(f"speculative: spec_steps {st['spec_steps']}, acceptance "
              f"{st['draft_accepted'] / max(st['draft_proposed'], 1):.2f} "
              f"({st['draft_accepted']}/{st['draft_proposed']} drafts), "
              f"accepted_hist {st['accepted_hist']}, drafter_failures "
              f"{st['drafter_failures']}")
    if args.slo_admission or tenants:
        print(f"admission: slo_rejected {st['slo_rejected']}, "
              f"quota_rejected {st['quota_rejected']}; tenants "
              f"{st['tenants']}")
    if len(ttft):
        print(f"TTFT p50/p95: {np.percentile(ttft, 50) * 1e3:.1f}/"
              f"{np.percentile(ttft, 95) * 1e3:.1f} ms")
    print(f"KV bytes read over live pages: "
          f"{engine.stats['kv_bytes_read_live']} ({engine._kv_row_bytes} "
          f"bytes per cached position, all layers, K + V)")
    if engine.tp > 1:
        print(f"mesh {engine.tp}: KV bytes read {st['kv_bytes_read']} in "
              f"all, {st['kv_bytes_read_device']} per rank")


if __name__ == "__main__":
    main()

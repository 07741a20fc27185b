"""InferenceEngine: continuous-batching serving over (BCR-packed) params on a
block-paged KV pool — the subset of the reference engine that carries the
main serving path.

Each ``step()``:

  1. admits waiting requests into free slots under the page budget (strict
     FCFS: the first request the pool cannot cover requeues itself and
     everything behind it). All admissions of a step share ONE batched
     ``prefill`` (prompts right-padded to a power-of-two bucket, rows padded
     to a power-of-two tier) whose KV is seated into each slot's pages;
     steady-state backfills are chunked (``backfill_chunk``);
  2. runs ONE ``decode_step`` over the whole ragged slot batch with per-slot
     lengths and block tables sliced to the pow2-bucketed live width, so
     the paged attention kernel reads each slot's live pages only;
  3. samples per slot (greedy / temperature / top-k), advances lengths and
     retires finished requests.

Free slots ride along as garbage rows: their length is 0 and their table row
is zero, so their writes land in the null page and their output is dropped.

Quantized serving: ``kv_dtype="int8"`` stores the pool as int8 codes with
per-row, per-kv-head fp32 scales; ``weight_dtype="int8"`` quantizes the
packed tiles to int8 codes with one fp32 scale per tile at engine build.

Not ported yet (each raises ``NotImplementedError`` when asked for): the
prefix cache, speculative decoding, tensor parallelism and unpaged pools.
The lifecycle machinery (deadlines, cancel, preemption, NaN containment,
``recover``), SLO admission and tenancy come in a later slice; a non-finite
sampled row is counted in ``stats["nonfinite_rows"]``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import chunks_fit
from repro_torch.kernels.plan import quantize_packed_params
from repro_torch.models.api import model_fns
from repro_torch.models.layers import FLASH_ATTN_IMPLS
from repro_torch.serving.kv_slots import PagedSlotPool
from repro_torch.serving.scheduler import Request, Scheduler

PyTree = Any


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temps: torch.Tensor, topks: torch.Tensor,
                  use_topk: bool = True) -> torch.Tensor:
    """Per-slot sampling: temps==0 → greedy (first maximal index, as
    ``jnp.argmax``); topks>0 → top-k filtering. logits (B, V); temps (B,);
    topks (B,). Sampled rows take the Gumbel-max draw ``argmax(z + g)``,
    ``g = -log(-log(u))`` with ``u`` uniform from ``generator`` — what the
    reference's ``jax.random.categorical`` computes — so a NaN or ±inf row
    still yields a token (the engine counts it in
    ``stats["nonfinite_rows"]``) and never aborts the batch. Tokens match
    the reference only in distribution."""
    logits = logits.float()
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    z = logits
    if use_topk:
        srt = torch.sort(logits, dim=-1, descending=True).values
        kth = torch.gather(srt, 1, torch.clamp(topks.long() - 1, 0,
                                               v - 1)[:, None])
        allow = (topks[:, None] <= 0) | (logits >= kth)
        z = torch.where(allow, logits, torch.full_like(logits, -float("inf")))
    z = z / torch.clamp(temps, min=1e-6)[:, None]
    u = torch.rand(z.shape, generator=generator, device=z.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(z + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    capacity: int = 128
    seed: int = 0
    max_admit_per_step: Optional[int] = None  # None → fill every free slot
    min_bucket: int = 8
    # block-paged KV (the only pool the port has so far): kv_pages None →
    # full provisioning; fewer pages oversubscribe the pool and admission
    # control requeues what the budget cannot cover
    page_size: int = 16
    kv_pages: Optional[int] = None
    # chunked backfill: hold steady-state admissions until `backfill_chunk`
    # can be seated together (or `backfill_max_defer` decode steps pass, or
    # the engine is idle), then run ONE merged prefill for all of them
    backfill_chunk: int = 2
    backfill_max_defer: int = 2
    # quantized serving: "int8" KV pages (codes + per-row scales) and/or
    # int8 packed tiles (codes + per-tile scales)
    kv_dtype: str = ""
    weight_dtype: str = ""
    # reference options not ported yet: each raises NotImplementedError
    prefix_cache: bool = False
    spec_k: int = 0
    mesh_model: int = 1

    def __post_init__(self):
        unported = [
            (self.page_size <= 0, "page_size=0 (unpaged pools)"),
            (self.prefix_cache, "prefix_cache"),
            (self.spec_k > 0, "spec_k (speculative decoding)"),
            (self.mesh_model > 1, "mesh_model > 1 (tensor parallelism)"),
        ]
        for bad, what in unported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet; it comes in a later slice of "
                    f"the port (see ROADMAP.md)")
        for name in ("kv_dtype", "weight_dtype"):
            if getattr(self, name) not in ("", "int8"):
                raise ValueError(f"unsupported {name} "
                                 f"{getattr(self, name)!r}")


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params: PyTree,
                 ec: Optional[EngineConfig] = None, *, device="cuda"):
        ec = ec or EngineConfig()
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        if ec.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_dtype=ec.kv_dtype)
        if ec.weight_dtype:
            # idempotent: packs quantized by pack_params stay as they are
            params = quantize_packed_params(params)
        self.cfg = cfg
        self.ec = ec
        self.params = params
        self.fns = model_fns(cfg)
        if cfg.attn_impl in FLASH_ATTN_IMPLS:
            bad = [b for b in self._buckets() if not self._chunks_fit(b)]
            if bad:
                raise ValueError(
                    f"prefill buckets {bad} do not split into the flash "
                    f"chunks q_chunk={cfg.q_chunk}, kv_chunk={cfg.kv_chunk}")
        self.pool = PagedSlotPool(self.fns.init_cache, ec.n_slots,
                                  ec.capacity, page_size=ec.page_size,
                                  n_pages=ec.kv_pages, device=self.device)
        self.sched = Scheduler(ec.n_slots)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ec.seed)
        self._defer_steps = 0
        # bytes one cache position costs to read across all layers: K + V
        # (+ their fp32 scales under int8 KV)
        self._kv_row_bytes = sum(
            leaf[0, 0].numel() * leaf.element_size()
            for layer in self.pool.cache for leaf in layer.values())
        # per-slot decode-state rows (host-side mirrors of the ragged batch)
        self._tokens = np.zeros((ec.n_slots, 1), np.int32)
        self._temps = np.zeros((ec.n_slots,), np.float32)
        self._topks = np.zeros((ec.n_slots,), np.int32)
        self.stats: Dict[str, Any] = {}
        self.reset_stats()

    # -- request intake ----------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               eos_id: Optional[int] = None) -> int:
        """Enqueue a request; returns its rid. A request the engine can
        NEVER seat (slot capacity / page pool too small) is retired at once
        as REJECTED — the rid still comes back."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, eos_id=eos_id,
                      submit_time=time.perf_counter())
        total = prompt.size + max_new_tokens
        if total > self.ec.capacity:
            self.stats["rejected"] += 1
            return self.sched.reject(
                req, f"prompt_len {prompt.size} + max_new_tokens "
                     f"{max_new_tokens} exceeds slot capacity "
                     f"{self.ec.capacity}")
        need = self.pool.pages_needed(total)
        if need > self.pool.n_pages - 1:
            self.stats["rejected"] += 1
            return self.sched.reject(
                req, f"request needs {need} KV pages but the pool only has "
                     f"{self.pool.n_pages - 1} allocatable pages")
        return self.sched.submit(req)

    # -- internals ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Prefill length for an n-token prompt: the next power of two from
        ``min_bucket``, capped at the capacity — unless the fused flash
        prefill (``attn_impl="pallas"``) could not split the capped length
        into its chunks; the uncapped power of two is then kept (pad rows
        past the capacity land in the null page)."""
        b = self.ec.min_bucket
        while b < n:
            b *= 2
        cap = self.ec.capacity
        if b > cap and (self.cfg.attn_impl not in FLASH_ATTN_IMPLS
                        or self._chunks_fit(cap)):
            return cap
        return b

    def _chunks_fit(self, s: int) -> bool:
        return chunks_fit(s, s, self.cfg.q_chunk, self.cfg.kv_chunk)

    def _buckets(self) -> List[int]:
        """Every prefill length :meth:`_bucket` can return."""
        out, n = [], 1
        while True:
            b = self._bucket(n)
            out.append(b)
            if b >= self.ec.capacity:
                return out
            n = b + 1

    def _row_tiers(self) -> List[int]:
        """Admission-batch row counts: powers of two up to ``n_slots`` (plus
        ``n_slots`` itself), as in the reference."""
        tiers, t = [], 1
        while t < self.ec.n_slots:
            tiers.append(t)
            t *= 2
        tiers.append(self.ec.n_slots)
        return tiers

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                topks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Sample (B, V) logits; returns host (tokens, finite-row flags) in
        one transfer. An all-greedy batch skips the sampler."""
        if temps.any():
            tok = sample_tokens(logits, self._gen, self._tensor(temps),
                                self._tensor(topks),
                                use_topk=bool(topks.any()))
        else:
            tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        ok = torch.isfinite(logits).all(dim=-1).to(torch.int32)
        both = torch.stack([tok, ok]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _admit_group(self, group: List) -> None:
        """ONE prefill for a batch of admissions. Prompts are right-padded
        to the largest member's bucket and rows to the next tier; pad rows
        alias the group's first slot but carry zero table rows, so their
        KV lands in the null page."""
        k = len(group)
        bucket = max(self._bucket(req.prompt_len) for req, _ in group)
        k_pad = next(t for t in self._row_tiers() if t >= k)
        toks = np.zeros((k_pad, bucket), np.int32)
        lens = np.ones((k_pad,), np.int32)
        temps = np.zeros((k_pad,), np.float32)
        topks = np.zeros((k_pad,), np.int32)
        slots = np.zeros((k_pad,), np.int32)
        for i, (req, slot) in enumerate(group):
            p = req.prompt_len
            toks[i, :p] = req.prompt
            lens[i] = p
            temps[i] = req.temperature
            topks[i] = req.top_k
            slots[i] = slot
        slots[k:] = slots[0]
        logits, pcache = self.fns.prefill(
            self.params, {"tokens": self._tensor(toks),
                          "length": self._tensor(lens)})
        tok, ok = self._sample(logits[:, -1], temps, topks)
        self.pool.insert_rows(pcache, slots, lens[:k])
        self.stats["prefills"] += 1
        now = time.perf_counter()
        for i, (req, slot) in enumerate(group):
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            self.stats["nonfinite_rows"] += int(not ok[i])
            req.admit_time = now
            req.first_token_time = now
            req.generated.append(int(tok[i]))
            req.token_times.append(now)
            self._tokens[slot, 0] = int(tok[i])
            self.stats["tokens_generated"] += 1

    def _should_admit(self) -> bool:
        """Chunked-backfill hysteresis: admit at once when idle or when a
        full chunk can be seated; otherwise defer up to
        ``backfill_max_defer`` decode steps."""
        ready = min(self.sched.free_slots(), len(self.sched.waiting))
        if ready == 0:
            return False
        chunk = max(1, min(self.ec.backfill_chunk, self.ec.n_slots))
        if chunk <= 1 or not self.sched.active or ready >= chunk:
            return True
        if self._defer_steps >= self.ec.backfill_max_defer:
            return True
        self._defer_steps += 1
        return False

    def step(self) -> List[Request]:
        """One engine iteration; returns the requests that finished."""
        finished: List[Request] = []
        admitted = (self.sched.admit(self.ec.max_admit_per_step)
                    if self._should_admit() else [])
        if admitted:
            # page-budget admission control, strict FCFS: the first request
            # that does not fit requeues itself and everything behind it
            fit = len(admitted)
            for i, (req, slot) in enumerate(admitted):
                if not self.pool.reserve(slot,
                                         req.prompt_len + req.max_new_tokens):
                    fit = i
                    break
            for req, slot in reversed(admitted[fit:]):
                self.sched.requeue(slot)
                self.stats["page_stalls"] += 1
            admitted = admitted[:fit]
        if admitted:
            self._defer_steps = 0
            self._admit_group(admitted)

        # requests whose first (prefill-sampled) token already completed them
        for slot, req in list(self.sched.active.items()):
            if req.is_finished():
                self.pool.release(slot)
                finished.append(self.sched.retire(slot))
        if not self.sched.active:
            return finished

        self.stats["slot_occupancy"].append(len(self.sched.active))
        for slot in self.sched.active:
            self.pool.ensure(slot, int(self.pool.lens[slot]) + 1)
        bt = self.pool.device_tables(self.pool.table_width(extra=1))
        self.stats["kv_bytes_read_live"] += (self.pool.live_page_rows()
                                             * self._kv_row_bytes)
        logits, self.pool.cache = self.fns.decode_step(
            self.params, {"tokens": self._tensor(self._tokens),
                          "cache_len": self._tensor(self.pool.lens),
                          "block_tables": bt}, self.pool.cache)
        next_tok, ok = self._sample(logits[:, -1], self._temps, self._topks)
        now = time.perf_counter()
        self.stats["decode_steps"] += 1
        for slot, req in list(self.sched.active.items()):
            self.stats["nonfinite_rows"] += int(not ok[slot])
            tok = int(next_tok[slot])
            req.generated.append(tok)
            req.token_times.append(now)
            self.pool.advance(slot)
            self._tokens[slot, 0] = tok
            self.stats["tokens_generated"] += 1
            if req.is_finished():
                self.pool.release(slot)
                finished.append(self.sched.retire(slot))
        return finished

    # -- convenience -------------------------------------------------------

    def reset_stats(self) -> None:
        self.stats.clear()
        self.stats.update(decode_steps=0, prefills=0, tokens_generated=0,
                          page_stalls=0, kv_bytes_read_live=0,
                          slot_occupancy=[], rejected=0, nonfinite_rows=0)

    def run(self) -> List[Request]:
        """Drain: step until queue and slots are empty; finished requests in
        completion order."""
        done: List[Request] = []
        while self.sched.has_work():
            done.extend(self.step())
        return done

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, eos_id: Optional[int] = None
                 ) -> List[List[int]]:
        """Batch convenience: submit all prompts, drain, return generated
        token lists in submission order (empty for rejected requests)."""
        rids = [self.submit(p, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_id=eos_id) for p in prompts]
        by_rid = {r.rid: r for r in self.run()}
        return [by_rid[rid].generated if rid in by_rid else []
                for rid in rids]

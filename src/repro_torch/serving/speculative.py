"""Speculative decoding: drafters + acceptance rules for the engine.

The multiplier: a cheap drafter proposes ``k`` tokens per live slot and
the target model scores all of them (plus the pending token) in ONE
``prefill_append`` dispatch against the paged prefix — decode is the S=1
special case of that kernel, so verification reuses the decode grid at
block width ``k + 1`` instead of paying ``k + 1`` sequential dispatches.
Acceptance then keeps the longest draft prefix the target agrees with and
always emits one more token from the target's own distribution (the
correction on a reject, the bonus on a full accept), so every speculative
step commits between 1 and ``k + 1`` tokens and the output distribution
is exactly the target's.

Position bookkeeping the engine and drafters share: a slot whose request
has committed ``g`` tokens over a ``P``-token prompt has target length
``P + g - 1`` — positions ``[0, P + g - 1)`` hold K/V for the prompt plus
all committed tokens except the last, and the last committed token is the
*pending* token whose K/V the next dispatch writes. Token at absolute
position ``P + i`` is ``generated[i]``.

Two drafters implement the engine's protocol:

* :class:`DraftModel` — a real second model: the same ``causal_lm`` stack
  at a small (optionally BCR-packed) config sharing the target's token
  space, running its own capacity-dense :class:`SlotPool`. Proposals come
  from ``k`` batched single-token decode steps; its cache trails the
  target by at most one position (the full-accept bonus token), which the
  next round's first step re-feeds.
* :class:`OracleDraft` — a synthetic high-acceptance drafter that replays
  precomputed continuations keyed by request id. No model, no state: it
  isolates the verify-dispatch economics (benches) and exercises the
  full-acceptance path (tests) — with a greedy target its proposals are
  always accepted.

A drafter only affects *speed*: acceptance re-derives every emitted token
from the target's logits, so greedy speculative output is bit-identical
to plain greedy decode no matter how bad the drafter is.

Acceptance is the reference's float64 numpy with a ``np.random.Generator``
(the functions below are copies of the reference's), so one seed gives the
same accept and resample decisions in both packages. The drafter's model
runs through the port's own ``causal_lm`` on torch tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import prefill_bucket
from repro_torch.models.api import model_fns
from repro_torch.models.layers import flash_chunks
from repro_torch.serving.kv_slots import SlotPool
from repro_torch.serving.scheduler import Request


def transform_probs(logits: np.ndarray, temperature: float,
                    top_k: int) -> np.ndarray:
    """Host-side mirror of ``engine.sample_tokens``'s distribution: top-k
    filter on raw logits, then temperature, then softmax. float64 so
    acceptance ratios are stable."""
    z = np.asarray(logits, np.float64)
    if top_k > 0:
        k = min(top_k, z.size)
        kth = np.partition(z, -k)[-k]       # O(V), vs a full-vocab sort
        z = np.where(z >= kth, z, -np.inf)
    z = z / max(temperature, 1e-6)
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def accept_greedy(argmaxes: np.ndarray, props: Sequence[int]
                  ) -> Tuple[int, int]:
    """Greedy acceptance off (n+1,) precomputed target argmaxes: accept
    while the proposal equals the argmax; the follow-up token is the
    argmax at the break — bit-identical to plain greedy decode. This is
    the all-greedy fast path: the verify dispatch ships only these int
    rows instead of full logit rows."""
    a = 0
    while a < len(props) and int(props[a]) == int(argmaxes[a]):
        a += 1
    return a, int(argmaxes[a])


def accept_draft(rows: np.ndarray, props: Sequence[int],
                 qrows: Optional[np.ndarray], temperature: float,
                 top_k: int, rng: np.random.Generator) -> Tuple[int, int]:
    """Pick the longest accepted draft prefix + the follow-up token.

    ``rows`` are the target logits (n+1, V) from the verify dispatch —
    row ``j`` is the target's distribution for the token after draft
    ``j`` (row 0: after the pending token). ``props`` the n proposed
    tokens, ``qrows`` the drafter's proposal distributions (n, V), or
    None for a deterministic drafter (a point mass at the proposal).

    Greedy (temperature 0): accept while the proposal equals the target
    argmax; the follow-up is the argmax at the break — bit-identical to
    plain greedy decode. Sampled: standard speculative sampling — accept
    ``d`` with probability ``min(1, p(d)/q(d))``, on rejection resample
    from the normalized residual ``max(p - q, 0)``; a full accept samples
    the bonus from the last row. Both return (accepted_count,
    follow_up_token)."""
    if temperature <= 0:
        return accept_greedy(np.asarray(rows).argmax(axis=-1), props)
    for j, d in enumerate(props):
        d = int(d)
        p = transform_probs(rows[j], temperature, top_k)
        q = None if qrows is None else np.asarray(qrows[j], np.float64)
        qd = 1.0 if q is None else float(q[d])
        if rng.random() < min(1.0, float(p[d]) / max(qd, 1e-300)):
            continue
        if q is None:
            resid = p.copy()
            resid[d] = 0.0
        else:
            resid = np.maximum(p - q, 0.0)
        s = resid.sum()
        resid = resid / s if s > 0 else p
        return j, int(rng.choice(resid.size, p=resid))
    p = transform_probs(rows[len(props)], temperature, top_k)
    return len(props), int(rng.choice(p.size, p=p))


class DraftModel:
    """Model-based drafter: a small ``causal_lm`` sharing the target's
    token space, serving proposals out of its own capacity-dense
    :class:`SlotPool` on the engine's device. The port's families (dense,
    MoE) are pure attention, so the drafter can rewind; a MoE drafter's
    routing sees only real tokens (pad positions and free slots are
    masked out of expert capacity, as in the engine).

    Protocol driven by the engine:

      ``admit(group)``      — full-prompt prefill into the drafter's own
                              cache for freshly admitted requests (the
                              drafter has no prefix cache, so prefix-hit
                              admissions still prefill everything here);
      ``propose(...)``      — ``k`` batched single-token decode steps per
                              engine step, catching up at most one
                              position first (see module docstring);
      ``rollback(slot, L)`` — clamp the drafter length to the target's
                              post-commit length (rejected-draft K/V past
                              it is masked, then overwritten);
      ``release(slot)``     — slot retired.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int,
                 capacity: int, min_bucket: int = 8, *, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.capacity = capacity
        self.min_bucket = min_bucket
        self.device = resolve_device(device)
        self.fns = model_fns(cfg)
        self.pool = SlotPool(self.fns.init_cache, n_slots, capacity,
                             device=self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def admit(self, group: List[Tuple[Request, int]]) -> None:
        """One drafter prefill for a batch of admissions: full prompts,
        right-padded to the engine's bucket rule (``prefill_bucket``),
        one row a request (no pad rows: nothing here is compiled per row
        count)."""
        k = len(group)
        bucket = max(prefill_bucket(req.prompt_len, self.min_bucket,
                                    self.capacity, flash_chunks(self.cfg))
                     for req, _ in group)
        toks = np.zeros((k, bucket), np.int32)
        lens = np.ones((k,), np.int32)
        mask = np.zeros((k, bucket), bool)
        slots = np.zeros((k,), np.int32)
        for i, (req, slot) in enumerate(group):
            p = req.prompt_len
            toks[i, :p] = req.prompt
            lens[i] = p
            mask[i, :p] = True
            slots[i] = slot
        _, pcache = self.fns.prefill(
            self.params, {"tokens": self._tensor(toks),
                          "length": self._tensor(lens),
                          "token_mask": self._tensor(mask)})
        self.pool.insert_rows(pcache, slots, lens)

    def propose(self, active: List[Tuple[int, Request]],
                target_lens: np.ndarray, k: int, rng: np.random.Generator
                ) -> Dict[int, Tuple[List[int], Optional[np.ndarray]]]:
        """``k`` batched single-token decode steps → per-slot proposals.

        Each slot first re-feeds the committed tokens its cache is
        missing (at most one: the full-accept bonus token), then its own
        chain — greedy for greedy requests, sampled from the drafter's
        temperature/top-k distribution otherwise (those proposal
        distributions are returned for the acceptance ratio). A slot with
        catch-up to do yields one fewer proposal this round. An all-greedy
        round copies only the ``(B,)`` argmaxes to the host."""
        feeds: Dict[int, List[int]] = {}
        for slot, req in active:
            dlen = int(self.pool.lens[slot])
            tlen = int(target_lens[slot])
            if not 0 <= tlen - dlen <= 1:
                raise AssertionError(f"drafter slot {slot} at {dlen} "
                                     f"positions, target at {tlen}")
            # tokens for positions [dlen, tlen]: trailing committed tokens
            # the drafter has not ingested, ending with the pending one.
            # Generated token i sits at absolute position
            # (prompt_len - folded) + i — preemption folds re-played
            # tokens into the prompt, so the base shifts by ``folded``.
            base = req.prompt_len - req.folded
            feeds[slot] = [int(t) for t in req.generated[dlen - base:]]
        toks = np.zeros((self.n_slots, 1), np.int32)
        for slot, _ in active:
            toks[slot, 0] = feeds[slot][0]
        props: Dict[int, List[int]] = {slot: [] for slot, _ in active}
        qrows: Dict[int, List[np.ndarray]] = {slot: [] for slot, _ in active}
        greedy_only = all(req.temperature <= 0 for _, req in active)
        for j in range(k):
            logits, self.pool.cache = self.fns.decode_step(
                self.params, {"tokens": self._tensor(toks),
                              "cache_len": self._tensor(self.pool.lens),
                              "token_mask": self._tensor(
                                  self.pool.lens > 0)[:, None]},
                self.pool.cache)
            last = logits[:, -1]
            if greedy_only:
                lg = torch.argmax(last.float(), dim=-1).cpu().numpy()
            else:
                lg = last.float().cpu().numpy()
            for slot, req in active:
                self.pool.advance(slot)
                if j + 1 < len(feeds[slot]):
                    nxt = feeds[slot][j + 1]      # catch-up: output unused
                elif req.temperature > 0:
                    q = transform_probs(lg[slot], req.temperature, req.top_k)
                    nxt = int(rng.choice(q.size, p=q))
                    props[slot].append(nxt)
                    qrows[slot].append(q)
                else:
                    nxt = int(lg[slot] if greedy_only else lg[slot].argmax())
                    props[slot].append(nxt)
                toks[slot, 0] = nxt
        return {slot: (props[slot],
                       np.asarray(qrows[slot]) if qrows[slot] else None)
                for slot, _ in active}

    def rollback(self, slot: int, length: int) -> None:
        self.pool.truncate(slot, min(int(self.pool.lens[slot]), length))

    def release(self, slot: int) -> None:
        self.pool.release(slot)


class OracleDraft:
    """Synthetic high-acceptance drafter: replays precomputed
    continuations keyed by request id (``continuations[rid]`` = the full
    expected ``generated`` list, e.g. recorded from a plain greedy run of
    the same workload). Unknown rids (engine warmup's throwaway requests)
    draw no proposals, degrading those steps to 1-token verify dispatches.
    Stateless — no cache, no catch-up, always ``k`` proposals."""

    def __init__(self, continuations: Optional[Dict[int, Sequence[int]]]
                 = None):
        self.continuations: Dict[int, Sequence[int]] = dict(
            continuations or {})

    def admit(self, group) -> None:
        pass

    def propose(self, active, target_lens, k, rng):
        out = {}
        for slot, req in active:
            cont = self.continuations.get(req.rid, ())
            done = len(req.generated)
            out[slot] = ([int(t) for t in cont[done:done + k]], None)
        return out

    def rollback(self, slot: int, length: int) -> None:
        pass

    def release(self, slot: int) -> None:
        pass

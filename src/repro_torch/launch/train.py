"""Training entry point and the train-step factory (the reference's
``launch/train.py``): GRIM's pruning pipeline — dense warm-up, ADMM-BCR
with Z/U dual updates, then frozen-mask retraining.

The step runs the loss (plus the ADMM penalty) forward and backward with
autograd through plain PyTorch ops (the reference has no backward kernel),
accumulates microbatch gradients, and applies AdamW and the frozen masks in
place. The loop wraps it with phase transitions, async checkpoints,
straggler records and resume. Parameters are a nested dict of leaf tensors
with ``requires_grad``; init and data come from explicit seeds (a
``torch.Generator`` for the weights, numpy for the batches).

CLI (runs on the card; ``--device cpu`` runs the plain path on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --steps 8 --batch 2 --seq 32 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import admm as admm_mod
from repro_torch.core.bcr import BCRSpec, choose_block_shape, kept_align
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.models.api import model_fns
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import StragglerDetector
from repro_torch.tree import leaves, tree_map

PyTree = Any


# ---------------------------------------------------------------------------
# BCR prune-filter: which params get the paper's sparsity
# ---------------------------------------------------------------------------


def default_prune_filter(cfg: ModelConfig):
    """BCR on every projection weight named 'w' (attention, MLP and MoE
    expert projections + lm_head; a stacked ``(E, N, K)`` expert weight by
    its trailing 2-D shape), excluding embeddings and norms — the paper's
    FC/GEMM scope. Takes a leaf's path (``['lm_head']['w']``) and tensor."""
    if cfg.bcr_keep_frac <= 0:
        return lambda name, leaf: None

    def fil(name: str, leaf: torch.Tensor) -> Optional[BCRSpec]:
        if not name.endswith("['w']"):
            return None
        if "embed" in name:
            return None
        if leaf.dim() < 2 or min(leaf.shape[-2:]) < 2 * min(cfg.bcr_block):
            return None
        block = choose_block_shape(tuple(leaf.shape[-2:]), cfg.bcr_block)
        return BCRSpec(block_shape=block, keep_frac=cfg.bcr_keep_frac,
                       align=kept_align(block))

    return fil


# ---------------------------------------------------------------------------
# Train state / step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt: adamw.AdamWState
    admm: Optional[admm_mod.ADMMState]
    masks: Optional[PyTree]           # frozen BCR masks (retrain phase)


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int):
    return [{k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum)]


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    admm_cfg: Optional[admm_mod.ADMMConfig] = None,
                    specs: Optional[Dict[str, BCRSpec]] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``. The step
    writes the new params and moments into ``state``'s tensors.

    Weight decay follows the reference's default mask for ``cfg`` (leaves
    of rank ≥ 2 in its stacked layout, :func:`adamw.decay_mask`). The loss
    is the family's (``model_fns``): an encdec batch carries ``frames``
    beside ``tokens`` and ``targets``."""

    fns = model_fns(cfg)
    loss_fn = fns.loss_fn

    def loss_with_penalty(params, mb, admm_state):
        loss = loss_fn(params, mb)
        if admm_state is not None and specs:
            loss = loss + admm_mod.admm_penalty(params, admm_state, specs,
                                                admm_cfg).to(loss.device)
        return loss

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        accum = max(cfg.grad_accum, 1)
        flat = leaves(state.params)
        for p in flat:
            p.grad = None
        if accum == 1:
            loss = loss_with_penalty(state.params, batch, state.admm)
            loss.backward()
            loss = loss.detach()
        else:
            # the microbatch grads sum in .grad; the reference sums them in
            # fp32 too, then divides loss and grads by accum
            loss = 0.0
            for mb in _split_microbatches(batch, accum):
                ml = loss_with_penalty(state.params, mb, state.admm)
                ml.backward()
                loss = loss + ml.detach()
            loss = loss / accum
            with torch.no_grad():
                for p in flat:
                    p.grad.div_(accum)
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), state.params)
        params, opt, metrics = adamw.update(
            opt_cfg, grads, state.opt, state.params,
            decay_mask=adamw.decay_mask(state.params, stacked=fns.stacked))
        for p in flat:
            p.grad = None
        if state.masks is not None:
            admm_mod.apply_masks(params, state.masks)
        metrics["loss"] = loss
        return TrainState(params, opt, state.admm, state.masks), metrics

    return train_step


# ---------------------------------------------------------------------------
# Host-scale training loop (examples / integration tests / CLI)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    admm_start: Optional[int] = None    # step to begin the ADMM phase
    retrain_start: Optional[int] = None # step to freeze masks and retrain
    data_kind: str = "synthetic"
    log_every: int = 10
    seed: int = 0
    device: str = "cuda"                # the card unless asked for "cpu"


def init_state(cfg: ModelConfig, seed: int, device) -> TrainState:
    """Seeded params (``requires_grad``) and a fresh AdamW state."""
    params = model_fns(cfg).init_params(seed, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params, adamw.init(params), None, None)


def _resume_like(state: TrainState, specs, tc: TrainerConfig,
                 step: int) -> TrainState:
    """The state's structure after the phase transitions of steps
    ``< step``: with Z/U while ADMM runs, with masks once retraining has
    begun. (The reference restores into a dense-phase state only, so it
    cannot resume a checkpoint written after ``admm_start``.)"""
    def zeros_pruned():
        return admm_mod._map_pruned(
            lambda spec, w: torch.zeros_like(w) if spec else None,
            state.params, specs=specs)
    retrained = tc.retrain_start is not None and tc.retrain_start < step
    in_admm = (tc.admm_start is not None and tc.admm_start < step
               and not retrained)
    admm = (admm_mod.ADMMState(zeros_pruned(), zeros_pruned(),
                               torch.zeros((), dtype=torch.int32))
            if in_admm and specs else None)
    masks = zeros_pruned() if retrained and specs else None
    return TrainState(state.params, state.opt, admm, masks)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(cfg: ModelConfig, tc: TrainerConfig,
               opt_cfg: Optional[adamw.AdamWConfig] = None,
               log=print) -> Dict[str, Any]:
    """Dense → ADMM (from ``tc.admm_start``) → retrain (from
    ``tc.retrain_start``) for ``tc.steps`` steps on ``tc.device``.

    Returns ``state``, ``history`` (loss per step), ``specs``, and the
    timings a run on the card reports: ``step_ms`` and ``phases`` (one
    entry per step run) and ``transition_ms`` (ADMM init, each dual
    update, finalize)."""
    dev = resolve_device(tc.device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-3, warmup_steps=min(20, tc.steps // 5 + 1),
        total_steps=tc.steps)
    admm_cfg = admm_mod.ADMMConfig(steps_per_admm=max(tc.steps // 10, 5))
    prune_filter = default_prune_filter(cfg)

    state = init_state(cfg, tc.seed, dev)
    specs = admm_mod.specs_for(state.params, prune_filter)

    data = TokenSource(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=tc.seq, global_batch=tc.batch,
        seed=tc.seed, kind=tc.data_kind))

    mgr = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(start_step,
                            _resume_like(state, specs, tc, start_step))
        log(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, admm_cfg, specs)
    straggler = StragglerDetector()
    history, step_ms, phases = [], [], []
    transition_ms: Dict[str, Any] = {"dual_update": []}
    for step in range(start_step, tc.steps):
        # phase transitions (ADMM → retrain)
        if tc.admm_start is not None and step == tc.admm_start and specs:
            t0 = time.perf_counter()
            state = TrainState(state.params, state.opt,
                               admm_mod.admm_init(state.params, specs), None)
            _sync(dev)
            transition_ms["admm_init"] = (time.perf_counter() - t0) * 1e3
            log(f"step {step}: ADMM phase begins ({len(specs)} pruned "
                f"tensors)")
        if (tc.retrain_start is not None and step == tc.retrain_start
                and specs):
            t0 = time.perf_counter()
            pruned, masks = admm_mod.finalize(state.params, specs)
            state = TrainState(pruned, state.opt, None, masks)
            _sync(dev)
            transition_ms["finalize"] = (time.perf_counter() - t0) * 1e3
            log(f"step {step}: masks frozen; retraining")
        if (state.admm is not None and specs
                and step % admm_cfg.steps_per_admm == 0 and step > 0):
            t0 = time.perf_counter()
            new_admm = admm_mod.admm_dual_update(state.params, state.admm,
                                                 specs)
            state = TrainState(state.params, state.opt, new_admm, state.masks)
            _sync(dev)
            transition_ms["dual_update"].append(
                (time.perf_counter() - t0) * 1e3)

        t0 = time.perf_counter()
        batch = data.device_batch(step, dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0
        straggler.record(0, dt)
        history.append(loss)
        step_ms.append(dt * 1e3)
        phases.append("retrain" if state.masks is not None else
                      "admm" if state.admm is not None else "dense")
        if step % tc.log_every == 0:
            log(f"step {step:5d} loss {loss:8.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f} ms")
        if mgr and (step + 1) % tc.ckpt_every == 0:
            mgr.save_async(step + 1, state)
    if mgr:
        mgr.wait()
    return {"state": state, "history": history, "specs": specs,
            "step_ms": step_ms, "phases": phases,
            "transition_ms": transition_ms}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bcr-keep", type=float, default=0.0)
    p.add_argument("--admm-start", type=int, default=None)
    p.add_argument("--retrain-start", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "markov", "file"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.bcr_keep > 0:
        cfg = dataclasses.replace(cfg, bcr_keep_frac=args.bcr_keep)
    tc = TrainerConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, admm_start=args.admm_start,
                       retrain_start=args.retrain_start, data_kind=args.data,
                       device=args.device)
    train_loop(cfg, tc, adamw.AdamWConfig(lr=args.lr, total_steps=args.steps))


if __name__ == "__main__":
    main()

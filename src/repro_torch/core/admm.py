"""ADMM-based BCR pruning (GRIM §5.2), the reference's ``core/admm.py``.

minimize f(W) + Σ g_i(Z_i)   s.t. W_i = Z_i,   g_i = indicator of BCR set S_i

  W-step:  AdamW on  f(W) + Σ ρ_i/2 ||W_i − Z_i + U_i||_F²
  Z-step:  Z_i ← Π_{S_i}(W_i + U_i)          (bcr_project)
  U-step:  U_i ← U_i + W_i − Z_i

A ``prune_filter(path, leaf)`` selects which leaves are BCR-constrained;
specs are keyed by the port's leaf paths (:mod:`repro_torch.tree`, e.g.
``['layers'][3]['ffn']['wo']['w']``). ``z``/``u`` (and the retrain masks)
are trees nested like the params, with ``None`` on unpruned leaves, as in
the reference. After ADMM the support is frozen (``finalize``) and
retraining proceeds with a hard mask.

Where the reference returns new trees, ``admm_dual_update``, ``finalize``
and ``apply_masks`` write into the tensors they are given (no second copy
of a full-width model's Z, U or params).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.bcr import BCRSpec, bcr_mask_any, bcr_project_any
from repro_torch.tree import flatten, leaves, unflatten

PyTree = Any
PruneFilter = Callable[[str, torch.Tensor], Optional[BCRSpec]]


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    rho_init: float = 1e-4
    rho_final: float = 1e-1        # paper: ρ grows exponentially 1e-4 → 1e-1
    num_admm_steps: int = 8        # number of Z/U updates (paper: per epoch)
    steps_per_admm: int = 50       # W-steps between consecutive Z/U updates

    def rho_at(self, admm_iter) -> torch.Tensor:
        """ρ after ``admm_iter`` dual updates, fp32 as in the reference."""
        it = torch.as_tensor(admm_iter, dtype=torch.float32)
        t = torch.clamp(it / max(self.num_admm_steps - 1, 1), 0.0, 1.0)
        base = torch.tensor(self.rho_final / self.rho_init,
                            dtype=torch.float32)
        return self.rho_init * base ** t


def specs_for(params: PyTree, prune_filter: PruneFilter
              ) -> Dict[str, BCRSpec]:
    """The BCRSpec of every pruned leaf, keyed by its path."""
    out = {}
    for path, leaf in flatten(params):
        spec = prune_filter(path, leaf)
        if spec is not None:
            out[path] = spec
    return out


@dataclasses.dataclass
class ADMMState:
    z: PyTree                 # auxiliary variables (None on unpruned leaves)
    u: PyTree                 # scaled duals (None on unpruned leaves)
    admm_iter: torch.Tensor   # int32 0-d, on the CPU


def _map_pruned(fn, params: PyTree, *trees: PyTree,
                specs: Dict[str, BCRSpec]) -> PyTree:
    """A tree like ``params`` of ``fn(spec, leaf, *other_leaves)``; spec is
    None on unpruned leaves."""
    others = [leaves(t) for t in trees]
    out = [fn(specs.get(path), leaf, *(o[i] for o in others))
           for i, (path, leaf) in enumerate(flatten(params))]
    return unflatten(params, out)


@torch.no_grad()
def admm_init(params: PyTree, specs: Dict[str, BCRSpec]) -> ADMMState:
    z = _map_pruned(lambda spec, w: bcr_project_any(w, spec) if spec else None,
                    params, specs=specs)
    u = _map_pruned(lambda spec, w: torch.zeros_like(w) if spec else None,
                    params, specs=specs)
    return ADMMState(z=z, u=u, admm_iter=torch.zeros((), dtype=torch.int32))


def admm_penalty(params: PyTree, state: ADMMState,
                 specs: Dict[str, BCRSpec], cfg: ADMMConfig) -> torch.Tensor:
    """Σ ρ/2 ||W − Z + U||² — add to the task loss for the W-step
    (differentiable in W; Z and U are constants)."""
    rho = cfg.rho_at(state.admm_iter)
    terms = [t for t in leaves(_map_pruned(
        lambda spec, w, z, u: None if spec is None else
        0.5 * torch.sum(torch.square((w - z + u).float())),
        params, state.z, state.u, specs=specs)) if t is not None]
    if not terms:
        return torch.zeros(())
    return rho.to(terms[0].device) * torch.stack(terms).sum()


@torch.no_grad()
def admm_dual_update(params: PyTree, state: ADMMState,
                     specs: Dict[str, BCRSpec]) -> ADMMState:
    """Z ← Π_S(W + U); U ← U + W − Z (every ``cfg.steps_per_admm`` steps).
    Writes into ``state``'s Z and U tensors."""
    for (path, w), z, u in zip(flatten(params), leaves(state.z),
                               leaves(state.u)):
        spec = specs.get(path)
        if spec is None:
            continue
        z.copy_(bcr_project_any((w + u).float(), spec).to(w.dtype))
        u.add_(w).sub_(z)
    return ADMMState(z=state.z, u=state.u, admm_iter=state.admm_iter + 1)


@torch.no_grad()
def primal_residual(params: PyTree, state: ADMMState,
                    specs: Dict[str, BCRSpec]) -> torch.Tensor:
    """||W − Z||_F / ||W||_F aggregated — ADMM convergence diagnostic."""
    num, den = [], []
    for (path, w), z in zip(flatten(params), leaves(state.z)):
        if path not in specs:
            continue
        num.append(torch.sum(torch.square((w - z).float())))
        den.append(torch.sum(torch.square(w.float())))
    if not num:
        return torch.zeros(())
    return torch.sqrt(torch.stack(num).sum()
                      / torch.clamp(torch.stack(den).sum(), min=1e-12))


@torch.no_grad()
def finalize(params: PyTree, specs: Dict[str, BCRSpec]):
    """Hard-project params in place and return ``(params, masks)`` for
    retraining (fp32 {0,1} masks, None on unpruned leaves)."""
    masks = _map_pruned(lambda spec, w: bcr_mask_any(w, spec) if spec else None,
                        params, specs=specs)
    apply_masks(params, masks)
    return params, masks


@torch.no_grad()
def apply_masks(params: PyTree, masks: PyTree) -> PyTree:
    """Re-apply frozen masks in place after an optimizer step (retraining
    phase)."""
    for w, m in zip(leaves(params), leaves(masks)):
        if m is not None:
            w.mul_(m.to(w.dtype))
    return params

"""BCR-sparsifiable Linear — the integration point between the paper's
technique and the model layers.

``linear_apply`` consumes either representation:
  * dense ``{"w": (N, K) [, "b"]}``       → a plain matmul
  * packed ``{"w_packed": TBCRC [, "b"]}`` → the BCR kernel (serving path)
``grouped_linear_apply`` consumes ``{"w_group": GroupedTBCRC [, "b"]}``.

A weight stacked on a leading expert axis (an MoE layer's experts: dense
``w`` ``(E, N, K)``, or a stacked pack) takes x ``(E, M, K)``; expert
``e``'s rows meet expert ``e``'s weight. Dispatch is by device, as for a
plain weight: the kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.bcr import BCRSpec, choose_block_shape

Params = Dict[str, Any]


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
                bias: bool = False, dtype=torch.float32) -> Params:
    dev = generator.device
    w = (torch.randn((out_dim, in_dim), generator=generator, device=dev)
         * in_dim ** -0.5)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=dev)
    return p


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "w_packed" in params:
        from repro_torch.kernels.ops import bcr_matmul  # lazy: core <-> kernels
        y = bcr_matmul(x, params["w_packed"])
    else:
        y = x @ params["w"].mT.to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def linear_in_dim(params: Params) -> int:
    """The input width ``K`` of a dense, packed or fused linear."""
    if "w_packed" in params:
        return params["w_packed"].shape[1]
    if "w_group" in params:
        return params["w_group"].shape[1]
    return params["w"].shape[-1]


def grouped_linear_apply(params: Params, x: torch.Tensor, *,
                         epilogue: Optional[str] = None):
    """Apply a fused projection group sharing activation ``x``; returns one
    output per member (Q/K/V or gate/up order is the member order used at
    fuse time). Bias and ``epilogue`` run inside the kernel's emit step;
    ``epilogue="swiglu"`` returns ``silu(y_gate) * y_up`` directly."""
    from repro_torch.kernels.ops import bcr_matmul_grouped  # lazy
    grouped = params["w_group"]
    y = bcr_matmul_grouped(x, grouped, bias=params.get("b"),
                           epilogue=epilogue)
    if epilogue == "swiglu":
        return y                                              # (..., N)
    return tuple(y[..., g, :] for g in range(grouped.group_size))


def pack_linear(params: Params, spec: BCRSpec, *,
                tune_m: Optional[int] = 8) -> Params:
    """Dense (ADMM-pruned) → packed serving representation.

    ``tune_m`` (decode-batch hint) wires in the §4.5 GA tuner: the packed
    weight carries a plan whose dispatch genome (M tile, configuration,
    split) was searched against the model of the CUDA kernel on an H100 —
    pass ``None`` to keep the default plan (the kernel's rule)."""
    from repro_torch.core.bcrc import tbcrc_pack  # lazy: core <-> kernels
    packed = tbcrc_pack(params["w"], spec)
    if tune_m:
        from repro_torch.kernels.plan import tune_packed  # lazy
        packed = tune_packed(packed, m=tune_m)
    out = {"w_packed": packed}
    if "b" in params:
        out["b"] = params["b"]
    return out


def spec_for_shape(shape, keep_frac: float, target_block=(256, 256),
                   align: int = 8) -> BCRSpec:
    """Helper: a valid BCRSpec for an arbitrary (N, K) weight."""
    return BCRSpec(block_shape=choose_block_shape(tuple(shape), target_block),
                   keep_frac=keep_frac, align=align)

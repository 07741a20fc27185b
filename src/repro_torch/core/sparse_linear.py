"""BCR-sparsifiable Linear — the integration point between the paper's
technique and the model layers.

``linear_apply`` consumes either representation:
  * dense ``{"w": (N, K) [, "b"]}``       → a plain matmul
  * packed ``{"w_packed": TBCRC [, "b"]}`` → the BCR kernel (serving path)
``grouped_linear_apply`` consumes ``{"w_group": GroupedTBCRC [, "b"]}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

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
        y = x @ params["w"].T.to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


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

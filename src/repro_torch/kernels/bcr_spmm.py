"""BCR block-sparse matmul over TBCRC-packed weights: the hand-written CUDA
kernels of ``csrc/bcr_spmm.cu`` and their wrappers.

* :func:`bcr_spmm` — ``y[M, N] = x[M, K] @ W.T``; replaces the reference's
  TPU kernel ``kernels/bcr_spmm.py:bcr_spmm``.
* :func:`bcr_spmm_grouped` — G same-shaped packed weights over one ``x``,
  with a fused ``(G, N)`` bias and optional SwiGLU epilogue; replaces
  ``kernels/bcr_spmm.py:bcr_spmm_grouped``.

Each has two forms, chosen by the packed ``vals``: the fp form (tiles in
x's dtype) and the int8 form (int8 codes with one fp32 scale per tile on
``plan.block_scales``, the reference's quantized serving).

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version in :mod:`repro_torch.kernels.ref`. Each
launch adds one to ``LAUNCHES[<kernel>]``, with separate keys per form
(``bcr_spmm`` / ``bcr_spmm_int8``, ``bcr_spmm_grouped`` /
``bcr_spmm_grouped_int8``). The kernels' design notes (what bounds them on
the card, and what the design does about it) head the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"bcr_spmm": 0, "bcr_spmm_grouped": 0, "bcr_spmm_int8": 0,
            "bcr_spmm_grouped_int8": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 200 * 1024    # of the 227 KB a Hopper CTA may take
_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.bcr_spmm_smem_bytes.argtypes = [_I] * 6
    lib.bcr_spmm_smem_bytes.restype = ctypes.c_longlong
    lib.bcr_spmm_launch.argtypes = ([_I, _I] + [_P] * 6 + [_I] * 10
                                    + [_P])
    lib.bcr_spmm_launch.restype = _I
    lib.bcr_spmm_grouped_launch.argtypes = ([_I, _I, _I] + [_P] * 7
                                            + [_I] * 11 + [_P])
    lib.bcr_spmm_grouped_launch.restype = _I


def _lib() -> ctypes.CDLL:
    return build.load("bcr_spmm", _declare)


def _m_tile(lib, m: int, g: int, br: int, bc: int, r: int, c: int) -> int:
    """Rows of x per CTA: the whole (4-aligned) M at decode sizes, else 32,
    halved until the CTA's shared memory fits."""
    mt = max(4, -(-m // 4) * 4) if m <= 16 else 32
    while lib.bcr_spmm_smem_bytes(g, br, bc, r, c, mt) > _SMEM_LIMIT:
        if mt == 4:
            raise ValueError(f"BCR block {br}x{bc} keeping {r}x{c} needs more "
                             f"shared memory than a CTA has")
        mt //= 2
    return mt


def _check(x: torch.Tensor, packed) -> Optional[torch.Tensor]:
    """Validate a launch; returns the fp32 tile scales of an int8 pack
    (None for the fp form)."""
    vals, row_idx, col_idx = packed.vals, packed.row_idx, packed.col_idx
    scales = getattr(packed.plan, "block_scales", None)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (M, K) tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if vals.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 packed vals need plan.block_scales")
        if scales.dtype != torch.float32 \
                or tuple(scales.shape) != tuple(vals.shape[:-2]):
            raise ValueError(f"block_scales must be fp32 "
                             f"{tuple(vals.shape[:-2])}, got {scales.dtype} "
                             f"{tuple(scales.shape)}")
    elif scales is not None:
        raise TypeError(f"block_scales given with {vals.dtype} vals "
                        f"(the int8 form takes int8 codes)")
    elif vals.dtype != x.dtype:
        raise TypeError(f"packed vals dtype {vals.dtype} != x dtype {x.dtype} "
                        f"(pack_params casts vals to the activation dtype)")
    tensors = [("vals", vals), ("row_idx", row_idx), ("col_idx", col_idx)]
    if scales is not None:
        tensors.append(("block_scales", scales))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if row_idx.dtype != torch.int32 or col_idx.dtype != torch.int32:
        raise TypeError("row_idx / col_idx must be int32")
    n, k = packed.shape
    br, bc = packed.block_shape
    nb_r, nb_c, r, c = vals.shape[-4:]
    if x.shape[1] != k:
        raise ValueError(f"x K dim {x.shape[1]} != packed K dim {k}")
    if nb_r * br != n or nb_c * bc != k:
        raise ValueError(f"packed grid {nb_r}x{nb_c} of {br}x{bc} blocks does "
                         f"not tile ({n}, {k})")
    if row_idx.shape[-1] != r or col_idx.shape[-1] != c:
        raise ValueError("index planes do not match the kept tile shape")
    return scales


def bcr_spmm(x: torch.Tensor, packed) -> torch.Tensor:
    """``y[M, N] = x[M, K] @ W.T`` for balanced-BCR packed ``W`` (fp tiles,
    or int8 codes with ``plan.block_scales``)."""
    if not x.is_cuda:
        return ref.bcr_spmm_packed_ref(x, packed)
    scales = _check(x, packed)
    m, k = x.shape
    n = packed.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    nb_r, nb_c, r, c = packed.vals.shape
    br, bc = packed.block_shape
    lib = _lib()
    mt = _m_tile(lib, m, 1, br, bc, r, c)
    err = lib.bcr_spmm_launch(
        _DTYPE_CODE[x.dtype], int(scales is not None), x.data_ptr(),
        packed.vals.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        packed.row_idx.data_ptr(), packed.col_idx.data_ptr(), y.data_ptr(),
        m, k, n, nb_r, nb_c, br, bc, r, c, mt,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bcr_spmm launch")
    LAUNCHES["bcr_spmm_int8" if scales is not None else "bcr_spmm"] += 1
    return y


def bcr_spmm_grouped(x: torch.Tensor, grouped,
                     bias: Optional[torch.Tensor] = None,
                     epilogue: Optional[str] = None) -> torch.Tensor:
    """``y[G, M, N] = x[M, K] @ W_g.T`` for G same-shaped packed weights;
    ``bias`` ``(G, N)`` adds off the fp32 accumulator and
    ``epilogue="swiglu"`` (G=2) returns ``silu(y[0]) * y[1]`` as ``(M, N)``."""
    if epilogue not in (None, "swiglu"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    g = grouped.group_size
    if epilogue == "swiglu" and g != 2:
        raise ValueError(f"swiglu epilogue needs a gate/up pair, got "
                         f"group_size={g}")
    if not x.is_cuda:
        y = ref.bcr_spmm_grouped_ref(x, grouped, bias=bias, epilogue=epilogue)
        return y if epilogue == "swiglu" else y.transpose(0, 1)
    scales = _check(x, grouped)
    m, k = x.shape
    n = grouped.shape[0]
    if bias is not None:
        if tuple(bias.shape) != (g, n):
            raise ValueError(f"bias shape {tuple(bias.shape)} != {(g, n)}")
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out_shape = (m, n) if epilogue == "swiglu" else (g, m, n)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    _, nb_r, nb_c, r, c = grouped.vals.shape
    br, bc = grouped.block_shape
    lib = _lib()
    mt = _m_tile(lib, m, g, br, bc, r, c)
    err = lib.bcr_spmm_grouped_launch(
        _DTYPE_CODE[x.dtype], int(scales is not None),
        int(epilogue == "swiglu"), x.data_ptr(), grouped.vals.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        grouped.row_idx.data_ptr(), grouped.col_idx.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        m, k, n, g, nb_r, nb_c, br, bc, r, c, mt,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bcr_spmm_grouped launch")
    LAUNCHES["bcr_spmm_grouped_int8" if scales is not None
             else "bcr_spmm_grouped"] += 1
    return y

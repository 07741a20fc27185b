"""Fused flash attention on the merged-head layout: the hand-written CUDA
kernel of ``csrc/flash_attention.cu`` and its wrapper.

Replaces the reference's TPU kernel
``kernels/flash_attention.py:flash_attention_fused``, the cold-prefill
attention under ``attn_impl="pallas"``. Heads are merged into the batch dim
(``B' = B·H``); GQA callers repeat K/V to all q heads first, as the
reference's caller does.

A CUDA tensor goes through the kernel (or the wrapper raises); a CPU tensor
goes through the plain version :func:`repro_torch.kernels.ref.
flash_attention_ref`. Each launch adds one to
``LAUNCHES["flash_attention_fused"]``. The kernel's own tiles do not depend
on ``q_chunk``/``kv_chunk``; the wrapper keeps the reference's divisibility
rule on them so both packages accept the same shapes.

bf16 runs on the tensor cores (FlashAttention-2: 128 query rows a CTA, 64
at head_dim 128, key tiles of 64, P kept in registers; both products on
wgmma at head_dim 64, mma.sync at the others; the heaviest q tiles
launched first under ``causal``); fp32 keeps the CUDA-core body (its 1e-4
tolerance). The CUDA source chooses its tiles, shared memory and CTA order
itself.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"flash_attention_fused": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = ([_I] + [_P] * 4 + [_I] * 7
                                           + [ctypes.c_float, _P])
    lib.flash_attention_launch.restype = _I


def library() -> ctypes.CDLL:
    """This kernel's library, built first if missing, and loaded."""
    return build.load("flash_attention", _declare)


def chunks_fit(sq: int, skv: int, q_chunk: int, kv_chunk: int) -> bool:
    """The reference's rule: the (clamped) chunks divide the lengths."""
    return sq % min(q_chunk, sq) == 0 and skv % min(kv_chunk, skv) == 0


def prefill_bucket(n: int, min_bucket: int, capacity: int,
                   chunks=None) -> int:
    """Prefill length for an n-token prompt: the next power of two from
    ``min_bucket``, capped at the capacity — unless this kernel runs the
    prefill (``chunks`` = its ``(q_chunk, kv_chunk)``; None when it does
    not) and could not split the capped length into them; the uncapped
    power of two is then kept (a pool routes the pad positions past the
    capacity to its null page or drops them)."""
    b = min_bucket
    while b < n:
        b *= 2
    if b > capacity and (chunks is None
                         or chunks_fit(capacity, capacity, *chunks)):
        return capacity
    return b


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_chunk: int = 256,
                          kv_chunk: int = 512, q_offset: int = 0
                          ) -> torch.Tensor:
    """q ``(B', Sq, D)``, k/v ``(B', Skv, D)`` with heads merged into
    ``B'``; fp32 online softmax with scale ``D**-0.5``; with ``causal``
    query row ``i`` sits at position ``q_offset + i``. Returns ``(B', Sq,
    D)`` in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} are not (B', S, D) triples")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if not chunks_fit(sq, skv, q_chunk, kv_chunk):
        raise ValueError(f"seq {sq}/{skv} not divisible by chunks "
                         f"{min(q_chunk, sq)}/{min(kv_chunk, skv)}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes one of float32, bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (one of {_HEAD_DIMS})")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    _launch(q, k, v, out, causal, q_offset)
    return out


def _launch(q, k, v, out, causal: bool, q_offset: int,
            bh_major: bool = False) -> None:
    """One launch on checked, aligned operands. ``bh_major`` forces the
    bf16 kernel's B·H-major CTA order where ``causal`` would launch the
    heaviest q tiles first; the order changes no output, and only the
    check of that sets it."""
    bh, sq, d = q.shape
    err = library().flash_attention_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), bh, sq, k.shape[1], d, int(causal), q_offset,
        int(bh_major), float(d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention launch")
    LAUNCHES["flash_attention_fused"] += 1

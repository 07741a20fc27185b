#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --bcr-ab TREE [TREE ...]

The second form times phase 3's ``bcr_spmm*``, ``bcr_spmm_skip`` and flash
cases for each checkout TREE (its own ``src/repro_torch``, built into its
own ``build/``), one process per TREE in the order given, and prints them
side by side — e.g. ``build/parent . . build/parent`` after ``git archive
HEAD~1 | tar -x -C build/parent``.

Phases, in order (any failed check raises and the script exits non-zero):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, one process per source, all started together; ptxas
   registers and spills; from the built libraries' SASS, the instruction
   each tensor-core kernel runs (``mma.sync`` = HMMA, ``wgmma`` = HGMMA):
   the BCR kernels by M tile (HMMA up to 64, HGMMA for 128), the bf16
   ``bcr_spmm_skip`` kernels by M tile likewise, the bf16 flash kernels
   HGMMA at head_dim 64 and HMMA at the others; none in any fp32
   (CUDA-core) body.
3. Kernels against their plain PyTorch versions on the card, bf16 at the
   llama3.2-1b full-width shapes (d_model 2048, 32/8 heads, head_dim 64,
   d_ff 8192, vocab 128256, BCR block 128 at keep 0.25, so R_keep = C_keep =
   64), plus one small fp32 case each: max error against the stated
   tolerance, CUDA-event times (median of 20 after warm-up, L2 flushed
   before each launch), the plain version's time, one library yardstick
   (never used by the port) and the bound. Every form: the fp and int8
   forms of ``bcr_spmm``, ``bcr_spmm_grouped`` (plus the one-launch split
   at decode: MLP wo and gate/up at M = 8, two launches bit-equal, output
   and workspace in freed NaN-filled blocks, split counters back at 0)
   and paged attention (decode over lengths 1..512 and 1024..4096,
   prefill-append of 16 rows; plus its one-launch split over pages at
   decode and prefill-append, fp and int8 pages, checked as the BCR split
   is, with an empty slot giving exact zeros), and the
   fused flash attention (B·H = 8·32, S in {128, 512}, causal, non-causal
   and a ``q_offset`` case; the heaviest-first CTA order bit-equal to the
   B·H-major one), and the block-skipping ``bcr_spmm_skip`` over
   unbalanced-BCR tiles (wq, MLP wo and lm_head with lognormal block
   scales, M = 8 and 2048; a zeroed block row; the output landing in a
   freed NaN-filled block; a fully pruned W; a small fp32 case; the
   one-launch split over a block row's tiles at M = 8 for wq and MLP wo,
   checked as the BCR split is), each with its surviving-tile share and
   empty block rows.
4. bf16 main path at full width: llama3.2-1b, 16 layers, random weights
   from a seeded generator, packed at keep 0.25 / block 128, served through
   the paged engine (8 slots, page 16, capacity 640): 16 greedy requests
   with prompts from {32, 128, 512} and 32 new tokens each. The launch
   counters are zeroed just before and read just after; a profiled window
   of decode steps; then one direct ``prefill_append`` on a live pool, held
   to a cold prefill.
5. Quantized main path, the same weights and traffic: int8 tiles
   (``pack_params(weight_dtype="int8")``), int8 KV pages
   (``EngineConfig(kv_dtype="int8")``) and cold prefill through the fused
   flash kernel (``attn_impl="pallas"``). The int8 and flash counters must
   move and the fp counters stay 0, with 16 flash launches per cold
   prefill; the same profile and live-pool ``prefill_append`` check; and
   the teacher-forced flip rate of the int8 path against the bf16 path on
   the bf16 path's trajectories (printed, not gated: random weights have
   near-ties).
6. Engines against the naive ``generate`` oracle, fp32, full width, 2
   layers, 4 requests: the bf16-config engine, then the quantized one
   (int8 tiles, int8 KV, flash prefill); greedy tokens equal up to
   near-ties.
7. GRIM's pruning path at full width: llama3.2-1b, 16 layers, fp32 params,
   bf16 activations, keep 0.25 / block 128, ``markov`` data (batch 8, seq
   128) through ``launch.train.train_loop``: 2 dense steps, ADMM from step
   2 (one Z/U dual update, at step 5), ``finalize`` and frozen-mask
   retraining from step 6, 8 steps in all. Loss finite and lower at the end;
   every pruned leaf a balanced-BCR member; step times and peak memory.
   Then the retrained weights go through ``pack_params``: packed prefill
   logits against ``forward`` on the dense finalized weights. Then the
   trained lm_head, MLP wo and wq are projected onto the unbalanced BCR set,
   packed by ``pack_skip`` and run by ``bcr_spmm_skip`` (its launch counter
   for the kernels line) against the plain version.
8. Checkpoint resume on the card: 2 layers (vocab cut to 8192), the same
   phases; a run stopped at step 4 (mid-ADMM, ``save_async``) and resumed
   must repeat the uninterrupted run's losses.
9. The card's line, the ``kernels`` JSON line, and the contract line.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_TOL, FP32_TOL = 2e-2, 1e-4  # × max(1, max |plain|)

REPO = "src/repro"               # the reference package, for "replaces"
PORT = "src/repro_torch/kernels/csrc"
# launch-counter key → (CUDA source, the TPU kernel it replaces, the case
# its row in the kernels line reports: its decode- or prefill-step shape)
KERNELS = {
    "bcr_spmm": (f"{PORT}/bcr_spmm.cu", f"{REPO}/kernels/bcr_spmm.py:158",
                 "lm_head 128256x2048 M=8"),
    "bcr_spmm_grouped": (f"{PORT}/bcr_spmm.cu",
                         f"{REPO}/kernels/bcr_spmm.py:311",
                         "wgi 2x8192x2048 M=8"),
    "paged_attention": (f"{PORT}/paged_attention.cu",
                        f"{REPO}/kernels/paged_decode_attention.py:126",
                        "decode B=8 lens 1..512"),
    "bcr_spmm_int8": (f"{PORT}/bcr_spmm.cu",
                      f"{REPO}/kernels/bcr_spmm.py:158",
                      "lm_head 128256x2048 M=8"),
    "bcr_spmm_grouped_int8": (f"{PORT}/bcr_spmm.cu",
                              f"{REPO}/kernels/bcr_spmm.py:311",
                              "wgi 2x8192x2048 M=8"),
    "paged_attention_int8": (f"{PORT}/paged_attention.cu",
                             f"{REPO}/kernels/paged_decode_attention.py:126",
                             "decode B=8 lens 1..512"),
    "flash_attention_fused": (f"{PORT}/flash_attention.cu",
                              f"{REPO}/kernels/flash_attention.py:83",
                              "causal BH=256 S=512"),
    "bcr_spmm_skip": (f"{PORT}/bcr_spmm_skip.cu",
                      f"{REPO}/kernels/bcr_spmm_skip.py:120",
                      "lm_head 128256x2048 M=8"),
}
FP_KERNELS = ("bcr_spmm", "bcr_spmm_grouped", "paged_attention")
INT8_KERNELS = ("bcr_spmm_int8", "bcr_spmm_grouped_int8",
                "paged_attention_int8")


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """CUDA-event timing: median of ``reps`` single launches after warm-up,
    with a 128 MB write before each launch so weights come from device
    memory, not the 50 MB L2, as they do in a decode step. A GPU spin is
    queued before the start event, so the host has enqueued the launch by
    the time the event fires: the interval is device time, not the
    wrapper's host time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def ms(self, fn, reps=20, warmup=3, flush=None) -> float:
        """``flush``: what empties the L2 before each launch (default: the
        128 MB write, which leaves the L2 full of dirty lines)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            (flush or self.flush.zero_)()
            torch.cuda._sleep(1_000_000)       # ~0.5 ms of device time
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def check_close(name, got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    ok = err <= tol * scale
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:g} x {scale:.3g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol} x {scale})")
    return err


def _library_dense_matmul(x, w_dense):
    return x @ w_dense.T


def _library_sdpa(torch, q, k, v, mask, is_causal=False):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=is_causal)


def counters():
    """The launch counters of every kernel wrapper, by module."""
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels.bcr_spmm_skip import LAUNCHES as SKIP
    return (K.LAUNCHES, PA.LAUNCHES, FA.LAUNCHES, SKIP)


def zero_counters():
    for c in counters():
        for key in c:
            c[key] = 0


def read_counters():
    return {k: v for c in counters() for k, v in c.items()}


def recorder(torch, rows):
    """``record(kernel, shape, err, ms, plain_ms, bytes, ops, dtype,
    library_ms)``: appends one timed row, with its bound, to ``rows``."""

    def record(kernel, shape, err, ms, plain_ms, byts, ops, dtype, lib_ms):
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        rows.append(dict(kernel=kernel, shape=shape, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations"))
        log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms")

    return record


def bcr_cases(torch, timer, gen, record):
    """Phase 3's timed ``bcr_spmm`` / ``bcr_spmm_grouped`` cases, fp and int8
    tiles under bf16 x, at the llama3.2-1b projections and M in {1, 8,
    2048}: each checked against its plain version, then timed beside the
    plain version and the dense library product; rows go through
    ``record``. It uses only the wrappers' public calls, so ``--bcr-ab``
    runs it against an older tree's package too."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack, tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import (pack_group, quantize_grouped,
                                          quantize_packed)

    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def pack(n, k, dtype):
        p = tbcrc_pack(randn(n, k, dtype=torch.float32, scale=k ** -0.5),
                       spec)
        p.vals = p.vals.to(dtype)
        return p

    def tile_bytes(p):
        return (p.vals.numel() * p.vals.element_size()
                + (p.row_idx.numel() + p.col_idx.numel()) * 4)

    def scale_bytes(p):
        return p.plan.block_scales.numel() * 4

    # -- bcr_spmm ----------------------------------------------------------
    log("bcr_spmm (bf16, block 128, keep 0.25)")
    for wname, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192),
                        ("lm_head", 128256, 2048)):
        p = pack(n, k, torch.bfloat16)
        w_dense = tbcrc_unpack(p)
        for m in (1, 8, 2048):
            x = randn(m, k)
            got = K.bcr_spmm(x, p)
            want = ref.bcr_spmm_packed_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"{wname} {n}x{k} M={m}", got, want, BF16_TOL)
            nb_r, nb_c, r, c = p.vals.shape
            record("bcr_spmm", f"{wname} {n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm(x, p)),
                   timer.ms(lambda: ref.bcr_spmm_packed_ref(x, p)),
                   tile_bytes(p) + (m * k + m * n) * 2,
                   2 * m * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_dense)))
        del p, w_dense
    # -- bcr_spmm_grouped ----------------------------------------------------
    log("bcr_spmm_grouped (bf16, block 128, keep 0.25)")
    for wname, n, k, epi in (("wkv", 512, 2048, None),
                             ("wgi", 8192, 2048, "swiglu")):
        grouped = pack_group([pack(n, k, torch.bfloat16) for _ in range(2)])
        w_cat = torch.cat([tbcrc_unpack(dataclasses.replace(
            grouped, vals=grouped.vals[g], row_idx=grouped.row_idx[g],
            col_idx=grouped.col_idx[g])) for g in range(2)])
        for m in (1, 8, 2048):
            x = randn(m, k)
            got = K.bcr_spmm_grouped(x, grouped, epilogue=epi)
            want = ref.bcr_spmm_grouped_ref(x, grouped, epilogue=epi)
            if epi is None:
                want = want.transpose(0, 1)
            torch.cuda.synchronize()
            err = check_close(f"{wname} 2x{n}x{k} M={m}", got, want,
                              BF16_TOL)
            _, nb_r, nb_c, r, c = grouped.vals.shape
            out_n = n if epi else 2 * n
            record("bcr_spmm_grouped", f"{wname} 2x{n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm_grouped(x, grouped,
                                                       epilogue=epi)),
                   timer.ms(lambda: ref.bcr_spmm_grouped_ref(
                       x, grouped, epilogue=epi)),
                   tile_bytes(grouped) + (m * k + m * out_n) * 2,
                   2 * m * 2 * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_cat)))
        del grouped, w_cat
    log("bcr_spmm int8 tiles (bf16 x, block 128, keep 0.25)")
    for wname, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192),
                        ("lm_head", 128256, 2048)):
        p = quantize_packed(pack(n, k, torch.float32))
        w_dense = tbcrc_unpack(p).to(torch.bfloat16)
        for m in (1, 8, 2048):
            x = randn(m, k)
            got = K.bcr_spmm(x, p)
            want = ref.bcr_spmm_packed_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"int8 {wname} {n}x{k} M={m}", got, want,
                              BF16_TOL)
            nb_r, nb_c, r, c = p.vals.shape
            record("bcr_spmm_int8", f"{wname} {n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm(x, p)),
                   timer.ms(lambda: ref.bcr_spmm_packed_ref(x, p)),
                   tile_bytes(p) + scale_bytes(p) + (m * k + m * n) * 2,
                   2 * m * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_dense)))
        del p, w_dense
    log("bcr_spmm_grouped int8 tiles (bf16 x, block 128, keep 0.25)")
    for wname, n, k, epi in (("wkv", 512, 2048, None),
                             ("wgi", 8192, 2048, "swiglu")):
        grouped = quantize_grouped(pack_group(
            [pack(n, k, torch.float32) for _ in range(2)]))
        w_cat = torch.cat([tbcrc_unpack(dataclasses.replace(
            grouped, vals=grouped.vals[g], row_idx=grouped.row_idx[g],
            col_idx=grouped.col_idx[g], plan=dataclasses.replace(
                grouped.plan, block_scales=grouped.plan.block_scales[g])))
            for g in range(2)]).to(torch.bfloat16)
        for m in (1, 8, 2048):
            x = randn(m, k)
            got = K.bcr_spmm_grouped(x, grouped, epilogue=epi)
            want = ref.bcr_spmm_grouped_ref(x, grouped, epilogue=epi)
            if epi is None:
                want = want.transpose(0, 1)
            torch.cuda.synchronize()
            err = check_close(f"int8 {wname} 2x{n}x{k} M={m}", got, want,
                              BF16_TOL)
            _, nb_r, nb_c, r, c = grouped.vals.shape
            out_n = n if epi else 2 * n
            record("bcr_spmm_grouped_int8", f"{wname} 2x{n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm_grouped(x, grouped,
                                                       epilogue=epi)),
                   timer.ms(lambda: ref.bcr_spmm_grouped_ref(
                       x, grouped, epilogue=epi)),
                   tile_bytes(grouped) + scale_bytes(grouped)
                   + (m * k + m * out_n) * 2,
                   2 * m * 2 * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_cat)))
        del grouped, w_cat


def sass_tensor_ops(lib_path: Path) -> dict:
    """Tensor-core instructions per kernel of a built library, from
    ``cuobjdump -sass``: {mangled kernel name: (HMMA count, HGMMA count)}.
    HMMA is the warp-level ``mma.sync``; HGMMA is ``wgmma``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    ops, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            ops[name] = [0, 0]
        elif name is not None:
            if "HGMMA" in line:
                ops[name][1] += 1
            elif "HMMA" in line:
                ops[name][0] += 1
    return {k: tuple(v) for k, v in ops.items()}


def bcr_instruction_check(lib_path: Path) -> None:
    """Which instruction each BCR form runs, read from the built library:
    every tensor-core kernel (bf16 x) of an M tile up to 64 issues
    ``mma.sync`` (HMMA) and the 128 tile ``wgmma`` (HGMMA); the fp32-x
    kernels issue neither (CUDA cores)."""
    from repro_torch.kernels import bcr_spmm as K

    ops = sass_tensor_ops(lib_path)
    rows = {}
    for name, (hmma, hgmma) in ops.items():
        m = re.search(r"bcr_spmm(_grouped)?_tcILb([01])ELi(\d+)ELi\d+ELi(\d+)E",
                      name)
        if m:
            form = ("bcr_spmm" + ("_grouped" if m.group(1) else "")
                    + ("_int8" if m.group(2) == "1" else ""))
            want = ("wgmma" if int(m.group(4)) == K.WGMMA_WARPS_M
                    else "mma.sync")
            got = ("wgmma" if hgmma and not hmma
                   else "mma.sync" if hmma and not hgmma else None)
            if got != want:
                raise AssertionError(f"{name}: {hmma} HMMA, {hgmma} HGMMA; "
                                     f"want {want}")
            rows.setdefault(form, set()).add(
                f"M tile {m.group(3)}: {want}")
        elif "cuda_core" in name and (hmma or hgmma):
            raise AssertionError(f"{name}: the fp32 body issued tensor-core "
                                 f"instructions")
    for form in sorted(rows):
        log(f"  {form} (bf16 x): "
            + ", ".join(sorted(rows[form], key=lambda t: int(t.split()[2][:-1]))))
    log("  fp32 x (every form): CUDA-core FMAs, no HMMA/HGMMA")


def tc_instruction_check(skip_lib: Path, flash_lib: Path,
                         paged_lib: Path) -> None:
    """The same for the bf16 bodies of ``bcr_spmm_skip`` (mma.sync = HMMA
    for M tiles 8..64, wgmma = HGMMA for the 128 tile),
    ``flash_attention_fused`` (HGMMA at head_dim 64, HMMA at the others)
    and paged attention (HMMA over bf16 and over int8 pages, every head_dim
    and row tile); their CUDA-core bodies run neither."""
    kinds = (
        (skip_lib, r"bcr_spmm_skip_tcILi(\d+)ELi(\d+)ELb([01])E",
         lambda m: (f"bcr_spmm_skip M tile {m.group(1)}",
                    m.group(3) == "1")),
        (flash_lib, r"flash_attention_tcILi(\d+)EE",
         lambda m: (f"flash_attention_fused head_dim {m.group(1)}",
                    int(m.group(1)) == 64)),
        (paged_lib, r"paged_attention_tcI(13__nv_bfloat16|a)Li(\d+)ELi(\d+)E",
         lambda m: ("paged_attention "
                    + ("int8" if m.group(1) == "a" else "bf16") + " pages",
                    False)),
    )
    seen = {}
    for lib, pat, kind_of in kinds:
        for name, (hmma, hgmma) in sass_tensor_ops(lib).items():
            m = re.search(pat, name)
            if m:
                kind, wg = kind_of(m)
                want = "wgmma" if wg else "mma.sync"
                got = ("wgmma" if hgmma and not hmma
                       else "mma.sync" if hmma and not hgmma else None)
                if got != want:
                    raise AssertionError(f"{name}: {hmma} HMMA, {hgmma} "
                                         f"HGMMA; want {want}")
                seen.setdefault(kind, set()).add(want)
            elif "cuda_core" in name and (hmma or hgmma):
                raise AssertionError(f"{name}: a CUDA-core body issued "
                                     f"tensor-core instructions")
    for prefix in ("bcr_spmm_skip", "flash", "paged_attention bf16",
                   "paged_attention int8"):
        if not any(k.startswith(prefix) for k in seen):
            raise AssertionError(f"tensor-core kernels missing ({prefix}): "
                                 f"{sorted(seen)}")
    log("  " + "; ".join(f"{k}: {'/'.join(sorted(v))}"
                         for k, v in sorted(seen.items())))
    log("  bcr_spmm_skip, flash and paged CUDA-core bodies (fp32, other "
        "blocks, head dims and page sizes): no HMMA/HGMMA")


def bcr_split_checks(torch, gen) -> None:
    """The one-launch split over contraction blocks at decode: MLP wo
    (2048 x 8192) and the gate/up pair (2 x 8192 x 2048, SwiGLU) at M = 8,
    fp and int8 tiles. Two launches give bit-equal y (the last split sums
    the partials in split order); the output and the workspace land in
    freed NaN-filled blocks and the result is still right; the split
    counters are back at zero after the calls."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import (pack_group, quantize_grouped,
                                          quantize_packed)

    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n, k, g in (("mlp_wo", 2048, 8192, 1), ("wgi", 8192, 2048, 2)):
        for int8 in (False, True):
            packs = []
            for _ in range(g):
                w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
                p = tbcrc_pack(w, spec)
                if not int8:
                    p.vals = p.vals.to(torch.bfloat16)
                packs.append(p)
            if g == 2:
                w = pack_group(packs)
                w = quantize_grouped(w) if int8 else w
            else:
                w = quantize_packed(packs[0]) if int8 else packs[0]
            x = torch.randn((8, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            r, c = w.vals.shape[-2:]
            plan = K.launch_plan(8, n, k, g, (128, 128), (r, c), sms, int8)
            if plan.splits < 2:
                raise AssertionError(f"{name} at M=8 did not split: {plan}")

            def run():
                if g == 2:
                    return K.bcr_spmm_grouped(x, w, epilogue="swiglu")
                return K.bcr_spmm(x, w)

            want = (ref.bcr_spmm_grouped_ref(x, w, epilogue="swiglu")
                    if g == 2 else ref.bcr_spmm_packed_ref(x, w))
            poison = (torch.full((plan.workspace_floats,), float("nan"),
                                 device="cuda"),
                      torch.full((8, n), float("nan"), dtype=torch.bfloat16,
                                 device="cuda"))
            del poison           # the allocator hands these blocks back next
            first = run()
            second = run()
            torch.cuda.synchronize()
            form = f"{'int8 ' if int8 else ''}{name} {g}x{n}x{k} M=8"
            if not bool(torch.isfinite(first).all()):
                raise AssertionError(f"split {form}: non-finite output over "
                                     f"NaN-filled buffers")
            if not torch.equal(first, second):
                raise AssertionError(f"split {form}: two launches differ")
            check_close(f"split {form} (S={plan.splits}, grid {plan.grid}, "
                        f"NaN-filled workspace and output)", first, want,
                        BF16_TOL)
            left = int(torch.count_nonzero(
                K.split_counters(x.device, plan.tiles)[:plan.tiles]))
            if left:
                raise AssertionError(f"split {form}: {left} counters not "
                                     f"back at zero")
            log(f"  split {form}: two launches bit-equal, counters back at 0")


def phase_kernels(torch, timer):
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack, tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import pack_group

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)
    rows = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def pack(n, k, dtype, block_spec=spec):
        p = tbcrc_pack(randn(n, k, dtype=torch.float32, scale=k ** -0.5),
                       block_spec)
        p.vals = p.vals.to(dtype)
        return p

    record = recorder(torch, rows)

    bcr_cases(torch, timer, gen, record)
    log("bcr_spmm split path (M=8, one launch)")
    bcr_split_checks(torch, gen)
    p = pack(256, 384, torch.float32)
    x = randn(5, 384, dtype=torch.float32)
    err = check_close("fp32 256x384 M=5", K.bcr_spmm(x, p),
                      ref.bcr_spmm_packed_ref(x, p), FP32_TOL)

    grouped = pack_group([pack(256, 384, torch.float32) for _ in range(2)])
    x = randn(5, 384, dtype=torch.float32)
    bias = randn(2, 256, dtype=torch.float32)
    check_close("fp32 2x256x384 M=5 swiglu+bias",
                K.bcr_spmm_grouped(x, grouped, bias=bias, epilogue="swiglu"),
                ref.bcr_spmm_grouped_ref(x, grouped, bias=bias,
                                         epilogue="swiglu"), FP32_TOL)

    # -- int8 tiles ----------------------------------------------------------
    from repro_torch.kernels.plan import quantize_grouped, quantize_packed

    p = quantize_packed(pack(256, 384, torch.float32))
    x = randn(5, 384, dtype=torch.float32)
    check_close("int8 tiles, fp32 x 256x384 M=5", K.bcr_spmm(x, p),
                ref.bcr_spmm_packed_ref(x, p), FP32_TOL)

    grouped = quantize_grouped(pack_group(
        [pack(256, 384, torch.float32) for _ in range(2)]))
    x = randn(5, 384, dtype=torch.float32)
    bias = randn(2, 256, dtype=torch.float32)
    check_close("int8 tiles, fp32 x 2x256x384 M=5 swiglu+bias",
                K.bcr_spmm_grouped(x, grouped, bias=bias, epilogue="swiglu"),
                ref.bcr_spmm_grouped_ref(x, grouped, bias=bias,
                                         epilogue="swiglu"), FP32_TOL)

    paged_cases(torch, timer, gen, record)
    log("paged attention split path (one launch)")
    paged_split_checks(torch, gen)
    flash_cases(torch, timer, gen, record)
    log("flash_attention_fused CTA order (heaviest q tiles first)")
    flash_order_check(torch, gen)
    skip_cases(torch, timer, gen, record)
    log("bcr_spmm_skip split path (M=8, one launch)")
    skip_split_checks(torch, gen)
    return rows


def paged_cases(torch, timer, gen, record):
    """Phase 3's paged attention cases (llama3.2-1b's attention: 32/8 heads,
    head_dim 64, page 16), fp (bf16) and int8 pages under bf16 q: decode
    over 8 slots of lengths 1..512 (one inactive) and 1024..4096,
    prefill-append of 16 rows over a 100-token prefix, each checked against
    its plain version and timed beside it and a gathered SDPA; plus small
    fp32 cases. It uses only the wrappers' public calls, so ``--bcr-ab``
    runs it against an older tree's package too."""
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import dequantize_rows, quantize_rows

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    log("paged attention (bf16, 32/8 heads, head_dim 64, page 16)")
    hkv, h, d, ps = 8, 32, 64, 16

    def pages(tlens, dtype):
        per = [-(-int(t) // ps) for t in tlens]
        n_pages = 1 + sum(per) + 8
        kp = randn(n_pages, ps, hkv, d, dtype=dtype)
        vp = randn(n_pages, ps, hkv, d, dtype=dtype)
        kp[0].zero_()
        vp[0].zero_()
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device="cuda").cpu() + 1
        width = max(per)
        bt = torch.zeros((len(tlens), width), dtype=torch.int32)
        nxt = 0
        for i, npg in enumerate(per):
            bt[i, :npg] = perm[nxt:nxt + npg]
            nxt += npg
        return kp, vp, bt.cuda()

    def gathered_sdpa(q, kp, vp, bt, qpos):
        b, s = q.shape[:2]
        l = bt.shape[1] * ps
        kk = kp[bt.long()].reshape(b, l, hkv, d).repeat_interleave(h // hkv,
                                                                   2)
        vv = vp[bt.long()].reshape(b, l, hkv, d).repeat_interleave(h // hkv,
                                                                   2)
        mask = (torch.arange(l, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        args = (q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                mask)
        return timer.ms(lambda: _library_sdpa(torch, *args))

    lens = torch.tensor([1, 37, 128, 200, 333, 511, 512, 0],
                        dtype=torch.int32, device="cuda")
    kp, vp, bt = pages(lens.tolist(), torch.bfloat16)
    q = randn(8, 1, h, d)
    got = PA.paged_decode_attention(q, kp, vp, bt, lens)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    live = lens > 0
    err = check_close("decode B=8 lens 1..512 + inactive", got[live],
                      want[live], BF16_TOL)
    if not (bool(torch.isfinite(got).all())
            and int(torch.count_nonzero(got[~live])) == 0):
        raise AssertionError("inactive slot output is not finite zeros")
    kv_bytes = PA.paged_kv_bytes(lens.cpu().numpy(), ps, hkv, d, 2)
    record("paged_attention", "decode B=8 lens 1..512", err,
           timer.ms(lambda: PA.paged_decode_attention(q, kp, vp, bt, lens)),
           timer.ms(lambda: ref.paged_decode_attention_ref(q, kp, vp, bt,
                                                           lens)),
           kv_bytes + 2 * q.numel() * 2 + bt.numel() * 4,
           4 * int(lens.sum()) * h * d, torch.bfloat16,
           gathered_sdpa(q, kp, vp, bt, (lens - 1)[:, None]))

    long_lens = torch.tensor([1024, 1500, 2000, 2500, 3000, 3500, 4000,
                              4096], dtype=torch.int32, device="cuda")
    kp, vp, bt = pages(long_lens.tolist(), torch.bfloat16)
    q = randn(8, 1, h, d)
    got = PA.paged_decode_attention(q, kp, vp, bt, long_lens)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, long_lens)
    torch.cuda.synchronize()
    err = check_close("decode B=8 lens 1024..4096", got, want, BF16_TOL)
    # what a plain read of the same bytes takes under the same timer, and
    # both again with the L2 flushed by a read (clean lines, as in a decode
    # step) instead of the write that leaves dirty lines to write back
    pool = torch.cat([kp.flatten(), vp.flatten()])

    def read_all():
        return pool.sum(dtype=torch.float32)

    def kernel():
        return PA.paged_decode_attention(q, kp, vp, bt, long_lens)

    clean = timer.flush.sum
    log(f"    streaming yardstick ({pool.numel() * 2 / 1e6:.1f} MB K/V "
        f"pool): torch sum {timer.ms(read_all):.4f} ms; flushed by a read: "
        f"kernel {timer.ms(kernel, flush=clean):.4f} ms, torch sum "
        f"{timer.ms(read_all, flush=clean):.4f} ms")
    del pool
    record("paged_attention", "decode B=8 lens 1024..4096", err,
           timer.ms(lambda: PA.paged_decode_attention(q, kp, vp, bt,
                                                      long_lens)),
           timer.ms(lambda: ref.paged_decode_attention_ref(q, kp, vp, bt,
                                                           long_lens)),
           PA.paged_kv_bytes(long_lens.cpu().numpy(), ps, hkv, d, 2)
           + 2 * q.numel() * 2 + bt.numel() * 4,
           4 * int(long_lens.sum()) * h * d, torch.bfloat16,
           gathered_sdpa(q, kp, vp, bt, (long_lens - 1)[:, None]))
    del kp, vp, got, want

    plen = torch.full((8,), 100, dtype=torch.int32, device="cuda")
    tlen = plen + 16
    kp, vp, bt = pages(tlen.tolist(), torch.bfloat16)
    q = randn(8, 16, h, d)
    got = PA.paged_prefill_append_attention(q, kp, vp, bt, plen, tlen)
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, plen, tlen)
    torch.cuda.synchronize()
    err = check_close("prefill-append B=8 S=16 over 100", got, want, BF16_TOL)
    qpos = plen[:, None] + torch.arange(16, device="cuda")[None]
    record("paged_attention", "prefill-append B=8 S=16 prefix 100", err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kp, vp, bt, plen, tlen)),
           timer.ms(lambda: ref.paged_prefill_append_ref(q, kp, vp, bt, plen,
                                                         tlen)),
           PA.paged_kv_bytes(tlen.cpu().numpy(), ps, hkv, d, 2)
           + 2 * q.numel() * 2, 4 * 8 * 16 * 108 * h * d, torch.bfloat16,
           gathered_sdpa(q, kp, vp, bt, qpos))

    small = torch.tensor([5, 0, 23], dtype=torch.int32, device="cuda")
    kp, vp, bt = pages([5, 1, 23], torch.float32)
    q = randn(3, 1, h, d, dtype=torch.float32)
    got = PA.paged_decode_attention(q, kp, vp, bt, small)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, small)
    check_close("fp32 decode B=3", got[small > 0], want[small > 0], FP32_TOL)
    q = randn(3, 4, h, d, dtype=torch.float32)
    pl = torch.tensor([1, 0, 19], dtype=torch.int32, device="cuda")
    tl = pl + 4
    kp, vp, bt = pages(tl.tolist(), torch.float32)
    check_close("fp32 prefill-append B=3 S=4",
                PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl),
                ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl),
                FP32_TOL)
    del kp, vp

    # -- int8 pages ----------------------------------------------------------
    log("paged attention int8 pages (bf16 q, 32/8 heads, head_dim 64, "
        "page 16)")

    def int8_pages(tlens):
        kp, vp, bt = pages(tlens, torch.float32)
        kc, ks = quantize_rows(kp)
        vc, vs = quantize_rows(vp)
        deq = (dequantize_rows(kc, ks, torch.bfloat16),
               dequantize_rows(vc, vs, torch.bfloat16))
        return kc, vc, ks, vs, bt, deq

    kc, vc, ks, vs, bt, deq = int8_pages(lens.tolist())
    q = randn(8, 1, h, d)
    got = PA.paged_decode_attention(q, kc, vc, bt, lens, k_scale=ks,
                                    v_scale=vs)
    want = ref.paged_decode_attention_ref(q, kc, vc, bt, lens, k_scale=ks,
                                          v_scale=vs)
    torch.cuda.synchronize()
    err = check_close("int8 decode B=8 lens 1..512 + inactive", got[live],
                      want[live], BF16_TOL)
    if not (bool(torch.isfinite(got).all())
            and int(torch.count_nonzero(got[~live])) == 0):
        raise AssertionError("inactive slot output is not finite zeros")
    record("paged_attention_int8", "decode B=8 lens 1..512", err,
           timer.ms(lambda: PA.paged_decode_attention(
               q, kc, vc, bt, lens, k_scale=ks, v_scale=vs)),
           timer.ms(lambda: ref.paged_decode_attention_ref(
               q, kc, vc, bt, lens, k_scale=ks, v_scale=vs)),
           PA.paged_kv_bytes(lens.cpu().numpy(), ps, hkv, d, 1, 4)
           + 2 * q.numel() * 2 + bt.numel() * 4,
           4 * int(lens.sum()) * h * d, torch.bfloat16,
           gathered_sdpa(q, *deq, bt, (lens - 1)[:, None]))

    kc, vc, ks, vs, bt, deq = int8_pages(tlen.tolist())
    q = randn(8, 16, h, d)
    got = PA.paged_prefill_append_attention(q, kc, vc, bt, plen, tlen,
                                            k_scale=ks, v_scale=vs)
    want = ref.paged_prefill_append_ref(q, kc, vc, bt, plen, tlen,
                                        k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = check_close("int8 prefill-append B=8 S=16 over 100", got, want,
                      BF16_TOL)
    record("paged_attention_int8", "prefill-append B=8 S=16 prefix 100", err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kc, vc, bt, plen, tlen, k_scale=ks, v_scale=vs)),
           timer.ms(lambda: ref.paged_prefill_append_ref(
               q, kc, vc, bt, plen, tlen, k_scale=ks, v_scale=vs)),
           PA.paged_kv_bytes(tlen.cpu().numpy(), ps, hkv, d, 1, 4)
           + 2 * q.numel() * 2, 4 * 8 * 16 * 108 * h * d, torch.bfloat16,
           gathered_sdpa(q, *deq, bt, qpos))

    kc, vc, ks, vs, bt, _ = int8_pages([5, 1, 23])
    q = randn(3, 1, h, d, dtype=torch.float32)
    check_close("int8 pages, fp32 q decode B=3",
                PA.paged_decode_attention(q, kc, vc, bt, small, k_scale=ks,
                                          v_scale=vs)[small > 0],
                ref.paged_decode_attention_ref(q, kc, vc, bt, small,
                                               k_scale=ks,
                                               v_scale=vs)[small > 0],
                FP32_TOL)
    kc, vc, ks, vs, bt, _ = int8_pages(tl.tolist())
    q = randn(3, 4, h, d, dtype=torch.float32)
    check_close("int8 pages, fp32 q prefill-append B=3 S=4",
                PA.paged_prefill_append_attention(q, kc, vc, bt, pl, tl,
                                                  k_scale=ks, v_scale=vs),
                ref.paged_prefill_append_ref(q, kc, vc, bt, pl, tl,
                                             k_scale=ks, v_scale=vs),
                FP32_TOL)
    del kc, vc, ks, vs, deq


def paged_split_checks(torch, gen) -> None:
    """The one-launch split over pages at the serving shapes (8 slots, one
    empty and one at 4096 positions), decode and prefill-append, fp and
    int8 pages: the plan splits; two launches give bit-equal output (the
    last split merges in split order); the output and the workspace land in
    freed NaN-filled blocks and the result is still right, the empty slot
    exact zeros; the split counters are back at zero after the calls."""
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import quantize_rows

    hkv, h, d, ps = 8, 32, 64, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lens = [1, 37, 128, 200, 333, 511, 4096, 0]
    per = [-(-n // ps) for n in lens]
    n_pages = 1 + sum(per)
    bt = torch.zeros((8, max(per)), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda").cpu() + 1
    nxt = 0
    for i, npg in enumerate(per):
        bt[i, :npg] = perm[nxt:nxt + npg]
        nxt += npg
    bt = bt.cuda()
    tl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kf = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda")
    vf = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda")
    for int8 in (False, True):
        if int8:
            (kp, ks), (vp, vs) = quantize_rows(kf), quantize_rows(vf)
            sc = dict(k_scale=ks, v_scale=vs)
        else:
            kp, vp, sc = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
        for s in (1, 16):
            q = torch.randn((8, s, h, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            pl = torch.clamp(tl - s, min=0)
            plan = PA.paged_plan(8, hkv, s * h // hkv, bt.shape[1], ps, sms)
            if plan.splits < 2:
                raise AssertionError(f"paged S={s} did not split: {plan}")

            def run():
                if s == 1:
                    return PA.paged_decode_attention(q, kp, vp, bt, tl, **sc)
                return PA.paged_prefill_append_attention(q, kp, vp, bt, pl,
                                                         tl, **sc)

            want = (ref.paged_decode_attention_ref(q, kp, vp, bt, tl, **sc)
                    if s == 1 else
                    ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl, **sc))
            poison = (torch.full((plan.workspace_floats(d),), float("nan"),
                                 device="cuda"),
                      torch.full(q.shape, float("nan"), dtype=torch.bfloat16,
                                 device="cuda"))
            del poison           # the allocator hands these blocks back next
            first = run()
            second = run()
            torch.cuda.synchronize()
            form = ("int8 " if int8 else "") + (
                "decode" if s == 1 else "prefill-append S=16")
            if not bool(torch.isfinite(first).all()) \
                    or int(torch.count_nonzero(first[-1])):
                raise AssertionError(f"paged split {form}: non-finite output "
                                     f"or a non-zero empty slot over "
                                     f"NaN-filled buffers")
            if not torch.equal(first, second):
                raise AssertionError(f"paged split {form}: two launches "
                                     f"differ")
            check_close(f"paged split {form} (S={plan.splits}, grid "
                        f"{plan.grid}, NaN-filled workspace and output)",
                        first[:-1], want[:-1], BF16_TOL)
            left = int(torch.count_nonzero(
                K.split_counters(q.device, plan.units)[:plan.units]))
            if left:
                raise AssertionError(f"paged split {form}: {left} counters "
                                     f"not back at zero")
            log(f"  paged split {form}: two launches bit-equal, counters "
                f"back at 0, empty slot zeros")


def flash_cases(torch, timer, gen, record):
    """Phase 3's timed ``flash_attention_fused`` cases (bf16, B·H = 8·32,
    head_dim 64: causal S in {128, 512}, non-causal 512, Sq = 128 over
    Skv = 512 at ``q_offset`` 384) and one small fp32 case. It uses only
    the wrapper's public call, so ``--bcr-ab`` runs it against an older
    tree's package too."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    log("flash_attention_fused (bf16, B*H = 8*32, head_dim 64)")
    h, d = 32, 64
    bh = 8 * h
    for name, sq, skv, causal, q_off in (
            ("causal BH=256 S=128", 128, 128, True, 0),
            ("causal BH=256 S=512", 512, 512, True, 0),
            ("non-causal BH=256 S=512", 512, 512, False, 0),
            ("q_offset 384 BH=256 Sq=128 Skv=512", 128, 512, True, 384)):
        q, k, v = randn(bh, sq, d), randn(bh, skv, d), randn(bh, skv, d)
        kw = dict(causal=causal, q_chunk=512, kv_chunk=1024, q_offset=q_off)
        got = FA.flash_attention_fused(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_off)
        torch.cuda.synchronize()
        err = check_close(f"flash {name}", got, want, BF16_TOL)
        # (q, k) pairs the function needs: under causal, row i sees keys
        # 0 .. q_offset + i
        pairs = (sum(min(skv, q_off + i + 1) for i in range(sq)) if causal
                 else sq * skv)
        q4, k4, v4 = (t.reshape(8, h, t.shape[1], d) for t in (q, k, v))
        if causal and q_off:
            mask = (torch.arange(skv, device="cuda")[None, :]
                    <= q_off + torch.arange(sq, device="cuda")[:, None])
            lib = timer.ms(lambda: _library_sdpa(torch, q4, k4, v4, mask))
        else:
            lib = timer.ms(lambda: _library_sdpa(torch, q4, k4, v4, None,
                                                 is_causal=causal))
        record("flash_attention_fused", name, err,
               timer.ms(lambda: FA.flash_attention_fused(q, k, v, **kw)),
               timer.ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=causal, q_offset=q_off)),
               (2 * bh * sq * d + 2 * bh * skv * d) * 2,
               4 * bh * pairs * d, torch.bfloat16, lib)
        del q, k, v, got, want
    q, k, v = (randn(4, 77, d, dtype=torch.float32) for _ in range(3))
    check_close("flash fp32 BH=4 S=77 causal",
                FA.flash_attention_fused(q, k, v, q_chunk=77, kv_chunk=77),
                ref.flash_attention_ref(q, k, v), FP32_TOL)


def flash_order_check(torch, gen):
    """Under ``causal`` the bf16 kernel launches the heaviest q tiles first
    (q-tile-major, last tile first); that order and the B·H-major one give
    bit-equal outputs at the serving shape."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = (torch.randn((256, 512, 64), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    outs = []
    for bh_major in (False, True):
        out = torch.empty_like(q)
        FA._launch(q, k, v, out, True, 0, bh_major=bh_major)
        outs.append(out)
    torch.cuda.synchronize()
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("the CTA order changed the flash output")
    log("  causal BH=256 S=512: heaviest-first order (q tile 3 of 4 of "
        "every row first) bit-equal to the B*H-major order")


def skip_pack(torch, w, block=128, keep=0.25, dtype=None):
    """``pack_skip`` at unbalanced keep ``keep``; tiles cast to ``dtype``
    (the activation dtype) once, as pack time would."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.kernels.bcr_spmm_skip import pack_skip
    p = pack_skip(w, BCRSpec(block_shape=(block, block), keep_frac=keep,
                             align=8 if block >= 32 else 1, balanced=False))
    if dtype is not None:
        p = dataclasses.replace(p, tiles=p.tiles.to(dtype))
    nb_r = p.shape[0] // p.block_shape[0]
    nb_c = p.shape[1] // p.block_shape[1]
    empty = int((p.row_start[1:] == p.row_start[:-1]).sum())
    return p, p.tiles.shape[0] / (nb_r * nb_c), empty


def skip_bytes_ops(p, m, elt=2):
    """What the function must move and do for these inputs: the surviving
    tiles, x once, y once, 12 bytes of indices per tile; 2·M·num_nz·br·bc
    operations."""
    n, k = p.shape
    br, bc = p.block_shape
    nz = p.tiles.shape[0]
    return (nz * br * bc * elt + (m * k + m * n) * elt + 12 * nz,
            2 * m * nz * br * bc)


def skip_cases(torch, timer, gen, record):
    """Phase 3's ``bcr_spmm_skip`` cases (see the module docstring); timed
    rows go through ``record``."""
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    from repro_torch.kernels import ref

    def weight(n, k, block=128, skew=True):
        w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
        if skew:     # one lognormal (sigma 1) factor per block
            f = torch.exp(torch.randn((n // block, 1, k // block, 1),
                                      generator=gen, device="cuda"))
            w = (w.view(n // block, block, k // block, block) * f).view(n, k)
        return w

    def x_of(m, k, dtype=torch.bfloat16):
        return torch.randn((m, k), generator=gen, device="cuda").to(dtype)

    log("bcr_spmm_skip (bf16, block 128, unbalanced keep 0.25, lognormal "
        "block scales)")
    for wname, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192),
                        ("lm_head", 128256, 2048)):
        p, share, empty = skip_pack(torch, weight(n, k),
                                    dtype=torch.bfloat16)
        log(f"  {wname}: {p.tiles.shape[0]} tiles, surviving-tile share "
            f"{share:.4f}, empty block rows {empty} of {n // 128}")
        w_dense = ref.skip_unpack(p)
        for m in (8, 2048):
            x = x_of(m, k)
            got = SK.bcr_spmm_skip(x, p)
            want = ref.bcr_spmm_skip_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"skip {wname} {n}x{k} M={m}", got, want,
                              BF16_TOL)
            byts, ops = skip_bytes_ops(p, m)
            record("bcr_spmm_skip", f"{wname} {n}x{k} M={m}", err,
                   timer.ms(lambda: SK.bcr_spmm_skip(x, p)),
                   timer.ms(lambda: ref.bcr_spmm_skip_ref(x, p)),
                   byts, ops, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_dense)))
        del p, w_dense

    # a whole block row zeroed before projection, and the output landing in
    # a freed NaN-filled block: the empty rows must be exact zeros
    w = weight(2048, 2048)
    w[3 * 128:4 * 128] = 0.0
    p, _, empty = skip_pack(torch, w, dtype=torch.bfloat16)
    if int(p.row_start[3]) != int(p.row_start[4]):
        raise AssertionError("the zeroed block row kept a tile")
    x = x_of(8, 2048)
    poison = torch.full((8, 2048), float("nan"), dtype=torch.bfloat16,
                        device="cuda")
    del poison                  # the allocator hands this block back next
    got = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    rows_zero = got[:, 3 * 128:4 * 128]
    if not (bool(torch.isfinite(got).all())
            and int(torch.count_nonzero(rows_zero)) == 0):
        raise AssertionError("empty block row is not exact zeros over a "
                             "NaN-poisoned output buffer")
    check_close("skip zeroed block row over a NaN-poisoned buffer", got,
                ref.bcr_spmm_skip_ref(x, p), BF16_TOL)
    log(f"  empty block rows {empty}: exact zeros (NaN-poisoned buffer)")
    p, _, _ = skip_pack(torch, torch.zeros((2048, 2048), device="cuda"),
                        dtype=torch.bfloat16)
    if p.tiles.shape[0] != 1:
        raise AssertionError("a fully pruned W must pack one zero tile")
    got = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    if int(torch.count_nonzero(got)) != 0:
        raise AssertionError("fully pruned W gave a nonzero y")
    log("  fully pruned 2048x2048: one zero tile, y exact zeros")
    p, share, empty = skip_pack(torch, weight(256, 512, 32, skew=False),
                                block=32, keep=0.05)
    x = x_of(8, 512, torch.float32)
    check_close(f"skip fp32 256x512 block 32 keep 0.05 (share {share:.3f}, "
                f"empty block rows {empty})", SK.bcr_spmm_skip(x, p),
                ref.bcr_spmm_skip_ref(x, p), FP32_TOL)


def skip_split_checks(torch, gen) -> None:
    """The one-launch split over a block row's tiles at decode: wq (2048 x
    2048) and MLP wo (2048 x 8192) at M = 8, lognormal block scales, two
    block rows zeroed. The grid reaches the SM count; two launches give
    bit-equal y (the last split sums the partials in split order); the
    output and the workspace land in freed NaN-filled blocks and the empty
    rows are still exact zeros; the split counters are back at zero."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcr_spmm import split_counters
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192)):
        w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
        f = torch.exp(torch.randn((n // 128, 1, k // 128, 1), generator=gen,
                                  device="cuda"))
        w = (w.view(n // 128, 128, k // 128, 128) * f).view(n, k)
        w[:256] = 0.0
        p, share, empty = skip_pack(torch, w, dtype=torch.bfloat16)
        x = torch.randn((8, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        plan = SK.skip_plan(tuple(p.row_start.tolist()), 8, (128, 128), sms)
        if plan.grid < sms or not plan.parts:
            raise AssertionError(f"{name} at M=8: grid {plan.grid}, "
                                 f"{plan.parts} partials")
        poison = (torch.full((plan.workspace_floats,), float("nan"),
                             device="cuda"),
                  torch.full((8, n), float("nan"), dtype=torch.bfloat16,
                             device="cuda"))
        del poison               # the allocator hands these blocks back next
        first = SK.bcr_spmm_skip(x, p)
        second = SK.bcr_spmm_skip(x, p)
        torch.cuda.synchronize()
        form = (f"{name} {n}x{k} M=8 (share {share:.4f}, empty block rows "
                f"{empty}, {len(plan.units)} units of rows {plan.rows}, "
                f"grid {plan.grid})")
        if not bool(torch.isfinite(first).all()) or int(
                torch.count_nonzero(first[:, :256])):
            raise AssertionError(f"split {form}: empty rows are not exact "
                                 f"zeros over NaN-filled buffers")
        if not torch.equal(first, second):
            raise AssertionError(f"split {form}: two launches differ")
        check_close(f"skip split {form}, NaN-filled workspace and output",
                    first, ref.bcr_spmm_skip_ref(x, p), BF16_TOL)
        left = int(torch.count_nonzero(
            split_counters(x.device, plan.counters)[:plan.counters]))
        if left:
            raise AssertionError(f"split {form}: {left} counters not back "
                                 f"at zero")
        log(f"  skip split {name}: two launches bit-equal, counters back "
            f"at 0")


def build_main_params(torch):
    """The full-width, full-depth llama3.2-1b of phases 4 and 5: one set of
    random weights (seed 0), packed at keep 0.25 / block 128 twice — bf16
    tiles, and int8 tiles quantized from the same fp32 packs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import packed_fraction, pack_params
    from repro_torch.models import causal_lm

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=16,
                              bcr_keep_frac=0.25, bcr_block=(128, 128))
    t0 = time.perf_counter()
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    params = pack_params(cfg, dense)
    params_q = pack_params(cfg, dense, weight_dtype="int8")
    fracs = (packed_fraction(dense, params), packed_fraction(dense, params_q))
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"init + pack (bf16 and int8) {time.perf_counter() - t0:.1f} s; "
        f"packed-weight fraction of the dense fp32 tree: bf16 "
        f"{fracs[0]:.4f}, int8 {fracs[1]:.4f}")
    return cfg, params, params_q, fracs


def serve_main_path(torch, np, cfg, params, ec, label, frac):
    """Serve the phase's 16 requests with the launch counters zeroed just
    before and read just after; then a profiled decode window and one
    direct ``prefill_append`` on a live pool, held to a cold prefill."""
    from repro_torch.models import causal_lm
    from repro_torch.serving import FINISHED, InferenceEngine

    engine = InferenceEngine(cfg, params, ec, device="cuda")
    cfg = engine.cfg                  # kv_dtype from the engine config
    rng = np.random.default_rng(0)
    plens = rng.choice([32, 128, 512], size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in plens]
    rids = [engine.submit(p, max_new_tokens=32) for p in prompts]

    zero_counters()
    done, decode_ms = [], []
    t0 = time.perf_counter()
    while engine.sched.has_work():
        prefills = engine.stats["prefills"]
        ts = time.perf_counter()
        done.extend(engine.step())       # ends in a device→host copy
        if engine.stats["prefills"] == prefills:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    log(f"{label} launches: {launches}")
    if len(done) != 16 or any(r.status != FINISHED or len(r.generated) != 32
                              for r in done):
        raise AssertionError(f"{label}: not every request FINISHED with 32 "
                             f"tokens")
    if engine.stats["nonfinite_rows"]:
        raise AssertionError(f"{label}: {engine.stats['nonfinite_rows']} "
                             f"sampled logit rows were not finite")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    stats = dict(
        tokens_per_s=engine.stats["tokens_generated"] / wall,
        decode_step_ms_mean=statistics.mean(decode_ms),
        decode_step_ms_p50=statistics.median(decode_ms),
        decode_steps=engine.stats["decode_steps"],
        prefills=engine.stats["prefills"], ttft_ms_p50=statistics.median(ttft),
        wall_s=wall, packed_fraction=frac,
        kv_bytes_read_live=engine.stats["kv_bytes_read_live"],
        kv_row_bytes=engine._kv_row_bytes,
        packed_weight_bytes=_weight_bytes(params),
        step_bound_ms=_weight_bytes(params) / HBM_BYTES_PER_S * 1e3)
    log(f"{label}: " + json.dumps(stats))
    stats["decode_profile"] = profile_decode(torch, engine, rng, cfg)

    # one direct prefill_append on a live pool: a 100-token prefix seated by
    # a cold prefill, then a 16-token suffix through the pages, held to a
    # cold prefill of all 116 tokens
    pool = engine.pool
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 116)),
                           dtype=torch.int32, device="cuda")
    pool.reserve(0, 116)
    _, pc = causal_lm.prefill(cfg, params, toks[:, :100])
    pool.insert_rows(pc, np.asarray([0]), np.asarray([100]))
    pool.ensure(0, 116)
    bt = pool.device_tables(pool.max_pages)[:1].contiguous()
    zero_counters()
    got, _ = causal_lm.prefill_append(
        cfg, params, toks[:, 100:], pool.cache,
        torch.tensor([100], dtype=torch.int32, device="cuda"), bt)
    torch.cuda.synchronize()
    append_launches = {k: v for k, v in read_counters().items() if v}
    if not any(k.startswith("paged_attention") for k in append_launches):
        raise AssertionError("prefill_append did not reach paged attention")
    want, _ = causal_lm.prefill(cfg, params, toks)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    same_top = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    log(f"{label} prefill_append over a live pool: launches "
        f"{append_launches}, max |append - cold| {err:.3e} of {scale:.3g}, "
        f"argmax equal {same_top}")
    if not (bool(torch.isfinite(got).all()) and err <= 5e-2 * scale):
        raise AssertionError("prefill_append disagrees with a cold prefill")
    stats["append_vs_cold_max_abs"] = err
    pool.release(0)
    pool.check_consistency()
    trajectories = [(prompts[i], r.generated) for i, r in
                    sorted(((rids.index(r.rid), r) for r in done),
                           key=lambda t: t[0])]
    return stats, launches, trajectories


def phase_main_path(torch, np, cfg, params, frac):
    from repro_torch.serving import EngineConfig

    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0)
    stats, launches, traj = serve_main_path(torch, np, cfg, params, ec,
                                            "bf16 main path", frac)
    if not all(launches[k] > 0 for k in FP_KERNELS):
        raise AssertionError(f"a kernel of the bf16 main path never "
                             f"launched: {launches}")
    return stats, launches, traj


def phase_quantized_path(torch, np, cfg, params_q, frac):
    from repro_torch.serving import EngineConfig

    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0,
                      kv_dtype="int8", weight_dtype="int8")
    stats, launches, traj = serve_main_path(torch, np, cfg, params_q, ec,
                                            "quantized main path", frac)
    if not all(launches[k] > 0 for k in INT8_KERNELS):
        raise AssertionError(f"an int8 kernel of the quantized path never "
                             f"launched: {launches}")
    if any(launches[k] for k in FP_KERNELS):
        raise AssertionError(f"the quantized path ran an fp-form kernel: "
                             f"{launches}")
    want = cfg.num_layers * stats["prefills"]
    if launches["flash_attention_fused"] != want:
        raise AssertionError(f"flash launches {launches['flash_attention_fused']}"
                             f" != {cfg.num_layers} per cold prefill x "
                             f"{stats['prefills']} prefills")
    log(f"flash_attention_fused: {launches['flash_attention_fused']} launches"
        f" = {cfg.num_layers} per cold prefill x {stats['prefills']}")
    return stats, launches, traj


def forced_flip_rate(torch, np, cfg, params, params_q, trajectories):
    """Teacher-forced flip rate of the quantized path against the bf16
    path: both replay the bf16 engine's trajectories (prompt + generated
    tokens) through the naive oracle, and at every generated position the
    two greedy picks are compared. Pinning the context to one trajectory
    keeps a single early flip from counting every later token."""
    from repro_torch.launch.serve import generate

    cfg_q = dataclasses.replace(cfg, attn_impl="pallas", kv_dtype="int8")
    flips = total = 0
    by_len = {}
    for prompt, gen in trajectories:
        by_len.setdefault(len(prompt), []).append((prompt, gen))
    for group in by_len.values():
        prompts = torch.as_tensor(np.stack([p for p, _ in group]))
        forced = torch.as_tensor(np.asarray([g for _, g in group],
                                            np.int32))
        picks = [generate(c, p, prompts, gen_tokens=forced.shape[1],
                          forced=forced)["tokens"]
                 for c, p in ((cfg, params), (cfg_q, params_q))]
        flips += int((picks[0] != picks[1]).sum())
        total += picks[0].numel()
    rate = flips / max(total, 1)
    log(f"teacher-forced flip rate, int8 path vs bf16 path (same weights, "
        f"bf16 trajectories): {flips}/{total} = {rate:.4f} (not gated)")
    return rate


# the port's functions whose host time the decode profile reports
HOST_FUNCTIONS = ("step", "decode_step", "layer_apply", "attention_apply",
                  "_qkv", "_paged_write", "quantize_rows", "swiglu_apply",
                  "rmsnorm", "apply_rope", "bcr_spmm", "bcr_spmm_grouped",
                  "_paged_attention", "_sample")


def profile_decode(torch, engine, rng, cfg, steps=5):
    """Device time of steady decode steps (8 live slots) under
    ``torch.profiler``: the sum of kernel time per step, by kernel family,
    against the wall time of the same number of unprofiled steps just
    before (the profiler slows the host) — the device's busy share. Then
    the host side under ``cProfile``: the cumulative time per step of the
    port's functions (``HOST_FUNCTIONS``); cProfile slows every Python
    call, so these rank where the host's time goes, they are not the
    unprofiled wall."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    for n in (32, 128, 512, 128, 32, 512, 128, 32):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=3 * steps + 4)
    engine.step()                     # admission + first decode
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    pr.disable()
    engine.run()
    host_fn_ms = dict.fromkeys(HOST_FUNCTIONS, 0.0)
    for (path, _, fn), (_, _, _, cum, _) in pstats.Stats(pr).stats.items():
        if "repro_torch" in path and fn in host_fn_ms:
            host_fn_ms[fn] += cum * 1e3 / steps
    by_name = {}
    for ev in prof.key_averages():
        # device-side kernel and copy events only: a CPU op's own entry
        # repeats the device time of the kernels it launched
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / steps
    # host side: the PyTorch ops of the step by self CPU time (the profiler
    # slows each op, so these rank the host's costs, they do not add up to
    # the unprofiled wall)
    host = sorted(((ev.self_cpu_time_total / 1e3 / steps, ev.count // steps,
                    ev.key[:60]) for ev in prof.key_averages()
                   if getattr(ev, "device_type", None)
                   == torch.autograd.DeviceType.CPU),
                  reverse=True)[:8]
    families = {}
    for name, ms in by_name.items():
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    device_ms = sum(families.values())
    out = dict(step_wall_ms=wall_ms, device_ms=device_ms,
               busy_share=device_ms / wall_ms if wall_ms else None,
               by_family_ms=families,
               top_other=sorted(((ms, n[:80]) for n, ms in by_name.items()
                                 if kernel_family(n) == "other"),
                                reverse=True)[:5],
               host_fn_ms_cprofile=host_fn_ms,
               host_ops_per_step=sum(ev.count for ev in prof.key_averages()
                                     if getattr(ev, "device_type", None)
                                     == torch.autograd.DeviceType.CPU)
               // steps,
               top_host_ms=host)
    log("decode profile (per step): " + json.dumps(out))
    return out


def kernel_family(name: str) -> str:
    """A profiler kernel name → its launch-counter key (or "other"); the
    int8 forms are the instantiations on int8 (``signed char``) tiles or
    pages, or the tensor-core BCR kernels' ``<true, ...>``."""
    int8 = ("_int8" if "signed char" in name or "_tc<true" in name
            else "")
    if "flash_attention" in name:
        return "flash_attention_fused"
    if "bcr_spmm_skip" in name:
        return "bcr_spmm_skip"
    if "bcr_spmm_grouped" in name:
        return "bcr_spmm_grouped" + int8
    if "bcr_spmm" in name:
        return "bcr_spmm" + int8
    if "paged_attention" in name:
        return "paged_attention" + int8
    return "other"


def _weight_bytes(params) -> int:
    """Bytes a decode step must stream: every projection and norm (the
    embedding table is read one row per token)."""
    from repro_torch.launch.serve import tree_bytes
    return tree_bytes({k: v for k, v in params.items() if k != "embed"})


def phase_engine_vs_naive(torch, np, quantized=False):
    """The engine's greedy tokens against the naive ``generate`` oracle on
    the same params, fp32 activations, full width, 2 layers. Quantized:
    int8 tiles, int8 KV and the flash cold prefill on both sides; a near-tie
    there is 1e-3 relative (one K/V code at a rounding boundary moves a
    logit by about that much), else 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params, generate
    from repro_torch.serving import EngineConfig, InferenceEngine

    over = (dict(attn_impl="pallas", kv_dtype="int8") if quantized else {})
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32", bcr_keep_frac=0.25,
                              bcr_block=(128, 128), **over)
    params = build_params(cfg, seed=1, device="cuda",
                          weight_dtype="int8" if quantized else "")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 77, 128, 300)]
    gen = 16
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=640, page_size=16, seed=0,
        kv_dtype=cfg.kv_dtype), device="cuda")
    got = engine.generate(prompts, max_new_tokens=gen)
    tie = 1e-3 if quantized else 1e-4
    near_ties = 0
    for p, toks in zip(prompts, got):
        naive = generate(cfg, params, torch.as_tensor(p)[None],
                         gen_tokens=gen, page_size=16)
        want = naive["tokens"][0].tolist()
        for i, (a, b) in enumerate(zip(toks, want)):
            if a == b:
                continue
            la = float(naive["logits"][0, i, a])
            lb = float(naive["logits"][0, i, b])
            if abs(la - lb) < tie * max(abs(la), abs(lb)):
                near_ties += 1     # later tokens follow another history
                break
            raise AssertionError(f"engine token {a} != naive {b} at step {i} "
                                 f"(logits {la} vs {lb})")
    what = "int8 tiles + int8 KV + flash prefill" if quantized else "bf16 cfg"
    log(f"engine vs naive generate ({what}, fp32, 2 layers, 4 requests): "
        f"tokens equal, near-ties {near_ties}")
    return near_ties


def train_cfg(torch, num_layers=16, **over):
    """llama3.2-1b at full width: fp32 params, bf16 activations, BCR keep
    0.25 with 128x128 blocks."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-1b"),
                               num_layers=num_layers, bcr_keep_frac=0.25,
                               bcr_block=(128, 128), **over)


def trainer_config(**over):
    from repro_torch.launch.train import TrainerConfig
    kw = dict(steps=8, batch=8, seq=128, admm_start=2, retrain_start=6,
              data_kind="markov", log_every=1, seed=0, device="cuda")
    kw.update(over)
    return TrainerConfig(**kw)


def phase_trainer(torch, np, smi, num_layers=16):
    """GRIM's pruning path at full width through ``train_loop`` (see the
    module docstring, phase 7). Returns the trainer's stats and the
    ``bcr_spmm_skip`` launches of the trained-weight runs."""
    from repro_torch.core.bcr import is_bcr_set_member
    from repro_torch.data.pipeline import DataConfig, TokenSource
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import pack_params
    from repro_torch.launch.train import train_loop
    from repro_torch.models import causal_lm
    from repro_torch.tree import flatten, tree_map

    cfg = train_cfg(torch, num_layers)
    tc = trainer_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_loop(cfg, tc, log=lambda *a: log(" ", *a))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist, phases, step_ms = out["history"], out["phases"], out["step_ms"]
    specs, state = out["specs"], out["state"]
    n_params = sum(p.numel() for _, p in flatten(state.params))
    by_phase = {ph: [ms for ms, p in zip(step_ms, phases) if p == ph]
                for ph in ("dense", "admm", "retrain")}
    stats = dict(
        params=n_params, pruned_leaves=len(specs), losses=hist,
        phases=phases, step_ms=step_ms,
        step_ms_p50={ph: statistics.median(v) for ph, v in by_phase.items()
                     if v},
        transition_ms=out["transition_ms"], wall_s=wall,
        peak_bytes=peak)
    log(f"trainer: {json.dumps(stats)}")
    log(f"trainer peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated) on {smi}; retrain step p50 "
        f"{stats['step_ms_p50'].get('retrain', float('nan')):.1f} ms")
    if phases != ["dense"] * 2 + ["admm"] * 4 + ["retrain"] * 2:
        raise AssertionError(f"unexpected phases {phases}")
    if len(out["transition_ms"]["dual_update"]) != 1:
        raise AssertionError("expected one Z/U dual update (step 5)")
    if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"loss not finite or not lower: {hist}")
    stats["profile"] = profile_train_step(torch, cfg, tc, state, specs)
    flat = dict(flatten(state.params))
    bad = [path for path, spec in specs.items()
           if not is_bcr_set_member(flat[path].detach(), spec)]
    if bad:
        raise AssertionError(f"{len(bad)} pruned leaves are not BCR members: "
                             f"{bad[:3]}")
    log(f"  every one of the {len(specs)} pruned leaves is a balanced-BCR "
        f"member; loss {hist[0]:.4f} -> {hist[-1]:.4f}")

    # the retrained weights through the serving path
    dense = tree_map(lambda p: p.detach(), state.params)
    del out, state, flat
    torch.cuda.empty_cache()
    packed = pack_params(cfg, dense)
    toks = TokenSource(DataConfig(cfg.vocab_size, tc.seq, tc.batch,
                                  seed=1, kind="markov")).device_batch(
        0, "cuda")["tokens"]
    zero_counters()
    with torch.no_grad():
        got, _ = causal_lm.prefill(cfg, packed, toks)
        torch.cuda.synchronize()
        serve_launches = {k: v for k, v in read_counters().items() if v}
        want = causal_lm.forward(cfg, dense, toks)[:, -1:]
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    a, b = got.float().argmax(-1), want.float().argmax(-1)
    ties = 0
    for r in torch.nonzero(a != b).tolist():
        la = float(want[r[0], r[1], a[r[0], r[1]]])
        lb = float(want[r[0], r[1], b[r[0], r[1]]])
        if abs(la - lb) > err:
            raise AssertionError(f"packed argmax differs at row {r}: dense "
                                 f"logits {la} vs {lb}, beyond the max "
                                 f"difference {err}")
        ties += 1
    log(f"  packed prefill vs dense forward of the finalized weights "
        f"(B={tc.batch}, S={tc.seq}): launches {serve_launches}, max |diff| "
        f"{err:.3e} of {scale:.3g}, argmax equal on {tc.batch - ties}/"
        f"{tc.batch} rows (near-ties {ties})")
    if not (bool(torch.isfinite(got).all()) and err <= 5e-2 * scale):
        raise AssertionError("packed prefill disagrees with the dense "
                             "forward of the finalized weights")
    if not serve_launches.get("bcr_spmm") or \
            not serve_launches.get("bcr_spmm_grouped"):
        raise AssertionError("packed prefill did not run the BCR kernels")
    stats.update(serve_max_abs=err, serve_scale=scale, serve_near_ties=ties)
    del packed, got, want
    torch.cuda.empty_cache()

    # the trained projections, paper-general form: unbalanced BCR, skip pack;
    # the counted runs first, then the timed ones (not counted)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    zero_counters()
    skip_rows, runs = [], []
    for name, w in (("lm_head", dense["lm_head"]["w"]),
                    ("mlp_wo", dense["layers"][0]["ffn"]["wo"]["w"]),
                    ("wq", dense["layers"][0]["mixer"]["wq"]["w"])):
        p, share, empty = skip_pack(torch, w, dtype=cfg.act_dtype)
        for m in (8, tc.batch * tc.seq):
            x = torch.randn((m, w.shape[1]), generator=gen,
                            device="cuda").to(cfg.act_dtype)
            got = SK.bcr_spmm_skip(x, p)
            want = ref.bcr_spmm_skip_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"trained {name} {tuple(w.shape)} unbalanced "
                              f"(share {share:.4f}, empty block rows "
                              f"{empty}) M={m}", got, want, BF16_TOL)
            skip_rows.append(dict(weight=name, m=m, share=share,
                                  empty_block_rows=empty, max_abs_err=err))
            runs.append((p, x))
        del p
    launches = read_counters()["bcr_spmm_skip"]
    log(f"  bcr_spmm_skip launches on the trained weights: {launches}")
    if launches != len(skip_rows):
        raise AssertionError("bcr_spmm_skip did not launch once per run")
    timer = Timer(torch)
    for row, (p, x) in zip(skip_rows, runs):
        byts, ops = skip_bytes_ops(p, x.shape[0])
        row["ms"] = timer.ms(lambda: SK.bcr_spmm_skip(x, p))
        row["bound_ms"] = max(byts / HBM_BYTES_PER_S,
                              ops / BF16_OPS_PER_S) * 1e3
        log(f"  trained {row['weight']} M={row['m']}: {row['ms']:.4f} ms "
            f"(bound {row['bound_ms']:.4f} ms)")
    stats["trained_skip"] = skip_rows
    del runs, timer
    del dense
    torch.cuda.empty_cache()
    return stats, launches


def train_kernel_family(name: str) -> str:
    """A profiler kernel name of a train step → a coarse family."""
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "sm90_",
                              "nvjet")):      # nvjet: cuBLASLt's Hopper GEMMs
        return "matmul"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reduction"
    if "elementwise" in low or "vectorized" in low or "foreach" in low:
        return "elementwise"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def profile_train_step(torch, cfg, tc, state, specs):
    """Where a retrain step's time goes: one more step (frozen masks, a
    tiny learning rate) timed on the host, then one under
    ``torch.profiler`` — device time by kernel family against the wall
    (the busy share), and the markov batch's host time on its own. Run
    after the 8 steps of ``train_loop``, on its final state."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.adamw import AdamWConfig

    data = TokenSource(DataConfig(cfg.vocab_size, tc.seq, tc.batch,
                                  seed=tc.seed, kind=tc.data_kind))
    t0 = time.perf_counter()
    batch = data.device_batch(tc.steps, "cuda")
    batch_ms = (time.perf_counter() - t0) * 1e3
    step = make_train_step(cfg, AdamWConfig(lr=1e-6, warmup_steps=0,
                                            total_steps=1), None, specs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        float(m["loss"])
    fams, top = {}, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            fam = train_kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + us / 1e3
            top.append((us / 1e3, ev.count, ev.key[:70]))
    device_ms = sum(fams.values())
    launches = sum(ev.count for ev in prof.key_averages()
                   if getattr(ev, "device_type", None)
                   == torch.autograd.DeviceType.CUDA)
    out = dict(step_wall_ms=wall_ms, markov_batch_host_ms=batch_ms,
               device_ms=device_ms, busy_share=device_ms / wall_ms,
               device_launches=launches, by_family_ms=fams,
               top_kernels=sorted(top, reverse=True)[:8])
    log("  retrain step profile: " + json.dumps(out))
    return out


def phase_resume(torch, np, tmp_dir):
    """2 layers, vocab cut to 8192 (the checkpoint stays ~3 GB), the same
    phases: a run stopped at step 4 (a ``save_async`` checkpoint inside the
    ADMM phase) and resumed must repeat the uninterrupted run's losses.
    fp32 tolerance 1e-4 relative: the embedding backward sums with atomics
    in a run-dependent order."""
    import shutil

    from repro_torch.launch.train import train_loop
    from repro_torch.optim.adamw import AdamWConfig

    cfg = train_cfg(torch, num_layers=2, vocab_size=8192)
    # the schedule of the 8-step run for all three (the loop's default
    # would follow each run's own step count)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    quiet = lambda *a: None                           # noqa: E731
    whole = train_loop(cfg, trainer_config(), opt, log=quiet)["history"]
    shutil.rmtree(tmp_dir, ignore_errors=True)
    t0 = time.perf_counter()
    first = train_loop(cfg, trainer_config(steps=4, ckpt_dir=str(tmp_dir),
                                           ckpt_every=4), opt, log=quiet)
    save_s = time.perf_counter() - t0
    rest = train_loop(cfg, trainer_config(ckpt_dir=str(tmp_dir),
                                          ckpt_every=100), opt, log=quiet)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    got = first["history"] + rest["history"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, whole))
    log(f"resume (2 layers, vocab 8192): uninterrupted {whole}; stopped at "
        f"4 and resumed {got}; max relative difference {rel:.2e} (first run "
        f"incl. its checkpoint {save_s:.1f} s)")
    if rest["phases"] != ["admm"] * 2 + ["retrain"] * 2 or rel > 1e-4:
        raise AssertionError("resumed losses disagree with the uninterrupted "
                             "run")
    return rel


def bcr_worker(tree: str) -> int:
    """``--bcr-worker TREE``: :func:`bcr_cases`, :func:`paged_cases`,
    :func:`skip_cases` and :func:`flash_cases` against TREE's own
    ``repro_torch`` (built into TREE's build directory); the rows come out
    as one ``bcr rows:`` JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["bcr_spmm", "bcr_spmm_skip", "flash_attention",
                     "paged_attention"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    timer, record = Timer(torch), recorder(torch, rows)
    bcr_cases(torch, timer, gen, record)
    paged_cases(torch, timer, gen, record)
    skip_cases(torch, timer, gen, record)
    flash_cases(torch, timer, gen, record)
    print("bcr rows: " + json.dumps(rows), flush=True)
    return 0


def bcr_ab(trees) -> int:
    """``--bcr-ab TREE...``: one :func:`bcr_worker` process per TREE, in the
    order given (e.g. ``build/parent . . build/parent`` to compare a parent
    checkout with this one on one card, in turns). Prints each run's
    kernel times side by side and writes them to ``build/bcr_ab.json``."""
    import torch

    if not torch.cuda.is_available() or not trees:
        print("chip_smoke: --bcr-ab needs a CUDA device and at least one "
              "tree", file=sys.stderr)
        return 2
    smi = smi_line()
    runs = []
    for tree in trees:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--bcr-worker", tree],
                             capture_output=True, text=True, timeout=1500)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("bcr rows: ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"bcr worker for {tree} failed "
                               f"({out.returncode})")
        runs.append((tree, json.loads(lines[-1][len("bcr rows: "):])))
        log(f"{tree}: {time.perf_counter() - t0:.1f} s")
    log(smi)
    log("kernel | shape | " + " | ".join(f"{t} ms" for t, _ in runs)
        + " | bound ms | library ms")
    for i, row in enumerate(runs[0][1]):
        times = [r[i]["ms"] for _, r in runs]
        log(f"{row['kernel']} | {row['shape']} | "
            + " | ".join(f"{t:.4f}" for t in times)
            + f" | {row['bound_ms']:.4f} | {row['library_ms']:.4f}")
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bcr_ab.json").write_text(json.dumps(
        {"device": smi, "runs": [{"tree": t, "rows": r} for t, r in runs]},
        indent=1))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--bcr-ab"]:
        return bcr_ab(sys.argv[2:])
    if sys.argv[1:2] == ["--bcr-worker"] and len(sys.argv) == 3:
        return bcr_worker(sys.argv[2])
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--bcr-ab TREE... | --bcr-worker TREE]",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1, device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"phase 2, build: {time.perf_counter() - t0:.1f} s for "
        f"{sorted(paths)}")
    for name, path in paths.items():
        log_text = path.with_suffix(".log").read_text()
        regs = [ln.split("Used")[1].strip() for ln in log_text.splitlines()
                if "Used" in ln]
        spills = [ln.strip() for ln in log_text.splitlines()
                  if "spill" in ln and "0 bytes spill stores" not in ln]
        log(f"  {name}: ptxas {regs}; spills {spills or 'none'}")
    log("BCR instructions (cuobjdump -sass of the built library)")
    bcr_instruction_check(paths["bcr_spmm"])
    tc_instruction_check(paths["bcr_spmm_skip"], paths["flash_attention"],
                         paths["paged_attention"])

    log("phase 3, kernels against their plain versions")
    t0 = time.perf_counter()
    timer = Timer(torch)
    rows = phase_kernels(torch, timer)
    log("kernel cases: " + json.dumps(rows))
    del timer
    torch.cuda.empty_cache()
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    log("phase 4, bf16 main path")
    t0 = time.perf_counter()
    cfg, params, params_q, fracs = build_main_params(torch)
    _, launches, traj = phase_main_path(torch, np, cfg, params, fracs[0])
    torch.cuda.empty_cache()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    log("phase 5, quantized main path (int8 tiles, int8 KV, flash prefill)")
    t0 = time.perf_counter()
    _, q_launches, _ = phase_quantized_path(torch, np, cfg, params_q,
                                            fracs[1])
    forced_flip_rate(torch, np, cfg, params, params_q, traj)
    del params, params_q
    torch.cuda.empty_cache()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    log("phase 6, engines against naive generate")
    t0 = time.perf_counter()
    phase_engine_vs_naive(torch, np)
    phase_engine_vs_naive(torch, np, quantized=True)
    torch.cuda.empty_cache()
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    log("phase 7, GRIM's pruning path at full width (train_loop, "
        "pack_params, bcr_spmm_skip)")
    t0 = time.perf_counter()
    _, skip_launches = phase_trainer(torch, np, smi)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    log("phase 8, checkpoint resume on the card")
    t0 = time.perf_counter()
    phase_resume(torch, np, Path(__file__).resolve().parent / "build"
                 / "chip_smoke_ckpt")
    torch.cuda.empty_cache()
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    # one entry per kernel form at its decode-step shape (M = 8 slots) or,
    # for flash, the largest cold-prefill bucket; launches from the main
    # path that runs it (for bcr_spmm_skip, the trained-weight runs of the
    # pruning path: the skip form is not on the serving path)
    path_launches = {**{k: launches[k] for k in FP_KERNELS},
                     **{k: q_launches[k] for k in INT8_KERNELS},
                     "flash_attention_fused":
                         q_launches["flash_attention_fused"],
                     "bcr_spmm_skip": skip_launches}
    kernels = []
    for name, (source, replaces, shape) in KERNELS.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["shape"] == shape)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == name),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

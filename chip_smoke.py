#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, in order (any failed check raises and the script exits non-zero):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, one process per source, all started together.
3. Kernels against their plain PyTorch versions on the card, bf16 at the
   llama3.2-1b full-width shapes (d_model 2048, 32/8 heads, head_dim 64,
   d_ff 8192, vocab 128256, BCR block 128 at keep 0.25, so R_keep = C_keep =
   64), plus one small fp32 case each: max error against the stated
   tolerance, CUDA-event times (median of 20 after warm-up, L2 flushed
   before each launch), the plain version's time, one library yardstick
   (never used by the port) and the bound.
4. Main path at full width: llama3.2-1b, 16 layers, random weights from a
   seeded generator, packed at keep 0.25 / block 128, served through the
   paged engine (8 slots, page 16, capacity 640): 16 greedy requests with
   prompts from {32, 128, 512} and 32 new tokens each. The launch counters
   are zeroed just before and read just after; then one direct
   ``prefill_append`` on a live pool, held to a cold prefill.
5. Engine against the naive ``generate`` oracle: fp32, full width, 2
   layers, 4 requests, greedy tokens equal up to near-ties.
6. The card's line, the ``kernels`` JSON line, and the contract line.
"""

from __future__ import annotations

import dataclasses
import json
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
KERNELS = {
    "bcr_spmm": (f"{PORT}/bcr_spmm.cu", f"{REPO}/kernels/bcr_spmm.py:158"),
    "bcr_spmm_grouped": (f"{PORT}/bcr_spmm.cu",
                         f"{REPO}/kernels/bcr_spmm.py:311"),
    "paged_attention": (f"{PORT}/paged_attention.cu",
                        f"{REPO}/kernels/paged_decode_attention.py:126"),
}


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

    def ms(self, fn, reps=20, warmup=3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
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


def _library_sdpa(torch, q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def phase_kernels(torch, timer):
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack, tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import paged_decode_attention as PA
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

    def tile_bytes(p):
        return (p.vals.numel() * p.vals.element_size()
                + (p.row_idx.numel() + p.col_idx.numel()) * 4)

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
    p = pack(256, 384, torch.float32)
    x = randn(5, 384, dtype=torch.float32)
    err = check_close("fp32 256x384 M=5", K.bcr_spmm(x, p),
                      ref.bcr_spmm_packed_ref(x, p), FP32_TOL)

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
    grouped = pack_group([pack(256, 384, torch.float32) for _ in range(2)])
    x = randn(5, 384, dtype=torch.float32)
    bias = randn(2, 256, dtype=torch.float32)
    check_close("fp32 2x256x384 M=5 swiglu+bias",
                K.bcr_spmm_grouped(x, grouped, bias=bias, epilogue="swiglu"),
                ref.bcr_spmm_grouped_ref(x, grouped, bias=bias,
                                         epilogue="swiglu"), FP32_TOL)

    # -- paged attention -----------------------------------------------------
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
    return rows


def phase_main_path(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.launch.serve import packed_fraction, pack_params
    from repro_torch.models import causal_lm
    from repro_torch.serving import FINISHED, EngineConfig, InferenceEngine

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=16,
                              bcr_keep_frac=0.25, bcr_block=(128, 128))
    t0 = time.perf_counter()
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    params = pack_params(cfg, dense)
    frac = packed_fraction(dense, params)
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"init + pack {time.perf_counter() - t0:.1f} s; packed-weight "
        f"fraction {frac:.4f} of the dense fp32 tree")
    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0)
    engine = InferenceEngine(cfg, params, ec, device="cuda")
    rng = np.random.default_rng(0)
    plens = rng.choice([32, 128, 512], size=16)
    for n in plens:
        engine.submit(rng.integers(0, cfg.vocab_size, size=int(n)),
                      max_new_tokens=32)

    counters = (K.LAUNCHES, PA.LAUNCHES)
    for c in counters:
        for key in c:
            c[key] = 0
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
    launches = {**K.LAUNCHES, **PA.LAUNCHES}
    log(f"main path launches: {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if len(done) != 16 or any(r.status != FINISHED or len(r.generated) != 32
                              for r in done):
        raise AssertionError("not every request FINISHED with 32 tokens")
    if engine.stats["nonfinite_rows"]:
        raise AssertionError(f"{engine.stats['nonfinite_rows']} sampled "
                             f"logit rows were not finite")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    stats = dict(
        tokens_per_s=engine.stats["tokens_generated"] / wall,
        decode_step_ms_mean=statistics.mean(decode_ms),
        decode_step_ms_p50=statistics.median(decode_ms),
        decode_steps=engine.stats["decode_steps"],
        prefills=engine.stats["prefills"], ttft_ms_p50=statistics.median(ttft),
        wall_s=wall, packed_fraction=frac,
        kv_bytes_read_live=engine.stats["kv_bytes_read_live"],
        packed_weight_bytes=_weight_bytes(params),
        step_bound_ms=_weight_bytes(params) / HBM_BYTES_PER_S * 1e3)
    log("main path: " + json.dumps(stats))
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
    for c in counters:
        for key in c:
            c[key] = 0
    got, _ = causal_lm.prefill_append(
        cfg, params, toks[:, 100:], pool.cache,
        torch.tensor([100], dtype=torch.int32, device="cuda"), bt)
    torch.cuda.synchronize()
    append_launches = dict(PA.LAUNCHES)
    if append_launches["paged_attention"] <= 0:
        raise AssertionError("prefill_append did not reach paged attention")
    want, _ = causal_lm.prefill(cfg, params, toks)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    same_top = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    log(f"prefill_append over a live pool: launches {append_launches}, "
        f"max |append - cold| {err:.3e} of {scale:.3g}, argmax equal "
        f"{same_top}")
    if not (bool(torch.isfinite(got).all()) and err <= 5e-2 * scale):
        raise AssertionError("prefill_append disagrees with a cold prefill")
    pool.release(0)
    pool.check_consistency()
    return stats, launches


def profile_decode(torch, engine, rng, cfg, steps=5):
    """Device time of steady decode steps (8 live slots) under
    ``torch.profiler``: the sum of kernel time per step, by kernel family,
    against the wall time of the same number of unprofiled steps just
    before (the profiler slows the host) — the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    for n in (32, 128, 512, 128, 32, 512, 128, 32):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=2 * steps + 4)
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
    engine.run()
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
    families = {"bcr_spmm": 0.0, "bcr_spmm_grouped": 0.0,
                "paged_attention": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        fam = ("bcr_spmm_grouped" if "bcr_spmm_grouped" in name else
               "bcr_spmm" if "bcr_spmm" in name else
               "paged_attention" if "paged_attention" in name else "other")
        families[fam] += ms
    device_ms = sum(families.values())
    out = dict(step_wall_ms=wall_ms, device_ms=device_ms,
               busy_share=device_ms / wall_ms if wall_ms else None,
               by_family_ms=families,
               top_other=sorted(((ms, n[:80]) for n, ms in by_name.items()
                                 if "bcr_spmm" not in n
                                 and "paged_attention" not in n),
                                reverse=True)[:5])
    log("decode profile (per step): " + json.dumps(out))
    return out


def _weight_bytes(params) -> int:
    """Bytes a decode step must stream: every projection and norm (the
    embedding table is read one row per token)."""
    from repro_torch.launch.serve import tree_bytes
    return tree_bytes({k: v for k, v in params.items() if k != "embed"})


def phase_engine_vs_naive(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params, generate
    from repro_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32", bcr_keep_frac=0.25,
                              bcr_block=(128, 128))
    params = build_params(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 77, 128, 300)]
    gen = 16
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=640, page_size=16, seed=0), device="cuda")
    got = engine.generate(prompts, max_new_tokens=gen)
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
            if abs(la - lb) < 1e-4 * max(abs(la), abs(lb)):
                near_ties += 1     # later tokens follow another history
                break
            raise AssertionError(f"engine token {a} != naive {b} at step {i} "
                                 f"(logits {la} vs {lb})")
    log(f"engine vs naive generate (fp32, 2 layers, 4 requests): tokens "
        f"equal, near-ties {near_ties}")
    return near_ties


def main() -> int:
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

    log("phase 3, kernels against their plain versions")
    timer = Timer(torch)
    rows = phase_kernels(torch, timer)
    log("kernel cases: " + json.dumps(rows))
    del timer
    torch.cuda.empty_cache()

    log("phase 4, main path")
    stats, launches = phase_main_path(torch, np)
    torch.cuda.empty_cache()

    log("phase 5, engine against naive generate")
    phase_engine_vs_naive(torch, np)

    # one entry per kernel at its decode-step shape (M = 8 slots)
    rep = {"bcr_spmm": "lm_head 128256x2048 M=8",
           "bcr_spmm_grouped": "wgi 2x8192x2048 M=8",
           "paged_attention": "decode B=8 lens 1..512"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["shape"] == rep[name])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
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

// Flash attention over a block-paged KV pool, written for Hopper (sm_90a),
// bound to Python through ctypes (kernels/paged_decode_attention.py).
//
// Replaces the reference package's TPU kernel _paged_attention / _kernel in
// kernels/paged_decode_attention.py, behind both of its entry points:
// paged_decode_attention (S = 1, prefix_len = cache_len - 1) and
// paged_prefill_append_attention (an S-row suffix over cached prefix pages).
//
// What it computes: for slot b and kv-head h the query block is the S·G rows
// of that kv-head (G = H / Hkv q-heads per kv-head); row r is q-head
// h·G + r % G of suffix position r / G and sits at absolute position
// prefix_len[b] + r / G. Each row attends to every cached position
// pos <= its own (and < total_len[b]), read through the slot's block table,
// with the scale D**-0.5 and an fp32 online softmax; the result is
// acc / max(l, 1e-30).
//
// Two forms: the fp form reads pages in q's dtype (the wrapper casts q to
// the pool's dtype, as the reference does, and P is rounded to the page
// dtype for P·V); the int8 form (the reference's quantized serving,
// kv_dtype="int8") reads int8 codes plus the per-row, per-kv-head fp32
// scales of the sibling (n_pages, page_size, Hkv) pools. As in the
// reference's kernel, q stays floating, the logits are formed on the codes
// and each logit column is multiplied by its row's k_scale; each
// probability column is multiplied by its row's v_scale before the P·V sum
// (the softmax denominator uses the unscaled probabilities).
//
// What bounds it on this card: the K/V bytes of the live pages, each read
// once per (kv-head, row tile): Hkv·D·2 bytes per cached position per K or
// V in bf16, Hkv·(D + 4) under int8 — ~3.7 MB at 8 slots over lengths
// 1..512, about 1 µs at 3.35 TB/s, below one launch's latency; 44 MB
// (13 µs) at lengths 1024..4096. At decode there are only G query rows per
// page read, far below the tensor cores' balance point, so the design is
// about keeping enough page bytes in flight, on enough SMs, with a short
// dependency chain per CTA.
//
// Design (the launch comes from kernels/paged_decode_attention.py:
// paged_plan, pinned by tests/test_torch_paged_plan.py):
//   * One launch split over pages. The grid is (B·Hkv·row tiles, splits);
//     CTA (unit, s) takes the unit's pages [s·P, min((s+1)·P, live)), P the
//     plan's pages per split, live = ceil(total_len / page_size) read on
//     the device (the host never reads the lengths, so nothing syncs). A
//     CTA whose split starts past the slot's live pages returns at once; a
//     slot with no live page has its split 0 write exact zeros. A unit
//     with one live split writes `out` itself; otherwise every live split
//     writes an fp32 partial (m, l, acc) to the wrapper's workspace and
//     bumps the unit's int32 counter, and the last to arrive merges the
//     partials in split order, writes `out` and puts the counter back to 0
//     (the scheme of bcr_spmm.cu's split): launches are bit-equal and a
//     CUDA graph can replay one.
// Three bodies, chosen on the host by kernels/paged_decode_attention.py:
// paged_body from dtypes and shapes:
//   * bf16 q over bf16 or int8 pages (namespace tc): both products on the
//     tensor cores, mma.sync m16n8k16 — S = Q·K^T with Q's fragments in
//     registers and K by ldmatrix, O += P·V with P repacked in registers
//     as the A fragment (as flash_attention.cu does) and V by
//     ldmatrix.trans. The online softmax runs on the accumulator in
//     registers, exp2 with log2(e) folded into the scale. The CTA owns
//     16·NSLAB query rows (NSLAB = 1, 2 or 4 slabs of 16; the plan takes
//     the most rows that still give the card enough CTAs) and walks its
//     split in rounds of 64 keys; the 4 warps split the round's keys over
//     the slabs: with one slab (decode's G = 4 rows padded to 16, or
//     prefill-append of 16 rows at 8 slots x 8 kv-heads) each warp takes
//     its own 16 keys, with four each warp its own slab over all 64 keys.
//     The warps' (m, l, acc) are merged in shared memory at the end
//     (flash-decoding inside the CTA), so no warp idles.
//   * Loads: the split's block-table entries are read once, then each
//     round's K and V rows (a kv-head's page row is D·2 contiguous bytes,
//     Hkv·D·2 apart) are gathered by cp.async in 16-byte chunks into a
//     3-4-stage ring, XOR-swizzled as in flash_attention.cu; positions past
//     the split's end or total_len arrive as zeros (a never-written page
//     slot cannot put NaN into P·V). At the short decode shapes the whole
//     split is in flight after the prologue.
//   * int8 pages: the codes (and their scales, 4-byte cp.async) come into
//     the ring as they are and are widened to bf16 in shared memory before
//     the products, exactly (|code| <= 127). k_scale multiplies S's fp32
//     columns; v_scale multiplies P before the bf16 repack, which adds one
//     bf16 rounding of P·v_scale (relative 2^-9), within the bf16
//     tolerance.
//   * fp32 q over fp32 or int8 pages (namespace f32), head_dim 16, 32, 64
//     or 128, any page size, 16-byte aligned q and pages: both products as
//     FFMA on the CUDA cores in full fp32 (no TF32: the 1e-4 gate). The
//     shape of the tc body: a CTA walks its split in rounds of 32 keys,
//     each round's K and V rows gathered by 16-byte cp.async into a 2-3
//     stage ring (one barrier a round, the next rounds in flight), int8
//     codes widened to fp32 tiles once a round. The logits are a register
//     tile a lane, 4 rows x 4 keys read as 16-byte shared loads: K (and Q)
//     rows sit key-major at a stride padded to head_dim + 4 floats, so the
//     8 keys a quarter-warp reads fall in 8 distinct bank groups (padding,
//     not a transposed staging). The online softmax stays in registers,
//     its row max and sum by shuffles over the lanes holding the row's
//     keys, exp2 with log2(e) folded into the scale; P goes through the
//     warp's own shared tile (rows x (keys + 4) floats) to P·V, where a
//     lane owns its rows x 4 d of the accumulator across rounds. Three
//     configurations by the query rows of a (slot, kv-head) (the plan in
//     kernels/paged_decode_attention.py:launch_plan, pinned by
//     tests/test_torch_paged_plan.py): decode's G <= 4 rows (4 warps, each
//     its own 8 keys of a round, the warps' (m, l, acc) merged in warp
//     order at the end: flash-decoding inside the CTA), up to 16 rows
//     (verify; a warp each 4 rows over the round's 32 keys) and 64 rows
//     (prefill-append; 8 warps of 8 rows, two lanes a dot). Its split
//     fills four CTAs an SM with splits of at least 64 positions and caps
//     a CTA at 256 (the heaviest CTA's products set the time).
//   * What bounds the fp32 body after the chip run (NVIDIA H100 80GB HBM3,
//     700 W; PERF.md §6): issue and shared-memory latency on the
//     CUDA cores, not bytes nor the FFMA peak — row 3f's prefill-append
//     (32/8 heads, head_dim 128, 16 rows over prefixes 0..496) runs at
//     about 17% of the fp32 FFMA rate, decode at about 20% of the HBM rate.
//   * Every other shape — head dims other than 16, 32, 64 and 128 (bf16 q
//     also at page sizes that are not multiples of 16), unaligned tensors —
//     runs the CUDA-core body (namespace cuda_core) under the same split:
//     per page, K and V of the kv-head staged in fp32 shared memory (the
//     next page's rows prefetched into registers), the masked logits, one
//     warp per row for the softmax statistics, scalar P·V.
//   * What still bounds the tc body after the chip run (H100, PERF.md §6):
//     at the short shapes a launch's chain of memory latencies — the
//     length and table entries, then the pages, then, when split, the
//     partials' round trip (fence, counter, merge) — 0.011-0.016 ms at the
//     phase-3 shapes of chip_smoke.py; over 1024..4096 positions the
//     bytes: 44.6 MB in 0.031 ms, level with a plain sum over the same
//     pool, under a timer whose flush leaves the L2 dirty (each line read
//     first evicts one to write back).

#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kSmemMax = 232448;   // bytes of shared memory a CTA may take

struct AttnShape {
  int B, S, H, Hkv, D, page_size, n_cols;
  int row_tile, row_tiles, units, pps, splits;
  float scale;
  int vec;   // CUDA-core body: 1 = registers-pipelined 16-byte page loads
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return (float)v;
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The (slot, kv-head, row tile) of CTA row blockIdx.x, and its live pages.
struct Unit {
  int b, h, r0, nr, G, live, live_splits;
};

__device__ __forceinline__ Unit unit_of(const AttnShape& s, int tlen) {
  Unit u;
  const int rt = blockIdx.x % s.row_tiles, bh = blockIdx.x / s.row_tiles;
  u.h = bh % s.Hkv;
  u.b = bh / s.Hkv;
  u.G = s.H / s.Hkv;
  u.r0 = rt * s.row_tile;
  u.nr = min(s.row_tile, s.S * u.G - u.r0);
  u.live = tlen > 0 ? min((tlen + s.page_size - 1) / s.page_size, s.n_cols)
                    : 0;
  u.live_splits = (u.live + s.pps - 1) / s.pps;
  return u;
}

template <typename T>
__device__ __forceinline__ T* out_row(T* out, const AttnShape& s,
                                      const Unit& u, int rr) {
  const int r = u.r0 + rr, si = r / u.G, g = r - si * u.G;
  return out + (((size_t)u.b * s.S + si) * s.H + u.h * u.G + g) * s.D;
}

// V consecutive floats: loaded from L2 (bypassing L1: other CTAs wrote
// them), stored, and written to `out` in its dtype.
template <int V> struct Vec { float v[V]; };

template <int V>
__device__ __forceinline__ Vec<V> ld_l2(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = __ldcg(p + i);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V, typename T>
__device__ __forceinline__ void st_out(T* p, const float* v, float inv) {
#pragma unroll
  for (int i = 0; i < V; ++i) p[i] = from_f<T>(v[i] * inv);
}

// Weight of a partial with maximum m against the merged maximum mx; a
// partial whose m is still kNegInf (no key reaches the row) weighs 0.
template <bool kLog2>
__device__ __forceinline__ float weight(float m, float mx) {
  if (m <= 0.5f * kNegInf) return 0.f;
  return kLog2 ? hopper::ex2(m - mx) : expf(m - mx);
}

// The CTA's rows (acc, m, l in shared memory; m in log2 units when kLog2)
// → out: directly when the slot has one live split; otherwise as an fp32
// partial in the workspace, and the last live split to arrive merges every
// split's partial in split order (so the result does not depend on the
// arrival order) and puts the unit's counter back to 0. V = 4 moves rows
// as float4 (D % 4 == 0). The merge is one online pass over the splits
// (running max, rescaled sum and acc), each thread two V-wide groups at a
// time and four splits' L2 reads in flight together. NT is the CTA's
// thread count.
template <bool kLog2, int V, int NT = kThreads, typename T>
__device__ void finish(const float* acc, int lda, const float* m,
                       const float* l, T* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters,
                       int* flag, const AttnShape& s, const Unit& u) {
  constexpr int kGroups = 2;   // V-wide groups a thread merges at once
  const int D = s.D, DV = D / V, tid = threadIdx.x, n = u.nr * DV;
  if (u.live_splits <= 1) {
    for (int e = tid; e < n; e += NT) {
      const int rr = e / DV, d = (e - rr * DV) * V;
      st_out<V>(out_row(out, s, u, rr) + d, acc + rr * lda + d,
                1.f / fmaxf(l[rr], 1e-30f));
    }
    return;
  }
  const int RT = s.row_tile, unit = blockIdx.x;
  const size_t first = (size_t)unit * s.splits;     // the unit's split 0
  float* wacc = ws;                                 // [unit][split][RT][D]
  float* wml = ws + (size_t)s.units * s.splits * RT * D;   // [..][RT][2]
  float* pa = wacc + (first + blockIdx.y) * RT * D;
  float* pm = wml + (first + blockIdx.y) * RT * 2;
  for (int e = tid; e < n; e += NT) {
    const int rr = e / DV, d = (e - rr * DV) * V;
    st_vec<V>(pa + rr * D + d, acc + rr * lda + d);
  }
  for (int rr = tid; rr < u.nr; rr += NT) {
    pm[2 * rr] = m[rr];
    pm[2 * rr + 1] = l[rr];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + unit, 1) == u.live_splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* ma = wacc + first * RT * D;
  const float* mm = wml + first * RT * 2;
  const int ls = u.live_splits;
  for (int e0 = tid; e0 < n; e0 += kGroups * NT) {
    float a[kGroups][V] = {}, mx[kGroups], lsum[kGroups] = {};
    int rows[kGroups], cols[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int e = min(e0 + j * NT, n - 1);
      rows[j] = e / DV;
      cols[j] = (e - rows[j] * DV) * V;
      mx[j] = kNegInf;
    }
#pragma unroll 4
    for (int q = 0; q < ls; ++q) {
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const size_t r = (size_t)q * RT + rows[j];
        const float mq = __ldcg(mm + 2 * r), lq = __ldcg(mm + 2 * r + 1);
        const Vec<V> v = ld_l2<V>(ma + r * D + cols[j]);
        const float mn = fmaxf(mx[j], mq);
        const float alpha = weight<kLog2>(mx[j], mn);
        const float w = weight<kLog2>(mq, mn);
        lsum[j] = lsum[j] * alpha + w * lq;
#pragma unroll
        for (int i = 0; i < V; ++i) a[j][i] = a[j][i] * alpha + w * v.v[i];
        mx[j] = mn;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      if (e0 + j * NT < n)
        st_out<V>(out_row(out, s, u, rows[j]) + cols[j], a[j],
                  1.f / fmaxf(lsum[j], 1e-30f));
  }
  if (tid == 0) counters[unit] = 0;   // ready for the next call
}

}  // namespace

// ---------------------------------------------------------------------------
// CUDA-core body: fp32 q or pages, and the shapes the MMA body does not take
// ---------------------------------------------------------------------------

namespace cuda_core {

constexpr int kPageVecs = 4;   // 16-byte K (and V) vectors a thread prefetches

// q tile, K page (rows padded by one word), V page, logits, accumulator,
// the per-row m / l / alpha, the page's K and V row scales (int8 form) and
// the split's arrival flag, in 4-byte words
__host__ __device__ inline size_t smem_words(int D, int ps, int rt) {
  return (size_t)rt * D + (size_t)ps * (D + 1) + (size_t)ps * D +
         (size_t)rt * ps + (size_t)rt * D + 3 * (size_t)rt + 2 * (size_t)ps +
         1;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const TP* __restrict__ k_pages,
                       const TP* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ prefix_len,
                       const int* __restrict__ total_len, T* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters,
                       const AttnShape s) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  extern __shared__ float smem[];
  const int tlen = total_len[(blockIdx.x / s.row_tiles) / s.Hkv];
  const Unit u = unit_of(s, tlen);
  if (blockIdx.y > 0 && (int)blockIdx.y >= u.live_splits) return;
  const int b = u.b, h = u.h, G = u.G, r0 = u.r0, nr = u.nr;
  const int D = s.D, ps = s.page_size;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kd = D + 1;

  float* qs = smem;
  float* ks = qs + (size_t)s.row_tile * D;
  float* vs = ks + (size_t)ps * kd;
  float* sc = vs + (size_t)ps * D;
  float* acc = sc + (size_t)s.row_tile * ps;
  float* m_s = acc + (size_t)s.row_tile * D;
  float* l_s = m_s + s.row_tile;
  float* al_s = l_s + s.row_tile;
  float* ksc = al_s + s.row_tile;             // int8 form: the page's row
  float* vsc = ksc + ps;                      // scales of kv-head h
  int* flag = reinterpret_cast<int*>(vsc + ps);

  for (int idx = tid; idx < nr * D; idx += kThreads) {
    const int rr = idx / D, d = idx - rr * D;
    const int r = r0 + rr, si = r / G, g = r - si * G;
    qs[idx] = to_f(q[(((size_t)b * s.S + si) * s.H + h * G + g) * D + d]);
    acc[idx] = 0.f;
  }
  for (int rr = tid; rr < nr; rr += kThreads) {
    m_s[rr] = kNegInf;
    l_s[rr] = 0.f;
  }

  const int plen = prefix_len != nullptr ? prefix_len[b] : tlen - s.S;
  const int p0 = blockIdx.y * s.pps, p1 = min(p0 + s.pps, u.live);
  const size_t row_stride = (size_t)s.Hkv * D;

  // register pipeline: the next page's K and V rows of this kv-head (and,
  // int8 form, their scales) are loaded (16-byte vectors) while the current
  // page is used; rows at or past total_len are never read (zeros below)
  constexpr int kEPV = 16 / sizeof(TP);
  const int dv = D / kEPV;                     // vectors per page row
  uint4 kreg[kPageVecs], vreg[kPageVecs];
  float kscr = 0.f, vscr = 0.f;
  auto fetch = [&](int p) {
    const size_t page = (size_t)block_tables[(size_t)b * s.n_cols + p];
#pragma unroll
    for (int w = 0; w < kPageVecs; ++w) {
      const int v = tid + w * kThreads;
      if (v < ps * dv) {
        const int t = v / dv, c = v - t * dv;
        const size_t o =
            ((page * ps + t) * row_stride + (size_t)h * D) / kEPV + c;
        if (p * ps + t < tlen) {
          kreg[w] = __ldg(reinterpret_cast<const uint4*>(k_pages) + o);
          vreg[w] = __ldg(reinterpret_cast<const uint4*>(v_pages) + o);
        } else {
          kreg[w] = make_uint4(0, 0, 0, 0);
          vreg[w] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    if (kQuant && tid < ps) {
      const size_t so = (page * ps + tid) * s.Hkv + h;
      const bool ok = p * ps + tid < tlen;
      kscr = ok ? __ldg(k_scale + so) : 0.f;
      vscr = ok ? __ldg(v_scale + so) : 0.f;
    }
  };
  if (s.vec && p1 > p0) fetch(p0);

  // logits work split: S lanes share one (row, position) dot over D
  int S = 1;
  while (S < 4 && nr * ps * S * 2 <= kThreads) S *= 2;

  for (int p = p0; p < p1; ++p) {
    __syncthreads();   // previous page's readers are done with ks / vs / sc
    if (s.vec) {
#pragma unroll
      for (int w = 0; w < kPageVecs; ++w) {
        const int v = tid + w * kThreads;
        if (v < ps * dv) {
          const int t = v / dv, c = v - t * dv;
          const TP* ke = reinterpret_cast<const TP*>(&kreg[w]);
          const TP* ve = reinterpret_cast<const TP*>(&vreg[w]);
#pragma unroll
          for (int e = 0; e < kEPV; ++e) {
            ks[t * kd + c * kEPV + e] = to_f(ke[e]);
            vs[t * D + c * kEPV + e] = to_f(ve[e]);
          }
        }
      }
      if (kQuant && tid < ps) {
        ksc[tid] = kscr;
        vsc[tid] = vscr;
      }
    } else {
      const size_t page = (size_t)block_tables[(size_t)b * s.n_cols + p];
      for (int idx = tid; idx < ps * D; idx += kThreads) {
        const int t = idx / D, d = idx - t * D;
        const size_t o = (page * ps + t) * row_stride + (size_t)h * D + d;
        const bool ok = p * ps + t < tlen;
        ks[t * kd + d] = ok ? to_f(k_pages[o]) : 0.f;
        vs[idx] = ok ? to_f(v_pages[o]) : 0.f;
      }
      if (kQuant)
        for (int t = tid; t < ps; t += kThreads) {
          const size_t so = (page * ps + t) * s.Hkv + h;
          const bool ok = p * ps + t < tlen;
          ksc[t] = ok ? k_scale[so] : 0.f;
          vsc[t] = ok ? v_scale[so] : 0.f;
        }
    }
    __syncthreads();
    if (s.vec && p + 1 < p1) fetch(p + 1);

    // masked logits: row rr (query position plen + (r0 + rr) / G) against
    // page position p * ps + t
    for (int base = 0; base < nr * ps * S; base += kThreads) {
      const int v = base + tid;
      const int item = v / S, part = v - item * S;
      const bool valid = item < nr * ps;
      const int rr = valid ? item / ps : 0, t = valid ? item - rr * ps : 0;
      float dot = 0.f;
      if (valid) {
        const float* qr = qs + rr * D;
        const float* kr = ks + t * kd;
        for (int d = part; d < D; d += S) dot = fmaf(qr[d], kr[d], dot);
      }
      for (int o = 1; o < S; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (valid && part == 0) {
        const int qpos = plen + (r0 + rr) / G, pos = p * ps + t;
        if (kQuant) dot *= ksc[t];    // the K scale folds into the column
        sc[item] = (pos <= qpos && pos < tlen) ? dot * s.scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax statistics, one warp per row
    for (int rr = warp; rr < nr; rr += kThreads / 32) {
      float* srow = sc + rr * ps;
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, srow[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float e = expf(srow[t] - m_new);
        srow[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (kQuant)   // V scale into the probability column, after the sum
        for (int t = lane; t < ps; t += 32) srow[t] *= vsc[t];
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[rr] = alpha;
        l_s[rr] = l_s[rr] * alpha + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < nr * D; idx += kThreads) {
      const int rr = idx / D, d = idx - rr * D;
      const float* prow = sc + rr * ps;
      float a = acc[idx] * al_s[rr];
      for (int t = 0; t < ps; ++t) a = fmaf(prow[t], vs[t * D + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  if (D % 4 == 0)
    finish<false, 4>(acc, D, m_s, l_s, out, ws, counters, flag, s, u);
  else
    finish<false, 1>(acc, D, m_s, l_s, out, ws, counters, flag, s, u);
}

template <typename T, typename TP>
int launch(const AttnShape& s, void** args, cudaStream_t stream) {
  const size_t smem = smem_words(s.D, s.page_size, s.row_tile) * 4;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel((const void*)paged_attention_kernel<T, TP>,
                         dim3(s.units, s.splits), dim3(kThreads), args, smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The register pipeline needs 16-byte page rows and pages small enough for
// the per-thread prefetch registers (one scale per thread, int8 form).
int pipelined(const AttnShape& s, int elem, const void* k, const void* v) {
  const int epv = 16 / elem;
  return ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0) &&
         s.D % epv == 0 && s.page_size * s.D / epv <= kPageVecs * kThreads &&
         s.page_size <= kThreads;
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// Tensor-core body: bf16 q over bf16 or int8 pages
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes: the Q tile (RT x D bf16, swizzled); the ring of
// ST stages — bf16 pages: a K and a V tile of 64 swizzled bf16 rows; int8
// pages: 64 rows of K codes, 64 of V codes, 64 K and 64 V scales — and,
// int8, the round's K and V widened to bf16 tiles; after the loop the ring
// holds the warps' (acc, m, l, weight) for the merge; then the split's
// block-table entries and the arrival flag.
template <typename TP, int D, int NSLAB>
struct Layout {
  static constexpr bool Q8 = std::is_same<TP, int8_t>::value;
  static constexpr int RT = 16 * NSLAB;         // query rows of the CTA
  static constexpr int WK = 4 / NSLAB;          // warps sharing one slab
  static constexpr int KEYS = 64;               // keys a round
  static constexpr int KC = KEYS / WK / 16;     // 16-key chunks a warp takes
  // ring stages: 64-96 KB of K/V in flight a CTA, three CTAs an SM up to
  // head_dim 64 (deeper rings, fewer CTAs an SM, were slower on the card)
  static constexpr int ST = D >= 128 ? 3 : 4;
  static constexpr int TILE = KEYS * D * 2;     // one bf16 K or V tile
  static constexpr int STAGE = Q8 ? 2 * KEYS * D + 2 * KEYS * 4 : 2 * TILE;
  static constexpr int LDC = D + 4;             // merge row stride (floats)
  static constexpr int ring = RT * D * 2;
  static constexpr int ring_bytes = ST * STAGE + (Q8 ? 2 * TILE : 0);
  static constexpr int merge_bytes = (WK * RT * LDC + 3 * WK * RT) * 4;
  static constexpr int table =
      ring + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes);
  static constexpr int CTAS = D >= 128 ? 2 : 3;  // for the register budget
};

template <typename TP, int D, int NSLAB>
__global__ void __launch_bounds__(kThreads, (Layout<TP, D, NSLAB>::CTAS))
paged_attention_tc(const bf16* __restrict__ q, const TP* __restrict__ k_pages,
                   const TP* __restrict__ v_pages,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ prefix_len,
                   const int* __restrict__ total_len, bf16* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters,
                   const AttnShape s) {
  using L = Layout<TP, D, NSLAB>;
  constexpr int KS = D / 16;      // k16 steps over D (S = Q·K^T)
  constexpr int ND = D / 8;       // n8 tiles over D (O = P·V)
  constexpr int KEYS = L::KEYS, KC = L::KC;
  constexpr int NK = 2 * KC;      // n8 key tiles a warp takes a round
  constexpr int CPR = D / 8;      // 16-byte bf16 chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  int* bts = reinterpret_cast<int*>(smem + L::table);
  int* flag = bts + s.pps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // prologue: the length and the split's block-table entries together
  const int b_ = (blockIdx.x / s.row_tiles) / s.Hkv;
  const int pg0 = blockIdx.y * s.pps;
  const int bt0 = tid < s.pps && pg0 + tid < s.n_cols
                      ? block_tables[(size_t)b_ * s.n_cols + pg0 + tid] : 0;
  const int tlen = total_len[b_];
  const Unit u = unit_of(s, tlen);
  if (blockIdx.y > 0 && (int)blockIdx.y >= u.live_splits) return;
  const int b = u.b, h = u.h, G = u.G, r0 = u.r0, nr = u.nr;
  if (u.live == 0) {   // nothing cached: exact zeros
    for (int idx = tid; idx < nr * D; idx += kThreads)
      out_row(out, s, u, idx / D)[idx % D] = __float2bfloat16(0.f);
    return;
  }
  if (tid < s.pps) bts[tid] = bt0;
  for (int i = tid + kThreads; i < s.pps; i += kThreads)
    bts[i] = pg0 + i < s.n_cols
                 ? block_tables[(size_t)b * s.n_cols + pg0 + i] : 0;

  // Q rows (rows past the block arrive as zeros)
  for (int e = tid; e < L::RT * CPR; e += kThreads) {
    const int rr = e / CPR, c = e - rr * CPR;
    const bool ok = rr < nr;
    const int r = r0 + (ok ? rr : 0), si = r / G, g = r - si * G;
    cp16(sbase + off<D>(rr, c),
         q + (((size_t)b * s.S + si) * s.H + h * G + g) * D + c * 8, ok);
  }
  cp_commit();
  const int plen = prefix_len != nullptr ? prefix_len[b] : tlen - s.S;
  const int PS = s.page_size;
  const int kbeg = pg0 * PS;                                 // split's keys
  const int kend = min(tlen, min(pg0 + s.pps, u.live) * PS);
  const int n_rounds = (kend - kbeg + KEYS - 1) / KEYS;
  __syncthreads();   // the table entries

  // one round's K and V rows (and int8 scales) into ring stage t % ST
  auto load_round = [&](int t) {
    const uint32_t st = sbase + L::ring + (t % L::ST) * L::STAGE;
    const int k0 = kbeg + t * KEYS;
    auto row_of = [&](int i, bool& ok) -> size_t {
      const int kpos = k0 + i;
      ok = kpos < kend;
      if (!ok) return 0;
      const int lp = kpos / PS;
      return ((size_t)bts[lp - pg0] * PS + (kpos - lp * PS)) * s.Hkv + h;
    };
    if constexpr (!L::Q8) {
      for (int e = tid; e < KEYS * CPR; e += kThreads) {
        const int i = e / CPR, c = e - i * CPR;
        bool ok;
        const size_t row = row_of(i, ok);
        cp16(st + off<D>(i, c), k_pages + row * D + c * 8, ok);
        cp16(st + L::TILE + off<D>(i, c), v_pages + row * D + c * 8, ok);
      }
    } else {
      constexpr int C8 = D / 16;   // 16-byte chunks of an int8 row
      for (int e = tid; e < KEYS * C8; e += kThreads) {
        const int i = e / C8, c = e - i * C8;
        bool ok;
        const size_t row = row_of(i, ok);
        cp16(st + i * D + c * 16, k_pages + row * D + c * 16, ok);
        cp16(st + KEYS * D + i * D + c * 16, v_pages + row * D + c * 16, ok);
      }
      for (int e = tid; e < 2 * KEYS; e += kThreads) {   // K, then V scales
        const int which = e / KEYS, i = e - which * KEYS;
        bool ok;
        const size_t row = row_of(i, ok);
        cp4(st + 2 * KEYS * D + e * 4, (which ? v_scale : k_scale) + row, ok);
      }
    }
  };

  // one commit group per round (empty past the last): rounds 0 .. ST-2 in
  // flight
#pragma unroll
  for (int t = 0; t < L::ST - 1; ++t) {
    if (t < n_rounds) load_round(t);
    cp_commit();
  }
  cp_wait<L::ST - 1>();   // the Q tile
  __syncthreads();

  // warp w: slab w % NSLAB, keys [16·KC·kg, +16·KC) of each round
  const int sl = warp % NSLAB, kg = warp / NSLAB;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], sbase + off<D>(sl * 16 + a_row, 2 * kk + (lane >> 4)));

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8
  const float sl2 = s.scale * kLog2e;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  int qlim[2];   // last key each of the lane's two rows may see
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + sl * 16 + g + 8 * i;
    qlim[i] = min(r < s.S * G ? plen + r / G : kend - 1, kend - 1);
  }
  const int kb = 16 * KC * kg;   // the warp's first key in a round
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_chunk = lane >> 4;

  for (int t = 0; t < n_rounds; ++t) {
    cp_wait<L::ST - 2>();
    __syncthreads();   // round t landed; every warp is done with round t - 1
    if (t + L::ST - 1 < n_rounds) load_round(t + L::ST - 1);
    cp_commit();
    const uint32_t st = sbase + L::ring + (t % L::ST) * L::STAGE;
    uint32_t kt = st, vt = st + L::TILE;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (L::Q8) {
      // widen the round's codes to bf16 tiles (exact: |code| <= 127)
      constexpr int C8 = D / 16;
      kt = sbase + L::ring + L::ST * L::STAGE;
      vt = kt + L::TILE;
      const unsigned char* codes = smem + (st - sbase);
      for (int e = tid; e < 2 * KEYS * C8; e += kThreads) {
        const int which = e / (KEYS * C8), e2 = e - which * KEYS * C8;
        const int i = e2 / C8, c = e2 - i * C8;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            codes + which * KEYS * D + i * D + c * 16);
        const int8_t* cs = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = pack_bf16((float)cs[2 * j], (float)cs[2 * j + 1]);
        const uint32_t dst = (which ? vt : kt) - sbase;
        *reinterpret_cast<uint4*>(smem + dst + off<D>(i, 2 * c)) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(smem + dst + off<D>(i, 2 * c + 1)) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      ksc = reinterpret_cast<const float*>(codes + 2 * KEYS * D);
      vsc = ksc + KEYS;
      __syncthreads();
    }

    // S = Q·K^T over the warp's 16·KC keys
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < KC; ++jp) {
        uint32_t r4[4];
        ldsm_x4(r4, kt + off<D>(kb + jp * 16 + k_row, 2 * kk + k_chunk));
        mma(sc[2 * jp], qf[kk], r4[0], r4[1]);
        mma(sc[2 * jp + 1], qf[kk], r4[2], r4[3]);
      }

    // scale into log2 units (int8: times the column's K scale), mask keys
    // past each row's position, the split's end or total_len
    const int k0 = kbeg + t * KEYS;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kb + j * 8 + c2 + (e & 1);
        float x = sc[j][e] * sl2;
        if constexpr (L::Q8) x *= ksc[kl];
        sc[j][e] = k0 + kl <= qlim[e >> 1] ? x : kNegInf;
      }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    const float mn0 = fmaxf(m[0], quad_max(mx0));
    const float mn1 = fmaxf(m[1], quad_max(mx1));
    const float al0 = ex2(m[0] - mn0), al1 = ex2(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float s0 = 0.f, s1 = 0.f;
    uint32_t pf[KC][4];   // P, as the A fragments of P·V's k16 steps
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      float p0 = ex2(sc[j][0] - mn0), p1 = ex2(sc[j][1] - mn0);
      float p2 = ex2(sc[j][2] - mn1), p3 = ex2(sc[j][3] - mn1);
      s0 += p0 + p1;
      s1 += p2 + p3;
      if constexpr (L::Q8) {   // V scale into P's columns, after the sum
        const int kl = kb + j * 8 + c2;
        p0 *= vsc[kl];
        p1 *= vsc[kl + 1];
        p2 *= vsc[kl];
        p3 *= vsc[kl + 1];
      }
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * al0 + s0;
    l[1] = l[1] * al1 + s1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }

    // O += P·V, each V fragment by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        uint32_t r4[4];
        ldsm_x4_trans(r4, vt + off<D>(kb + kk * 16 + v_row, 2 * jp + v_chunk));
        mma(o[2 * jp], pf[kk], r4[0], r4[1]);
        mma(o[2 * jp + 1], pf[kk], r4[2], r4[3]);
      }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free

  // merge the WK warps of each slab: acc co[kg][row][LDC], m, l, weights
  float* co = reinterpret_cast<float*>(smem + L::ring);
  float* cm = co + L::WK * L::RT * L::LDC;
  float* cl = cm + L::WK * L::RT;
  float* cw = cl + L::WK * L::RT;
  const int rr0 = sl * 16 + g;
  float* c0 = co + ((size_t)kg * L::RT + rr0) * L::LDC;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<float2*>(c0 + j * 8 + c2) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(c0 + 8 * L::LDC + j * 8 + c2) =
        make_float2(o[j][2], o[j][3]);
  }
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  if ((lane & 3) == 0) {
    cm[kg * L::RT + rr0] = m[0];
    cm[kg * L::RT + rr0 + 8] = m[1];
    cl[kg * L::RT + rr0] = l0;
    cl[kg * L::RT + rr0 + 8] = l1;
  }
  __syncthreads();
  for (int rr = tid; rr < L::RT; rr += kThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < L::WK; ++k) mx = fmaxf(mx, cm[k * L::RT + rr]);
    float lsum = 0.f;
#pragma unroll
    for (int k = 0; k < L::WK; ++k) {
      const float mk = cm[k * L::RT + rr];
      const float w = mk <= 0.5f * kNegInf ? 0.f : ex2(mk - mx);
      cw[k * L::RT + rr] = w;
      lsum += w * cl[k * L::RT + rr];
    }
    cm[rr] = mx;
    cl[rr] = lsum;
  }
  __syncthreads();
  for (int idx = tid; idx < L::RT * D; idx += kThreads) {
    const int rr = idx / D, d = idx - rr * D;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < L::WK; ++k)
      a += cw[k * L::RT + rr] * co[((size_t)k * L::RT + rr) * L::LDC + d];
    co[rr * L::LDC + d] = a;
  }
  __syncthreads();
  finish<true, 4>(co, L::LDC, cm, cl, out, ws, counters, flag, s, u);
}

template <typename TP, int D, int NSLAB>
int launch(const AttnShape& s, void** args, cudaStream_t stream) {
  using L = Layout<TP, D, NSLAB>;
  static_assert(L::table + 8 <= kSmemMax, "paged tile does not fit a CTA");
  const size_t smem = L::table + 4 * ((size_t)s.pps + 1);
  if (smem > (size_t)kSmemMax || s.row_tile != L::RT)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_tc<TP, D, NSLAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaError_t err =
      cudaLaunchKernel((const void*)paged_attention_tc<TP, D, NSLAB>,
                       dim3(s.units, s.splits), dim3(kThreads), args, smem,
                       stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TP, int D>
int launch_slabs(const AttnShape& s, void** args, cudaStream_t stream) {
  switch (s.row_tile) {
    case 16: return launch<TP, D, 1>(s, args, stream);
    case 32: return launch<TP, D, 2>(s, args, stream);
    case 64: return launch<TP, D, 4>(s, args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TP>
int launch_d(const AttnShape& s, void** args, cudaStream_t stream) {
  if (s.page_size % 16) return (int)cudaErrorInvalidValue;
  switch (s.D) {
    case 16: return launch_slabs<TP, 16>(s, args, stream);
    case 32: return launch_slabs<TP, 32>(s, args, stream);
    case 64: return launch_slabs<TP, 64>(s, args, stream);
    case 128: return launch_slabs<TP, 128>(s, args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 body: fp32 q over fp32 or int8 pages, on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// One configuration of the body (kernels/paged_decode_attention.py:
// F32_CONFIGS mirrors the table below): RT query rows a CTA, NW warps, WK of
// them over each row's keys (warp w takes keys [w·KW, (w+1)·KW) of every
// round, KW = KEYS / WK; their (m, l, acc) merged in warp order at the end),
// the other NW / WK over the rows; KEYS keys a round; LR x LK lanes of a warp
// over its rows x keys for the logits, the remaining LS = 32 / (LR·LK) lanes
// splitting head_dim (summed by shuffles); ST ring stages; CTAS CTAs an SM
// the register budget is set for.
template <int RT_, int NW_, int WK_, int KEYS_, int LR_, int LK_, int ST_,
          int CTAS_>
struct Cfg {
  static constexpr int RT = RT_, NW = NW_, WK = WK_, KEYS = KEYS_;
  static constexpr int LR = LR_, LK = LK_, ST = ST_, CTAS = CTAS_;
};

template <typename TP, int D, typename C>
struct Layout {
  static constexpr bool Q8 = std::is_same<TP, int8_t>::value;
  static constexpr int RT = C::RT, NW = C::NW, WK = C::WK, KEYS = C::KEYS;
  static constexpr int LR = C::LR, LK = C::LK, ST = C::ST;
  static constexpr int THREADS = NW * 32;
  static constexpr int WR = NW / WK;          // warps over the rows
  static constexpr int RW = RT / WR;          // rows a warp
  static constexpr int KW = KEYS / WK;        // keys a warp takes a round
  static constexpr int LS = 32 / (LR * LK);   // lanes sharing one dot
  static constexpr int TR = RW / LR;          // rows a lane (logits)
  static constexpr int TK = KW / LK;          // keys a lane (logits)
  static constexpr int DC = D / 4;            // float4 chunks of a row
  static constexpr int DCL = DC / LS;         // chunks a lane sums a dot over
  static constexpr int LDK = D + 4;           // Q and K row stride (floats)
  static constexpr int LDP = KW + 4;          // P row stride (floats)
  static constexpr int PD = DC < 32 ? DC : 32;             // P·V lanes over d
  static constexpr int PR = 32 / PD < RW ? 32 / PD : RW;   // ... over rows
  static constexpr int OR = RW / PR;          // rows a lane (P·V)
  static_assert(NW % WK == 0 && RT % WR == 0 && KEYS % WK == 0, "warps");
  static_assert(32 % (LR * LK) == 0 && RW % LR == 0 && KW % LK == 0, "lanes");
  static_assert(DC % LS == 0 && DC <= 32 && KW % 4 == 0 && RW % PR == 0,
                "tile");
  // bytes: the Q tile; a ring stage (fp32: K rows padded to LDK, V rows;
  // int8: the K and V codes, then their KEYS K and KEYS V scales); int8: the
  // round's K and V widened to fp32 tiles; after the loop the ring holds
  // the warps' (acc, m, l, weight) for the merge; then each warp's P tile
  // and its rows' rescale factors, the split's block-table entries and the
  // arrival flag
  static constexpr int QB = RT * LDK * 4;
  static constexpr int KT = KEYS * LDK * 4;
  static constexpr int VT = KEYS * D * 4;
  static constexpr int STAGE = Q8 ? 2 * KEYS * D + 2 * KEYS * 4 : KT + VT;
  static constexpr int RING = ST * STAGE + (Q8 ? KT + VT : 0);
  static constexpr int MERGE = (WK * RT * LDK + 3 * WK * RT) * 4;
  static constexpr int ring = QB;
  static constexpr int pbuf = ring + (RING > MERGE ? RING : MERGE);
  static constexpr int abuf = pbuf + NW * RW * LDP * 4;
  static constexpr int table = abuf + NW * RW * 4;
};

template <typename TP, int D, typename C>
__global__ void __launch_bounds__(C::NW * 32, C::CTAS)
paged_attention_f32(const float* __restrict__ q,
                    const TP* __restrict__ k_pages,
                    const TP* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ prefix_len,
                    const int* __restrict__ total_len,
                    float* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ counters, const AttnShape s) {
  using L = Layout<TP, D, C>;
  constexpr int NT = L::THREADS, KEYS = L::KEYS, DC = L::DC, LDK = L::LDK;
  constexpr int RW = L::RW, KW = L::KW, LS = L::LS, LK = L::LK, LR = L::LR;
  constexpr int TR = L::TR, TK = L::TK, OR = L::OR, PR = L::PR, PD = L::PD;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const float* qs = reinterpret_cast<const float*>(smem);
  int* bts = reinterpret_cast<int*>(smem + L::table);
  int* flag = bts + s.pps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // prologue: the length and the split's block-table entries together
  const int b_ = (blockIdx.x / s.row_tiles) / s.Hkv;
  const int pg0 = blockIdx.y * s.pps;
  const int bt0 = tid < s.pps && pg0 + tid < s.n_cols
                      ? block_tables[(size_t)b_ * s.n_cols + pg0 + tid] : 0;
  const int tlen = total_len[b_];
  const Unit u = unit_of(s, tlen);
  if (blockIdx.y > 0 && (int)blockIdx.y >= u.live_splits) return;
  const int b = u.b, h = u.h, G = u.G, r0 = u.r0, nr = u.nr;
  if (u.live == 0) {   // nothing cached: exact zeros
    for (int idx = tid; idx < nr * D; idx += NT)
      out_row(out, s, u, idx / D)[idx % D] = 0.f;
    return;
  }
  if (tid < s.pps) bts[tid] = bt0;
  for (int i = tid + NT; i < s.pps; i += NT)
    bts[i] = pg0 + i < s.n_cols
                 ? block_tables[(size_t)b * s.n_cols + pg0 + i] : 0;

  // Q rows, padded to LDK (rows past the block arrive as zeros)
  for (int e = tid; e < L::RT * DC; e += NT) {
    const int rr = e / DC, c = e - rr * DC;
    const bool ok = rr < nr;
    const int r = r0 + (ok ? rr : 0), si = r / G, g = r - si * G;
    cp16(sbase + (rr * LDK + 4 * c) * 4,
         q + (((size_t)b * s.S + si) * s.H + h * G + g) * D + 4 * c, ok);
  }
  cp_commit();
  const int plen = prefix_len != nullptr ? prefix_len[b] : tlen - s.S;
  const int PS = s.page_size;
  const int kbeg = pg0 * PS;                                 // split's keys
  const int kend = min(tlen, min(pg0 + s.pps, u.live) * PS);
  const int n_rounds = (kend - kbeg + KEYS - 1) / KEYS;
  __syncthreads();   // the table entries

  // one round's K and V rows (and int8 scales) into ring stage t % ST;
  // positions past the split's end or total_len arrive as zeros
  auto load_round = [&](int t) {
    const uint32_t st = sbase + L::ring + (t % L::ST) * L::STAGE;
    const int k0 = kbeg + t * KEYS;
    auto row_of = [&](int i, bool& ok) -> size_t {
      const int kpos = k0 + i;
      ok = kpos < kend;
      if (!ok) return 0;
      const int lp = kpos / PS;
      return ((size_t)bts[lp - pg0] * PS + (kpos - lp * PS)) * s.Hkv + h;
    };
    if constexpr (!L::Q8) {
      for (int e = tid; e < KEYS * DC; e += NT) {
        const int i = e / DC, c = e - i * DC;
        bool ok;
        const size_t row = row_of(i, ok);
        cp16(st + (i * LDK + 4 * c) * 4, k_pages + row * D + 4 * c, ok);
        cp16(st + L::KT + (i * D + 4 * c) * 4, v_pages + row * D + 4 * c,
             ok);
      }
    } else {
      constexpr int C8 = D / 16;   // 16-byte chunks of an int8 row
      for (int e = tid; e < KEYS * C8; e += NT) {
        const int i = e / C8, c = e - i * C8;
        bool ok;
        const size_t row = row_of(i, ok);
        cp16(st + i * D + c * 16, k_pages + row * D + c * 16, ok);
        cp16(st + KEYS * D + i * D + c * 16, v_pages + row * D + c * 16, ok);
      }
      for (int e = tid; e < 2 * KEYS; e += NT) {   // K, then V scales
        const int which = e / KEYS, i = e - which * KEYS;
        bool ok;
        const size_t row = row_of(i, ok);
        cp4(st + 2 * KEYS * D + e * 4, (which ? v_scale : k_scale) + row, ok);
      }
    }
  };

  // one commit group per round (empty past the last): rounds 0 .. ST-2 in
  // flight; the first wait of the loop also covers the Q tile
#pragma unroll
  for (int t = 0; t < L::ST - 1; ++t) {
    if (t < n_rounds) load_round(t);
    cp_commit();
  }

  // warp (wr, wk): rows [wr·RW, +RW), keys [wk·KW, +KW) of each round.
  // Logits lane (lr, lk, ls): rows lr + i·LR, keys lk + j·LK, the d chunks
  // ls + c·LS. P·V lane (pr, pd): rows pr + i·PR, d chunk pd.
  const int wk = warp % L::WK, wr = warp / L::WK;
  const int ls = lane % LS, lk = (lane / LS) % LK, lr = lane / (LS * LK);
  const int pd = lane % PD, pr = lane / PD;
  const float sl2 = s.scale * kLog2e;
  int qlim[TR];   // last key each of the lane's rows may see
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + wr * RW + lr + i * LR;
    qlim[i] = min(r < s.S * G ? plen + r / G : kend - 1, kend - 1);
  }
  float m[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float4 o[OR];
#pragma unroll
  for (int i = 0; i < OR; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* pw = reinterpret_cast<float*>(smem + L::pbuf) + warp * RW * L::LDP;
  float* aw = reinterpret_cast<float*>(smem + L::abuf) + warp * RW;

  for (int t = 0; t < n_rounds; ++t) {
    cp_wait<L::ST - 2>();
    __syncthreads();   // round t landed; every warp is done with round t - 1
    if (t + L::ST - 1 < n_rounds) load_round(t + L::ST - 1);
    cp_commit();
    const unsigned char* st = smem + L::ring + (t % L::ST) * L::STAGE;
    const float* kt = reinterpret_cast<const float*>(st);
    const float* vt = reinterpret_cast<const float*>(st + L::KT);
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (L::Q8) {
      // widen the round's codes to fp32 tiles (exact)
      constexpr int C8 = D / 16;
      float* kw = reinterpret_cast<float*>(smem + L::ring +
                                           L::ST * L::STAGE);
      float* vw = kw + KEYS * LDK;
      for (int e = tid; e < 2 * KEYS * C8; e += NT) {
        const int which = e / (KEYS * C8), e2 = e - which * KEYS * C8;
        const int i = e2 / C8, c = e2 - i * C8;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            st + which * KEYS * D + i * D + c * 16);
        const int8_t* cs = reinterpret_cast<const int8_t*>(&raw);
        float* dst = (which ? vw + i * D : kw + i * LDK) + c * 16;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(dst + 4 * j) =
              make_float4((float)cs[4 * j], (float)cs[4 * j + 1],
                          (float)cs[4 * j + 2], (float)cs[4 * j + 3]);
      }
      kt = kw;
      vt = vw;
      ksc = reinterpret_cast<const float*>(st + 2 * KEYS * D);
      vsc = ksc + KEYS;
      __syncthreads();
    }

    // S = Q·K^T: the lane's TR x TK dots over its d chunks, 16-byte reads
    float sa[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) sa[i][j] = 0.f;
    const float* qp = qs + (wr * RW + lr) * LDK + 4 * ls;
    const float* kp = kt + (wk * KW + lk) * LDK + 4 * ls;
#pragma unroll
    for (int c = 0; c < L::DCL; ++c) {
      float4 a[TR], bk[TK];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        a[i] = *reinterpret_cast<const float4*>(qp + i * LR * LDK +
                                                4 * LS * c);
#pragma unroll
      for (int j = 0; j < TK; ++j)
        bk[j] = *reinterpret_cast<const float4*>(kp + j * LK * LDK +
                                                 4 * LS * c);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          float x = sa[i][j];
          x = fmaf(a[i].x, bk[j].x, x);
          x = fmaf(a[i].y, bk[j].y, x);
          x = fmaf(a[i].z, bk[j].z, x);
          sa[i][j] = fmaf(a[i].w, bk[j].w, x);
        }
    }
#pragma unroll
    for (int off = 1; off < LS; off <<= 1)
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j)
          sa[i][j] += __shfl_xor_sync(0xffffffffu, sa[i][j], off);

    // scale into log2 units (int8: times the column's K scale), mask keys
    // past each row's position, the split's end or total_len; the online
    // softmax over the lanes that hold a row's keys
    const int k0 = kbeg + t * KEYS;
    float al[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int kl = wk * KW + lk + j * LK;
        float x = sa[i][j] * sl2;
        if constexpr (L::Q8) x *= ksc[kl];
        sa[i][j] = k0 + kl <= qlim[i] ? x : kNegInf;
        mx = fmaxf(mx, sa[i][j]);
      }
#pragma unroll
      for (int off = LS; off < LS * LK; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      al[i] = ex2(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        sa[i][j] = ex2(sa[i][j] - mn);
        sum += sa[i][j];
      }
#pragma unroll
      for (int off = LS; off < LS * LK; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * al[i] + sum;
      if constexpr (L::Q8) {   // V scale into P's columns, after the sum
#pragma unroll
        for (int j = 0; j < TK; ++j) sa[i][j] *= vsc[wk * KW + lk + j * LK];
      }
    }

    // P and the rows' rescale factors through the warp's own buffer
    if (ls == 0) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < TK; ++j)
          pw[(lr + i * LR) * L::LDP + lk + j * LK] = sa[i][j];
        if (lk == 0) aw[lr + i * LR] = al[i];
      }
    }
    __syncwarp();

    // O += P·V: the lane's OR rows x 4 d, over the warp's KW keys
    if (pr < PR) {
#pragma unroll
      for (int i = 0; i < OR; ++i) {
        const float a = aw[pr + i * PR];
        o[i].x *= a;
        o[i].y *= a;
        o[i].z *= a;
        o[i].w *= a;
      }
      const float* vp = vt + (size_t)wk * KW * D + 4 * pd;
#pragma unroll 2
      for (int k = 0; k < KW; k += 4) {
        float4 p4[OR];
#pragma unroll
        for (int i = 0; i < OR; ++i)
          p4[i] = *reinterpret_cast<const float4*>(
              pw + (pr + i * PR) * L::LDP + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = *reinterpret_cast<const float4*>(vp + (k + kk) * D);
#pragma unroll
          for (int i = 0; i < OR; ++i) {
            const float p = kk == 0 ? p4[i].x : kk == 1 ? p4[i].y
                          : kk == 2 ? p4[i].z : p4[i].w;
            o[i].x = fmaf(p, v.x, o[i].x);
            o[i].y = fmaf(p, v.y, o[i].y);
            o[i].z = fmaf(p, v.z, o[i].z);
            o[i].w = fmaf(p, v.w, o[i].w);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free

  // the warps' (acc, m, l): co[wk][row][LDK], cm[wk][row], cl[wk][row]
  float* co = reinterpret_cast<float*>(smem + L::ring);
  float* cm = co + L::WK * L::RT * LDK;
  float* cl = cm + L::WK * L::RT;
  float* cw = cl + L::WK * L::RT;
  if (pr < PR) {
#pragma unroll
    for (int i = 0; i < OR; ++i)
      *reinterpret_cast<float4*>(
          co + ((size_t)wk * L::RT + wr * RW + pr + i * PR) * LDK + 4 * pd) =
          o[i];
  }
  if (ls == 0 && lk == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      cm[wk * L::RT + wr * RW + lr + i * LR] = m[i];
      cl[wk * L::RT + wr * RW + lr + i * LR] = l[i];
    }
  }
  __syncthreads();
  if constexpr (L::WK > 1) {   // merge the key warps, in warp order
    for (int rr = tid; rr < L::RT; rr += NT) {
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < L::WK; ++k) mx = fmaxf(mx, cm[k * L::RT + rr]);
      float lsum = 0.f;
#pragma unroll
      for (int k = 0; k < L::WK; ++k) {
        const float mk = cm[k * L::RT + rr];
        const float w = mk <= 0.5f * kNegInf ? 0.f : ex2(mk - mx);
        cw[k * L::RT + rr] = w;
        lsum += w * cl[k * L::RT + rr];
      }
      cm[rr] = mx;
      cl[rr] = lsum;
    }
    __syncthreads();
    for (int idx = tid; idx < L::RT * D; idx += NT) {
      const int rr = idx / D, d = idx - rr * D;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < L::WK; ++k)
        a += cw[k * L::RT + rr] * co[((size_t)k * L::RT + rr) * LDK + d];
      co[rr * LDK + d] = a;
    }
    __syncthreads();
  }
  finish<true, 4, NT>(co, LDK, cm, cl, out, ws, counters, flag, s, u);
}

template <typename TP, int D, typename C>
int launch(const AttnShape& s, int keys, int stages, int warps,
           int smem_bytes, void** args, cudaStream_t stream) {
  using L = Layout<TP, D, C>;
  static_assert(L::table + 8 <= kSmemMax, "fp32 paged tile does not fit");
  const size_t smem = L::table + 4 * ((size_t)s.pps + 1);
  // the plan's shared memory must be this configuration's
  if (smem > (size_t)kSmemMax || (size_t)smem_bytes != smem) return -1;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_f32<TP, D, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaError_t err =
      cudaLaunchKernel((const void*)paged_attention_f32<TP, D, C>,
                       dim3(s.units, s.splits), dim3(C::NW * 32), args, smem,
                       stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The configurations, by the plan's row tile: decode (G rows of one
// kv-head, up to 4: the 4 warps split each round's 32 keys), verify and
// short suffixes (up to 16 rows: a warp each 4 rows over all 32 keys), and
// prefill-append (64 rows: 8 warps of 8 rows over 32 keys a round, two
// lanes a dot, two CTAs an SM at head_dim 128); every lane 4 x 4 logits
// but decode's (4 x 1: the warps split the keys)
using Decode = Cfg<4, 4, 4, 32, 1, 8, 3, 2>;
using Short = Cfg<16, 4, 1, 32, 1, 8, 3, 2>;
using Rows = Cfg<64, 8, 1, 32, 2, 8, 2, 2>;

// the configuration whose (row tile, keys, stages, warps) the plan names
template <typename TP, int D, typename C, typename... More>
int launch_any(const AttnShape& s, int keys, int stages, int warps,
               int smem_bytes, void** args, cudaStream_t stream) {
  if (s.row_tile == C::RT && keys == C::KEYS && stages == C::ST &&
      warps == C::NW)
    return launch<TP, D, C>(s, keys, stages, warps, smem_bytes, args,
                            stream);
  if constexpr (sizeof...(More) > 0)
    return launch_any<TP, D, More...>(s, keys, stages, warps, smem_bytes,
                                      args, stream);
  else
    return -1;
}

template <typename TP, int D>
int launch_rows(const AttnShape& s, int keys, int stages, int warps,
                int smem_bytes, void** args, cudaStream_t stream) {
  return launch_any<TP, D, Decode, Short, Rows>(s, keys, stages, warps,
                                                smem_bytes, args, stream);
}

template <typename TP>
int launch_d(const AttnShape& s, int keys, int stages, int warps,
             int smem_bytes, void** args, cudaStream_t stream) {
  switch (s.D) {
    case 16: return launch_rows<TP, 16>(s, keys, stages, warps, smem_bytes,
                                        args, stream);
    case 32: return launch_rows<TP, 32>(s, keys, stages, warps, smem_bytes,
                                        args, stream);
    case 64: return launch_rows<TP, 64>(s, keys, stages, warps, smem_bytes,
                                        args, stream);
    case 128: return launch_rows<TP, 128>(s, keys, stages, warps, smem_bytes,
                                          args, stream);
    default: return -1;
  }
}

}  // namespace f32

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out share it). int8_pages = 0:
// pages in q's dtype, scales unused; 1: int8 pages with (n_pages,
// page_size, Hkv) fp32 k_scale / v_scale pools. body: 0 the CUDA-core
// body; 1 the tensor-core body (bf16 q, head_dim 16/32/64/128, page_size a
// multiple of 16, row_tile 16/32/64); 2 the fp32 body (fp32 q, head_dim
// 16/32/64/128, row_tile 4/16/64, with the plan's keys a round, ring
// stages, warps and shared-memory bytes, which must be the configuration's:
// else -1). The plan (row_tile, row_tiles, pages_per_split, splits) is
// kernels/paged_decode_attention.py:launch_plan; with splits > 1, ws holds
// units·splits·row_tile·(D + 2) floats and counters units zeroed ints (the
// last split of a unit puts its counter back to 0). prefix_len may be null:
// each slot's S rows are then its last S positions (prefix_len = total_len
// - S; decode, with no kernel launched to form it).
int paged_attention_launch(int dtype, int int8_pages, int body,
                           const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scale,
                           const float* v_scale, const int* block_tables,
                           const int* prefix_len, const int* total_len,
                           void* out, float* ws, int* counters, int B, int S,
                           int H, int Hkv, int D, int page_size, int n_cols,
                           int row_tile, int row_tiles, int pps, int splits,
                           int keys, int stages, int warps, int smem_bytes,
                           float scale, void* stream) {
  AttnShape s;
  s.B = B; s.S = S; s.H = H; s.Hkv = Hkv; s.D = D; s.page_size = page_size;
  s.n_cols = n_cols; s.row_tile = row_tile; s.row_tiles = row_tiles;
  s.units = B * Hkv * row_tiles; s.pps = pps; s.splits = splits;
  s.scale = scale; s.vec = 0;
  if (pps < 1 || splits < 1 || splits > 65535 || row_tile < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&q, (void*)&k_pages, (void*)&v_pages,
                  (void*)&k_scale, (void*)&v_scale, (void*)&block_tables,
                  (void*)&prefix_len, (void*)&total_len, (void*)&out,
                  (void*)&ws, (void*)&counters, (void*)&s};
  cudaStream_t st = (cudaStream_t)stream;
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return int8_pages ? tc::launch_d<int8_t>(s, args, st)
                      : tc::launch_d<__nv_bfloat16>(s, args, st);
  }
  if (body == 2) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    return int8_pages
               ? f32::launch_d<int8_t>(s, keys, stages, warps, smem_bytes,
                                       args, st)
               : f32::launch_d<float>(s, keys, stages, warps, smem_bytes,
                                      args, st);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  s.vec = cuda_core::pipelined(s, int8_pages ? 1 : (dtype == 0 ? 4 : 2),
                               k_pages, v_pages);
  if (dtype == 0 && !int8_pages)
    return cuda_core::launch<float, float>(s, args, st);
  if (dtype == 1 && !int8_pages)
    return cuda_core::launch<__nv_bfloat16, __nv_bfloat16>(s, args, st);
  if (dtype == 0 && int8_pages)
    return cuda_core::launch<float, int8_t>(s, args, st);
  if (dtype == 1 && int8_pages)
    return cuda_core::launch<__nv_bfloat16, int8_t>(s, args, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

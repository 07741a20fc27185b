// BCR block-sparse matmul over TBCRC-packed weights, written for Hopper
// (sm_90a), bound to Python through ctypes (kernels/bcr_spmm.py).
//
// Replaces the reference package's TPU kernels in kernels/bcr_spmm.py:
//   * bcr_spmm          (bodies _kernel_idx, _block_update)
//   * bcr_spmm_grouped  (bodies _grouped_kernel_idx, _grouped_emit)
//
// What it computes: y[M, N] = x[M, K] @ W.T for a balanced-BCR weight W
// (N, K) cut into (br, bc) blocks, each of which keeps R_keep whole rows and
// C_keep whole columns stored as a dense (R_keep, C_keep) tile plus the
// block-local row/col indices. The grouped form runs G same-shaped weights
// over one x, adds a (G, N) fp32 bias, and either emits (G, M, N) or, for a
// gate/up pair, silu(acc0) * acc1 as (M, N). Tiles come in x's dtype (the
// fp form) or as int8 codes with one fp32 scale per kept tile (the int8
// form, the reference's quantized serving: plan.block_scales), whose scale
// multiplies the block's fp32 partial, as the reference's _block_update
// does.
//
// Two bodies, chosen by x's dtype.
//
// bf16 x (the serving path; fp and int8 tiles) — namespace tc, tensor
// cores. What bounds it on this card: at decode (M = 1..8) the bytes of the
// packed tiles (keep_frac of the dense weight, read once; half as many
// under int8) and, at 1 to 16 contraction blocks a CTA, the latency of
// each block's short chain of copies and shared-memory steps; at prefill
// (M in the thousands) the shared-memory pipe, which every block's x
// staging, column gather and operand reads go through, ahead of the
// tensor cores. What the design does:
//   * y^T = W_tile · x_g^T per block, the weight as the wide operand: the
//     output rows are the MMA's M side and the M tile its N side, so one
//     form serves M = 1 and M = 4096. M tiles of 8..64 (decode, short
//     prefill) run mma.sync.aligned.m16n8k16 bf16 → fp32 with both operands
//     by ldmatrix; the 128-row M tile (prefill) runs wgmma.mma_async
//     m64n128k16 with A (the weight rows) in registers by ldmatrix and B
//     (the gathered x, K-major, 128-byte swizzled) read by descriptor, its
//     products overlapping the preparation of the next block. int8 codes
//     are widened in shared memory with their tile's scale folded in,
//     bf16(code × scale): one rounding of at most 2^-9 relative per weight,
//     against the 2e-2 × output-scale tolerance. (The reference scales each
//     block's fp32 partial; a temporary accumulator per block in that order
//     doubled the accumulator registers, spilled at the 128-column tile and
//     cost more per block than the widening pass.)
//   * The row scatter costs no barrier: the whole (rows × M tile) fp32
//     accumulator stays in registers, and each output row's A operand is
//     read, by ldmatrix's per-lane row addresses, from the staged tile row
//     its block keeps there, or from a zero row. An inverse row map
//     (output row → kept row), tagged with the block's number so stale
//     entries read as "not kept", is rebuilt per block from row_idx. Rows
//     no index reaches are exact zeros. This does br/R_keep = 2× the kept
//     MMA work at the serving block.
//   * Copies are asynchronous, into a ring of 3 to 8 stages with one
//     mbarrier each: a producer warp's lane issues per block one TMA copy
//     of the x block (rows past M arrive as zeros), one TMA copy per bf16
//     tile (rows 128-byte swizzled when C_keep = 64, so ldmatrix reads
//     them without bank conflicts) or one bulk copy per int8 tile (never
//     widened in device memory), and bulk copies of the indices. One block
//     barrier per contraction block separates the preparation of block j+1
//     (inverse map, x's kept columns gathered into B's layout, int8
//     widening; double-buffered) from the products of block j. Operands
//     the copies cannot take (rows that are not 16-byte multiples: kept
//     counts of 1..16 at smoke sizes) take plain loads through the same
//     ring.
//   * At small M a grid of (block rows × M tiles) leaves most SMs idle, so
//     where the output tiles number at most half the SMs the contraction
//     blocks of each tile are split over S CTAs of the same launch. Each
//     writes its fp32 partial to a workspace and bumps the tile's counter;
//     the last to arrive sums the S partials in split order (so y does not
//     depend on arrival order), applies bias and SwiGLU, writes y and puts
//     the counter back to 0. No second kernel, no atomics on y.
//   * The M tile, the warp layout, the output rows per CTA, S and the ring
//     depth come from kernels/bcr_spmm.py:launch_plan; the launcher checks
//     the plan's shared-memory total against its own layout and encodes
//     the tensor maps.
//
// fp32 x (fp32 tiles, or int8 tiles under fp32 x; only the cross-package
// fp32 configurations, never the bf16 serving path) — namespace cuda_core,
// unchanged from the first port: its 1e-4 tolerance rules out bf16 or TF32
// operands, so it multiplies on the CUDA cores. One CTA owns one output
// block row and one M tile and walks the contraction blocks itself, JB at a
// time, staging tiles (widened to fp32), x columns and indices in shared
// memory through a two-stage register prefetch; a gather pass makes each
// member's kept x columns a dense tile; each block's partial is added into
// an fp32 shared accumulator at its kept rows, with a barrier between
// blocks. Bounded by fp32 FMA throughput at large M and by grid under-fill
// (nb_r × M tiles CTAs) at small M.

#include <string.h>

#include "hopper.cuh"

#include <type_traits>

namespace cuda_core {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;   // M rows one work item accumulates
constexpr int kTileVecs = 8;        // 16-byte tile vectors a thread prefetches
constexpr int kXVecs = 4;           // 16-byte x vectors a thread prefetches
constexpr int kIdx = 2;             // indices a thread prefetches
constexpr int kMaxJB = 4;           // contraction blocks per phase
constexpr size_t kSmemLimit = 200 * 1024;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return (float)v;
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

struct SpmmShape {
  int M, K, N, G, nb_r, nb_c, br, bc, R, C, m_tile;
  int jb;    // contraction blocks staged per phase (divides nb_c)
  int vec;   // 1: register-pipelined 16-byte loads; 0: plain loads
};

// Row stride, in floats, of the kept tiles and gathered x tiles: a whole
// number of float4s, odd, so 8 lanes reading float4s of 8 rows hit 8
// distinct bank quads.
__host__ __device__ inline int padded_c(int C) {
  int cp = (C + 3) / 4 * 4;
  if ((cp / 4) % 2 == 0) cp += 4;
  return cp;
}

// Shared-memory layout, in 4-byte words, float4-aligned parts first: kept
// tiles, gathered x tiles, accumulator, raw x columns, indices, tile scales.
__host__ __device__ inline size_t smem_words(const SpmmShape& s) {
  const size_t cp = padded_c(s.C);
  return (size_t)s.jb * s.G * s.R * cp + (size_t)s.jb * s.G * s.m_tile * cp +
         (size_t)s.G * s.m_tile * s.br +
         (size_t)s.m_tile * (s.jb * s.bc + 1) +
         (size_t)s.jb * s.G * (s.C + s.R) + (size_t)s.jb * s.G;
}

struct Stage {   // one phase's loads, held in registers between phases
  uint4 tile[kTileVecs];
  uint4 x[kXVecs];
  int idx[kIdx];
  float sc;      // int8 form: one tile scale (thread g·jb + jj)
};

// Index of member g's tile (i, j) in vals' leading (G, nb_r, nb_c) grid,
// which block_scales shares.
__device__ __forceinline__ size_t tile_id(const SpmmShape& s, int g, int i,
                                          int j) {
  return ((size_t)g * s.nb_r + i) * s.nb_c + j;
}

// Loads of phase j0 .. j0+jb-1. For member g the jb tiles (and index rows)
// of block-row i are contiguous in memory, as are the x columns of a row.
template <typename T, typename TW>
__device__ __forceinline__ void prefetch(Stage& st, const T* __restrict__ x,
                                         const TW* __restrict__ vals,
                                         const float* __restrict__ scales,
                                         const int* __restrict__ row_idx,
                                         const int* __restrict__ col_idx,
                                         const SpmmShape& s, int i, int j0,
                                         int m0, int mt) {
  const int tid = threadIdx.x;
  constexpr int kEPV = 16 / sizeof(T);           // x elements per vector
  constexpr int kEPW = 16 / sizeof(TW);          // tile elements per vector
  const int per_g = s.jb * s.R * s.C / kEPW;     // vectors per member
#pragma unroll
  for (int u = 0; u < kTileVecs; ++u) {
    const int v = tid + u * kThreads;
    if (v < s.G * per_g) {
      const int g = v / per_g, w = v - g * per_g;
      const TW* base = vals + tile_id(s, g, i, j0) * (size_t)(s.R * s.C);
      st.tile[u] = __ldg(reinterpret_cast<const uint4*>(base) + w);
    }
  }
  if (std::is_same<TW, int8_t>::value && tid < s.jb * s.G)
    st.sc = __ldg(scales + tile_id(s, tid / s.jb, i, j0 + tid % s.jb));
  const int xr = s.jb * s.bc / kEPV;             // vectors per x row
#pragma unroll
  for (int u = 0; u < kXVecs; ++u) {
    const int v = tid + u * kThreads;
    if (v < s.m_tile * xr) {
      const int m = v / xr, w = v - m * xr;
      st.x[u] = m < mt ? __ldg(reinterpret_cast<const uint4*>(
                             x + (size_t)(m0 + m) * s.K + (size_t)j0 * s.bc) + w)
                       : make_uint4(0, 0, 0, 0);
    }
  }
  const int nc = s.jb * s.C, nr = s.jb * s.R;
#pragma unroll
  for (int u = 0; u < kIdx; ++u) {
    const int e = tid + u * kThreads;
    if (e < s.G * nc) {
      const int g = e / nc, off = e - g * nc;
      st.idx[u] = __ldg(col_idx + (((size_t)g * s.nb_r + i) * s.nb_c + j0) * s.C + off);
    } else if (e < s.G * (nc + nr)) {
      const int f = e - s.G * nc;
      const int g = f / nr, off = f - g * nr;
      st.idx[u] = __ldg(row_idx + (((size_t)g * s.nb_r + i) * s.nb_c + j0) * s.R + off);
    }
  }
}

// Registers → shared memory: kept tile rows at ((jj·G + g)·R + r)·Cp, raw x
// columns at m·(jb·bc + 1), indices as loaded (cols, then rows), tile
// scales at g·jb + jj.
template <typename T, typename TW>
__device__ __forceinline__ void commit(const Stage& st, float* xs,
                                       float* ws, int* idx, float* bsc,
                                       const SpmmShape& s, int cp) {
  const int tid = threadIdx.x;
  constexpr int kEPV = 16 / sizeof(T);
  constexpr int kEPW = 16 / sizeof(TW);
  const int vpt = s.R * s.C / kEPW, per_g = s.jb * vpt;
#pragma unroll
  for (int u = 0; u < kTileVecs; ++u) {
    const int v = tid + u * kThreads;
    if (v < s.G * per_g) {
      const int g = v / per_g, v2 = v - g * per_g;
      const int jj = v2 / vpt, w = v2 - jj * vpt;
      const int e0 = w * kEPW;                     // C_keep % kEPW == 0:
      const int r = e0 / s.C, c0 = e0 - r * s.C;   // a vector is in one row
      float* dst = ws + ((jj * s.G + g) * s.R + r) * cp + c0;
      const TW* e = reinterpret_cast<const TW*>(&st.tile[u]);
#pragma unroll
      for (int q = 0; q < kEPW; ++q) dst[q] = to_f(e[q]);
    }
  }
  if (std::is_same<TW, int8_t>::value && tid < s.jb * s.G) bsc[tid] = st.sc;
  const int xr = s.jb * s.bc / kEPV;
#pragma unroll
  for (int u = 0; u < kXVecs; ++u) {
    const int v = tid + u * kThreads;
    if (v < s.m_tile * xr) {
      const int m = v / xr, w = v - m * xr;
      float* dst = xs + m * (s.jb * s.bc + 1) + w * kEPV;
      const T* e = reinterpret_cast<const T*>(&st.x[u]);
#pragma unroll
      for (int q = 0; q < kEPV; ++q) dst[q] = to_f(e[q]);
    }
  }
#pragma unroll
  for (int u = 0; u < kIdx; ++u) {
    const int e = tid + u * kThreads;
    if (e < s.jb * s.G * (s.C + s.R)) idx[e] = st.idx[u];
  }
}

// Plain loads straight into shared memory (one block per phase), for shapes
// the register pipeline skips.
template <typename T, typename TW>
__device__ void load_plain(const T* __restrict__ x, const TW* __restrict__ vals,
                           const float* __restrict__ scales,
                           const int* __restrict__ row_idx,
                           const int* __restrict__ col_idx, float* xs,
                           float* ws, int* idx, float* bsc, const SpmmShape& s,
                           int cp, int i, int j, int m0, int mt) {
  const int tid = threadIdx.x;
  for (int v = tid; v < s.m_tile * s.bc; v += kThreads) {
    const int m = v / s.bc, c = v - m * s.bc;
    xs[m * (s.bc + 1) + c] =
        m < mt ? to_f(x[(size_t)(m0 + m) * s.K + (size_t)j * s.bc + c]) : 0.f;
  }
  const int tile = s.R * s.C;
  for (int v = tid; v < s.G * tile; v += kThreads) {
    const int g = v / tile, rc = v - g * tile;
    const int r = rc / s.C, c = rc - r * s.C;
    ws[(g * s.R + r) * cp + c] = to_f(vals[tile_id(s, g, i, j) * tile + rc]);
  }
  if (std::is_same<TW, int8_t>::value)
    for (int g = tid; g < s.G; g += kThreads)
      bsc[g] = scales[tile_id(s, g, i, j)];
  for (int e = tid; e < s.G * (s.C + s.R); e += kThreads) {
    if (e < s.G * s.C) {
      const int g = e / s.C, c = e - g * s.C;
      idx[e] = col_idx[(((size_t)g * s.nb_r + i) * s.nb_c + j) * s.C + c];
    } else {
      const int f = e - s.G * s.C;
      const int g = f / s.R, r = f - g * s.R;
      idx[e] = row_idx[(((size_t)g * s.nb_r + i) * s.nb_c + j) * s.R + r];
    }
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T, typename TW, bool SWIGLU>
__device__ void spmm_body(const T* __restrict__ x, const TW* __restrict__ vals,
                          const float* __restrict__ scales,
                          const int* __restrict__ row_idx,
                          const int* __restrict__ col_idx,
                          const float* __restrict__ bias, T* __restrict__ y,
                          const SpmmShape s) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.x;
  const int m0 = blockIdx.y * s.m_tile;
  const int mt = min(s.m_tile, s.M - m0);
  const int tid = threadIdx.x;
  const int cp = padded_c(s.C);
  const int GR = s.G * s.R;
  const int xs_stride = s.jb * s.bc + 1;

  float* ws = smem;                                        // kept tiles
  float* xg = ws + (size_t)s.jb * GR * cp;                 // gathered x
  float* acc = xg + (size_t)s.jb * s.G * s.m_tile * cp;
  float* xs = acc + (size_t)s.G * s.m_tile * s.br;         // raw x columns
  int* cols = reinterpret_cast<int*>(xs + (size_t)s.m_tile * xs_stride);
  int* rows = cols + s.jb * s.G * s.C;
  float* bsc = reinterpret_cast<float*>(rows + s.jb * s.G * s.R);

  for (int v = tid; v < s.G * s.m_tile * s.br; v += kThreads) acc[v] = 0.f;
  // the pad columns C..cp of the tile and gathered rows stay zero: the
  // float4 product loop reads them
  const int npad = cp - s.C;
  const int nrows = s.jb * (GR + s.G * s.m_tile);
  for (int v = tid; v < nrows * npad; v += kThreads) {
    const int row = v / npad;
    ws[row * cp + s.C + (v - row * npad)] = 0.f;
  }

  // work split: items = (member row gr, group of kRowsPerThread M rows);
  // S lanes share one item's sum over the C_keep float4 chunks
  const int nq = (s.C + 3) / 4;
  const int mq = (mt + kRowsPerThread - 1) / kRowsPerThread;
  const int items = GR * mq;
  int S = 1;
  while (S < 4 && items * S * 2 <= kThreads && S * 2 <= nq) S *= 2;

  Stage st;
  const int n_phase = s.nb_c / s.jb;
  if (s.vec) prefetch(st, x, vals, scales, row_idx, col_idx, s, i, 0, m0, mt);
  for (int ph = 0; ph < n_phase; ++ph) {
    const int j0 = ph * s.jb;
    if (s.vec) {
      commit<T, TW>(st, xs, ws, cols, bsc, s, cp);
    } else {
      load_plain(x, vals, scales, row_idx, col_idx, xs, ws, cols, bsc, s, cp,
                 i, j0, m0, mt);
    }
    __syncthreads();
    if (s.vec && ph + 1 < n_phase)   // in flight while this phase multiplies
      prefetch(st, x, vals, scales, row_idx, col_idx, s, i, j0 + s.jb, m0,
               mt);

    // gather each member's kept x columns into dense (M_t, C_keep) tiles
    const int ng = s.jb * s.G * s.m_tile * s.C;
    for (int v = tid; v < ng; v += kThreads) {
      const int c = v % s.C;
      int t = v / s.C;
      const int m = t % s.m_tile;
      t /= s.m_tile;                                   // t = jj·G + g
      const int g = t % s.G, jj = t / s.G;
      xg[(t * s.m_tile + m) * cp + c] =
          xs[m * xs_stride + jj * s.bc + cols[(g * s.jb + jj) * s.C + c]];
    }
    __syncthreads();

    for (int jj = 0; jj < s.jb; ++jj) {
      for (int base = 0; base < items * S; base += kThreads) {
        const int v = base + tid;
        const int item = v / S, part = v - item * S;
        float a[kRowsPerThread];
#pragma unroll
        for (int u = 0; u < kRowsPerThread; ++u) a[u] = 0.f;
        const bool valid = item < items;
        int gr = 0, ma = 0;
        if (valid) {
          gr = item % GR;
          ma = (item / GR) * kRowsPerThread;
          const int g = gr / s.R;
          const float4* wrow = reinterpret_cast<const float4*>(
              ws + (size_t)(jj * GR + gr) * cp);
          const float* xt = xg + (size_t)((jj * s.G + g) * s.m_tile) * cp;
          for (int q = part; q < nq; q += S) {
            const float4 w = wrow[q];
#pragma unroll
            for (int u = 0; u < kRowsPerThread; ++u) {
              // rows past m_tile would read outside the tile: clamp the
              // address, the product is dropped below
              const int m = min(ma + u, s.m_tile - 1);
              a[u] += dot4(w, reinterpret_cast<const float4*>(
                                  xt + (size_t)m * cp)[q]);
            }
          }
        }
        for (int o = 1; o < S; o <<= 1) {
#pragma unroll
          for (int u = 0; u < kRowsPerThread; ++u)
            a[u] += __shfl_xor_sync(0xffffffffu, a[u], o);
        }
        if (valid && part == 0) {
          const int g = gr / s.R, r = gr - g * s.R;
          float* ac = acc + ((size_t)g * s.m_tile) * s.br +
                      rows[(g * s.jb + jj) * s.R + r];
          if (std::is_same<TW, int8_t>::value) {
            // int8 tile: its scale multiplies the fp32 partial before the
            // scatter-add (the reference's _block_update)
            const float sc = bsc[g * s.jb + jj];
#pragma unroll
            for (int u = 0; u < kRowsPerThread; ++u) a[u] *= sc;
          }
#pragma unroll
          for (int u = 0; u < kRowsPerThread; ++u)
            if (ma + u < mt) ac[(ma + u) * s.br] += a[u];
        }
      }
      // the next block's kept rows may coincide with this one's; after the
      // last block, the next phase's commit overwrites the staged data
      __syncthreads();
    }
  }

  // emit: fp32 accumulator (+ bias) → x's dtype, each output element once
  const int n0 = i * s.br;
  if (SWIGLU) {
    for (int v = tid; v < mt * s.br; v += kThreads) {
      const int m = v / s.br, n = v - m * s.br;
      float gate = acc[m * s.br + n];
      float up = acc[((size_t)s.m_tile + m) * s.br + n];
      if (bias != nullptr) {
        gate += bias[n0 + n];
        up += bias[(size_t)s.N + n0 + n];
      }
      const float silu = gate / (1.f + expf(-gate));
      y[(size_t)(m0 + m) * s.N + n0 + n] = from_f<T>(silu * up);
    }
  } else {
    for (int v = tid; v < s.G * mt * s.br; v += kThreads) {
      const int g = v / (mt * s.br);
      const int rem = v - g * mt * s.br;
      const int m = rem / s.br, n = rem - m * s.br;
      float val = acc[((size_t)g * s.m_tile + m) * s.br + n];
      if (bias != nullptr) val += bias[(size_t)g * s.N + n0 + n];
      y[((size_t)g * s.M + m0 + m) * s.N + n0 + n] = from_f<T>(val);
    }
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
bcr_spmm_kernel(const T* x, const TW* vals, const float* scales,
                const int* row_idx, const int* col_idx, T* y, SpmmShape s) {
  spmm_body<T, TW, false>(x, vals, scales, row_idx, col_idx, nullptr, y, s);
}


template <typename T, typename TW, bool SWIGLU>
__global__ void __launch_bounds__(kThreads)
bcr_spmm_grouped_kernel(const T* x, const TW* vals, const float* scales,
                        const int* row_idx, const int* col_idx,
                        const float* bias, T* y, SpmmShape s) {
  spmm_body<T, TW, SWIGLU>(x, vals, scales, row_idx, col_idx, bias, y, s);
}

// Blocks per phase: the register pipeline needs 16-byte rows (a vector
// never straddles a kept row) and a phase small enough for the per-thread
// prefetch registers and for shared memory; else one block, plain loads.
void plan_phases(SpmmShape& s, int elem_x, int elem_w, const void* x,
                 const void* vals) {
  const int epv = 16 / elem_x, epw = 16 / elem_w;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)vals % 16 == 0);
  s.vec = 0;
  s.jb = 1;
  if (!(aligned && s.C % epw == 0 && s.bc % epv == 0 && s.K % epv == 0))
    return;
  for (int jb = kMaxJB; jb >= 1; jb /= 2) {
    SpmmShape t = s;
    t.jb = jb;
    if (s.nb_c % jb == 0 &&
        s.G * jb * s.R * s.C / epw <= kTileVecs * kThreads &&
        s.m_tile * jb * s.bc / epv <= kXVecs * kThreads &&
        s.G * jb * (s.C + s.R) <= kIdx * kThreads && s.G * jb <= kThreads &&
        smem_words(t) * 4 <= kSmemLimit) {
      s.vec = 1;
      s.jb = jb;
      return;
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, const SpmmShape& s, cudaStream_t stream,
           void** args) {
  const size_t smem = smem_words(s) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s.nb_r, (s.M + s.m_tile - 1) / s.m_tile);
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(kThreads), args,
                         smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

SpmmShape make_shape(int M, int K, int N, int G, int nb_r, int nb_c, int br,
                     int bc, int R, int C, int m_tile) {
  SpmmShape s;
  s.M = M; s.K = K; s.N = N; s.G = G; s.nb_r = nb_r; s.nb_c = nb_c;
  s.br = br; s.bc = bc; s.R = R; s.C = C; s.m_tile = m_tile;
  s.jb = 1; s.vec = 0;
  return s;
}

// Rows of x per CTA: the whole (4-aligned) M at decode sizes, else 32,
// halved until the CTA's shared memory fits.
int m_tile_for(SpmmShape s) {
  s.m_tile = s.M <= 16 ? (s.M + 3) / 4 * 4 : 32;
  if (s.m_tile < 4) s.m_tile = 4;
  while (smem_words(s) * 4 > kSmemLimit) {
    if (s.m_tile == 4) return 0;
    s.m_tile /= 2;
  }
  return s.m_tile;
}

}  // namespace cuda_core

// ===========================================================================
// bf16-activation forms: tensor cores
// ===========================================================================

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTagShift = 12;   // inverse row map entry: (block << 12) | row

// The launch plan kernels/bcr_spmm.py:launch_plan chose, in the order of its
// LaunchPlan.args().
struct Plan {
  int mt, slabs, warps_m, n_chunk, chunks, splits, stages, vec, smem;
};

__host__ __device__ inline int up16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets of shared memory, as kernels/bcr_spmm.py:smem_layout
// computes them (the launcher refuses a plan whose total disagrees).
struct Layout {
  int cp, as;                 // C_keep padded to 16; padded row (elements)
  int ts, swz;                // staged bf16 tile row stride (bytes); 128B swizzle
  int bs_row;                 // gathered-x row stride (bytes)
  int tile_member;            // bytes of one member's tile in a stage
  int slot;                   // bytes of one ring stage
  int off_x, off_ridx, off_cidx;           // within a stage
  int off_bs, off_aconv, off_inv, off_zero, off_flag, off_bar, off_scales;
  int total;
};

struct Shape {
  int M, K, N, G, nb_r, nb_c, br, bc, R, C, m_tiles;
  int int8_tiles, swiglu, grouped;
  Plan p;
  Layout l;
};

__host__ __device__ inline int up(int v, int q) { return (v + q - 1) / q * q; }

// Stage rows: a bf16 tile copied by TMA is dense (C_keep · 2 bytes a row,
// 128-byte swizzled when that is exactly 128 bytes); tiles of the plain-load
// path are padded to Cp + 8 elements a row. Stages are 1024-byte aligned
// (the swizzle's unit); the total carries 1024 bytes of alignment slack.
inline Layout make_layout(const Shape& s) {
  Layout l;
  l.cp = up16(s.C);
  l.as = l.cp + 8;
  const int row = l.as * 2;
  const bool tma_tile = s.p.vec && !s.int8_tiles;
  l.ts = tma_tile ? s.C * 2 : row;
  l.swz = tma_tile && s.C * 2 == 128 && s.R % 8 == 0;
  l.tile_member = s.int8_tiles ? up16(s.R * s.C) : s.R * l.ts;
  l.off_x = up(s.G * l.tile_member, 128);
  l.off_ridx = l.off_x + up(s.p.mt * s.bc * 2, 128);
  l.off_cidx = l.off_ridx + up16(s.G * s.R * 4);
  l.slot = up(l.off_cidx + up16(s.G * s.C * 4), 1024);
  l.off_bs = s.p.stages * l.slot;
  l.bs_row = s.p.mt == 128 ? 128 : row;   // wgmma's swizzled B rows
  l.off_aconv = l.off_bs + 2 * s.G * s.p.mt * l.bs_row;
  const int main_end = l.off_aconv + (s.int8_tiles ? 2 * s.G * s.R * row : 0);
  const int red = s.G * s.p.mt * (s.p.n_chunk + 4) * 4;
  l.off_inv = main_end > red ? main_end : red;
  l.off_zero = l.off_inv + up16(2 * s.G * s.p.n_chunk * 4);
  l.off_flag = l.off_zero + up16(row);
  l.off_bar = l.off_flag + 16;
  l.off_scales = l.off_bar + up16(s.p.stages * 8);
  const int blocks = (s.nb_c + s.p.splits - 1) / s.p.splits;
  l.total = l.off_scales + (s.int8_tiles ? up16(blocks * s.G * 4) : 0) + 1024;
  return l;
}

// Warpgroup MMA for the 128-column M tile: d (64 rows × 128 columns per
// warpgroup, fp32, the m16n8 fragment layout repeated over 16 n8 groups)
// += a (this warp's 16 rows × k16, bf16 registers, as ldmatrix gives them)
// · B (k16 × 128 from shared memory, K-major, 128-byte swizzled); scale_d =
// 0 overwrites d.
__device__ __forceinline__ void wgmma128(float (&d)[4][4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[1][0][0]), "+f"(d[1][0][1]), "+f"(d[1][0][2]), "+f"(d[1][0][3]),
        "+f"(d[1][1][0]), "+f"(d[1][1][1]), "+f"(d[1][1][2]), "+f"(d[1][1][3]),
        "+f"(d[1][2][0]), "+f"(d[1][2][1]), "+f"(d[1][2][2]), "+f"(d[1][2][3]),
        "+f"(d[1][3][0]), "+f"(d[1][3][1]), "+f"(d[1][3][2]), "+f"(d[1][3][3]),
        "+f"(d[2][0][0]), "+f"(d[2][0][1]), "+f"(d[2][0][2]), "+f"(d[2][0][3]),
        "+f"(d[2][1][0]), "+f"(d[2][1][1]), "+f"(d[2][1][2]), "+f"(d[2][1][3]),
        "+f"(d[2][2][0]), "+f"(d[2][2][1]), "+f"(d[2][2][2]), "+f"(d[2][2][3]),
        "+f"(d[2][3][0]), "+f"(d[2][3][1]), "+f"(d[2][3][2]), "+f"(d[2][3][3]),
        "+f"(d[3][0][0]), "+f"(d[3][0][1]), "+f"(d[3][0][2]), "+f"(d[3][0][3]),
        "+f"(d[3][1][0]), "+f"(d[3][1][1]), "+f"(d[3][1][2]), "+f"(d[3][1][3]),
        "+f"(d[3][2][0]), "+f"(d[3][2][1]), "+f"(d[3][2][2]), "+f"(d[3][2][3]),
        "+f"(d[3][3][0]), "+f"(d[3][3][1]), "+f"(d[3][3][2]), "+f"(d[3][3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// Keep the compiler from moving accesses to d across an in-flight wgmma.
__device__ __forceinline__ void fence_operands(float (&d)[4][4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(d[a][b][q]));
}

// Index of member g's tile (i, j) in vals' (G, nb_r, nb_c) grid.
__device__ __forceinline__ size_t tile_id(const Shape& s, int g, int i,
                                          int j) {
  return ((size_t)g * s.nb_r + i) * s.nb_c + j;
}

// Stage contraction block j of block row i (all members) into ring slot sl
// and arm its mbarrier: a TMA copy of the x block (rows past M arrive as
// zeros), one TMA copy per bf16 tile (or one bulk copy per int8 tile) and
// bulk copies of the indices. One thread (the producer warp's lane 0)
// issues them.
template <bool INT8>
__device__ __forceinline__ void issue_tma(const Shape& s, unsigned char* sl,
                                          uint32_t bar,
                                          const CUtensorMap* xmap,
                                          const CUtensorMap* wmap,
                                          const void* __restrict__ vals,
                                          const int* __restrict__ row_idx,
                                          const int* __restrict__ col_idx,
                                          int i, int j, int m0) {
  const Layout& l = s.l;
  const int RC = s.R * s.C;
  bar_expect(bar, s.p.mt * s.bc * 2 + s.G * RC * (INT8 ? 1 : 2) +
                      s.G * (s.R + s.C) * 4);
  tma2d(smem_u32(sl + l.off_x), xmap, j * s.bc, m0, bar);
  for (int g = 0; g < s.G; ++g) {
    const size_t t = tile_id(s, g, i, j);
    if (INT8)
      bulk(smem_u32(sl + g * l.tile_member),
           static_cast<const int8_t*>(vals) + t * RC, RC, bar);
    else
      tma2d(smem_u32(sl + g * l.tile_member), wmap, 0, (int)(t * s.R), bar);
    bulk(smem_u32(sl + l.off_ridx + g * s.R * 4), row_idx + t * s.R, s.R * 4,
         bar);
    bulk(smem_u32(sl + l.off_cidx + g * s.C * 4), col_idx + t * s.C, s.C * 4,
         bar);
  }
}

// The same stage by plain loads from every thread, for operands the copies
// cannot take (rows that are not 16-byte multiples); thread 0 arrives on the
// mbarrier without bytes, and the next block barrier publishes the stores.
template <bool INT8>
__device__ __forceinline__ void issue_plain(const Shape& s, unsigned char* sl,
                                            uint32_t bar,
                                            const bf16* __restrict__ x,
                                            const void* __restrict__ vals,
                                            const int* __restrict__ row_idx,
                                            const int* __restrict__ col_idx,
                                            int i, int j, int m0, int mt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout& l = s.l;
  const int RC = s.R * s.C;
  for (int e = tid; e < s.G * RC; e += nt) {
    const int g = e / RC, v = e - g * RC;
    if (INT8) {
      sl[g * l.tile_member + v] =
          static_cast<const unsigned char*>(vals)[tile_id(s, g, i, j) * RC + v];
    } else {
      const int r = v / s.C, c = v - r * s.C;
      reinterpret_cast<bf16*>(sl)[(g * s.R + r) * l.as + c] =
          static_cast<const bf16*>(vals)[tile_id(s, g, i, j) * RC + v];
    }
  }
  bf16* xs = reinterpret_cast<bf16*>(sl + l.off_x);
  for (int e = tid; e < mt * s.bc; e += nt) {
    const int m = e / s.bc, c = e - m * s.bc;
    xs[e] = x[(size_t)(m0 + m) * s.K + (size_t)j * s.bc + c];   // m < mt
  }
  int* ri = reinterpret_cast<int*>(sl + l.off_ridx);
  int* ci = reinterpret_cast<int*>(sl + l.off_cidx);
  for (int e = tid; e < s.G * s.R; e += nt) {
    const int g = e / s.R;
    ri[e] = row_idx[tile_id(s, g, i, j) * s.R + (e - g * s.R)];
  }
  for (int e = tid; e < s.G * s.C; e += nt) {
    const int g = e / s.C;
    ci[e] = col_idx[tile_id(s, g, i, j) * s.C + (e - g * s.C)];
  }
  if (tid == 0)   // the stores are published by the next block barrier
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// Ready block jl (staged in slot sl) for the tensor cores, into the buffers
// of parity buf: the inverse row map (output row → kept row, tagged with
// jl), x's kept columns gathered into B's layout, and (int8) the codes
// times the tile's scale, rounded to bf16. A lane keeps one pair
// of kept columns and walks its warp's rows, loads first, stores after, so
// the gathers of a row group are in flight together.
template <bool INT8, int MT, int NW>
__device__ __forceinline__ void prepare(const Shape& s, unsigned char* smem,
                                        const unsigned char* sl, int jl,
                                        int buf, int nc0) {
  constexpr int kRows = MT / NW;            // x rows per warp
  constexpr int kU = kRows < 8 ? kRows : 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout& l = s.l;
  const int NC = s.p.n_chunk;
  const int* ridx = reinterpret_cast<const int*>(sl + l.off_ridx);
  const int* cidx = reinterpret_cast<const int*>(sl + l.off_cidx);
  int* inv = reinterpret_cast<int*>(smem + l.off_inv) + buf * s.G * NC;
  const int hc = (s.C + 1) / 2;
  const bf16* xs = reinterpret_cast<const bf16*>(sl + l.off_x);
  unsigned char* bs = smem + l.off_bs + (size_t)buf * s.G * MT * l.bs_row;
  const bf16 zero = __float2bfloat16(0.f);
  for (int g = 0; g < s.G; ++g) {
    for (int r = tid; r < s.R; r += NW * 32) {
      const int n = ridx[g * s.R + r] - nc0;
      if (n >= 0 && n < NC) inv[g * NC + n] = (jl << kTagShift) | r;
    }
    const int* cg = cidx + g * s.C;
    for (int q = lane; q < hc; q += 32) {
      const int c0 = cg[2 * q];
      const bool two = 2 * q + 1 < s.C;
      const int c1 = two ? cg[2 * q + 1] : c0;
      unsigned char* dst = bs + (size_t)g * MT * l.bs_row;
#pragma unroll
      for (int u0 = 0; u0 < kRows; u0 += kU) {
        __nv_bfloat162 v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bf16* xr = xs + (warp + (u0 + u) * NW) * s.bc;
          v[u].x = xr[c0];
          v[u].y = two ? xr[c1] : zero;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int m = warp + (u0 + u) * NW;
          // MT = 128 (wgmma): 128-byte rows, 16-byte chunks XOR (m & 7)
          const int off = MT == 128
                              ? (((q >> 2) ^ (m & 7)) << 4) | ((q & 3) << 2)
                              : 4 * q;
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)m * l.bs_row +
                                             off) = v[u];
        }
      }
    }
    if (INT8) {
      const int8_t* t8 =
          reinterpret_cast<const int8_t*>(sl) + g * l.tile_member;
      const float sc =
          reinterpret_cast<const float*>(smem + l.off_scales)[jl * s.G + g];
      bf16* ac = reinterpret_cast<bf16*>(smem + l.off_aconv) +
                 ((size_t)buf * s.G + g) * s.R * l.as;
      for (int q = lane; q < hc; q += 32) {
        const bool two = 2 * q + 1 < s.C;
        for (int r0 = warp; r0 < s.R; r0 += 4 * NW) {
          __nv_bfloat162 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + u * NW;
            const int8_t* row = t8 + (r < s.R ? r : 0) * s.C + 2 * q;
            v[u].x = __float2bfloat16((float)row[0] * sc);
            v[u].y = two ? __float2bfloat16((float)row[1] * sc) : zero;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + u * NW;
            if (r < s.R)
              *reinterpret_cast<__nv_bfloat162*>(ac + (size_t)r * l.as +
                                                 2 * q) = v[u];
          }
        }
      }
    }
  }
  // wgmma reads the gathered x through the async proxy
  if (MT == 128) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// Member g's 8 outputs (m, n .. n+7) of this tile, plus bias at column nb:
// from the shared tile (one split) or the sum of the S partials in split
// order, four splits' loads in flight at once.
__device__ __forceinline__ void emit_sum8(const Shape& s, const float* red,
                                          const float* wt, int rs, int per,
                                          int S, int MT, int g, int m, int n,
                                          int nb, const float* bias,
                                          float4& a0, float4& a1) {
  const int NC = s.p.n_chunk;
  if (S > 1) {
    const float* p = wt + ((size_t)g * MT + m) * NC + n;
    a0 = __ldcg(reinterpret_cast<const float4*>(p));
    a1 = __ldcg(reinterpret_cast<const float4*>(p + 4));
    for (int q0 = 1; q0 < S; q0 += 4) {
      float4 b[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < S) {
          const float* pq = p + (size_t)(q0 + u) * per;
          b[u][0] = __ldcg(reinterpret_cast<const float4*>(pq));
          b[u][1] = __ldcg(reinterpret_cast<const float4*>(pq + 4));
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < S) {
          add4(a0, b[u][0]);
          add4(a1, b[u][1]);
        }
    }
  } else {
    const float* p = red + ((size_t)g * MT + m) * rs + n;
    a0 = *reinterpret_cast<const float4*>(p);
    a1 = *reinterpret_cast<const float4*>(p + 4);
  }
  if (bias != nullptr) {
    const float* bb = bias + (size_t)g * s.N + nb;
    add4(a0, make_float4(bb[0], bb[1], bb[2], bb[3]));
    add4(a1, make_float4(bb[4], bb[5], bb[6], bb[7]));
  }
}

// One contraction block on the warp-level tensor cores (M tiles up to 64):
// SLABS m16 slabs (A rows a_row, chunk XOR a_xor) by NI n8 tiles of the
// gathered x (ldmatrix rows from b_addr, b_row bytes apart), k16 steps up
// to Cp, accumulated into acc.
template <int SLABS, int NI>
__device__ __forceinline__ void mma_block(float (&acc)[SLABS][NI][4],
                                          const uint32_t (&a_row)[SLABS],
                                          const int (&a_xor)[SLABS], int a_kc,
                                          uint32_t b_addr, int b_row,
                                          int ks_n) {
  constexpr int NB = NI == 1 ? 1 : NI / 2;
  for (int ks = 0; ks < ks_n; ++ks) {
    uint32_t af[SLABS][4];
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
      ldsm_x4(af[a], a_row[a] + (((ks * 2 + a_kc) ^ a_xor[a]) << 4));
    uint32_t bfr[NI][2];
    if (NI == 1) {
      ldsm_x2(bfr[0][0], bfr[0][1], b_addr + ks * 32);
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        uint32_t r4[4];
        ldsm_x4(r4, b_addr + b * 16 * b_row + ks * 32);
        bfr[2 * b][0] = r4[0];
        bfr[2 * b][1] = r4[1];
        bfr[(2 * b + 1) % NI][0] = r4[2];
        bfr[(2 * b + 1) % NI][1] = r4[3];
      }
    }
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
        mma(acc[a][b], af[a], bfr[b][0], bfr[b][1]);
  }
}

// One CTA: output rows [nc0, nc0 + n_chunk) of block row i for all G
// members (MMA rows) by x rows [m0, m0 + MT) (MMA columns), over the
// contraction blocks of split sp. mma.sync (M tiles up to 64): warp (wr,
// wc) owns SLABS m16 row slabs of one member by NI n8 column tiles. wgmma
// (the 128 tile, WM = 4): warpgroup wr owns 64 rows of one member by all
// 128 columns, warp wc of it 16 of those rows. Warp NW is the producer.
template <bool INT8, int MT, int SLABS, int WM, int NW>
__device__ __forceinline__ void tc_body(
    const CUtensorMap* xmap, const CUtensorMap* wmap,
    const bf16* __restrict__ x, const void* __restrict__ vals,
    const float* __restrict__ scales, const int* __restrict__ row_idx,
    const int* __restrict__ col_idx, const float* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters,
    const Shape& s) {
  constexpr int NI = MT / (WM * 8);
  constexpr bool WG = MT == 128;   // wgmma m64n128k16, else mma.sync
  static_assert(NI >= 1 && MT % (WM * 8) == 0, "M tile / warp layout");
  static_assert(!WG || (SLABS == 4 && NI == 4), "wgmma fragment layout");
  static_assert(NI == 1 || NI % 2 == 0, "n8 tiles load in pairs");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* smem = smem_tc + ((1024 - (smem_u32(smem_tc) & 1023)) & 1023);
  const Layout& l = s.l;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;                // NW compute warps + a producer
  const bool producer = warp == NW;
  const int wr = warp / WM, wc = warp - wr * WM;
  const int S = s.p.splits, ST = s.p.stages, NC = s.p.n_chunk;

  int idx = blockIdx.x;
  const int sp = idx % S;
  const int tile = idx / S;                 // (i, chunk, M tile)
  idx = tile;
  const int mtile = idx % s.m_tiles;
  idx /= s.m_tiles;
  const int ch = idx % s.p.chunks, i = idx / s.p.chunks;
  const int m0 = mtile * MT, mt = min(MT, s.M - m0);
  const int nc0 = ch * NC;
  const int j0 = (int)((long long)sp * s.nb_c / S);
  const int nblk = (int)((long long)(sp + 1) * s.nb_c / S) - j0;
  const bool vec = s.p.vec != 0;
  const uint32_t bar0 = smem_u32(smem + l.off_bar);

  // one mbarrier per stage; with TMA the producer arms the first ST-1
  // stages at once, so their copies overlap the set-up below
  if (vec ? producer && lane == 0 : tid == 0) {
    for (int st = 0; st < ST; ++st) bar_init(bar0 + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (vec)
      for (int p = 0; p < ST - 1 && p < nblk; ++p)
        issue_tma<INT8>(s, smem + p * l.slot, bar0 + p * 8, xmap, wmap, vals,
                        row_idx, col_idx, i, j0 + p, m0);
  }

  // what no copy writes: the zero row, x rows past M in every stage, the
  // pad columns C..Cp of the staged bf16 tiles, gathered x and widened int8
  // tiles; inverse maps start untagged
  bf16* zrow = reinterpret_cast<bf16*>(smem + l.off_zero);
  const bf16 zero = __float2bfloat16(0.f);
  for (int c = tid; c < l.cp; c += nt) zrow[c] = zero;
  if (!vec && mt < MT) {
    const int per = (MT - mt) * s.bc;
    for (int e = tid; e < ST * per; e += nt) {
      const int st = e / per;
      reinterpret_cast<bf16*>(smem + st * l.slot + l.off_x)[mt * s.bc + e -
                                                           st * per] = zero;
    }
  }
  const int pad = l.cp - s.C;
  if (pad > 0) {
    const int stage_rows = INT8 || l.ts != l.as * 2 ? 0 : ST * s.G * s.R;
    const int bs_rows = MT == 128 ? 0 : 2 * s.G * MT;
    const int ac_rows = INT8 ? 2 * s.G * s.R : 0;
    for (int e = tid; e < (stage_rows + bs_rows + ac_rows) * pad;
         e += nt) {
      int rw = e / pad;
      const int c = s.C + (e - rw * pad);
      bf16* p;
      if (rw < stage_rows) {
        const int slot = rw / (s.G * s.R);
        p = reinterpret_cast<bf16*>(smem + slot * l.slot) +
            (size_t)(rw - slot * s.G * s.R) * l.as;
      } else if ((rw -= stage_rows) < bs_rows) {
        p = reinterpret_cast<bf16*>(smem + l.off_bs) + (size_t)rw * l.as;
      } else {
        p = reinterpret_cast<bf16*>(smem + l.off_aconv) +
            (size_t)(rw - bs_rows) * l.as;
      }
      p[c] = zero;
    }
  }
  if (l.cp != s.C && l.ts == s.C * 2) {
    // dense tile rows of C_keep % 16 == 8: the last k step reads 16 bytes
    // past a row, against gathered-x columns that are zero; keep the bytes
    // past the last row finite
    const int end = s.G * l.tile_member;
    for (int e = tid; e < ST * 16; e += nt)
      if (end + (e & 15) < l.off_x) smem[(e >> 4) * l.slot + end + (e & 15)] = 0;
  }
  if (MT == 128 && s.C < 64) {   // swizzled B rows: zero columns C..63
    uint4* b4 = reinterpret_cast<uint4*>(smem + l.off_bs);
    for (int e = tid; e < 2 * s.G * MT * 8; e += nt) b4[e] = make_uint4(0, 0, 0, 0);
  }
  int* inv_all = reinterpret_cast<int*>(smem + l.off_inv);
  for (int e = tid; e < 2 * s.G * NC; e += nt) inv_all[e] = -1;
  if (INT8) {   // the tile scales of this CTA's blocks, all in flight at once
    float* sc_all = reinterpret_cast<float*>(smem + l.off_scales);
    for (int e = tid; e < nblk * s.G; e += nt) {
      const int b = e / s.G;
      sc_all[e] = __ldg(scales + tile_id(s, e - b * s.G, i, j0 + b));
    }
  }
  __syncthreads();
  if (!vec)   // ring prologue by plain loads: blocks 0 .. ST-2
    for (int p = 0; p < ST - 1 && p < nblk; ++p)
      issue_plain<INT8>(s, smem + p * l.slot, bar0 + p * 8, x, vals, row_idx,
                        col_idx, i, j0 + p, m0, mt);
  bar_wait(bar0, 0);
  __syncthreads();
  if (!producer) prepare<INT8, MT, NW>(s, smem, smem, 0, 0, nc0);

  // this warp's member and the lane's ldmatrix rows
  const int row0 = wr * SLABS * 16;
  const int gw = producer ? s.G : row0 / NC;   // >= G: no rows
  float acc[SLABS][NI][4];
#pragma unroll
  for (int a = 0; a < SLABS; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;
  const int a_lane_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_kc = lane >> 4;
  const int b_lane_row = NI == 1 ? (lane & 7) : ((lane >> 4) * 8 + (lane & 7));
  const int b_kc = (lane >> 3) & 1;
  const int ks_n = l.cp / 16;

  for (int jl = 0; jl < nblk; ++jl) {
    if (jl + 1 < nblk)
      bar_wait(bar0 + ((jl + 1) % ST) * 8, ((jl + 1) / ST) & 1);
    __syncthreads();   // block jl prepared, block jl+1 staged, jl-1 done
    const int nxt = jl + ST - 1;
    if (nxt < nblk) {
      unsigned char* sn = smem + (nxt % ST) * l.slot;
      const uint32_t bn = bar0 + (nxt % ST) * 8;
      if (!vec)
        issue_plain<INT8>(s, sn, bn, x, vals, row_idx, col_idx, i, j0 + nxt,
                          m0, mt);
      else if (producer && lane == 0)
        issue_tma<INT8>(s, sn, bn, xmap, wmap, vals, row_idx, col_idx, i,
                        j0 + nxt, m0);
    }
    const bool next = jl + 1 < nblk && !producer;
    const int buf = jl & 1;
    if (gw < s.G) {
      // A rows: the kept row's staged row (bf16 tile rows ts bytes apart,
      // 16-byte chunks XOR-swizzled by row under TMA's 128B swizzle;
      // widened int8 rows padded) or the zero row
      const int* inv = inv_all + (buf * s.G + gw) * NC;
      const unsigned char* abase =
          INT8 ? smem + l.off_aconv + (size_t)(buf * s.G + gw) * s.R * l.as * 2
               : smem + (jl % ST) * l.slot + (size_t)gw * l.tile_member;
      const int a_stride = INT8 ? l.as * 2 : l.ts;
      const bool swz = !INT8 && l.swz;
      uint32_t a_row[WG ? 1 : SLABS];
      int a_xor[WG ? 1 : SLABS];
#pragma unroll
      for (int a = 0; a < (WG ? 1 : SLABS); ++a) {
        // wgmma: the warp's 16 rows of its warpgroup's 64
        const int e = inv[row0 - gw * NC + (WG ? wc : a) * 16 + a_lane_row];
        const bool kept = (e >> kTagShift) == jl;
        const int r = e & ((1 << kTagShift) - 1);
        a_row[a] = kept ? smem_u32(abase) + r * a_stride : smem_u32(zrow);
        a_xor[a] = kept && swz ? (r & 7) : 0;
      }
      if constexpr (WG) {
        // the block's wgmmas run on the tensor cores while the warps
        // prepare the next block
        const uint64_t desc = desc_sw128(smem_u32(
            smem + l.off_bs + (size_t)(buf * s.G + gw) * MT * l.bs_row));
        uint32_t af[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < ks_n)
            ldsm_x4(af[ks], a_row[0] + (((ks * 2 + a_kc) ^ a_xor[0]) << 4));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < ks_n) {
            wgmma128(acc, af[ks], desc + 2 * ks, 1);
          }
        wgmma_commit();
      } else {
        if (next)
          prepare<INT8, MT, NW>(s, smem, smem + ((jl + 1) % ST) * l.slot,
                                jl + 1, buf ^ 1, nc0);
        mma_block<SLABS, NI>(
            acc, a_row, a_xor, a_kc,
            smem_u32(smem + l.off_bs +
                     (size_t)(buf * s.G + gw) * MT * l.bs_row) +
                (wc * NI * 8 + b_lane_row) * l.bs_row + b_kc * 16,
            l.bs_row, ks_n);
      }
    } else if (!WG && next) {
      prepare<INT8, MT, NW>(s, smem, smem + ((jl + 1) % ST) * l.slot, jl + 1,
                            buf ^ 1, nc0);
    }
    if constexpr (WG) {
      if (next)
        prepare<INT8, MT, NW>(s, smem, smem + ((jl + 1) % ST) * l.slot,
                              jl + 1, buf ^ 1, nc0);
      if (gw < s.G) wgmma_wait();
    }
    if constexpr (WG) fence_operands(acc);
  }

  // fp32 tile → shared memory as [g][m][n] (row stride NC + 4), over the
  // ring (every copy has landed: each block was waited on)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int rs = NC + 4;
  if (gw < s.G) {
#pragma unroll
    for (int a = 0; a < SLABS; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // mma.sync: slab a, n8 tile b of warp (wr, wc); wgmma (MT = 128):
          // n8 group 4a + b of the warp's 16 rows
          const int n = row0 - gw * NC + (WG ? wc : a) * 16 + (lane >> 2) +
                        (q >> 1) * 8;
          const int m = (WG ? (4 * a + b) * 8 : wc * NI * 8 + b * 8) +
                        (lane & 3) * 2 + (q & 1);
          red[((size_t)gw * MT + m) * rs + n] = acc[a][b][q];
        }
  }
  __syncthreads();

  const int per = s.G * MT * NC;
  if (S > 1) {
    // this split's partial to the workspace; the last split to arrive sums
    // all of them in split order, so y does not depend on arrival order
    float* wp = ws + ((size_t)tile * S + sp) * per;
    for (int gm = warp; gm < s.G * MT; gm += NW + 1)
      for (int n = lane; n < NC; n += 32)
        wp[(size_t)gm * NC + n] = red[(size_t)gm * rs + n];
    __threadfence();
    __syncthreads();
    int* flag = reinterpret_cast<int*>(smem + l.off_flag);
    if (tid == 0) *flag = atomicAdd(counters + tile, 1) == S - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  }

  // emit: bias, SwiGLU, x's dtype. Where rows allow, a thread takes 8
  // consecutive outputs: two float4 reads of the tile (or of each split's
  // partial, four splits' loads in flight at once, summed in split order)
  // and one 16-byte store.
  const int n0 = i * s.br + nc0;
  const int nv = min(NC, s.br - nc0);
  const float* wt = ws + (size_t)tile * S * per;
  const int gy = s.swiglu ? 1 : s.G;
  if (nv % 8 == 0 && s.N % 8 == 0 && s.br % 8 == 0) {
    const int nq = nv / 8;
    for (int e = tid; e < gy * mt * nq; e += nt) {
      const int gm = e / nq, n = (e - gm * nq) * 8;
      const int go = gm / mt, m = gm - go * mt;
      float4 a0, a1, b0, b1;
      emit_sum8(s, red, wt, rs, per, S, MT, s.swiglu ? 0 : go, m, n, n0 + n,
                bias, a0, a1);
      if (s.swiglu) {
        emit_sum8(s, red, wt, rs, per, S, MT, 1, m, n, n0 + n, bias, b0, b1);
        a0 = make_float4(silu(a0.x) * b0.x, silu(a0.y) * b0.y,
                         silu(a0.z) * b0.z, silu(a0.w) * b0.w);
        a1 = make_float4(silu(a1.x) * b1.x, silu(a1.y) * b1.y,
                         silu(a1.z) * b1.z, silu(a1.w) * b1.w);
      }
      *reinterpret_cast<uint4*>(y + ((size_t)go * s.M + m0 + m) * s.N + n0 +
                                n) =
          make_uint4(pack_bf16(a0.x, a0.y), pack_bf16(a0.z, a0.w),
                     pack_bf16(a1.x, a1.y), pack_bf16(a1.z, a1.w));
    }
  } else {
    for (int e = tid; e < gy * mt * nv; e += nt) {
      const int gm = e / nv, n = e - gm * nv;
      const int go = gm / mt, m = gm - go * mt;
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !s.swiglu) break;
        const int g = s.swiglu ? h : go;
        float val;
        if (S > 1) {
          const size_t o = ((size_t)g * MT + m) * NC + n;
          val = __ldcg(wt + o);
          for (int q = 1; q < S; ++q) val += __ldcg(wt + (size_t)q * per + o);
        } else {
          val = red[((size_t)g * MT + m) * rs + n];
        }
        if (bias != nullptr) val += bias[(size_t)g * s.N + n0 + n];
        v[h] = val;
      }
      const float o = s.swiglu ? silu(v[0]) * v[1] : v[0];
      y[((size_t)go * s.M + m0 + m) * s.N + n0 + n] = __float2bfloat16(o);
    }
  }
  if (S > 1 && tid == 0) counters[tile] = 0;   // ready for the next call
}

// One body under two names, so a profile tells bcr_spmm's launches from
// bcr_spmm_grouped's.
#define BCR_TC_KERNEL(NAME)                                                  \
  template <bool INT8, int MT, int SLABS, int WM, int NW>                    \
  __global__ void __launch_bounds__(NW * 32 + 32, 1)                         \
  NAME(const __grid_constant__ CUtensorMap xmap,                             \
       const __grid_constant__ CUtensorMap wmap, const bf16* x,              \
       const void* vals, const float* scales, const int* row_idx,            \
       const int* col_idx, const float* bias, bf16* y, float* ws,            \
       int* counters, const Shape s) {                                       \
    tc_body<INT8, MT, SLABS, WM, NW>(&xmap, &wmap, x, vals, scales, row_idx, \
                                 col_idx, bias, y, ws, counters, s);         \
  }
BCR_TC_KERNEL(bcr_spmm_tc)
BCR_TC_KERNEL(bcr_spmm_grouped_tc)
#undef BCR_TC_KERNEL

template <bool INT8, int MT, int SLABS, int WM, int NW>
int launch_cfg(const Shape& s, cudaStream_t stream, void** args) {
  auto kernel = s.grouped ? bcr_spmm_grouped_tc<INT8, MT, SLABS, WM, NW>
                          : bcr_spmm_tc<INT8, MT, SLABS, WM, NW>;
  static int smem_set[2] = {0, 0};   // per kernel: raise the limit once
  if (s.p.smem > smem_set[s.grouped]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.p.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[s.grouped] = s.p.smem;
  }
  const int grid = s.nb_r * s.p.chunks * s.m_tiles * s.p.splits;
  cudaError_t err = cudaLaunchKernel((const void*)kernel, dim3(grid),
                                     dim3(NW * 32 + 32), args, s.p.smem,
                                     stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled configurations: kernels/bcr_spmm.py:CONFIGS.
template <bool INT8>
int dispatch(const Shape& s, cudaStream_t st, void** args) {
  const int mt = s.p.mt, sl = s.p.slabs, wm = s.p.warps_m;
#define BCR_CFG(A, B, C, D) \
  if (mt == A && sl == B && wm == C) return launch_cfg<INT8, A, B, C, D>(s, st, args);
  BCR_CFG(8, 1, 1, 8)
  BCR_CFG(8, 2, 1, 8)
  BCR_CFG(16, 1, 1, 8)
  BCR_CFG(16, 2, 1, 8)
  BCR_CFG(32, 1, 1, 8)
  BCR_CFG(32, 2, 1, 8)
  BCR_CFG(64, 2, 2, 8)
  BCR_CFG(128, 4, 4, 8)
#undef BCR_CFG
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

extern "C" {

// One launch of either body. dtype: 0 = float32, 1 = bfloat16 (x and y
// share it). grouped: bcr_spmm_grouped's call (its kernels' names).
// int8_tiles = 0: vals in x's dtype, scales unused; 1: int8 vals
// with ([G,] nb_r, nb_c) fp32 scales. bias: (G, N) fp32 or null; swiglu: G
// = 2, y (M, N), else y (G, M, N). plan: kernels/bcr_spmm.py:LaunchPlan.args()
// under bf16 (ws: its fp32 workspace, counters: its zeroed split counters,
// both null when unsplit); ignored under fp32.
int bcr_spmm_launch(int dtype, int grouped, int int8_tiles, int swiglu,
                    const void* x,
                    const void* vals, const float* scales, const int* row_idx,
                    const int* col_idx, const float* bias, void* y, float* ws,
                    int* counters, int M, int K, int N, int G, int nb_r,
                    int nb_c, int br, int bc, int R, int C, const int* plan,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    using namespace cuda_core;
    SpmmShape s = make_shape(M, K, N, G, nb_r, nb_c, br, bc, R, C, 4);
    s.m_tile = m_tile_for(s);
    if (s.m_tile == 0) return (int)cudaErrorInvalidValue;
    plan_phases(s, 4, int8_tiles ? 1 : 4, x, vals);
    void* args[] = {(void*)&x, (void*)&vals, (void*)&scales, (void*)&row_idx,
                    (void*)&col_idx, (void*)&y, (void*)&s};
    if (!grouped)
      return int8_tiles
                 ? launch(bcr_spmm_kernel<float, int8_t>, s, st, args)
                 : launch(bcr_spmm_kernel<float, float>, s, st, args);
    void* gargs[] = {(void*)&x, (void*)&vals, (void*)&scales,
                     (void*)&row_idx, (void*)&col_idx, (void*)&bias,
                     (void*)&y, (void*)&s};
    if (int8_tiles)
      return swiglu
                 ? launch(bcr_spmm_grouped_kernel<float, int8_t, true>, s, st,
                          gargs)
                 : launch(bcr_spmm_grouped_kernel<float, int8_t, false>, s,
                          st, gargs);
    return swiglu ? launch(bcr_spmm_grouped_kernel<float, float, true>, s, st,
                           gargs)
                  : launch(bcr_spmm_grouped_kernel<float, float, false>, s,
                           st, gargs);
  }
  if (dtype != 1 || plan == nullptr) return (int)cudaErrorInvalidValue;
  tc::Shape s;
  s.M = M; s.K = K; s.N = N; s.G = G; s.nb_r = nb_r; s.nb_c = nb_c;
  s.br = br; s.bc = bc; s.R = R; s.C = C;
  s.int8_tiles = int8_tiles; s.swiglu = swiglu; s.grouped = grouped != 0;
  s.p = tc::Plan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
                 plan[6], plan[7], plan[8]};
  s.m_tiles = (M + s.p.mt - 1) / s.p.mt;
  s.l = tc::make_layout(s);
  if (s.l.total != s.p.smem) return -1;   // plan and layout disagree
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (s.p.vec) {   // the plan's copies need 16-byte aligned operands
    if ((uintptr_t)x % 16 || (uintptr_t)vals % 16 || (uintptr_t)row_idx % 16 ||
        (uintptr_t)col_idx % 16)
      return -2;
    if (!hopper::make_map(&xmap, x, M, K, s.p.mt, bc, false) ||
        (!int8_tiles &&
         !hopper::make_map(&wmap, vals, (uint64_t)G * nb_r * nb_c * R, C, R, C,
                       s.l.swz)))
      return -3;
  }
  void* args[] = {(void*)&xmap, (void*)&wmap, (void*)&x, (void*)&vals,
                  (void*)&scales, (void*)&row_idx, (void*)&col_idx,
                  (void*)&bias, (void*)&y, (void*)&ws, (void*)&counters,
                  (void*)&s};
  return int8_tiles ? tc::dispatch<true>(s, st, args)
                    : tc::dispatch<false>(s, st, args);
}

}  // extern "C"

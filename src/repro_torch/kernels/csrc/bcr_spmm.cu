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
// gate/up pair, silu(acc0) * acc1 as (M, N).
//
// What bounds it on this card: at decode (M = 1..8) the bytes of the packed
// tiles it streams (keep_frac of the dense weight, read once); at prefill
// (M in the thousands) fp32 FMA throughput, since this version does its
// tile products on the CUDA cores, not on the tensor cores.
//
// Design: one CTA owns one output block-row i and one M tile, and walks the
// contraction blocks j = 0 .. nb_c-1 itself (the TPU's sequential grid axis
// becomes a loop inside the CTA). The blocks are staged JB at a time (a
// phase): the x columns of the JB blocks once for all G members, the kept
// tiles (fp32, rows padded so float4 reads hit distinct banks) and their
// indices go to shared memory; a gather pass copies each member's C_keep
// kept x columns into a dense (M_t, C_keep) tile, so the product loop reads
// contiguous float4s with no dependent index load; each block's (M_t,
// R_keep) partial is added into an fp32 shared accumulator at its kept
// rows. Row indices inside a block are distinct and one CTA owns block-row
// i, so the adds need no atomics; a barrier separates the blocks of a phase,
// whose kept rows may coincide. The tile is written once, in x's dtype; rows
// no index reaches stay exact zeros. M, R_keep and C_keep edges are masked,
// so kept counts of 1..8 and M = 1 are legal.
//
// Against the device-memory latency a CTA would otherwise pay per block, the
// next phase's tiles, x columns and indices are loaded with 16-byte loads
// into registers while the current phase is multiplied (a two-stage register
// pipeline); JB (4, 2 or 1) is the most blocks those registers and shared
// memory hold. Shapes whose rows are not 16-byte multiples take the same
// loop one block per phase with plain loads and no overlap. At small M the
// C_keep sum of one output is split over up to 4 lanes.
//
// Known limit: the grid has nb_r × ceil(M / M_t) CTAs — 16 for a 2048-row
// weight at decode, far fewer than the 132 SMs — so small-N projections
// leave most of the card idle. Splitting j across CTAs (with a second
// reduction pass), wgmma on the tensor cores and TMA loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;   // M rows one work item accumulates
constexpr int kTileVecs = 8;        // 16-byte tile vectors a thread prefetches
constexpr int kXVecs = 4;           // 16-byte x vectors a thread prefetches
constexpr int kIdx = 2;             // indices a thread prefetches
constexpr int kMaxJB = 4;           // contraction blocks per phase
constexpr size_t kSmemLimit = 200 * 1024;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
// tiles, gathered x tiles, accumulator, raw x columns, indices.
__host__ __device__ inline size_t smem_words(const SpmmShape& s) {
  const size_t cp = padded_c(s.C);
  return (size_t)s.jb * s.G * s.R * cp + (size_t)s.jb * s.G * s.m_tile * cp +
         (size_t)s.G * s.m_tile * s.br +
         (size_t)s.m_tile * (s.jb * s.bc + 1) +
         (size_t)s.jb * s.G * (s.C + s.R);
}

template <typename T>
struct Stage {   // one phase's loads, held in registers between phases
  uint4 tile[kTileVecs];
  uint4 x[kXVecs];
  int idx[kIdx];
};

// Loads of phase j0 .. j0+jb-1. For member g the jb tiles (and index rows)
// of block-row i are contiguous in memory, as are the x columns of a row.
template <typename T>
__device__ __forceinline__ void prefetch(Stage<T>& st, const T* __restrict__ x,
                                         const T* __restrict__ vals,
                                         const int* __restrict__ row_idx,
                                         const int* __restrict__ col_idx,
                                         const SpmmShape& s, int i, int j0,
                                         int m0, int mt) {
  const int tid = threadIdx.x;
  constexpr int kEPV = 16 / sizeof(T);           // elements per vector
  const int per_g = s.jb * s.R * s.C / kEPV;     // vectors per member
#pragma unroll
  for (int u = 0; u < kTileVecs; ++u) {
    const int v = tid + u * kThreads;
    if (v < s.G * per_g) {
      const int g = v / per_g, w = v - g * per_g;
      const T* base = vals + (((size_t)g * s.nb_r + i) * s.nb_c + j0) *
                                 (size_t)(s.R * s.C);
      st.tile[u] = __ldg(reinterpret_cast<const uint4*>(base) + w);
    }
  }
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
// columns at m·(jb·bc + 1), indices as loaded (cols, then rows).
template <typename T>
__device__ __forceinline__ void commit(const Stage<T>& st, float* xs,
                                       float* ws, int* idx, const SpmmShape& s,
                                       int cp) {
  const int tid = threadIdx.x;
  constexpr int kEPV = 16 / sizeof(T);
  const int vpt = s.R * s.C / kEPV, per_g = s.jb * vpt;
#pragma unroll
  for (int u = 0; u < kTileVecs; ++u) {
    const int v = tid + u * kThreads;
    if (v < s.G * per_g) {
      const int g = v / per_g, v2 = v - g * per_g;
      const int jj = v2 / vpt, w = v2 - jj * vpt;
      const int e0 = w * kEPV;                     // C_keep % kEPV == 0:
      const int r = e0 / s.C, c0 = e0 - r * s.C;   // a vector is in one row
      float* dst = ws + ((jj * s.G + g) * s.R + r) * cp + c0;
      const T* e = reinterpret_cast<const T*>(&st.tile[u]);
#pragma unroll
      for (int q = 0; q < kEPV; ++q) dst[q] = to_f(e[q]);
    }
  }
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
template <typename T>
__device__ void load_plain(const T* __restrict__ x, const T* __restrict__ vals,
                           const int* __restrict__ row_idx,
                           const int* __restrict__ col_idx, float* xs,
                           float* ws, int* idx, const SpmmShape& s, int cp,
                           int i, int j, int m0, int mt) {
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
    ws[(g * s.R + r) * cp + c] =
        to_f(vals[(((size_t)g * s.nb_r + i) * s.nb_c + j) * tile + rc]);
  }
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

template <typename T, bool SWIGLU>
__device__ void spmm_body(const T* __restrict__ x, const T* __restrict__ vals,
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

  Stage<T> st;
  const int n_phase = s.nb_c / s.jb;
  if (s.vec) prefetch(st, x, vals, row_idx, col_idx, s, i, 0, m0, mt);
  for (int ph = 0; ph < n_phase; ++ph) {
    const int j0 = ph * s.jb;
    if (s.vec) {
      commit(st, xs, ws, cols, s, cp);
    } else {
      load_plain(x, vals, row_idx, col_idx, xs, ws, cols, s, cp, i, j0, m0,
                 mt);
    }
    __syncthreads();
    if (s.vec && ph + 1 < n_phase)   // in flight while this phase multiplies
      prefetch(st, x, vals, row_idx, col_idx, s, i, j0 + s.jb, m0, mt);

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
bcr_spmm_kernel(const T* x, const T* vals, const int* row_idx,
                const int* col_idx, T* y, SpmmShape s) {
  spmm_body<T, false>(x, vals, row_idx, col_idx, nullptr, y, s);
}

template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(kThreads)
bcr_spmm_grouped_kernel(const T* x, const T* vals, const int* row_idx,
                        const int* col_idx, const float* bias, T* y,
                        SpmmShape s) {
  spmm_body<T, SWIGLU>(x, vals, row_idx, col_idx, bias, y, s);
}

// Blocks per phase: the register pipeline needs 16-byte rows (a vector
// never straddles a kept row) and a phase small enough for the per-thread
// prefetch registers and for shared memory; else one block, plain loads.
void plan_phases(SpmmShape& s, int elem, const void* x, const void* vals) {
  const int epv = 16 / elem;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)vals % 16 == 0);
  s.vec = 0;
  s.jb = 1;
  if (!(aligned && s.C % epv == 0 && s.bc % epv == 0 && s.K % epv == 0))
    return;
  for (int jb = kMaxJB; jb >= 1; jb /= 2) {
    SpmmShape t = s;
    t.jb = jb;
    if (s.nb_c % jb == 0 &&
        s.G * jb * s.R * s.C / epv <= kTileVecs * kThreads &&
        s.m_tile * jb * s.bc / epv <= kXVecs * kThreads &&
        s.G * jb * (s.C + s.R) <= kIdx * kThreads &&
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

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs at one block per phase; the wrapper
// sizes m_tile with it (the launcher then stages more blocks per phase
// where they fit).
long long bcr_spmm_smem_bytes(int G, int br, int bc, int R, int C,
                              int m_tile) {
  SpmmShape s = make_shape(0, 0, 0, G, 0, 0, br, bc, R, C, m_tile);
  return (long long)smem_words(s) * 4;
}

// dtype: 0 = float32, 1 = bfloat16 (x, vals and y share it).
int bcr_spmm_launch(int dtype, const void* x, const void* vals,
                    const int* row_idx, const int* col_idx, void* y, int M,
                    int K, int N, int nb_r, int nb_c, int br, int bc, int R,
                    int C, int m_tile, void* stream) {
  SpmmShape s = make_shape(M, K, N, 1, nb_r, nb_c, br, bc, R, C, m_tile);
  plan_phases(s, dtype == 0 ? 4 : 2, x, vals);
  void* args[] = {(void*)&x, (void*)&vals, (void*)&row_idx, (void*)&col_idx,
                  (void*)&y, (void*)&s};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch(bcr_spmm_kernel<float>, s, st, args);
  if (dtype == 1) return launch(bcr_spmm_kernel<__nv_bfloat16>, s, st, args);
  return (int)cudaErrorInvalidValue;
}

int bcr_spmm_grouped_launch(int dtype, int swiglu, const void* x,
                            const void* vals, const int* row_idx,
                            const int* col_idx, const float* bias, void* y,
                            int M, int K, int N, int G, int nb_r, int nb_c,
                            int br, int bc, int R, int C, int m_tile,
                            void* stream) {
  SpmmShape s = make_shape(M, K, N, G, nb_r, nb_c, br, bc, R, C, m_tile);
  plan_phases(s, dtype == 0 ? 4 : 2, x, vals);
  void* args[] = {(void*)&x, (void*)&vals, (void*)&row_idx, (void*)&col_idx,
                  (void*)&bias, (void*)&y, (void*)&s};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && !swiglu)
    return launch(bcr_spmm_grouped_kernel<float, false>, s, st, args);
  if (dtype == 0 && swiglu)
    return launch(bcr_spmm_grouped_kernel<float, true>, s, st, args);
  if (dtype == 1 && !swiglu)
    return launch(bcr_spmm_grouped_kernel<__nv_bfloat16, false>, s, st, args);
  if (dtype == 1 && swiglu)
    return launch(bcr_spmm_grouped_kernel<__nv_bfloat16, true>, s, st, args);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Block-skipping matmul over unbalanced-BCR tiles, written for Hopper
// (sm_90a), bound to Python through ctypes (kernels/bcr_spmm_skip.py).
//
// Replaces the reference package's TPU kernel
// kernels/bcr_spmm_skip.py:bcr_spmm_skip (body _kernel).
//
// What it computes: y[M, N] = x[M, K] @ W.T where W (N, K) is cut into
// (br, bc) blocks and only the surviving blocks are stored, as dense tiles
// (num_nz, br, bc) sorted by output block row bi, with their contraction
// block column bj. row_start (nb_r + 1) gives the tile range of each block
// row. Output rows of a block row with no tile are exact zeros.
//
// The TPU kernel walks the tiles as one sequential grid, resets a VMEM
// accumulator on the first tile of a bi, emits on the last, and leaves the
// never-visited output rows to a where(row_mask, y, 0) pass after it (they
// may hold NaN). Here blocks run in parallel and in no order, so each CTA
// owns one (block row, 64-row output slice, M tile) and walks its block
// row's tiles [row_start[i], row_start[i + 1]) itself in a loop: the sum
// stays in fp32 registers and nothing carries between CTAs. A CTA whose
// block row has no tile runs no iteration and writes its zeros itself, so
// every element of y is written by this kernel and no mask pass or
// read-modify-write of y follows.
//
// What bounds it on this card: at decode (M = 1..8) the bytes of the
// surviving tiles (read once); at prefill (M in the thousands) fp32 FMA
// throughput, since this version multiplies on the CUDA cores, not the
// tensor cores. Design: 256 threads as 16 x 16; each (BK = 32)-wide slice
// of the x columns of tile bj and of the tile's 64 output rows is staged in
// shared memory as fp32 (one padding word per row, so the transposed
// stores hit distinct banks), and each thread accumulates a TM x 4 block of
// outputs (TM = 1 for M <= 16, else 4). The next slice is loaded into
// registers while the current one is multiplied (a two-stage register
// pipeline across tile boundaries). M, br and bc edges are masked, so any
// block shape and any M are legal.
//
// Known limits: a 16-block-row weight at decode has 32 CTAs for 132 SMs;
// split-K over a block row's tiles, wgmma on the tensor cores and a TMA
// ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;   // output rows of a block row per CTA
constexpr int kBK = 32;   // contraction columns per staged slice

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
skip_kernel(const T* __restrict__ x, const T* __restrict__ tiles,
            const int* __restrict__ bj, const int* __restrict__ row_start,
            T* __restrict__ y, int M, int K, int N, int br, int bc,
            int n_slices) {
  constexpr int TM = BM / 16;
  constexpr int TN = kBN / 16;
  constexpr int XL = BM * kBK / kThreads;   // x values a thread stages
  constexpr int WL = kBN * kBK / kThreads;  // tile values a thread stages
  static_assert(XL >= 1 && WL >= 1, "tile shape");
  __shared__ float xs[kBK][BM + 1];
  __shared__ float ws[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int brow = blockIdx.x / n_slices;
  const int n0 = (blockIdx.x % n_slices) * kBN;
  const int m0 = blockIdx.y * BM;
  const int t0 = row_start[brow];
  const int kchunks = (bc + kBK - 1) / kBK;
  const int total = (row_start[brow + 1] - t0) * kchunks;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  float xr[XL], wr[WL];
  auto load = [&](int c) {
    const int t = t0 + c / kchunks;
    const int kc = (c % kchunks) * kBK;
    const int j = bj[t];
    const T* xb = x + (size_t)m0 * K + (size_t)j * bc + kc;
    const T* wb = tiles + (size_t)t * br * bc + (size_t)n0 * bc + kc;
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int e = tid + l * kThreads, r = e / kBK, k = e % kBK;
      xr[l] = (m0 + r < M && kc + k < bc) ? to_f(xb[(size_t)r * K + k]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < WL; ++l) {
      const int e = tid + l * kThreads, r = e / kBK, k = e % kBK;
      wr[l] = (n0 + r < br && kc + k < bc) ? to_f(wb[(size_t)r * bc + k])
                                           : 0.f;
    }
  };

  if (total > 0) load(0);
  for (int c = 0; c < total; ++c) {
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int e = tid + l * kThreads;
      xs[e % kBK][e / kBK] = xr[l];
    }
#pragma unroll
    for (int l = 0; l < WL; ++l) {
      const int e = tid + l * kThreads;
      ws[e % kBK][e / kBK] = wr[l];
    }
    __syncthreads();
    if (c + 1 < total) load(c + 1);   // in flight while this slice multiplies
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = xs[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < TN; ++b) bv[b] = ws[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

  // every (row, column) of this CTA's slice is written, zeros included
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int m = m0 + ty + 16 * a;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int n = n0 + tx + 16 * b;
      if (n < br) y[(size_t)m * N + (size_t)brow * br + n] = from_f<T>(acc[a][b]);
    }
  }
}

template <typename T, int BM>
int launch_typed(const void* x, const void* tiles, const int* bj,
                 const int* row_start, void* y, int M, int K, int N, int nb_r,
                 int br, int bc, cudaStream_t stream) {
  const int n_slices = (br + kBN - 1) / kBN;
  dim3 grid((unsigned)nb_r * n_slices, (unsigned)((M + BM - 1) / BM));
  skip_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)tiles, bj, row_start, (T*)y, M, K, N, br, bc,
      n_slices);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_m(const void* x, const void* tiles, const int* bj,
             const int* row_start, void* y, int M, int K, int N, int nb_r,
             int br, int bc, cudaStream_t stream) {
  if (M <= 16)
    return launch_typed<T, 16>(x, tiles, bj, row_start, y, M, K, N, nb_r, br,
                               bc, stream);
  return launch_typed<T, 64>(x, tiles, bj, row_start, y, M, K, N, nb_r, br,
                             bc, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, tiles and y share it). The wrapper
// has checked the plan: bi sorted, row_start = the tile range of each block
// row, bj within the nb_c contraction blocks.
int bcr_spmm_skip_launch(int dtype, const void* x, const void* tiles,
                         const int* bj, const int* row_start, void* y, int M,
                         int K, int N, int nb_r, int nb_c, int br, int bc,
                         void* stream) {
  if (M <= 0 || nb_r <= 0 || nb_c <= 0 || br <= 0 || bc <= 0 ||
      nb_r * br != N || nb_c * bc != K ||
      (M + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_m<float>(x, tiles, bj, row_start, y, M, K, N, nb_r, br, bc,
                           s);
  if (dtype == 1)
    return launch_m<__nv_bfloat16>(x, tiles, bj, row_start, y, M, K, N, nb_r,
                                   br, bc, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

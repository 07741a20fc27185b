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
// may hold NaN). Here CTAs run in parallel and in no order: each CTA owns a
// work unit (a contiguous range of one block row's tiles) for one slice of
// the block row's output rows and one M tile, and walks the range itself
// with the sum in fp32 registers. A unit with no tile (an empty block row)
// writes its zeros itself, so every element of y is written by this kernel
// and no mask pass follows.
//
// Two bodies.
//
// bf16 x, blocks whose sides are multiples of 16, 16-byte aligned tiles —
// namespace tc, tensor cores. What bounds it on this card: at decode (M =
// 1..16) the bytes of the surviving tiles, read once, and how many SMs
// stream them; at prefill (M in the thousands) the bf16 tensor-core rate
// on the surviving share of the dense work (and, behind it, the L2 → shared
// traffic of re-reading each tile once per M tile). What the design does:
//   * Nothing is gathered or scattered: a surviving tile is a dense block
//     of W and x's slab for its bj a dense box, so both operands go from
//     shared memory to the tensor cores as they arrive. The tile's rows are
//     the MMA's M side and the M tile its N side: y^T = W_tile · x_slab^T.
//     Prefill (M > 64, both sides multiples of 64): wgmma m64n128k16, one
//     consumer warpgroup per 64 tile rows, A (the tile) and B (x, K-major)
//     both read by 128-byte-swizzled descriptors, one stage's products in
//     flight while the next stage's are issued. Decode and short prefill
//     (M tiles of 8, 16, 64) and every other block: mma.sync m16n8k16 with
//     both operands by ldmatrix (decode is bound by bytes, so the
//     instruction hardly matters there).
//   * Copies: one producer warp keeps a ring of stages in flight, each one
//     64-column (or 32-, 16-column) slice of one tile by a 2-D TMA copy over
//     tiles viewed as (num_nz·br, bc), plus the same columns of x's slab by
//     a TMA copy over x (M, K) — rows past M arrive as zeros, so nothing is
//     masked. 64-column slices are 128-byte swizzled (ldmatrix and wgmma
//     read them without bank conflicts). Full and empty mbarriers per stage;
//     the producer's lanes hold 32 bj values at a time, so no copy waits on
//     an index load.
//   * Filling the card: the host cuts each block row's tile range into
//     units once per pack (kernels/bcr_spmm_skip.py:skip_plan) so the grid
//     reaches the SM count wherever the tile count allows (at decode wq and
//     MLP wo have 16 block rows; a 2048-row projection at M = 8 gets its
//     units from single tiles or from 64-row slices of a tile). A split
//     block row's units write fp32 partials to a workspace and bump the
//     row's counter; the last to arrive sums the partials in split order (y
//     does not depend on arrival order: launches are bit-equal), writes y
//     and puts the counter back to 0 — one launch, no atomics on y.
//   * Load balance at prefill: unbalanced BCR gives block rows from 0 to
//     nb_c tiles. The units are launched longest first (the CTA order of
//     the plan), not walked by persistent CTAs: a CTA holds under half an
//     SM's shared memory and registers, so two run per SM and one's
//     prologue and epilogue overlap the other's products, and the longest
//     units start in the first wave, so the last wave holds short ones.
//
// fp32 x, or blocks the tensor-core body does not take — namespace
// cuda_core, unchanged from the first port: its 1e-4 tolerance rules out
// bf16 or TF32 operands, so it multiplies on the CUDA cores. Each CTA owns
// one (block row, 64-row output slice, M tile), stages 32-column slices of
// x and the tile as fp32 in padded shared memory (a two-stage register
// prefetch) and accumulates TM x 4 outputs a thread; any block shape and
// any M are legal. Bound by fp32 FMA throughput at prefill and by its
// nb_r-row grid at decode.

#include <string.h>

#include "hopper.cuh"

namespace cuda_core {


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
bcr_spmm_skip_kernel(const T* __restrict__ x, const T* __restrict__ tiles,
                     const int* __restrict__ bj,
                     const int* __restrict__ row_start, T* __restrict__ y,
                     int M, int K, int N, int br, int bc, int n_slices) {
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
  bcr_spmm_skip_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
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

}  // namespace cuda_core

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;                    // consumer warps; warp 8 copies
constexpr int kThreads = kWarps * 32 + 32;
constexpr int kUnit = 7;  // row, t0, t1, split, nsplit, first partial, counter

// The plan kernels/bcr_spmm_skip.py:skip_plan chose, in the order of its
// SkipPlan.args().
struct Plan {
  int wgmma, mt, rows, chunks, m_tiles, kc, stages, smem, n_units;
};

struct Shape {
  int M, K, N, br, bc;
  Plan p;
  int w_bytes, x_bytes, slot;   // one stage: tile slice (rows x kc), x (mt x kc)
  int off_bar, off_flag, total;
};

__host__ __device__ inline int up(int v, int q) { return (v + q - 1) / q * q; }

// Shared memory, as kernels/bcr_spmm_skip.py:skip_smem lays it out: the ring
// (128-byte-swizzled slices 1024-byte aligned), which the fp32 epilogue tile
// reuses, the full and empty mbarriers, a flag, 1024 bytes of alignment
// slack.
inline void make_layout(Shape& s) {
  const int align = s.p.kc == 64 ? 1024 : 128;
  s.w_bytes = up(s.p.rows * s.p.kc * 2, align);
  s.x_bytes = up(s.p.mt * s.p.kc * 2, align);
  s.slot = s.w_bytes + s.x_bytes;
  const int ring = s.p.stages * s.slot;
  const int epi = s.p.mt * (s.p.rows + 4) * 4;
  s.off_bar = up(ring > epi ? ring : epi, 16);
  s.off_flag = s.off_bar + up(2 * s.p.stages * 8, 16);
  s.total = s.off_flag + 16 + 1024;
}

// Shared address of 16-byte chunk c of row r in a staged slice of rb-byte
// rows (xmask 7: TMA's 128-byte swizzle, chunk XOR row mod 8; 0: dense).
__device__ __forceinline__ uint32_t at(uint32_t base, int r, int c, int rb,
                                       int xmask) {
  return base + r * rb + ((c ^ (r & xmask)) << 4);
}

// d (64 tile rows x 128 x rows per warpgroup, fp32, the m16n8 fragment
// layout over 16 n8 groups) += A (64 x k16, K-major) · B (k16 x 128,
// K-major), both by 128-byte-swizzled shared-memory descriptors.
__device__ __forceinline__ void wgmma_ss128(float (&d)[16][4], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accesses to d across an in-flight wgmma.
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA][4]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(d[a][q]));
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// One CTA: output rows [chunk·R, (chunk+1)·R) of a unit's block row (R =
// 16·SLABS) by x rows [m0, m0 + MT), over the unit's tiles. wgmma (WG):
// warpgroup g owns tile rows 64g..64g+63 by all 128 x rows. mma.sync:
// warp w owns the 16-row slab w % SLABS by NI n8 tiles of x rows, from
// n8 tile (w / SLABS)·NI. Warp kWarps is the producer.
template <int MT, int SLABS, bool WG>
__global__ void __launch_bounds__(kThreads, 2)
bcr_spmm_skip_tc(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const int* __restrict__ bj, const int* __restrict__ units,
                 bf16* __restrict__ y, float* __restrict__ ws,
                 int* __restrict__ counters, const Shape s) {
  constexpr int R = SLABS * 16;                 // tile rows of this CTA
  constexpr int NT = MT / 8;                    // n8 tiles over the M tile
  constexpr int WN = kWarps / SLABS;            // mma.sync: warps across M
  constexpr int NI = NT / WN > 0 ? NT / WN : 1; // mma.sync: n8 tiles a warp
  constexpr int NA = WG ? 16 : NI;
  static_assert(!WG || (MT == 128 && (SLABS == 4 || SLABS == 8)),
                "wgmma tile");
  static_assert(NI == 1 || NI % 2 == 0, "n8 tiles load in pairs");
  // active consumer warps: the warpgroups over R rows, or the mma.sync
  // warps whose n8 tiles lie inside the M tile
  constexpr int kActive = WG ? SLABS : (NT >= WN ? kWarps : SLABS * NT);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ST = s.p.stages, KC = s.p.kc;
  const int per_unit = s.p.chunks * s.p.m_tiles;
  const int* u = units + (size_t)(blockIdx.x / per_unit) * kUnit;
  const int ct = blockIdx.x % per_unit;
  const int chunk = ct / s.p.m_tiles, mtile = ct - chunk * s.p.m_tiles;
  const int row = u[0], t0 = u[1], t1 = u[2], nsplit = u[4];
  const int m0 = mtile * MT, mt = min(MT, s.M - m0);
  const int cpt = s.bc / KC;                    // stages per tile
  const int n_it = (t1 - t0) * cpt;
  const uint32_t full0 = smem_u32(smem + s.off_bar);
  const uint32_t empty0 = full0 + ST * 8;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      bar_init(full0 + st * 8, 1);
      bar_init(empty0 + st * 8, kActive);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NA][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;

  if (warp == kWarps) {
    // producer: stage `it` is slice it % cpt of tile t0 + it / cpt
    const int bytes = (R + MT) * KC * 2;
    int jv = 0;
    for (int it = 0; it < n_it; ++it) {
      const int tl = it / cpt, c = it - tl * cpt;
      if ((tl & 31) == 0 && c == 0) {
        const int t = t0 + tl + lane;
        jv = t < t1 ? __ldg(bj + t) : 0;
      }
      const int j = __shfl_sync(0xffffffffu, jv, tl & 31);
      const int st = it % ST;
      if (it >= ST) bar_wait(empty0 + st * 8, ((it / ST) - 1) & 1);
      if (lane == 0) {
        const uint32_t sl = smem_u32(smem + st * s.slot);
        const uint32_t bar = full0 + st * 8;
        bar_expect(bar, bytes);
        tma2d(sl, &wmap, c * KC, (t0 + tl) * s.br + chunk * R, bar);
        tma2d(sl + s.w_bytes, &xmap, j * s.bc + c * KC, m0, bar);
      }
      __syncwarp();
    }
  } else if (warp < kActive) {
    const int rb = KC * 2, xm = KC == 64 ? 7 : 0;
    const int slab = warp % SLABS, wn = warp / SLABS;
    const int arow = slab * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int akc = lane >> 4, bkc = (lane >> 3) & 1;
    const int brow = NI == 1 ? wn * 8 + (lane & 7)
                             : wn * NI * 8 + (lane >> 4) * 8 + (lane & 7);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ST;
      bar_wait(full0 + st * 8, (it / ST) & 1);
      const uint32_t wb = smem_u32(smem + st * s.slot), xb = wb + s.w_bytes;
      if constexpr (WG) {
        const uint64_t da = desc_sw128(wb + (warp >> 2) * 64 * 128);
        const uint64_t db = desc_sw128(xb);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss128(acc, da + 2 * ks, db + 2 * ks);
        wgmma_commit();
        wgmma_wait<1>();   // the previous stage's products are done
        fence_acc(acc);
        __syncwarp();
        if (it > 0 && lane == 0) bar_arrive(empty0 + ((it - 1) % ST) * 8);
      } else {
        for (int ks = 0; ks < KC / 16; ++ks) {
          uint32_t af[4];
          ldsm_x4(af, at(wb, arow, ks * 2 + akc, rb, xm));
          uint32_t bfr[NI][2];
          if (NI == 1) {
            ldsm_x2(bfr[0][0], bfr[0][1], at(xb, brow, ks * 2 + bkc, rb, xm));
          } else {
#pragma unroll
            for (int b = 0; b < NI / 2; ++b) {
              uint32_t r4[4];
              ldsm_x4(r4, at(xb, brow + b * 16, ks * 2 + bkc, rb, xm));
              bfr[2 * b][0] = r4[0];
              bfr[2 * b][1] = r4[1];
              bfr[(2 * b + 1) % NI][0] = r4[2];
              bfr[(2 * b + 1) % NI][1] = r4[3];
            }
          }
#pragma unroll
          for (int b = 0; b < NI; ++b) mma(acc[b], af, bfr[b][0], bfr[b][1]);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(empty0 + st * 8);
      }
    }
    if constexpr (WG) {
      wgmma_wait<0>();
      fence_acc(acc);
    }
  }

  // every stage consumed (each was waited on): the ring becomes the fp32
  // tile [m][n], row stride R + 4
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  constexpr int RS = R + 4;
  if (warp < kActive) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // wgmma: n8 group a of the warp's 16 rows; mma.sync: n8 tile a
        const int n = (WG ? warp : warp % SLABS) * 16 + (lane >> 2) +
                      (q >> 1) * 8;
        const int m = (WG ? a : (warp / SLABS) * NI + a) * 8 +
                      (lane & 3) * 2 + (q & 1);
        red[m * RS + n] = acc[a][q];
      }
  }
  __syncthreads();

  const int per = MT * R;
  const float* wt = nullptr;
  int* ctr = nullptr;
  if (nsplit > 1) {
    // this split's partial to the workspace; the last split of the row to
    // arrive sums all of them in split order
    float* wp = ws + ((size_t)(u[5] + u[3]) * per_unit + ct) * per;
    for (int e = tid; e < mt * (R / 4); e += kThreads) {
      const int m = e / (R / 4), n = (e - m * (R / 4)) * 4;
      *reinterpret_cast<float4*>(wp + m * R + n) =
          *reinterpret_cast<const float4*>(red + m * RS + n);
    }
    __threadfence();
    __syncthreads();
    ctr = counters + (size_t)u[6] * per_unit + ct;
    int* flag = reinterpret_cast<int*>(smem + s.off_flag);
    if (tid == 0) *flag = atomicAdd(ctr, 1) == nsplit - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
    wt = ws + ((size_t)u[5] * per_unit + ct) * per;
  }

  // emit: 8 consecutive outputs a thread, one 16-byte store
  const int n0 = row * s.br + chunk * R;
  const size_t stride = (size_t)per_unit * per;   // split q → q + 1
  for (int e = tid; e < mt * (R / 8); e += kThreads) {
    const int m = e / (R / 8), n = (e - m * (R / 8)) * 8;
    float4 a0, a1;
    if (wt != nullptr) {
      const float* p = wt + m * R + n;
      a0 = __ldcg(reinterpret_cast<const float4*>(p));
      a1 = __ldcg(reinterpret_cast<const float4*>(p + 4));
      for (int q = 1; q < nsplit; ++q) {
        const float* pq = p + q * stride;
        add4(a0, __ldcg(reinterpret_cast<const float4*>(pq)));
        add4(a1, __ldcg(reinterpret_cast<const float4*>(pq + 4)));
      }
    } else {
      a0 = *reinterpret_cast<const float4*>(red + m * RS + n);
      a1 = *reinterpret_cast<const float4*>(red + m * RS + n + 4);
    }
    *reinterpret_cast<uint4*>(y + (size_t)(m0 + m) * s.N + n0 + n) =
        make_uint4(pack_bf16(a0.x, a0.y), pack_bf16(a0.z, a0.w),
                   pack_bf16(a1.x, a1.y), pack_bf16(a1.z, a1.w));
  }
  if (ctr != nullptr && tid == 0) *ctr = 0;   // ready for the next call
}

template <int MT, int SLABS, bool WG>
int launch_cfg(const Shape& s, cudaStream_t stream, void** args) {
  static int smem_set = 0;   // per kernel: raise the limit once
  if (s.p.smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        bcr_spmm_skip_tc<MT, SLABS, WG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, s.p.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = s.p.smem;
  }
  const unsigned grid = (unsigned)s.p.n_units * s.p.chunks * s.p.m_tiles;
  cudaError_t err =
      cudaLaunchKernel((const void*)bcr_spmm_skip_tc<MT, SLABS, WG>,
                       dim3(grid), dim3(kThreads), args, s.p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled configurations: kernels/bcr_spmm_skip.py:skip_plan.
int dispatch(const Shape& s, cudaStream_t st, void** args) {
  const int mt = s.p.mt, sl = s.p.rows / 16;
  if (s.p.wgmma) {
    if (mt == 128 && sl == 4) return launch_cfg<128, 4, true>(s, st, args);
    if (mt == 128 && sl == 8) return launch_cfg<128, 8, true>(s, st, args);
    return (int)cudaErrorInvalidValue;
  }
#define SKIP_CFG(A, B) \
  if (mt == A && sl == B) return launch_cfg<A, B, false>(s, st, args);
  SKIP_CFG(8, 1) SKIP_CFG(8, 2) SKIP_CFG(8, 4) SKIP_CFG(8, 8)
  SKIP_CFG(16, 1) SKIP_CFG(16, 2) SKIP_CFG(16, 4) SKIP_CFG(16, 8)
  SKIP_CFG(64, 1) SKIP_CFG(64, 2) SKIP_CFG(64, 4) SKIP_CFG(64, 8)
#undef SKIP_CFG
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, tiles and y share it). The wrapper
// has checked the pack: bi sorted, row_start = the tile range of each block
// row, bj within the nb_c contraction blocks. plan: kernels/
// bcr_spmm_skip.py:SkipPlan.args() for the tensor-core body (bf16 only;
// units its (n_units, 7) int32 records, ws its fp32 workspace and counters
// its zeroed split counters, both null when nothing splits), or null for
// the CUDA-core body (units, ws, counters unused).
int bcr_spmm_skip_launch(int dtype, const void* x, const void* tiles,
                         const int* bj, const int* row_start, const int* units,
                         void* y, float* ws, int* counters, int M, int K,
                         int N, int nb_r, int nb_c, int br, int bc,
                         int num_nz, const int* plan, void* stream) {
  if (M <= 0 || nb_r <= 0 || nb_c <= 0 || br <= 0 || bc <= 0 ||
      nb_r * br != N || nb_c * bc != K || num_nz <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (plan == nullptr) {
    using namespace cuda_core;
    if ((M + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return launch_m<float>(x, tiles, bj, row_start, y, M, K, N, nb_r, br,
                             bc, st);
    if (dtype == 1)
      return launch_m<__nv_bfloat16>(x, tiles, bj, row_start, y, M, K, N,
                                     nb_r, br, bc, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  tc::Shape s;
  s.M = M; s.K = K; s.N = N; s.br = br; s.bc = bc;
  s.p = tc::Plan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
                 plan[6], plan[7], plan[8]};
  tc::make_layout(s);
  if (s.total != s.p.smem) return -1;   // plan and layout disagree
  if (s.p.rows % 16 || br % s.p.rows || s.p.chunks * s.p.rows != br ||
      bc % s.p.kc || s.p.m_tiles != (M + s.p.mt - 1) / s.p.mt ||
      s.p.stages < 2 || s.p.n_units <= 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)tiles % 16 || (uintptr_t)y % 16)
    return -2;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  const bool swz = s.p.kc == 64;
  if (!hopper::make_map(&xmap, x, M, K, s.p.mt, s.p.kc, swz) ||
      !hopper::make_map(&wmap, tiles, (uint64_t)num_nz * br, bc, s.p.rows,
                        s.p.kc, swz))
    return -3;
  void* args[] = {(void*)&xmap, (void*)&wmap, (void*)&bj, (void*)&units,
                  (void*)&y, (void*)&ws, (void*)&counters, (void*)&s};
  return tc::dispatch(s, st, args);
}

}  // extern "C"

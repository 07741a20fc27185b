// Fused flash attention on the merged-head layout, written for Hopper
// (sm_90a), bound to Python through ctypes (kernels/flash_attention.py).
//
// Replaces the reference package's TPU kernel flash_attention_fused (body
// _kernel) in kernels/flash_attention.py, the cold-prefill attention of
// attn_impl="pallas".
//
// What it computes: for each row b of B·H, out[b] = softmax(q[b] k[b]^T ·
// D**-0.5) v[b] over q (Sq, D) and k, v (Skv, D), fp32 online softmax, and
// with `causal` query row i at absolute position q_offset + i sees key
// positions <= its own. The result is acc / max(l, 1e-30), in q's dtype.
// GQA callers repeat K/V to all q heads first, as the reference does.
//
// Two bodies.
//
// bf16 (the serving path) — namespace tc, FlashAttention-2 on the tensor
// cores. What bounds it on this card: at the serving shapes (S <= 512, D =
// 64) the two products, 4·Sq·Skv·D operations a head (half of that under
// causal), and the softmax between them; the bytes (one read of q, k, v
// and one write of out) are far below that. What the design does:
//   * A CTA of 4 warps (one warpgroup) owns 128 query rows, two 16-row
//     slabs a warp (64 and one slab at head_dim 128, for registers), and
//     walks the key tiles of 64 rows itself (the TPU's sequential kv grid
//     axis becomes a loop). The loop stops at the tile holding the causal
//     diagonal of the CTA's last query row (q_offset included):
//     fully-future tiles are never loaded. Only the tiles that cross the
//     diagonal or the end of the keys are masked.
//   * Head_dim 64, the serving width: both products on wgmma m64n64k16,
//     one 64-row slab per instruction. S = Q·K^T reads Q and K (K-major)
//     from shared memory by 128-byte-swizzled descriptors; O += P·V takes P
//     from registers and V by descriptor as an MN-major B (the transpose
//     bit; 8-key groups 1024 bytes apart). No operand goes through
//     ldmatrix, and at 164 registers a thread three CTAs share an SM.
//     Other head dims: mma.sync m16n8k16, the warp's Q fragments in
//     registers, K by ldmatrix and V by ldmatrix.trans, each fragment
//     feeding both slabs' MMAs.
//   * The online softmax runs on the S accumulator in registers (the wgmma
//     and mma.sync fragments agree lane for lane): a row's values live in
//     one quad of lanes, so the row max takes two shuffles; each lane keeps
//     its part of the row sum and the quad adds them once at the end. exp2
//     with log2(e) folded into the scale: exp2(s·scale·log2 e − m) =
//     exp(s·scale − m'), one multiply fewer per score, on the hardware's
//     ex2.approx (relative error ~2^-22, far inside the bf16 tolerance).
//   * P never touches shared memory: the S accumulator of two n8 key tiles
//     is, lane for lane, the A fragment of a k16 step of P·V, so it is
//     repacked to bf16 in registers.
//   * Q, K and V tiles come by cp.async (rows past the end zero-filled, so
//     no NaN reaches P·V) into a three-stage ring, rows XOR-swizzled in
//     16-byte chunks (at head_dim 64 exactly the 128-byte swizzle of the
//     descriptors), so neither ldmatrix nor wgmma meets bank conflicts: the
//     next two key tiles are in flight while this one is used, one barrier
//     a tile.
//   * Under `causal` the heaviest q tiles are launched first (the CTA
//     order is q-tile-major, last q tile first, over all B·H rows), so the
//     last wave holds short CTAs; without it every tile weighs the same and
//     the order is B·H-major, so a row's q tiles share its K/V in L2. The
//     order does not change any output.
//   * What bounds it now (read from the card's timings; no profiler runs
//     there): the chain inside the warpgroup — a tile's S products, then
//     its softmax, then its P·V products, each waiting on the one before.
//     Issuing tile t + 1's S ahead of tile t's softmax was not faster (its
//     registers cost occupancy); two consumer warpgroups whose softmax and
//     products alternate are the next step.
//
// fp32 — namespace cuda_core, unchanged from the first port: its 1e-4
// tolerance rules out bf16 or TF32 operands, so both products run on the
// CUDA cores (67 TFLOP/s), Q, K and V staged as fp32 in padded shared
// memory, the probabilities through shared memory to the P·V product.

#include "hopper.cuh"

namespace cuda_core {


constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // key rows per tile
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // logits columns per thread
constexpr float kNegInf = -1e30f;

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

struct FlashShape {
  int BH, Sq, Skv, causal, q_offset;
  float scale;
};

// q tile and K tile (rows padded by one word), V tile, probabilities (rows
// padded by one word), in bytes
template <int D>
constexpr size_t smem_bytes() {
  return 4 * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
              (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

// max / sum over the 16 lanes of a half-warp (xor offsets below 16 stay
// inside it)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const FlashShape s) {
  constexpr int kDP = D + 1;                 // padded q / K row
  constexpr int kPP = kBK + 1;               // padded probability row
  constexpr int kDJ = D / 16;                // output columns per thread
  constexpr int kEPV = 16 / sizeof(T);       // elements per 16-byte vector
  constexpr int kRowVecs = D / kEPV;
  constexpr int kTileVecs = kBK * kRowVecs;
  constexpr int kVecs = (kTileVecs + kThreads - 1) / kThreads;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kDP;
  float* vs = ks + kBK * kDP;
  float* ps = vs + kBK * D;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = q + (size_t)bh * s.Sq * D;
  const T* kb = k + (size_t)bh * s.Skv * D;
  const T* vb = v + (size_t)bh * s.Skv * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    qs[r * kDP + d] =
        q0 + r < s.Sq ? to_f(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  // key extent: under `causal` nothing past the last query row's diagonal
  const int q_last = min(q0 + kBQ, s.Sq) - 1;
  const int kv_end = s.causal ? min(s.Skv, s.q_offset + q_last + 1) : s.Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  float m[kRows], l[kRows], o[kRows][kDJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kDJ; ++jd) o[i][jd] = 0.f;
  }

  uint4 kreg[kVecs], vreg[kVecs];
  auto fetch = [&](int t) {
    const int k0 = t * kBK;
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int vi = tid + u * kThreads;
      if (vi < kTileVecs) {
        const int row = vi / kRowVecs, w = vi - row * kRowVecs;
        if (k0 + row < s.Skv) {
          const size_t off = (size_t)(k0 + row) * kRowVecs + w;
          kreg[u] = __ldg(reinterpret_cast<const uint4*>(kb) + off);
          vreg[u] = __ldg(reinterpret_cast<const uint4*>(vb) + off);
        } else {
          kreg[u] = make_uint4(0, 0, 0, 0);
          vreg[u] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  };
  if (n_tiles > 0) fetch(0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's readers are done with ks/vs/ps
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int vi = tid + u * kThreads;
      if (vi < kTileVecs) {
        const int row = vi / kRowVecs, w = vi - row * kRowVecs;
        const T* ke = reinterpret_cast<const T*>(&kreg[u]);
        const T* ve = reinterpret_cast<const T*>(&vreg[u]);
#pragma unroll
        for (int e = 0; e < kEPV; ++e) {
          ks[row * kDP + w * kEPV + e] = to_f(ke[e]);
          vs[row * D + w * kEPV + e] = to_f(ve[e]);
        }
      }
    }
    __syncthreads();
    if (t + 1 < n_tiles) fetch(t + 1);   // in flight while this tile is used

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * kDP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * kDP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = s.q_offset + q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < s.Skv && (!s.causal || kpos <= qpos);
        sc[i][j] = ok ? sc[i][j] * s.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[r * kPP + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < kDJ; ++jd) o[i][jd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kDJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kPP + c];
#pragma unroll
      for (int jd = 0; jd < kDJ; ++jd) vv[jd] = vs[c * D + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jd = 0; jd < kDJ; ++jd) o[i][jd] = fmaf(pv[i], vv[jd], o[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < kDJ; ++jd)
      out[((size_t)bh * s.Sq + r) * D + tx + 16 * jd] = from_f<T>(o[i][jd] * inv);
  }
}

template <typename T, int D>
int launch(const FlashShape& s, void** args, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s.Sq + kBQ - 1) / kBQ, s.BH);
  err = cudaLaunchKernel((const void*)flash_attention_kernel<T, D>, grid,
                         dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const FlashShape& s, void** args, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(s, args, stream);
    case 32: return launch<T, 32>(s, args, stream);
    case 64: return launch<T, 64>(s, args, stream);
    case 128: return launch<T, 128>(s, args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cuda_core

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;            // key rows per tile
constexpr int kStages = 3;         // K/V tiles in the cp.async ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FlashShape {
  int BH, Sq, Skv, causal, q_offset, heavy_first;
  float scale;
};

// 16-row slabs a warp owns: two up to head_dim 64 (each K and V fragment
// read from shared memory feeds two MMAs), one at 128 (registers).
template <int D>
__host__ __device__ constexpr int slabs() {
  return D <= 64 ? 2 : 1;
}

// query rows per CTA
template <int D>
__host__ __device__ constexpr int q_rows() {
  return 16 * kWarps * slabs<D>();
}

// Shared memory: the q tile, then kStages K tiles and kStages V tiles,
// all bf16, and 1024 bytes of alignment slack.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (q_rows<D>() + 2 * kStages * kBK) * D * 2 + 1024;
}

// Both products on wgmma at head_dim 64, where a tile row is one 128-byte
// swizzle span (the tiles' XOR layout is then exactly the 128-byte swizzle
// wgmma's descriptors read); mma.sync at the other head dims.
template <int D>
__host__ __device__ constexpr bool wgmma_body() {
  return D == 64;
}

// Rows [r0, r0 + R) of a (S, D) bf16 matrix into a swizzled tile.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int r0, int S, int tid) {
  constexpr int CPR = D / 8;   // 16-byte chunks a row
  for (int e = tid; e < R * CPR; e += kThreads) {
    const int r = e / CPR, c = e - r * CPR;
    const bool ok = r0 + r < S;
    cp16(dst + off<D>(r, c), src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// d (64 query rows x 64 keys, fp32, the m16n8 fragment layout over 8 n8
// groups) += Q (64 x k16) · K^T (k16 x 64), both K-major by 128-byte-
// swizzled descriptors.
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 query rows x 64 head dims) += P (64 x k16 keys, bf16 registers in
// the m16n8k16 A layout) · V (k16 keys x 64 dims from shared memory, rows
// of dims: MN-major, so the transpose bit; 8-key groups 1024 bytes apart).
__device__ __forceinline__ void wgmma_rs64t(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(db));
}

template <int A, int B>
__device__ __forceinline__ void fence_regs(float (&d)[A][B][4]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][j][e]));
}

// CTAs an SM, as the register bound asks: three at head_dim 64, else two
template <int D>
__host__ __device__ constexpr int ctas_per_sm() {
  return wgmma_body<D>() ? 3 : 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<D>())
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   const FlashShape s) {
  constexpr int SL = slabs<D>();
  constexpr int BQ = q_rows<D>();
  constexpr int KS = D / 16;   // k16 steps over D (S = Q·K^T)
  constexpr int ND = D / 8;    // n8 tiles over D (O = P·V)
  constexpr int NK = kBK / 8;  // n8 tiles over a key tile
  constexpr int TILE = kBK * D * 2;
  constexpr bool WG = wgmma_body<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  // 1024-byte aligned: wgmma reads the tiles as 128-byte-swizzled operands
  const uint32_t qs =
      smem_u32(smem) + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const uint32_t ks = qs + BQ * D * 2;   // the K stages, then the V stages
  const uint32_t vs = ks + kStages * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // CTA order (chosen by the launcher): heavy_first is q-tile-major over
  // all B·H rows, the last q tile first; otherwise B·H-major, so one row's
  // q tiles run together while its K/V is in L2
  const int n_qt = (s.Sq + BQ - 1) / BQ;
  int bh, qt;
  if (s.heavy_first) {
    qt = n_qt - 1 - (int)(blockIdx.x / s.BH);
    bh = blockIdx.x % s.BH;
  } else {
    bh = blockIdx.x / n_qt;
    qt = blockIdx.x % n_qt;
  }
  const int q0 = qt * BQ;
  const bf16* qb = q + (size_t)bh * s.Sq * D;
  const bf16* kb = k + (size_t)bh * s.Skv * D;
  const bf16* vb = v + (size_t)bh * s.Skv * D;

  // key extent: under `causal` nothing past the last query row's diagonal
  const int q_last = min(q0 + BQ, s.Sq) - 1;
  const int kv_end = s.causal ? min(s.Skv, s.q_offset + q_last + 1) : s.Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  // one commit group per tile (empty past the last), so group counts stay
  // uniform: the q tile, then key tiles 0 .. kStages-2 in flight
  load_tile<D, BQ>(qs, qb, q0, s.Sq, tid);
  cp_commit();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      load_tile<D, kBK>(ks + t * TILE, kb, t * kBK, s.Skv, tid);
      load_tile<D, kBK>(vs + t * TILE, vb, t * kBK, s.Skv, tid);
    }
    cp_commit();
  }
  cp_wait<kStages - 1>();   // the q tile
  __syncthreads();

  // slab sl of warp w: query rows 64·sl + 16·w .. +16 of the tile
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t qf[SL][WG ? 1 : KS][4];   // mma.sync: Q stays in registers
  if constexpr (!WG) {
#pragma unroll
    for (int sl = 0; sl < SL; ++sl)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[sl][kk], qs + off<D>(sl * 64 + warp * 16 + a_row,
                                        2 * kk + (lane >> 4)));
  }

  float o[SL][ND][4];
  float m[SL][2], l[SL][2];   // rows g and g + 8 of each slab
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[sl][j][e] = 0.f;
    m[sl][0] = m[sl][1] = kNegInf;
    l[sl][0] = l[sl][1] = 0.f;
  }
  const float sl2 = s.scale * kLog2e;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int qpos = s.q_offset + q0 + warp * 16 + g;   // slab 0's row g
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_chunk = lane >> 4;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kStages - 2>();
    // wgmma reads the copied tiles through the async proxy
    if (WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    const int nxt = t + kStages - 1;   // into tile t - 1's stage
    if (nxt < n_tiles) {
      const int b = nxt % kStages;
      load_tile<D, kBK>(ks + b * TILE, kb, nxt * kBK, s.Skv, tid);
      load_tile<D, kBK>(vs + b * TILE, vb, nxt * kBK, s.Skv, tid);
    }
    cp_commit();
    const int cur = t % kStages;
    const uint32_t kt = ks + cur * TILE, vt = vs + cur * TILE;

    // S = Q·K^T
    float sc[SL][NK][4];
#pragma unroll
    for (int sl = 0; sl < SL; ++sl)
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[sl][j][e] = 0.f;
    if constexpr (WG) {
      const uint64_t db = desc_sw128(kt);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        const uint64_t da = desc_sw128(qs + sl * 64 * 128);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss64(sc[sl], da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
    } else {
      // each K fragment feeds every slab
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jp = 0; jp < NK / 2; ++jp) {
          uint32_t r4[4];
          ldsm_x4(r4, kt + off<D>(jp * 16 + k_row, 2 * kk + k_chunk));
#pragma unroll
          for (int sl = 0; sl < SL; ++sl) {
            mma(sc[sl][2 * jp], qf[sl][kk], r4[0], r4[1]);
            mma(sc[sl][2 * jp + 1], qf[sl][kk], r4[2], r4[3]);
          }
        }
    }

    // scale into log2 units; mask only a tile crossing the diagonal or the
    // end of the keys
    const int k0 = t * kBK;
    const bool edge = k0 + kBK > s.Skv ||
                      (s.causal && k0 + kBK - 1 > s.q_offset + q0);
    uint32_t pf[SL][NK / 2][4];   // P, as the A fragments of P·V's k16 steps
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[sl][j][e] * sl2;
          if (edge) {
            const int kpos = k0 + j * 8 + c2 + (e & 1);
            if (kpos >= s.Skv ||
                (s.causal && kpos > qpos + sl * 64 + (e >> 1) * 8))
              x = kNegInf;
          }
          sc[sl][j][e] = x;
        }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[sl][j][0], sc[sl][j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[sl][j][2], sc[sl][j][3]));
      }
      const float mn0 = fmaxf(m[sl][0], quad_max(mx0));
      const float mn1 = fmaxf(m[sl][1], quad_max(mx1));
      const float al0 = ex2(m[sl][0] - mn0), al1 = ex2(m[sl][1] - mn1);
      m[sl][0] = mn0;
      m[sl][1] = mn1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float p0 = ex2(sc[sl][j][0] - mn0);
        const float p1 = ex2(sc[sl][j][1] - mn0);
        const float p2 = ex2(sc[sl][j][2] - mn1);
        const float p3 = ex2(sc[sl][j][3] - mn1);
        s0 += p0 + p1;
        s1 += p2 + p3;
        pf[sl][j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[sl][j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l[sl][0] = l[sl][0] * al0 + s0;
      l[sl][1] = l[sl][1] * al1 + s1;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[sl][j][0] *= al0;
        o[sl][j][1] *= al0;
        o[sl][j][2] *= al1;
        o[sl][j][3] *= al1;
      }
    }

    // O += P·V
    if constexpr (WG) {
      const uint64_t db = desc_sw128(vt);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < SL; ++sl)
#pragma unroll
        for (int kk = 0; kk < NK / 2; ++kk)
          wgmma_rs64t(o[sl], pf[sl][kk], db + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    } else {
      // each V fragment feeds every slab
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk)
#pragma unroll
        for (int jp = 0; jp < ND / 2; ++jp) {
          uint32_t r4[4];
          ldsm_x4_trans(r4, vt + off<D>(kk * 16 + v_row, 2 * jp + v_chunk));
#pragma unroll
          for (int sl = 0; sl < SL; ++sl) {
            mma(o[sl][2 * jp], pf[sl][kk], r4[0], r4[1]);
            mma(o[sl][2 * jp + 1], pf[sl][kk], r4[2], r4[3]);
          }
        }
    }
  }

  bf16* ob = out + (size_t)bh * s.Sq * D;
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {
    const float inv0 = 1.f / fmaxf(quad_sum(l[sl][0]), 1e-30f);
    const float inv1 = 1.f / fmaxf(quad_sum(l[sl][1]), 1e-30f);
    const int r0 = q0 + sl * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = j * 8 + c2;
      if (r0 < s.Sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + d) =
            pack_bf16(o[sl][j][0] * inv0, o[sl][j][1] * inv0);
      if (r0 + 8 < s.Sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8) * D + d) =
            pack_bf16(o[sl][j][2] * inv1, o[sl][j][3] * inv1);
    }
  }
}

template <int D>
int launch(const FlashShape& s, const void* q, const void* k, const void* v,
           void* out, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // within a CTA's 227 KB, and ctas_per_sm CTAs share an SM's 228 KB (1 KB
  // of each reserved)
  static_assert(smem <= 232448, "flash tile does not fit a CTA");
  static_assert(ctas_per_sm<D>() * (smem + 1024) <= 233472,
                "flash CTAs do not share an SM");
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const long long grid =
      (long long)((s.Sq + q_rows<D>() - 1) / q_rows<D>()) * s.BH;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, (void*)&out, (void*)&s};
  cudaError_t err = cudaLaunchKernel((const void*)flash_attention_tc<D>,
                                     dim3((unsigned)grid), dim3(kThreads),
                                     args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body); q,
// k, v and out share it. D in {16, 32, 64, 128}; q (BH, Sq, D), k / v (BH,
// Skv, D), all contiguous and 16-byte aligned. The bf16 CTA order is the
// heaviest q tiles first under `causal`; bh_major != 0 forces the B·H-major
// order instead (only to show that the order changes no output).
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int BH, int Sq, int Skv,
                           int D, int causal, int q_offset, int bh_major,
                           float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    cuda_core::FlashShape s;
    s.BH = BH; s.Sq = Sq; s.Skv = Skv; s.causal = causal;
    s.q_offset = q_offset; s.scale = scale;
    void* args[] = {(void*)&q, (void*)&k, (void*)&v, (void*)&out, (void*)&s};
    return cuda_core::launch_d<float>(D, s, args, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  tc::FlashShape s;
  s.BH = BH; s.Sq = Sq; s.Skv = Skv; s.causal = causal;
  s.q_offset = q_offset; s.heavy_first = causal && !bh_major; s.scale = scale;
  switch (D) {
    case 16: return tc::launch<16>(s, q, k, v, out, st);
    case 32: return tc::launch<32>(s, q, k, v, out, st);
    case 64: return tc::launch<64>(s, q, k, v, out, st);
    case 128: return tc::launch<128>(s, q, k, v, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

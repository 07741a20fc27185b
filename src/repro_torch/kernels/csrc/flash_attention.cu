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
// What bounds it on this card: at the serving shapes (S <= 512, D = 64)
// the fp32 multiply-adds of the two products, since this version runs them
// on the CUDA cores (67 TFLOP/s), not the tensor cores; the bytes (one read
// of q, k, v and one write of out) are far below that.
//
// Design: one CTA of 256 threads per (row b, tile of kBQ = 64 query rows).
// It walks the key tiles of kBK = 64 rows itself — the TPU's sequential kv
// grid axis becomes a loop — and its loop bound stops at the tile holding
// the causal diagonal of its last query row (q_offset included), so fully-
// future tiles are never loaded at all (the TPU kernel still copies them
// and skips only their compute). Each key tile's K and V rows are staged
// in shared memory as fp32 (K rows padded by one word so 16 lanes reading
// 16 rows hit 16 banks); the next tile is loaded into registers with
// 16-byte loads while the current one is used. Thread (ty, tx), 16 x 16,
// owns query rows ty + 16 i (i < 4) and key columns tx + 16 j (j < 4) of
// the logits tile, reduces row max and sum over its 16-lane half-warp with
// shuffles, and keeps m, l and its 4 x D/16 slice of the fp32 output
// accumulator in registers; the probabilities go through shared memory to
// the P·V product. Rows and keys past the ends are masked, so any Sq, Skv
// work; head_dim is a template constant (16, 32, 64 or 128).
//
// Known limit: CUDA-core products; wgmma on the tensor cores and a TMA
// ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); D in
// {16, 32, 64, 128}; q (BH, Sq, D), k / v (BH, Skv, D), all contiguous and
// 16-byte aligned.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int BH, int Sq, int Skv,
                           int D, int causal, int q_offset, float scale,
                           void* stream) {
  FlashShape s;
  s.BH = BH; s.Sq = Sq; s.Skv = Skv; s.causal = causal;
  s.q_offset = q_offset; s.scale = scale;
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, (void*)&out, (void*)&s};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(D, s, args, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(D, s, args, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

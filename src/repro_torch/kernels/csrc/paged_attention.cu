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
// pos <= its own, read through the slot's block table, with the scale
// D**-0.5 and fp32 online softmax; the result is acc / max(l, 1e-30).
//
// Two forms, one template: the fp form reads pages in q's dtype; the int8
// form (the reference's quantized serving, kv_dtype="int8") reads int8
// codes plus the per-row, per-kv-head fp32 scales of the sibling
// (n_pages, page_size, Hkv) pools. As in the reference's kernel, q stays
// floating, the logits are formed on the codes and each logit column is
// multiplied by its row's k_scale; each probability column is multiplied
// by its row's v_scale before the P·V sum (the softmax denominator uses
// the unscaled probabilities); accumulation stays fp32 and the output is
// in q's dtype.
//
// What bounds it on this card: the K/V page bytes of the live pages (each
// read once per kv-head and row tile: Hkv·D·2 bytes per row per K or V in
// bf16, Hkv·(D + 4) under int8); at decode there are only G = 4 query
// rows per page read, so it is far below the tensor cores' balance point.
//
// Design: one CTA per (slot, kv-head, row tile). The CTA reads its slot's
// block table itself and walks only the live pages,
// p < ceil(total_len[b] / page_size) — on the TPU a clamped index map
// elides the dead pages' copies; here the loop bound does that job, so the
// bytes read follow each slot's own length, not the table width. Per page it
// stages K and V of its kv-head in shared memory (fp32), forms the masked
// (rows, page_size) logits, updates the fp32 running max m and denominator l
// with one warp per row, and rescales the fp32 accumulator. A slot with
// total_len 0 visits no page and emits zeros. The next live page's K and V
// rows are loaded into registers (16-byte loads) while the current page is
// used, so each CTA pays the device-memory latency about once, not once per
// page; head dims that are not 16-byte multiples, or pages too large for the
// registers, take the same loop with plain loads.
// Known limit: B × Hkv CTAs (64 at 8 slots × 8 kv-heads) leave half the
// card's SMs idle, and each walks its slot's pages alone; splitting the pages
// of a long slot across CTAs (with a second pass to merge the partial
// softmaxes) and the tensor cores for long suffix blocks are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kPageVecs = 4;   // 16-byte K (and V) vectors a thread prefetches
constexpr float kNegInf = -1e30f;

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

struct AttnShape {
  int B, S, H, Hkv, D, page_size, n_cols, row_tile;
  float scale;
  int vec;   // 1: registers-pipelined 16-byte page loads; 0: plain loads
};

// q tile, K page (rows padded by one word), V page, logits, accumulator,
// the per-row m / l / alpha and the page's K and V row scales (int8 form),
// in 4-byte words
__host__ __device__ inline size_t smem_words(const AttnShape& s) {
  return (size_t)s.row_tile * s.D + (size_t)s.page_size * (s.D + 1) +
         (size_t)s.page_size * s.D + (size_t)s.row_tile * s.page_size +
         (size_t)s.row_tile * s.D + 3 * (size_t)s.row_tile +
         2 * (size_t)s.page_size;
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
                       const AttnShape s) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = s.H / s.Hkv;
  const int rows = s.S * G;
  const int r0 = blockIdx.z * s.row_tile;
  const int nr = min(s.row_tile, rows - r0);
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

  const int plen = prefix_len[b];
  const int tlen = total_len[b];
  const int live = tlen > 0 ? min((tlen + ps - 1) / ps, s.n_cols) : 0;
  const size_t row_stride = (size_t)s.Hkv * D;

  // register pipeline: the next live page's K and V rows of this kv-head
  // (and, int8 form, their scales) are loaded (16-byte vectors) while the
  // current page is used
  constexpr int kEPV = 16 / sizeof(TP);
  const int dv = D / kEPV;                     // vectors per page row
  uint4 kreg[kPageVecs], vreg[kPageVecs];
  float kscr = 0.f, vscr = 0.f;
  auto fetch = [&](int p) {
    const size_t page = (size_t)block_tables[(size_t)b * s.n_cols + p];
#pragma unroll
    for (int u = 0; u < kPageVecs; ++u) {
      const int v = tid + u * kThreads;
      if (v < ps * dv) {
        const int t = v / dv, w = v - t * dv;
        const size_t off =
            ((page * ps + t) * row_stride + (size_t)h * D) / kEPV + w;
        kreg[u] = __ldg(reinterpret_cast<const uint4*>(k_pages) + off);
        vreg[u] = __ldg(reinterpret_cast<const uint4*>(v_pages) + off);
      }
    }
    if (kQuant && tid < ps) {
      const size_t so = (page * ps + tid) * s.Hkv + h;
      kscr = __ldg(k_scale + so);
      vscr = __ldg(v_scale + so);
    }
  };
  if (s.vec && live > 0) fetch(0);

  // logits work split: S lanes share one (row, position) dot over D
  int S = 1;
  while (S < 4 && nr * ps * S * 2 <= kThreads) S *= 2;

  for (int p = 0; p < live; ++p) {
    __syncthreads();   // previous page's readers are done with ks / vs / sc
    if (s.vec) {
#pragma unroll
      for (int u = 0; u < kPageVecs; ++u) {
        const int v = tid + u * kThreads;
        if (v < ps * dv) {
          const int t = v / dv, w = v - t * dv;
          const TP* ke = reinterpret_cast<const TP*>(&kreg[u]);
          const TP* ve = reinterpret_cast<const TP*>(&vreg[u]);
#pragma unroll
          for (int q = 0; q < kEPV; ++q) {
            ks[t * kd + w * kEPV + q] = to_f(ke[q]);
            vs[t * D + w * kEPV + q] = to_f(ve[q]);
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
        const size_t off = (page * ps + t) * row_stride + (size_t)h * D + d;
        ks[t * kd + d] = to_f(k_pages[off]);
        vs[idx] = to_f(v_pages[off]);
      }
      if (kQuant)
        for (int t = tid; t < ps; t += kThreads) {
          const size_t so = (page * ps + t) * s.Hkv + h;
          ksc[t] = k_scale[so];
          vsc[t] = v_scale[so];
        }
    }
    __syncthreads();
    if (s.vec && p + 1 < live) fetch(p + 1);

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
        const int qpos = plen + (r0 + rr) / G;
        if (kQuant) dot *= ksc[t];    // the K scale folds into the column
        sc[item] = (p * ps + t <= qpos) ? dot * s.scale : kNegInf;
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

  for (int idx = tid; idx < nr * D; idx += kThreads) {
    const int rr = idx / D, d = idx - rr * D;
    const int r = r0 + rr, si = r / G, g = r - si * G;
    out[(((size_t)b * s.S + si) * s.H + h * G + g) * D + d] =
        from_f<T>(acc[idx] / fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T, typename TP>
int launch(const AttnShape& s, void** args, cudaStream_t stream) {
  const size_t smem = smem_words(s) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = s.S * (s.H / s.Hkv);
  dim3 grid(s.B, s.Hkv, (rows + s.row_tile - 1) / s.row_tile);
  err = cudaLaunchKernel((const void*)paged_attention_kernel<T, TP>, grid,
                         dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

AttnShape make_shape(int B, int S, int H, int Hkv, int D, int page_size,
                     int n_cols, int row_tile, float scale) {
  AttnShape s;
  s.B = B; s.S = S; s.H = H; s.Hkv = Hkv; s.D = D; s.page_size = page_size;
  s.n_cols = n_cols; s.row_tile = row_tile; s.scale = scale; s.vec = 0;
  return s;
}

// The register pipeline needs 16-byte page rows and pages small enough for
// the per-thread prefetch registers (one scale per thread, int8 form).
int pipelined(const AttnShape& s, int elem, const void* k, const void* v) {
  const int epv = 16 / elem;
  return ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0) &&
         s.D % epv == 0 && s.page_size * s.D / epv <= kPageVecs * kThreads &&
         s.page_size <= kThreads;
}

}  // namespace

extern "C" {

long long paged_attention_smem_bytes(int D, int page_size, int row_tile) {
  AttnShape s = make_shape(0, 0, 0, 0, D, page_size, 0, row_tile, 0.f);
  return (long long)smem_words(s) * 4;
}

// dtype: 0 = float32, 1 = bfloat16 (q and out share it). int8_pages = 0:
// pages in q's dtype, scales unused; 1: int8 pages with (n_pages,
// page_size, Hkv) fp32 k_scale / v_scale pools.
int paged_attention_launch(int dtype, int int8_pages, const void* q,
                           const void* k_pages, const void* v_pages,
                           const float* k_scale, const float* v_scale,
                           const int* block_tables, const int* prefix_len,
                           const int* total_len, void* out, int B, int S,
                           int H, int Hkv, int D, int page_size, int n_cols,
                           int row_tile, float scale, void* stream) {
  AttnShape s = make_shape(B, S, H, Hkv, D, page_size, n_cols, row_tile, scale);
  s.vec = pipelined(s, int8_pages ? 1 : (dtype == 0 ? 4 : 2), k_pages,
                    v_pages);
  void* args[] = {(void*)&q, (void*)&k_pages, (void*)&v_pages,
                  (void*)&k_scale, (void*)&v_scale, (void*)&block_tables,
                  (void*)&prefix_len, (void*)&total_len, (void*)&out,
                  (void*)&s};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && !int8_pages) return launch<float, float>(s, args, st);
  if (dtype == 1 && !int8_pages)
    return launch<__nv_bfloat16, __nv_bfloat16>(s, args, st);
  if (dtype == 0 && int8_pages) return launch<float, int8_t>(s, args, st);
  if (dtype == 1 && int8_pages)
    return launch<__nv_bfloat16, int8_t>(s, args, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

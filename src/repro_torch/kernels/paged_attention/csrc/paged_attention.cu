// Paged attention for Hopper (sm_90a): the decode step and the
// multi-query prefill chunk of the paged continuous engine.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention/
// paged_attention.py: `_paged_kernel` (one query per request, the decode
// step) with `paged_decode`, and `_paged_mq_kernel` (a block of K queries
// per request, query j at position lengths[b] - K + j; the prefill chunk
// with lengths = pos0 + C) with `paged_mq`.
//
// What bounds it on this card: bytes. Each K/V page holds bs tokens of one
// kv head; the work per page is 4 * rows * bs * hd flops against
// 2 * bs * hd * itemsize bytes, far below the ~295 flop/byte the H100
// needs before its tensor cores are the limit. The design therefore reads
// every needed K/V page of a request once per CTA and no page it does not
// need:
//   * One CTA serves one (request b, kv head g) and ALL the R = H / Hkv
//     query heads of that group (for gemma-2b's MQA: all 8 heads), so a
//     page is fetched from device memory once per request, not once per
//     query head. The multi-query kernel adds a third grid axis over tiles
//     of query positions; every (query, head) row of a CTA shares the
//     staged K/V tile.
//   * The table walk stops at the last block the CTA's queries can see
//     (ceil((qpos_max + 1) / bs)), starts at the first block inside the
//     sliding window, and skips -1 entries, so the data decides how many
//     pages are read.
//   * K and V tiles are staged in shared memory with 16-byte vector loads
//     and converted to float32 there; scores, the online-softmax running
//     max / sum and the accumulator are float32.
// Not yet done (later work): cp.async/TMA double buffering, wgmma for the
// q.k and p.v products, and split-K over long contexts to fill more SMs
// when the batch is small.
//
// Rows that can see no token (lengths <= 0, an all -1 table) write zeros:
// finite garbage that the serving engine discards.
//
// Both kernels share one device body, so paged_mq at K = 1 reduces in the
// same order as paged_decode and is bit-identical to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

struct Params {
  const void* q;        // (B, K, H, hd) — decode: K = 1
  const void* k;        // (P, bs, Hkv, hd)
  const void* v;        // (P, bs, Hkv, hd)
  const int* tables;    // (B, NB), -1 = absent
  const int* lengths;   // (B,)
  void* out;            // same layout as q
  int B, H, Hkv, hd, bs, NB, K, qt, window;
  float softcap, scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T -> float32 values.
__device__ __forceinline__ void unpack16(const uint4& u, const float*,
                                         float* o) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, const __nv_bfloat16*,
                                         float* o) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the top half of an f32
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage rows [0, bs) of one page (row stride `stride` elements, hd
// contiguous elements each) into dst (bs x hd float32).
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int bs,
                                           int hd, int stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = hd / kVec;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < bs * vpr; idx += blockDim.x) {
    const int t = idx / vpr;
    const int c = idx - t * vpr;
    const uint4 u =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)t * stride) + c);
    float f[kVec];
    unpack16(u, src, f);
    float4* d4 = reinterpret_cast<float4*>(dst + t * hd + c * kVec);
#pragma unroll
    for (int e = 0; e < kVec / 4; ++e)
      d4[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
  }
}

// One CTA: request b, kv head g, query positions [j0, j0 + nq). Rows are
// (query, head) pairs, rr = (j - j0) * R + (h - g * R).
template <typename T>
__device__ void attend(const Params& p, int b, int g, int j0, int nq,
                       float* smem) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int hd = p.hd, bs = p.bs, R = p.H / p.Hkv;
  const int rows = nq * R, rows_max = p.qt * R;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  float* q_s = smem;                      // rows_max x hd
  float* acc_s = q_s + rows_max * hd;     // rows_max x hd
  float* k_s = acc_s + rows_max * hd;     // bs x hd
  float* v_s = k_s + bs * hd;             // bs x hd
  float* s_s = v_s + bs * hd;             // rows_max x bs
  float* m_s = s_s + rows_max * bs;       // rows_max
  float* l_s = m_s + rows_max;            // rows_max
  float* c_s = l_s + rows_max;            // rows_max

  const int length = p.lengths[b];
  const int qlo = length - p.K + j0;      // position of the tile's 1st query
  const int qhi = qlo + nq - 1;
  int i_end = 0;
  if (qhi >= 0) i_end = min(p.NB, qhi / bs + 1);
  int i_begin = 0;
  if (p.window > 0 && qlo - p.window + 1 > 0)
    i_begin = (qlo - p.window + 1) / bs;

  for (int e = tid; e < rows * hd; e += nthr) {
    const int rr = e / hd, d = e - rr * hd;
    const int j = j0 + rr / R, h = g * R + rr % R;
    q_s[e] = load_f32(q + (((size_t)b * p.K + j) * p.H + h) * hd + d);
    acc_s[e] = 0.f;
  }
  for (int rr = tid; rr < rows; rr += nthr) {
    m_s[rr] = kNegInf;
    l_s[rr] = 0.f;
  }
  __syncthreads();

  const int* trow = p.tables + (size_t)b * p.NB;
  const int stride = p.Hkv * hd;
  for (int i = i_begin; i < i_end; ++i) {
    const int blk = trow[i];
    if (blk < 0) continue;  // absent entry: uniform across the CTA
    const size_t base = ((size_t)blk * bs * p.Hkv + g) * hd;
    stage_tile<T>(k_s, kp + base, bs, hd, stride);
    stage_tile<T>(v_s, vp + base, bs, hd, stride);
    __syncthreads();

    // scores: one warp per (row, token), lanes across hd
    for (int pr = warp; pr < rows * bs; pr += nwarps) {
      const int rr = pr / bs, t = pr - rr * bs;
      const float* qr = q_s + rr * hd;
      const float* kr = k_s + t * hd;
      float a = 0.f;
      for (int d = lane; d < hd; d += 32) a = fmaf(qr[d], kr[d], a);
      a = warp_sum(a);
      if (lane == 0) {
        float s = a * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        const int qpos = qlo + rr / R, tok = i * bs + t;
        bool ok = tok <= qpos;
        if (p.window > 0) ok = ok && tok > qpos - p.window;
        s_s[rr * bs + t] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int rr = warp; rr < rows; rr += nwarps) {
      float* sr = s_s + rr * bs;
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[rr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float e = expf(sr[t] - m_new);
        sr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        c_s[rr] = c;
        l_s[rr] = l_s[rr] * c + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: each thread owns (row, d) elements
    for (int e = tid; e < rows * hd; e += nthr) {
      const int rr = e / hd, d = e - rr * hd;
      const float* pr = s_s + rr * bs;
      float a = acc_s[e] * c_s[rr];
      for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * hd; e += nthr) {
    const int rr = e / hd, d = e - rr * hd;
    const int j = j0 + rr / R, h = g * R + rr % R;
    store_from_f32(out + (((size_t)b * p.K + j) * p.H + h) * hd + d,
                   acc_s[e] / fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  attend<T>(p, blockIdx.y, blockIdx.x, 0, 1, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_mq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int j0 = blockIdx.x * p.qt;
  attend<T>(p, blockIdx.z, blockIdx.y, j0, min(p.qt, p.K - j0), smem);
}

size_t smem_bytes(const Params& p) {
  const size_t rows = (size_t)p.qt * (p.H / p.Hkv);
  return sizeof(float) *
         (2 * rows * p.hd + 2 * (size_t)p.bs * p.hd + rows * p.bs + 3 * rows);
}

bool valid(const Params& p) {
  return p.B > 0 && p.H > 0 && p.Hkv > 0 && p.H % p.Hkv == 0 && p.hd > 0 &&
         p.hd % 8 == 0 && p.bs > 0 && p.NB > 0 && p.K > 0 && p.qt > 0 &&
         p.B <= 65535 && p.Hkv <= 65535;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, const Params& p, void* stream) {
  const size_t smem = smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const int* tables, const int* lengths, void* out, int B,
                   int H, int Hkv, int hd, int bs, int NB, int K, int qt,
                   int window, float softcap, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.tables = tables; p.lengths = lengths;
  p.out = out;
  p.B = B; p.H = H; p.Hkv = Hkv; p.hd = hd; p.bs = bs; p.NB = NB; p.K = K;
  p.qt = qt; p.window = window; p.softcap = softcap; p.scale = scale;
  return p;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode(int dtype, const void* q, const void* k,
                            const void* v, const int* tables,
                            const int* lengths, void* out, int B, int H,
                            int Hkv, int hd, int bs, int NB, int window,
                            float softcap, float scale, void* stream) {
  const Params p = make_params(q, k, v, tables, lengths, out, B, H, Hkv, hd,
                               bs, NB, 1, 1, window, softcap, scale);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  if (dtype == 0) return (int)launch(paged_decode_kernel<float>, grid, p, stream);
  if (dtype == 1)
    return (int)launch(paged_decode_kernel<__nv_bfloat16>, grid, p, stream);
  return (int)cudaErrorInvalidValue;
}

// q holds K queries per request; qt query positions share one CTA.
extern "C" int paged_mq(int dtype, const void* q, const void* k,
                        const void* v, const int* tables, const int* lengths,
                        void* out, int B, int K, int H, int Hkv, int hd,
                        int bs, int NB, int qt, int window, float softcap,
                        float scale, void* stream) {
  const Params p = make_params(q, k, v, tables, lengths, out, B, H, Hkv, hd,
                               bs, NB, K, qt, window, softcap, scale);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + qt - 1) / qt, Hkv, B);
  if (dtype == 0) return (int)launch(paged_mq_kernel<float>, grid, p, stream);
  if (dtype == 1)
    return (int)launch(paged_mq_kernel<__nv_bfloat16>, grid, p, stream);
  return (int)cudaErrorInvalidValue;
}

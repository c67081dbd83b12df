// Flash attention for Hopper (sm_90a): the monolithic prefill's causal
// attention over a whole prompt.
//
// Replaces the TPU kernel `_flash_kernel` of src/repro/kernels/
// flash_attention/flash_attention.py (via `flash_attention_fwd`): blocked
// online-softmax attention of q (B, H, Sq, hd) over k, v (B, Hkv, Sk, hd),
// GQA by index (query head h reads kv head h * Hkv / H, as the Pallas
// index map does), scale 1/sqrt(hd), causal mask k_pos <= q_offset + i,
// sliding window k_pos > q_pos - window when window > 0, running max / sum /
// accumulator in float32, p cast to the input dtype before the p.v product,
// output acc / max(l, 1e-30).
//
// Where it departs from the Pallas kernel:
//   * Ragged lengths are allowed: the tail tiles are masked (zero-filled
//     rows, keys past Sk masked to -1e30), where the Pallas kernel asserts
//     that Sq and Sk divide the block sizes.
//   * Strided operands: q, k, v and the output are addressed through
//     (batch, head, position) strides with a contiguous head dimension, so
//     the model's (B, S, H, hd) activations are read and written in place,
//     with no transpose copies.
//   * Tiles that lie wholly above the causal diagonal or wholly outside
//     the window are skipped, so the work and the bytes read follow the
//     mask. A query row that can see no key at all (not on any serving
//     path: q_offset + i >= Sk with a window) gets zeros, where the Pallas
//     kernel gives the mean of the masked tiles' values.
//
// What bounds it on this card: at the serving shapes (hd = 256, prompts of
// 16 to 2048 tokens) the causal flops over 989 TFLOP/s and the q/k/v/o
// bytes over 3.35 TB/s are within a factor of a few of each other; a
// kernel on the CUDA cores (no tensor cores) is bound by its own FMA and
// shared-memory issue rate far above both. The design keeps the card busy
// and the work proportional to the mask:
//   * One CTA per (64-query tile, query head, batch row): B * H * ceil(Sq
//     / 64) CTAs, launched latest tile first so the longest causal rows
//     start first.
//   * 256 threads as a 16 x 16 grid. Thread (ty, tx) owns query rows
//     ty*4 .. ty*4+3 and score columns tx + 16 j (j < 4) of each 64-key
//     tile, and accumulator columns tx + 16 c (c < hd / 16): the scores,
//     the running m / l and the accumulator live in registers; the row max
//     and sum are 16-lane shuffles.
//   * q, k and v tiles are staged in shared memory as float32 with 16-byte
//     vector loads (k and q rows padded by one float, so the score loop
//     reads them without bank conflicts); p goes through shared memory to
//     the p.v product. At hd = 256 that is 209 KB, set with
//     cudaFuncSetAttribute.
// Not yet done (later work): tensor cores (mma.sync / wgmma) for q.k and
// p.v, cp.async or TMA double buffering, and sharing one staged K/V tile
// across the query heads of an MQA group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows of a tile
constexpr int kBK = 64;        // keys of a tile

struct Params {
  const void* q;  // (B, H, Sq, hd) through strides q_s*
  const void* k;  // (B, Hkv, Sk, hd)
  const void* v;  // (B, Hkv, Sk, hd)
  void* out;      // (B, H, Sq, hd)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  int B, H, Hkv, Sq, Sk, causal, window, q_offset;
  float scale;
};

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

// p rounded to the input dtype, as the Pallas kernel casts it before p.v.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage `rows` rows of HD contiguous elements (row stride `src_stride`)
// into dst (kBQ x dst_stride float32); rows [rows, 64) are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const T* src, long long src_stride,
                                      int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = HD / kVec;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kBQ * kVpr; idx += kThreads) {
    const int r = idx / kVpr;
    const int c = idx - r * kVpr;
    float f[kVec];
    if (r < rows) {
      const uint4 u = __ldg(
          reinterpret_cast<const uint4*>(src + (long long)r * src_stride) + c);
      unpack16(u, src, f);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
    float* d = dst + r * dst_stride + c * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) d[e] = f[e];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  constexpr int QS = HD + 1;  // padded row stride of the q and k tiles
  constexpr int PS = kBK + 1; // padded row stride of the p tile
  constexpr int NC = HD / 16; // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;            // kBQ x QS
  float* k_s = q_s + kBQ * QS;  // kBK x QS
  float* v_s = k_s + kBK * QS;  // kBK x HD
  float* p_s = v_s + kBK * HD;  // kBQ x PS

  const int iq = gridDim.x - 1 - blockIdx.x;  // latest (longest) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h * p.Hkv / p.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = iq * kBQ;
  const int nrows = min(kBQ, p.Sq - q0);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                (long long)q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  stage<T, HD>(q_s, QS, qg, p.q_ss, nrows);

  // the key range this tile's queries can see
  const int qpos_lo = p.q_offset + q0;
  const int qpos_hi = qpos_lo + nrows - 1;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, qpos_lo - p.window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * kBK;
    const int nk = min(kBK, p.Sk - k0);
    __syncthreads();  // the previous tile's readers are done with k/v/p
    stage<T, HD>(k_s, QS, kg + (long long)k0 * p.k_ss, p.k_ss, nk);
    stage<T, HD>(v_s, HD, vg + (long long)k0 * p.v_ss, p.v_ss, nk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qr = q_s + (ty * 4) * QS;
    const float* kr = k_s + tx * QS;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qr[i * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kr[j * 16 * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    // mask, then the online softmax of each row (16 lanes share a row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = p.q_offset + q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool ok = c < nk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        p_s[r * PS + tx + 16 * j] = round_to(e, static_cast<const T*>(nullptr));
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += p @ v (keys past Sk have p = 0 or a zero value row)
    const float* pr = p_s + (ty * 4) * PS;
    for (int t = 0; t < nk; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pr[i * PS + t];
      const float* vr = v_s + t * HD + tx;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vr[16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = og + (long long)(q0 + r) * p.o_ss + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(orow + 16 * c, acc[i][c] / denom);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
cudaError_t launch(const Params& p, void* stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_kernel<T, HD><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int hd, void* stream) {
  if (hd == 64) return launch<T, 64>(p, stream);
  if (hd == 128) return launch<T, 128>(p, stream);
  if (hd == 256) return launch<T, 256>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, position) of q, k, v and out in turn; the head dimension is
// contiguous. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out,
                               const long long* strides, int B, int H,
                               int Hkv, int Sq, int Sk, int hd, int causal,
                               int window, int q_offset, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale;
  if (dtype == 0) return (int)launch_hd<float>(p, hd, stream);
  if (dtype == 1) return (int)launch_hd<__nv_bfloat16>(p, hd, stream);
  return (int)cudaErrorInvalidValue;
}

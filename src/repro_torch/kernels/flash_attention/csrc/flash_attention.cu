// Flash attention for Hopper (sm_90a): the monolithic prefill's causal
// attention over a whole prompt, and the encoder-decoder's non-causal
// encoder self-attention and cross-attention.
//
// Replaces the TPU kernel `_flash_kernel` of src/repro/kernels/
// flash_attention/flash_attention.py (via `flash_attention_fwd`): blocked
// online-softmax attention of q (B, H, Sq, hd) over k, v (B, Hkv, Sk, hd),
// GQA by index (query head h reads kv head h * Hkv / H, as the Pallas
// index map does), scale 1/sqrt(hd), causal mask k_pos <= q_offset + i,
// sliding window k_pos > q_pos - window when window > 0, running max / sum /
// accumulator in float32, p cast to the input dtype before the p.v product
// (the sum l is taken over the unrounded p), output acc / max(l, 1e-30).
//
// Where it departs from the Pallas kernel:
//   * Ragged lengths are allowed: queries past Sq are zero rows that are
//     never stored, keys past Sk are zero-filled by the copy and masked.
//   * Strided operands: q, k, v and the output are addressed through
//     (batch, head, position) strides with a contiguous head dimension, so
//     the model's (B, S, H, hd) activations are read and written in place,
//     with no transpose copies.
//   * A CTA walks only the key stages its queries can see (causal range
//     and window), so the work and the bytes read follow the mask. A query
//     row that can see no key at all (not on any serving path: q_offset +
//     i < 0, or a window past Sk) gets zeros, where the Pallas kernel gives
//     the mean of the masked tiles' values.
//
// What bounds it on this card: at the serving shapes (gemma-2b: 8 query
// heads on one kv head, hd 256; hymba-1.5b: 25 on 5, hd 64; prompts of 16
// to 2048 tokens) the q/k/v/o bytes over 3.35 TB/s and the causal flops
// over 989 TFLOP/s are within a factor of a few of each other; what a
// CTA waits on is its chain of stages. The design is the one of the paged
// kernels (paged_attention.cu), on contiguous K/V:
//   1. A CTA's 64 rows are (query, head) pairs of one kv group, row
//      rr = (j - j0) * R + h_local with R = H / Hkv, so each staged K/V
//      tile feeds every query head of the group (gemma: 8 queries x 8
//      heads a CTA; hymba: 12.8 queries x 5 heads). The work items (row
//      tile, kv group, batch row) run latest row tile first, so the
//      longest causal rows start first, and are handed to blocks in
//      layers of one block an SM, every other layer reversed: an SM's
//      second block is short when its first is long. Each row is masked
//      by its own query position, so a 16-row fragment may span several
//      queries (at R = 5 up to four).
//   2. bf16 runs on tensor cores: mma.sync.m16n8k16 (bf16 operands, f32
//      accumulators), four warps of 16 rows each; ldmatrix loads Q and K
//      fragments, ldmatrix.trans loads V for P.V (hopper.cuh). Q is staged
//      once; K and V stay bf16 in shared memory.
//   3. K and V move by 16-byte cp.async copies into a ring of stages of
//      32 keys (two stages at hd 256 and 128, four at hd 64): the next
//      stages are in flight while one computes. Keys past Sk are
//      zero-filled by the copy itself (src-size 0).
//   4. The scores, the running max and sum and the accumulator live in
//      registers (the mma fragment layout); the row max and sum are quad
//      shuffles, so a stage needs one barrier, not three. A warp skips the
//      per-key masks of a stage that all its rows see whole, and the
//      accumulator's rescale when no row's max moved.
//   5. p is rounded to bf16 before p.v, the sum l taken over the
//      unrounded p, as the Pallas kernel does.
//   6. The output leaves through the Q tile in 16-byte pieces, a warp
//      writing whole rows.
//   7. When the work items cannot fill the card (fewer than one an SM: a
//      cross-attention of a few decode queries against 1500 encoder
//      keys is 48 items of one row each), each item's key stages are
//      split across `splits` CTAs (the wrapper picks the count from the
//      shapes, ops.splits_for); each writes its unnormalised float32
//      accumulator, max and sum, and a second small kernel merges the
//      splits in split order (`flash_combine`): deterministic, no
//      atomics.
// float32 inputs take the same structure (tiling, ring, fragment layout)
// with both products on CUDA cores in full float32: TF32 would not hold
// the float32 tolerance.
//
// Shared-memory tiles are swizzled: 16-byte chunk c of row r sits at
// chunk c ^ (r & 7), so the eight rows an ldmatrix reads fall in eight
// different bank groups.
//
// Left for later: wgmma with TMA loads and an mbarrier pipeline, and
// persistent CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;            // keys of K (and of V) in a stage
constexpr int kWarps = 4;            // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // (query, head) rows of a CTA
constexpr int kPStride = kTile + 1;  // float32 path: p scratch row stride

// Ring depth: enough stages for about 32 KB of K and V in flight, and at
// least two (deeper rings cost hymba's hd-64 prefill CTAs an SM and time:
// PERF.md).
template <typename T, int HD>
struct Ring {
  static constexpr int kStageBytes = 2 * kTile * HD * (int)sizeof(T);
  static constexpr int kStages =
      32768 / kStageBytes > 2 ? 32768 / kStageBytes : 2;
};

struct Params {
  const void* q;  // (B, H, Sq, hd) through strides q_s*
  const void* k;  // (B, Hkv, Sk, hd)
  const void* v;  // (B, Hkv, Sk, hd)
  void* out;      // (B, H, Sq, hd)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  int B, H, Hkv, Sq, Sk, causal, window, q_offset;
  int row_tiles, sms;  // row tiles of a kv group; the card's SMs
  int splits;          // CTAs an item's key stages are split across
  float* part_acc;     // splits > 1: (splits, B, H, Sq, hd) float32
  float* part_ml;      // splits > 1: (splits, B, H, Sq, 2) max, sum
  float scale;
};

// Rows f0 .. f0 + kRows - 1 of kv group g's (query, head) rows of batch
// row b (row f: query f / R, head g * R + f % R); rows past Sq * R are
// zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_q(T* qs, const Params& p, int b, int g,
                                       int f0) {
  constexpr int kChunk = 16 / (int)sizeof(T), kCpr = HD / kChunk;
  const int R = p.H / p.Hkv, rows = p.Sq * R;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  for (int idx = threadIdx.x; idx < kRows * kCpr; idx += kThreads) {
    const int r = idx / kCpr, c = idx % kCpr;
    const int f = f0 + r;
    const bool ok = f < rows;
    const int j = f / R, h = g * R + (f - j * R);
    const long long off = ok ? h * p.q_sh + j * p.q_ss + c * kChunk : 0;
    cp_async16(qs + swz<T, HD>(r, c), q + off, ok);
  }
}

// Keys k0 .. k0 + kTile - 1 of kv group g; keys at or past Sk are
// zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const Params& p, int b,
                                        int g, int k0) {
  constexpr int kChunk = 16 / (int)sizeof(T), kCpr = HD / kChunk;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  for (int idx = threadIdx.x; idx < kTile * kCpr; idx += kThreads) {
    const int r = idx / kCpr, c = idx % kCpr;
    const int pos = k0 + r;
    const bool ok = pos < p.Sk;
    cp_async16(ks + swz<T, HD>(r, c),
               kp + (ok ? pos * p.k_ss + c * kChunk : 0), ok);
    cp_async16(vs + swz<T, HD>(r, c),
               vp + (ok ? pos * p.v_ss + c * kChunk : 0), ok);
  }
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(kRows + Ring<T, HD>::kStages * 2 * kTile) * HD +
         (sizeof(T) == 4 ? sizeof(float) * kRows * kPStride : 0);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  constexpr int kStages = Ring<T, HD>::kStages;
  extern __shared__ __align__(16) char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = qs + kRows * HD;  // stage st: K at ring + 2 st kTile HD, then V
  float* ps = reinterpret_cast<float*>(ring + kStages * 2 * kTile * HD);

  // work items m = 0, 1, ... run longest first (latest row tile first);
  // blocks are handed out in layers of one block an SM, every other layer
  // reversed, so an SM's second block is a short one when its first is
  // long; an item's splits are neighbours
  const int G = p.Hkv * p.B, n_work = p.row_tiles * G * p.splits;
  const int layer = blockIdx.x / p.sms, pos = blockIdx.x % p.sms;
  const int width = min(p.sms, n_work - layer * p.sms);
  const int work = layer * p.sms + (layer & 1 ? width - 1 - pos : pos);
  const int item = work / p.splits, split = work % p.splits;
  const int rt = p.row_tiles - 1 - item / G;
  const int g = item % G % p.Hkv, b = item % G / p.Hkv;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int R = p.H / p.Hkv, rows = p.Sq * R;
  const int f0 = rt * kRows;

  // the keys the tile's queries can see: [k_begin, k_end)
  const int qpos_lo = p.q_offset + f0 / R;
  const int qpos_hi = p.q_offset + (min(f0 + kRows, rows) - 1) / R;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, qpos_lo - p.window + 1);
  int t_begin = k_begin / kTile;
  int n_tiles = k_end > k_begin ? (k_end + kTile - 1) / kTile - t_begin : 0;
  if (p.splits > 1) {  // this CTA's share of the item's stages
    const int per = (n_tiles + p.splits - 1) / p.splits;
    const int lo = min(n_tiles, split * per);
    t_begin += lo;
    n_tiles = min(n_tiles, lo + per) - lo;
  }

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = p.q_offset + (f0 + w * 16 + gid + 8 * i) / R;
  // the warp's first and last query position
  const int wq_lo = p.q_offset + (f0 + w * 16) / R;
  const int wq_hi = p.q_offset + (f0 + w * 16 + 15) / R;

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    load_q<T, HD>(qs, p, b, g, f0);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) {
        T* ks = ring + 2 * st * kTile * HD;
        load_kv<T, HD>(ks, ks + kTile * HD, p, b, g, (t_begin + st) * kTile);
      }
      cp_async_commit();
    }
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage it landed; stage it - 1 is free again
      const int nx = it + kStages - 1;
      if (nx < n_tiles) {
        T* ks = ring + 2 * (nx % kStages) * kTile * HD;
        load_kv<T, HD>(ks, ks + kTile * HD, p, b, g, (t_begin + nx) * kTile);
      }
      cp_async_commit();

      const T* ks = ring + 2 * (it % kStages) * kTile * HD;
      const int k0 = (t_begin + it) * kTile;
      float s[kTile / 8][4];
      qk<HD, kTile>(s, qs, ks, w, lane);

      // scale and masks; each row by its own query position, unless
      // every row of the warp sees every key of the stage
      uint32_t ok = 0;
      float mx[2] = {kNegInf, kNegInf};
      const bool whole = k0 + kTile <= p.Sk &&
                         (!p.causal || k0 + kTile - 1 <= wq_lo) &&
                         (p.window <= 0 || k0 > wq_hi - p.window);
      if (whole) {
        ok = (1u << (kTile / 2)) - 1;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= p.scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int pos = k0 + 8 * n + 2 * tq + (e & 1);
            bool see = pos < p.Sk;
            if (p.causal) see = see && pos <= qpos[i];
            if (p.window > 0) see = see && pos > qpos[i] - p.window;
            s[n][e] = see ? s[n][e] * p.scale : kNegInf;
            if (see) ok |= 1u << (4 * n + e);
            mx[i] = fmaxf(mx[i], s[n][e]);
          }
        }
      }
      // online softmax in registers; a row's four lanes form a quad
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float pe =
              (ok >> (4 * n + e)) & 1u ? expf(s[n][e] - m[i]) : 0.f;
          s[n][e] = pe;
          sum[i] += pe;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
      // rescale only when some row's max moved (x * 1 is x, bit for bit)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }
      }
      pv<HD, kTile>(o, s, ks + kTile * HD, ps, w, lane);
    }
    cp_async_wait<0>();
  }

  if (p.splits > 1) {
    // this split's partial: the unnormalised accumulator, the max (none
    // when the split saw no key) and the sum of each row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = f0 + w * 16 + gid + 8 * i;
      if (f >= rows) continue;
      const int j = f / R, h = g * R + (f - j * R);
      const size_t prow =
          (((size_t)split * p.B + b) * p.H + h) * (size_t)p.Sq + j;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        store2(p.part_acc + prow * HD + 8 * n + 2 * tq, o[n][2 * i],
               o[n][2 * i + 1]);
      if (tq == 0)
        store2(p.part_ml + prow * 2, l[i] > 0.f ? m[i] : kNegInf, l[i]);
    }
    return;
  }

  // epilogue: the normalised rows go through the Q tile (free once every
  // warp is past its last q.k) so that the output leaves in 16-byte
  // pieces, a warp writing whole rows, rather than 4-byte ones scattered
  // over 16 rows
  constexpr int kChunk = 16 / (int)sizeof(T), kCpr = HD / kChunk;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w * 16 + gid + 8 * i;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + 2 * tq;
      store2(qs + swz<T, HD>(r, col / kChunk) + col % kChunk,
             o[n][2 * i] / den, o[n][2 * i + 1] / den);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + b * p.o_sb;
  for (int idx = threadIdx.x; idx < kRows * kCpr; idx += kThreads) {
    const int r = idx / kCpr, c = idx % kCpr;
    const int f = f0 + r;
    if (f >= rows) continue;
    const int j = f / R, h = g * R + (f - j * R);
    *reinterpret_cast<uint4*>(out + h * p.o_sh + j * p.o_ss + c * kChunk) =
        *reinterpret_cast<const uint4*>(qs + swz<T, HD>(r, c));
  }
}

// Merge the splits' partials of one (b, h, j) row per threadIdx.y, four
// columns per thread, in split order, into the output through its
// strides; a row no split saw comes out as zeros.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) flash_combine(Params p) {
  const size_t rows = (size_t)p.B * p.H * p.Sq;
  const size_t row = (size_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int d = 4 * threadIdx.x;
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml) + row;
  const float* acc = p.part_acc + row * HD + d;
  float mx = kNegInf;
  for (int s = 0; s < p.splits; ++s) {
    const float2 x = ml[s * rows];
    if (x.y > 0.f) mx = fmaxf(mx, x.x);
  }
  float den = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < p.splits; ++s) {
    const float2 x = ml[s * rows];
    const float4 v = *reinterpret_cast<const float4*>(acc + s * rows * HD);
    if (x.y > 0.f) {
      const float wgt = expf(x.x - mx);
      den += wgt * x.y;
      a.x = fmaf(wgt, v.x, a.x);
      a.y = fmaf(wgt, v.y, a.y);
      a.z = fmaf(wgt, v.z, a.z);
      a.w = fmaf(wgt, v.w, a.w);
    }
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  const int j = (int)(row % p.Sq), h = (int)(row / p.Sq % p.H),
            b = (int)(row / ((size_t)p.Sq * p.H));
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh + j * p.o_ss + d;
  store2(out, a.x * inv, a.y * inv);
  store2(out + 2, a.z * inv, a.w * inv);
}

constexpr int kCombineRows = 4;  // rows of one combine CTA (HD/4 threads)

template <typename T, int HD>
cudaError_t launch(const Params& p, void* stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  // once per instantiation, not on every launch: the call costs host
  // time
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const long long work = (long long)p.row_tiles * p.Hkv * p.B * p.splits;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_kernel<T, HD><<<(unsigned)work, kThreads, smem, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long rows = (long long)p.B * p.H * p.Sq;
  flash_combine<T, HD><<<(unsigned)((rows + kCombineRows - 1) / kCombineRows),
                         dim3(HD / 4, kCombineRows), 0, st>>>(p);
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
// contiguous. splits > 1 splits each work item's key stages across that
// many CTAs, with float32 workspaces part_acc (splits, B, H, Sq, hd) and
// part_ml (splits, B, H, Sq, 2). Returns a cudaError_t (0 = launched).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out,
                               const long long* strides, int B, int H,
                               int Hkv, int Sq, int Sk, int hd, int causal,
                               int window, int q_offset, float scale,
                               int splits, float* part_acc, float* part_ml,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      splits <= 0 || (splits > 1 && (!part_acc || !part_ml)))
    return (int)cudaErrorInvalidValue;
  const long long row_tiles = ((long long)Sq * (H / Hkv) + kRows - 1) / kRows;
  if (row_tiles * Hkv * B * splits > 2147483647LL)
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
  p.splits = splits;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.row_tiles = (int)row_tiles;
  p.sms = sm_count();
  if (dtype == 0) return (int)launch_hd<float>(p, hd, stream);
  if (dtype == 1) return (int)launch_hd<bf16>(p, hd, stream);
  return (int)cudaErrorInvalidValue;
}

// Paged attention for Hopper (sm_90a): the decode step and the
// multi-query prefill chunk of the paged continuous engine.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention/
// paged_attention.py: `_paged_kernel` (one query per request, the decode
// step) with `paged_decode`, and `_paged_mq_kernel` (a block of K queries
// per request, query j at position lengths[b] - K + j; the prefill chunk
// with lengths = pos0 + C) with `paged_mq`. Both take q in the (B, K, H,
// hd) layout (decode: K = 1) and share one device body, `attend`.
//
// What bounds it on this card: bytes. A CTA's rows are (query, head)
// pairs of one kv group, rr = (j - j0) * R + h_local, so each staged K/V
// token is used by every row of the tile; even then the work per byte
// (2 * rows flops per K or V element) stays far below the ~295 flop/byte
// at which the H100's bf16 tensor cores, not its memory, are the limit.
// The design answers the five things that held the first version back:
//   1. Scores were one warp-wide shuffle reduction per (row, token). Now
//      both products are tensor-core mma.sync.m16n8k16 (bf16 operands,
//      f32 accumulators): a warp owns 16 rows; ldmatrix loads Q and K
//      fragments, ldmatrix.trans loads V for P.V. The cost per token no
//      longer grows with the row count.
//   2. Pages were staged synchronously. Now K and V are gathered through
//      the block table, token row by token row, with 16-byte cp.async
//      copies into a ring of kStages stages of kTile tokens: stage i + 1
//      is in flight while stage i computes. Absent tokens are zero-filled
//      by the copy itself (src-size 0), so stale shared memory never
//      meets a masked p.
//   3. Decode had B * Hkv CTAs (16 at gemma's MQA). Now the table is
//      split (flash-decoding): CTA (row tile, split, g, b) covers a fixed
//      range of table entries, intersected with the entries its queries
//      can see (window and causal range, from lengths, on the device).
//      The wrapper picks the number of splits from shapes alone (ops.py
//      `plan`), never from lengths or tables, so no device-to-host read
//      is needed. Each split writes an f32 partial (running max m, sum l,
//      unnormalised accumulator); a second kernel (`paged_*_combine`)
//      merges them in fixed split order, with no atomics, so the result
//      is deterministic. Partials with l = 0 add nothing; a row with no
//      partial writes zeros. With one split the first kernel writes the
//      output itself. The combine is a programmatic dependent launch
//      (griddepcontrol): it is scheduled while the first grid drains.
//   4. Each query tile of a chunk re-staged and re-widened the same pages
//      to f32 (about 98 KB of shared memory a CTA). Now K and V stay bf16
//      in shared memory (about 64 KB of stages: two of 32 tokens at hd
//      256, eight at hd 64), a chunk's tile holds 64 rows (four warps x
//      16), and Q is staged once. A decode tile (R <= 16 rows) computes
//      on one warp; all four warps of every CTA issue the copies, since
//      one warp alone takes longer to issue a stage than to compute it.
//   5. The TPU kernels run both products on the MXU and round p to the
//      value type before p.v; so does this kernel (p to bf16; the sum l
//      is taken over the unrounded p, as there).
// Rows are masked one by one (each has its own query position), so a
// 16-row fragment may span several queries (at R = 5 up to four).
// float32 inputs take the same structure (split, ring, combine) with
// both products on CUDA cores in full float32, in the same fragment
// layout: TF32 would not hold the float32 tolerances.
//
// Shared-memory tiles are swizzled: 16-byte chunk c of row r sits at
// chunk c ^ (r & 7), so the eight rows an ldmatrix reads fall in eight
// different bank groups. The PTX wrappers, the swizzle and the two
// products of a stage live in ../../hopper.cuh, shared with the flash
// kernel.
//
// Left for later: wgmma with TMA loads and an mbarrier pipeline, and
// persistent CTAs (one per SM walking the (tile, split) work list).
//
// Rows that can see no token (parked lengths near -2^30, an all -1 table)
// write zeros: finite garbage that the serving engine discards. The
// decode launch and a K = 1 paged_mq run the same body with the same
// plan, so they are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;            // tokens of K (and of V) in a stage
constexpr int kThreads = 128;        // every CTA: four warps copy
constexpr int kPStride = kTile + 1;  // float32 path: p scratch row stride

// Ring depth: enough stages for about 64 KB of K and V in flight (a
// stage at hd 64 in bf16 is 8 KB, at hd 256 32 KB), and at least two.
template <typename T, int HD>
struct Ring {
  static constexpr int kStageBytes = 2 * kTile * HD * (int)sizeof(T);
  static constexpr int kStages =
      65536 / kStageBytes > 2 ? 65536 / kStageBytes : 2;
};

struct Params {
  const void* q;        // (B, K, H, hd) — decode: K = 1
  const void* k;        // (P, bs, Hkv, hd)
  const void* v;        // (P, bs, Hkv, hd)
  const int* tables;    // (B, NB), -1 = absent
  const int* lengths;   // (B,)
  void* out;            // same layout as q
  float* part_acc;      // (splits, B, K, H, hd): unnormalised accumulators
  float* part_ml;       // (splits, B, K, H, 2): running max, sum
  int B, H, Hkv, hd, bs, NB, K, window;
  int row_tiles, splits, eps;  // eps: table entries a split covers
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// staging: Q once, K and V one stage at a time, all by cp.async
// ---------------------------------------------------------------------------

// Rows f0 .. f0 + M - 1 of the (query, head) rows of kv group g; rows past
// K * R are zero-filled.
template <typename T, int HD, int M, int NT>
__device__ __forceinline__ void load_q(T* qs, const Params& p, int b, int g,
                                       int f0) {
  constexpr int kCpr = HD * (int)sizeof(T) / 16;  // chunks per row
  const int R = p.H / p.Hkv, rows = p.K * R;
  const T* q = static_cast<const T*>(p.q);
  for (int idx = threadIdx.x; idx < M * kCpr; idx += NT) {
    const int r = idx / kCpr, c = idx % kCpr;
    const int f = f0 + r;
    const bool ok = f < rows;
    const int j = f / R, h = g * R + (f - j * R);
    const size_t off =
        ok ? (((size_t)b * p.K + j) * p.H + h) * HD + c * (16 / sizeof(T))
           : 0;
    cp_async16(qs + swz<T, HD>(r, c), q + off, ok);
  }
}

// Pool block of the stage's token row `lane` (kTile == 32: one row a
// lane): entry e0 + lane / bs, or -1 where that entry is absent or at or
// past e_hi.
__device__ __forceinline__ int stage_block(const Params& p, const int* trow,
                                          int e0, int e_hi, int lane) {
  const int e = e0 + lane / p.bs;
  return e < e_hi ? __ldg(trow + e) : -1;
}

// Token rows of table entries e0 .. e0 + kTile / bs - 1 of kv group g; a
// row whose block is -1 is zero-filled. A row of page blk, head g, token
// t sits at ((blk * bs + t) * Hkv + g) * hd. Each lane works out one
// row's offset and the warp broadcasts it, so the copy loop itself holds
// no table load and no division.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const Params& p,
                                        const int* trow, int e0, int e_hi,
                                        int g) {
  static_assert(kTile == 32, "one token row a lane");
  constexpr int kChunk = 16 / (int)sizeof(T), kCpr = HD / kChunk;
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const int lane = threadIdx.x & 31;
  const int blk = stage_block(p, trow, e0, e_hi, lane);
  const long long mine =
      blk >= 0 ? (((long long)blk * p.bs + lane % p.bs) * p.Hkv + g) * HD
               : -1;
  // kTile * kCpr is a multiple of NT: every lane runs every iteration
  static_assert(kTile * kCpr % NT == 0, "whole warps per copy round");
  for (int idx = threadIdx.x; idx < kTile * kCpr; idx += NT) {
    const int r = idx / kCpr, c = idx % kCpr;
    const long long off = __shfl_sync(0xffffffffu, mine, r);
    const bool ok = off >= 0;
    const size_t at = ok ? (size_t)off + c * kChunk : 0;
    cp_async16(ks + swz<T, HD>(r, c), kp + at, ok);
    cp_async16(vs + swz<T, HD>(r, c), vp + at, ok);
  }
}

template <typename T, int HD, int WARPS>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(16 * WARPS + Ring<T, HD>::kStages * 2 * kTile) *
             HD +
         (sizeof(T) == 4 ? sizeof(float) * 16 * WARPS * kPStride : 0);
}

// ---------------------------------------------------------------------------
// the shared body: one CTA = (row tile rt, split, kv group g, request b)
// ---------------------------------------------------------------------------

template <typename T, int HD, int WARPS>
__device__ __forceinline__ void attend(const Params& p, int b, int g, int rt,
                                       int split, char* smem) {
  constexpr int M = 16 * WARPS, NT = kThreads;
  constexpr int kStages = Ring<T, HD>::kStages;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // all four warps copy; the first WARPS compute (16 rows each)
  const bool computes = w < WARPS;
  const int gid = lane >> 2, tq = lane & 3;
  const int R = p.H / p.Hkv, rows = p.K * R;
  const int f0 = rt * M;

  // the entries the tile's queries can see: [i_begin, i_end)
  const int length = p.lengths[b];
  const int qlo = length - p.K + f0 / R;
  const int qhi = length - p.K + (min(f0 + M, rows) - 1) / R;
  int i_end = 0;
  if (qhi >= 0) i_end = min(p.NB, qhi / p.bs + 1);
  int i_begin = 0;
  if (p.window > 0 && qlo - p.window + 1 > 0)
    i_begin = (qlo - p.window + 1) / p.bs;
  // ... intersected with this split's fixed range
  const int e_lo = max(i_begin, split * p.eps);
  const int e_hi = min(i_end, min(p.NB, (split + 1) * p.eps));

  // the combine grid may be scheduled now; it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = length - p.K + (f0 + w * 16 + gid + 8 * i) / R;

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (e_lo < e_hi) {
    T* qs = reinterpret_cast<T*>(smem);
    T* ring = qs + M * HD;  // stage st: K at ring + 2 st kTile HD, then V
    float* ps = reinterpret_cast<float*>(ring + kStages * 2 * kTile * HD);
    const int per_tile = kTile / p.bs;
    const int n_tiles = (e_hi - e_lo + per_tile - 1) / per_tile;
    const int* trow = p.tables + (size_t)b * p.NB;

    load_q<T, HD, M, NT>(qs, p, b, g, f0);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) {
        T* ks = ring + 2 * st * kTile * HD;
        load_kv<T, HD, NT>(ks, ks + kTile * HD, p, trow, e_lo + st * per_tile,
                           e_hi, g);
      }
      cp_async_commit();
    }
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage it landed; stage it - 1 is free again
      const int nx = it + kStages - 1;
      if (nx < n_tiles) {
        T* ks = ring + 2 * (nx % kStages) * kTile * HD;
        load_kv<T, HD, NT>(ks, ks + kTile * HD, p, trow, e_lo + nx * per_tile,
                           e_hi, g);
      }
      cp_async_commit();
      if (!computes) continue;

      const T* ks = ring + 2 * (it % kStages) * kTile * HD;
      const int e0 = e_lo + it * per_tile;
      // bit t: token row t of the stage is present
      const uint32_t present = __ballot_sync(
          0xffffffffu, stage_block(p, trow, e0, e_hi, lane) >= 0);

      float s[kTile / 8][4];
      qk<HD, kTile>(s, qs, ks, w, lane);

      // scale, softcap and masks; each row by its own query position
      uint32_t ok = 0;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * tq + (e & 1), i = e >> 1;
          const int pos = e0 * p.bs + col;
          bool see = ((present >> col) & 1u) && pos <= qpos[i];
          if (p.window > 0) see = see && pos > qpos[i] - p.window;
          float x = s[n][e] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          s[n][e] = see ? x : kNegInf;
          if (see) ok |= 1u << (4 * n + e);
          mx[i] = fmaxf(mx[i], s[n][e]);
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
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      pv<HD, kTile>(o, s, ks + kTile * HD, ps, w, lane);
    }
    cp_async_wait<0>();
  }

  if (!computes) return;
  // epilogue: the output itself (one split) or this split's partial
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + w * 16 + gid + 8 * i;
    if (f >= rows) continue;
    const int j = f / R, h = g * R + (f - j * R);
    const size_t row = ((size_t)b * p.K + j) * p.H + h;
    if (p.splits == 1) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        store2(out + row * HD + 8 * n + 2 * tq, o[n][2 * i] / den,
               o[n][2 * i + 1] / den);
      continue;
    }
    const size_t prow = (size_t)split * p.B * p.K * p.H + row;
    if (e_lo < e_hi) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        store2(p.part_acc + prow * HD + 8 * n + 2 * tq, o[n][2 * i],
               o[n][2 * i + 1]);
    }
    if (tq == 0) store2(p.part_ml + prow * 2, l[i] > 0.f ? m[i] : kNegInf, l[i]);
  }
}

// Merge the splits' partials of one (b, j, h) row per threadIdx.y, four
// columns per thread, in split order. Every load is issued whatever the
// partial holds (an empty split's accumulator is never written and is
// discarded by a select), so no load waits on another.
template <typename T, int HD>
__device__ __forceinline__ void combine(const Params& p) {
  // launched as a programmatic dependent of the attention grid: wait for
  // that grid to end and its partials to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t rows = (size_t)p.B * p.K * p.H;
  const size_t row = (size_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int d = 4 * threadIdx.x;
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml) + row;
  const float* acc = p.part_acc + row * HD + d;
  float mx = kNegInf;
#pragma unroll 4
  for (int s = 0; s < p.splits; ++s) {
    const float2 x = ml[s * rows];
    if (x.y > 0.f) mx = fmaxf(mx, x.x);
  }
  float den = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
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
  T* out = static_cast<T*>(p.out) + row * HD + d;
  store2(out, a.x * inv, a.y * inv);
  store2(out + 2, a.z * inv, a.w * inv);
}

// Entry points: two names (so a profile tells the decode step from the
// chunk), one body.
template <typename T, int HD, int WARPS>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  attend<T, HD, WARPS>(p, blockIdx.z, blockIdx.y, blockIdx.x % p.row_tiles,
                       blockIdx.x / p.row_tiles, smem);
}

template <typename T, int HD, int WARPS>
__global__ void __launch_bounds__(kThreads) paged_mq_kernel(Params p) {
  extern __shared__ __align__(16) char smem[];
  attend<T, HD, WARPS>(p, blockIdx.z, blockIdx.y, blockIdx.x % p.row_tiles,
                       blockIdx.x / p.row_tiles, smem);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD) paged_decode_combine(Params p) {
  combine<T, HD>(p);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD) paged_mq_combine(Params p) {
  combine<T, HD>(p);
}

constexpr int kCombineRows = 4;  // rows of one combine CTA (HD threads)

template <typename T, int HD, int WARPS>
cudaError_t run(bool mq, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = mq ? paged_mq_kernel<T, HD, WARPS>
                              : paged_decode_kernel<T, HD, WARPS>;
  constexpr size_t smem = smem_bytes<T, HD, WARPS>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.row_tiles * p.splits, p.Hkv, p.B), kThreads, smem,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  // the combine is a programmatic dependent launch: its blocks are
  // scheduled while the attention grid finishes, which hides the gap
  // between the two launches
  void (*comb)(Params) =
      mq ? paged_mq_combine<T, HD> : paged_decode_combine<T, HD>;
  const int rows = p.B * p.K * p.H;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kCombineRows - 1) / kCombineRows);
  cfg.blockDim = dim3(HD / 4, kCombineRows);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, comb, p);
}

template <typename T>
cudaError_t dispatch(bool mq, int warps, const Params& p,
                     cudaStream_t stream) {
  const bool one = warps == 1;
  switch (p.hd) {
    case 64:
      return one ? run<T, 64, 1>(mq, p, stream) : run<T, 64, 4>(mq, p, stream);
    case 128:
      return one ? run<T, 128, 1>(mq, p, stream)
                 : run<T, 128, 4>(mq, p, stream);
    case 256:
      return one ? run<T, 256, 1>(mq, p, stream)
                 : run<T, 256, 4>(mq, p, stream);
  }
  return cudaErrorInvalidValue;
}

bool valid(const Params& p, int warps) {
  if (!(p.B > 0 && p.B <= 65535 && p.H > 0 && p.Hkv > 0 &&
        p.Hkv <= 65535 && p.H % p.Hkv == 0 && p.K > 0 && p.NB > 0 &&
        (p.hd == 64 || p.hd == 128 || p.hd == 256) && p.bs > 0 &&
        kTile % p.bs == 0 && (warps == 1 || warps == 4) && p.splits > 0 &&
        p.eps > 0 && p.eps % (kTile / p.bs) == 0))
    return false;
  const long long rows = (long long)p.K * (p.H / p.Hkv);
  const long long m = 16 * warps;
  if (p.row_tiles != (rows + m - 1) / m) return false;
  if ((long long)p.splits * p.eps < p.NB ||
      (long long)(p.splits - 1) * p.eps >= p.NB)
    return false;
  if ((long long)p.row_tiles * p.splits > INT_MAX ||
      (long long)p.B * rows * p.Hkv > INT_MAX)
    return false;
  return p.splits == 1 || (p.part_acc != nullptr && p.part_ml != nullptr);
}

int launch_both(bool mq, int dtype, const void* q, const void* k,
                const void* v, const int* tables, const int* lengths,
                void* out, float* part_acc, float* part_ml, int B, int K,
                int H, int Hkv, int hd, int bs, int NB, int warps,
                int row_tiles, int splits, int eps, int window,
                float softcap, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.tables = tables; p.lengths = lengths;
  p.out = out; p.part_acc = part_acc; p.part_ml = part_ml;
  p.B = B; p.H = H; p.Hkv = Hkv; p.hd = hd; p.bs = bs; p.NB = NB; p.K = K;
  p.window = window; p.row_tiles = row_tiles; p.splits = splits;
  p.eps = eps; p.softcap = softcap; p.scale = scale;
  if (!valid(p, warps)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(mq, warps, p, st);
  if (dtype == 1) return (int)dispatch<bf16>(mq, warps, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. warps, row_tiles, splits and eps come
// from the wrapper's plan (ops.py `plan`). part_acc / part_ml: f32
// scratch of (splits, B, K, H, hd) / (splits, B, K, H, 2), unused (may be
// null) with one split. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode(int dtype, const void* q, const void* k,
                            const void* v, const int* tables,
                            const int* lengths, void* out, float* part_acc,
                            float* part_ml, int B, int H, int Hkv, int hd,
                            int bs, int NB, int warps, int row_tiles,
                            int splits, int eps, int window, float softcap,
                            float scale, void* stream) {
  return launch_both(false, dtype, q, k, v, tables, lengths, out, part_acc,
                     part_ml, B, 1, H, Hkv, hd, bs, NB, warps, row_tiles,
                     splits, eps, window, softcap, scale, stream);
}

// q holds K queries per request, query j at lengths[b] - K + j.
extern "C" int paged_mq(int dtype, const void* q, const void* k,
                        const void* v, const int* tables, const int* lengths,
                        void* out, float* part_acc, float* part_ml, int B,
                        int K, int H, int Hkv, int hd, int bs, int NB,
                        int warps, int row_tiles, int splits, int eps,
                        int window, float softcap, float scale,
                        void* stream) {
  return launch_both(true, dtype, q, k, v, tables, lengths, out, part_acc,
                     part_ml, B, K, H, Hkv, hd, bs, NB, warps, row_tiles,
                     splits, eps, window, softcap, scale, stream);
}

// Top-k grouped expert products of the dropless MoE layer for Hopper
// (sm_90a): the serving FFN of every MoE configuration of the port
// (models/moe.py, moe_apply_dropless).
//
// Replaces no TPU kernel: the JAX package leaves its dense dropless MoE
// (every expert on every token, a zero gate for the experts a token did
// not pick) to XLA. It was added because those dense products ran 64
// experts where a token needs its top 8, 8x the work, over (E, T, f)
// temporaries of up to a gigabyte. Here each expert runs its products
// only over the (token, slot) assignments that picked it.
//
// One call, five launches on the caller's stream, no host sync:
//   1. moe_dispatch (one CTA): from the router's (T, K) expert ids, the
//      per-expert counts and their exclusive prefix sum `offsets` (E + 1),
//      the permutation `perm` that lists the T*K assignments expert by
//      expert, in (token, slot) order within an expert (a = t*K + k), and
//      the row-tile table `tiles` (R, 2): each tile's expert and first
//      sorted row, -1 past the last tile. R = ceil(T*K / BM) + E bounds
//      the tiles, so the host sizes every grid from T, K and E alone.
//      The ids are staged in shared memory a chunk at a time; each warp
//      walks a contiguous run of the chunk, and __match_any_sync ranks
//      equal experts inside a 32-wide step, so the order is stable and the
//      tables are a function of the ids alone.
//   2. moe_gather: xs[p] = x[perm[p] / K], the token rows in sorted order.
//   3. gate/up GEMM: for each row tile of expert e and each 128 columns
//      of f, g = xs . w_gate[e] and u = xs . w_up[e] in one product whose
//      256 columns are 128 of w_gate and the same 128 of w_up; the
//      epilogue stores bf16 h = silu(g) * u, computed in float32.
//   4. down GEMM: y[perm[p]] = (h[p] . w_down[e]) * gate[perm[p]], float32
//      rows indexed by assignment.
//   5. moe_combine: out[t] = sum over k = 0 .. K-1 of y[t*K + k], in slot
//      order, in float32, cast to the model's dtype once. No atomics: a
//      token's output depends on its own hidden state alone, bit for bit,
//      whatever its neighbours in the batch.
//
// The bf16 GEMMs: CTAs of 288 threads, two consumer warpgroups of 64
// rows each (BM = 128) and one producer warp. The producer's lane 0 keeps
// a 4-stage ring of 48 KB stages full by TMA: a 128 x 64 tile of xs or h
// (K-major, 128-byte swizzle) and four 64 x 64 boxes of the weights read
// in place in their stored (E, d, f) / (E, f, d) layout (N-major, the
// same swizzle), completing on the stage's mbarrier. Each consumer
// warpgroup runs wgmma m64n256k16 (bf16 in, float32 accumulators in
// registers, B transposed from N-major) over the stage and releases it
// one k-tile later. A warpgroup whose 64 rows all lie past its expert's
// count skips the products (decode: ~8 rows an expert). Ragged edges are
// the TMA's zero fill (k past d or f, columns past n, rows past T*K) and
// masked stores. The float32 GEMMs are CUDA-core tiles of 64 x 64 with
// the same tables (BM = 64), for float32 models; float32 products do not
// go through TF32.
//
// What bounds it on this card: at olmoe's chunk shape (T = 4096
// positions, K = 8, d = 2048, f = 1024, E = 64) the products are
// 4.1e11 FLOP (0.42 ms at 989 TFLOP/s) against 805 MB of weights read
// once (0.24 ms at 3.35 TB/s) and ~0.6 GB of xs, h and y traffic: the
// tensor cores. At its decode shape (T = 64, ~8 rows an expert) nearly
// every expert is hit and the same 805 MB of weights bound the step.
// The design keeps a full 256-column product per warpgroup so that the
// tensor cores, not shared memory, set the pace, and orders the grid
// with the column tiles of one row tile adjacent, so the CTAs in flight
// share a few experts' weights and rows in L2.
//
// Limits: d and f multiples of 8 (16-byte TMA strides and vector
// stores), 1 <= E <= 256, T*K < 2^31; anything else returns
// cudaErrorInvalidValue. x, the weights and the outputs are contiguous.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

using hopper::bf16;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;

constexpr int kMaxExperts = 256;
constexpr int kDispatchThreads = 1024;
constexpr int kChunk = 16384;         // ids staged at a time (uint8)

// ---------------------------------------------------------------------------
// 1. dispatch tables
// ---------------------------------------------------------------------------

// ids: (T, K) expert ids with row stride ld; n = T * K assignments.
// Dynamic shared memory: cnt (32 warps x E ints), tot, off, run, tstart
// (E + 1 ints each) and the staged ids of a chunk (kChunk bytes).
__global__ void __launch_bounds__(kDispatchThreads)
    moe_dispatch_kernel(const long long* __restrict__ ids, long long ld,
                        int n, int K, int E, int bm, int R,
                        int* __restrict__ offsets, int* __restrict__ perm,
                        int* __restrict__ tiles) {
  constexpr int kWarps = kDispatchThreads / 32;
  constexpr int kPerWarp = kChunk / kWarps;
  extern __shared__ int dsm[];
  int* cnt = dsm;                                   // [warp * E + e]
  int* tot = cnt + kWarps * E;
  int* off = tot + E + 1;
  int* run = off + E + 1;
  int* tstart = run + E + 1;
  uint8_t* sid = reinterpret_cast<uint8_t*>(tstart + E + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e <= E; e += blockDim.x) tot[e] = 0;
  __syncthreads();
  // pass 1: each expert's count
#pragma unroll 4
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    const int e = (int)ids[(long long)(a / K) * ld + a % K];
    if (e < 0 || e >= E) __trap();
    atomicAdd(&tot[e], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    tstart[0] = 0;
    for (int e = 0; e < E; ++e) {
      off[e + 1] = off[e] + tot[e];
      tstart[e + 1] = tstart[e] + (tot[e] + bm - 1) / bm;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e <= E; e += blockDim.x) {
    offsets[e] = off[e];
    run[e] = off[e];
  }
  // the row tiles: tile r belongs to the last expert whose first tile is
  // at or before r
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    if (r >= tstart[E]) {
      tiles[2 * r] = -1;
      tiles[2 * r + 1] = 0;
      continue;
    }
    int lo_e = 0, hi_e = E - 1;
    while (lo_e < hi_e) {
      const int mid = (lo_e + hi_e + 1) >> 1;
      if (tstart[mid] <= r) lo_e = mid; else hi_e = mid - 1;
    }
    tiles[2 * r] = lo_e;
    tiles[2 * r + 1] = off[lo_e] + (r - tstart[lo_e]) * bm;
  }
  // pass 2, a chunk of kChunk assignments at a time, each warp a run of
  // kPerWarp of them: positions in (token, slot) order within an expert
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int len = min(kChunk, n - c0);
#pragma unroll 4
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int a = c0 + i;
      sid[i] = (uint8_t)ids[(long long)(a / K) * ld + a % K];
    }
    for (int e = lane; e < E; e += 32) cnt[warp * E + e] = 0;
    __syncthreads();
    const int lo = warp * kPerWarp, hi = min(len, lo + kPerWarp);
    for (int base = lo; base < hi; base += 32) {
      const int e = base + lane < hi ? sid[base + lane] : -1;
      const unsigned m = __match_any_sync(0xffffffffu, e);
      if (e >= 0 && lane == __ffs(m) - 1) cnt[warp * E + e] += __popc(m);
      __syncwarp();
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      int s = run[e];
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w * E + e];
        cnt[w * E + e] = s;
        s += c;
      }
      run[e] = s;
    }
    __syncthreads();
    for (int base = lo; base < hi; base += 32) {
      const int e = base + lane < hi ? sid[base + lane] : -1;
      const unsigned m = __match_any_sync(0xffffffffu, e);
      if (e >= 0)
        perm[cnt[warp * E + e] + __popc(m & ((1u << lane) - 1u))] =
            c0 + base + lane;
      __syncwarp();
      if (e >= 0 && lane == __ffs(m) - 1) cnt[warp * E + e] += __popc(m);
      __syncwarp();
    }
    __syncthreads();
  }
}

int dispatch_smem(int E) {
  return (kDispatchThreads / 32 * E + 4 * (E + 1)) * 4 + kChunk;
}

// ---------------------------------------------------------------------------
// 2. gather and 5. combine
// ---------------------------------------------------------------------------

// xs[p] = x[perm[p] / K]; rows of `vecs` 16-byte vectors, a row a block
// at a time.
__global__ void moe_gather_kernel(const uint4* __restrict__ x,
                                  const int* __restrict__ perm,
                                  uint4* __restrict__ xs, int n, int K,
                                  int vecs) {
  for (int p = blockIdx.x; p < n; p += gridDim.x) {
    const uint4* src = x + (long long)(perm[p] / K) * vecs;
    uint4* dst = xs + (long long)p * vecs;
    for (int c = threadIdx.x; c < vecs; c += blockDim.x) dst[c] = src[c];
  }
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// out[t] = y[t*K] + y[t*K + 1] + ... in that order, float32, cast once;
// a token a block at a time.
template <typename T>
__global__ void moe_combine_kernel(const float* __restrict__ y,
                                   T* __restrict__ out, int tokens, int K,
                                   int d) {
  for (int t = blockIdx.x; t < tokens; t += gridDim.x) {
    const float* src = y + (long long)t * K * d;
    for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
      float4 s = *reinterpret_cast<const float4*>(src + c);
      for (int k = 1; k < K; ++k) {
        const float4 v =
            *reinterpret_cast<const float4*>(src + (long long)k * d + c);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      store4(out + (long long)t * d + c, s);
    }
  }
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

// ---------------------------------------------------------------------------
// 3-4. bf16 grouped GEMMs: TMA + wgmma
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 288;                    // 2 warpgroups + a warp
constexpr int A_TILE = BM * BK * 2;             // 16 KB
constexpr int B_BOX = BK * 64 * 2;              // 8 KB: 64 k x 64 n
constexpr int STAGE = A_TILE + 4 * B_BOX;       // 48 KB
constexpr int SMEM = STAGES * STAGE + 1024;     // + 1024-byte alignment
}  // namespace wg

__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* tm,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* tm,
                                            int c0, int c1, int c2,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major (A): rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO unused. N-major
// (B): 64-column atoms `lbo` bytes apart (LBO), 8-row groups along k
// 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t gmma_desc(unsigned saddr, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators at this point of the program (no read or write of
// them moves across it).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MOE_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 float32, the m64n256 fragment) += A (64 x 16, K-major) .
// B (16 x 256, N-major): bf16 in, float32 accumulate.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      "%122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MOE_F8(0), MOE_F8(8), MOE_F8(16), MOE_F8(24), MOE_F8(32),
        MOE_F8(40), MOE_F8(48), MOE_F8(56), MOE_F8(64), MOE_F8(72),
        MOE_F8(80), MOE_F8(88), MOE_F8(96), MOE_F8(104), MOE_F8(112),
        MOE_F8(120)
      : "l"(da), "l"(db), "r"(1));
}

#undef MOE_F8

// kGateUp: a = xs (n x d), b0 = w_gate, b1 = w_up (E, d, f), out = h (n x
// f) bf16, a tile's 128 output columns from n0 = blockIdx.x * 128.
// Otherwise: a = h (n x f), b0 = w_down (E, f, d), out = y (n x d) float32
// at row perm[p], times gates[perm[p]], 256 columns from blockIdx.x * 256.
template <bool kGateUp>
__global__ void __launch_bounds__(wg::THREADS, 1)
    moe_gemm_wgmma(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b0,
                   const __grid_constant__ CUtensorMap tm_b1,
                   const int* __restrict__ tiles,
                   const int* __restrict__ offsets,
                   const int* __restrict__ perm,
                   const float* __restrict__ gates, void* __restrict__ out,
                   int k_dim, int n_dim) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int e = tiles[2 * blockIdx.y];
  if (e < 0) return;
  const int row0 = tiles[2 * blockIdx.y + 1];
  const int rows = min(BM, offsets[e + 1] - row0);
  const int n0 = blockIdx.x * (kGateUp ? BN / 2 : BN);
  const unsigned base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int nk = (k_dim + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                                  // the producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(smem_addr(&empty[s]), ((kt / STAGES) - 1) & 1);
        const unsigned fb = smem_addr(&full[s]);
        const unsigned sa = base + s * STAGE, sb = sa + A_TILE;
        const int k0 = kt * BK;
        mbar_expect_tx(fb, STAGE);
        tma_load_2d(sa, &tm_a, k0, row0, fb);
        if (kGateUp) {
          tma_load_3d(sb, &tm_b0, n0, k0, e, fb);
          tma_load_3d(sb + B_BOX, &tm_b0, n0 + 64, k0, e, fb);
          tma_load_3d(sb + 2 * B_BOX, &tm_b1, n0, k0, e, fb);
          tma_load_3d(sb + 3 * B_BOX, &tm_b1, n0 + 64, k0, e, fb);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_3d(sb + j * B_BOX, &tm_b0, n0 + 64 * j, k0, e, fb);
        }
      }
    }
    return;
  }

  // the two consumer warpgroups: rows wgi*64 .. wgi*64 + 63 of the tile
  const int wgi = warp >> 2;
  const bool active = rows > wgi * 64;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_addr(&full[s]), (kt / STAGES) & 1);
    if (active) {
      const unsigned sa = base + s * STAGE + wgi * 64 * 128;
      const unsigned sb = base + s * STAGE + A_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(acc, gmma_desc(sa + kk * 32, 16, 1024),
                         gmma_desc(sb + kk * 2048, B_BOX, 1024));
      wgmma_commit();
      wgmma_wait<1>();
    }
    if (kt > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(smem_addr(&empty[(kt - 1) % STAGES]));
  }
  if (!active) return;
  wgmma_wait<0>();
  fence_acc(acc);

  // the m64n256 fragment: acc[4j + 2h + c] is row 16*(warp%4) + lane/4 +
  // 8h, column 8j + 2*(lane%4) + c of the warpgroup's 64 x 256
  const int r_lo = wgi * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  if (kGateUp) {
    bf16* h = static_cast<bf16*>(out);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= rows) continue;
      bf16* dst = h + (long long)(row0 + row) * n_dim + n0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + c_lo;
        if (n0 + col >= n_dim) continue;
        const int i = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            silu_mul(acc[i], acc[i + 64]), silu_mul(acc[i + 1], acc[i + 65]));
      }
    }
  } else {
    float* y = static_cast<float*>(out);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= rows) continue;
      const int a = perm[row0 + row];
      const float g = gates[a];
      float* dst = y + (long long)a * n_dim + n0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + c_lo;
        if (n0 + col >= n_dim) continue;
        const int i = 4 * j + 2 * hh;
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[i] * g, acc[i + 1] * g);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3-4. float32 grouped GEMMs on CUDA cores
// ---------------------------------------------------------------------------

namespace simt {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
}  // namespace simt

// The same two products in float32: a CTA takes 64 rows of one expert and
// 64 output columns (gate/up: 64 of each), each thread a 4 x 4 block.
template <bool kGateUp>
__global__ void __launch_bounds__(simt::THREADS)
    moe_gemm_f32(const float* __restrict__ a, const float* __restrict__ b0,
                 const float* __restrict__ b1, const int* __restrict__ tiles,
                 const int* __restrict__ offsets,
                 const int* __restrict__ perm,
                 const float* __restrict__ gates, float* __restrict__ out,
                 int k_dim, int n_dim) {
  using namespace simt;
  constexpr int NB = kGateUp ? 2 : 1;
  __shared__ float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[NB][BK][BN];
  const int e = tiles[2 * blockIdx.y];
  if (e < 0) return;
  const int row0 = tiles[2 * blockIdx.y + 1];
  const int rows = min(BM, offsets[e + 1] - row0);
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* w[2] = {b0 + (long long)e * k_dim * n_dim,
                       kGateUp ? b1 + (long long)e * k_dim * n_dim : b0};
  float acc[NB][4][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.f;
  for (int k0 = 0; k0 < k_dim; k0 += BK) {
    {
      const int rr = tid >> 2, kc = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < rows && k0 + kc < k_dim)
        v = *reinterpret_cast<const float4*>(
            a + (long long)(row0 + rr) * k_dim + k0 + kc);
      As[kc][rr] = v.x;
      As[kc + 1][rr] = v.y;
      As[kc + 2][rr] = v.z;
      As[kc + 3][rr] = v.w;
    }
    {
      const int kk = tid >> 4, nc = (tid & 15) * 4;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < k_dim && n0 + nc < n_dim)
          v = *reinterpret_cast<const float4*>(
              w[b] + (long long)(k0 + kk) * n_dim + n0 + nc);
        *reinterpret_cast<float4*>(&Bs[b][kk][nc]) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[b][kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[b][i][0] = fmaf(av[i], bv.x, acc[b][i][0]);
          acc[b][i][1] = fmaf(av[i], bv.y, acc[b][i][1]);
          acc[b][i][2] = fmaf(av[i], bv.z, acc[b][i][2]);
          acc[b][i][3] = fmaf(av[i], bv.w, acc[b][i][3]);
        }
      }
    }
    __syncthreads();
  }
  const int col = n0 + tx * 4;
  if (col >= n_dim) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= rows) continue;
    float4 v;
    if (kGateUp) {
      v = make_float4(silu_mul(acc[0][i][0], acc[NB - 1][i][0]),
                      silu_mul(acc[0][i][1], acc[NB - 1][i][1]),
                      silu_mul(acc[0][i][2], acc[NB - 1][i][2]),
                      silu_mul(acc[0][i][3], acc[NB - 1][i][3]));
      store4(out + (long long)(row0 + row) * n_dim + col, v);
    } else {
      const int as = perm[row0 + row];
      const float g = gates[as];
      v = make_float4(acc[0][i][0] * g, acc[0][i][1] * g, acc[0][i][2] * g,
                      acc[0][i][3] * g);
      store4(out + (long long)as * n_dim + col, v);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first) as TMA boxes of 64 x
// box1 (x 1), 128-byte swizzle, zero fill out of bounds.
bool tensor_map(CUtensorMap* tm, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                cuuint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[3] = {64, box1, 1}, unit[3] = {1, 1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// rows x cols, row-major
bool matrix_map(CUtensorMap* tm, const void* ptr, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  return tensor_map(tm, ptr, 2, dims, strides, wg::BM);
}

// (E, k, n) stacked expert weights, read as 64 (n) x 64 (k) boxes
bool weight_map(CUtensorMap* tm, const void* ptr, int E, int k, int n) {
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)k, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 2, (cuuint64_t)k * n * 2};
  return tensor_map(tm, ptr, 3, dims, strides, wg::BK);
}

template <bool kGateUp>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb0,
                         const CUtensorMap& tb1, const int* tiles,
                         const int* offsets, const int* perm,
                         const float* gates, void* out, int k_dim, int n_dim,
                         int R, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_gemm_wgmma<kGateUp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::SMEM);
  if (attr != cudaSuccess) return attr;
  const int cols = kGateUp ? wg::BN / 2 : wg::BN;
  const dim3 grid((n_dim + cols - 1) / cols, R);
  moe_gemm_wgmma<kGateUp><<<grid, wg::THREADS, wg::SMEM, st>>>(
      ta, tb0, tb1, tiles, offsets, perm, gates, out, k_dim, n_dim);
  return cudaGetLastError();
}

template <bool kGateUp>
cudaError_t launch_f32(const float* a, const float* b0, const float* b1,
                       const int* tiles, const int* offsets, const int* perm,
                       const float* gates, float* out, int k_dim, int n_dim,
                       int R, cudaStream_t st) {
  const dim3 grid((n_dim + simt::BN - 1) / simt::BN, R);
  moe_gemm_f32<kGateUp><<<grid, simt::THREADS, 0, st>>>(
      a, b0, b1, tiles, offsets, perm, gates, out, k_dim, n_dim);
  return cudaGetLastError();
}

// Blocks of a row-at-a-time pass over `rows` rows: one a row, at most
// 16 an SM.
int rows_grid(int rows) {
  const int cap = 16 * hopper::sm_count();
  return rows < cap ? rows : cap;
}

long long up256(long long bytes) { return (bytes + 255) & ~255LL; }

// Row tile of the grouped products for a dtype (0 float32, 1 bfloat16).
int tile_rows(int dtype) { return dtype == 1 ? wg::BM : simt::BM; }

bool shapes_ok(int T, int K, int E, int d, int f, int bm, int R) {
  return T > 0 && K > 0 && E >= 1 && E <= kMaxExperts && d > 0 && f > 0 &&
         d % 8 == 0 && f % 8 == 0 && (long long)T * K < (1LL << 31) &&
         bm > 0 && R == (T * K + bm - 1) / bm + E;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dispatch tables alone: ints = offsets (E + 1), perm (T*K), tiles
// (R x 2). Returns a cudaError_t (0 = launched).
extern "C" int moe_dispatch(const long long* ids, long long ld, int T, int K,
                            int E, int bm, int R, int* ints, void* stream) {
  if (T <= 0 || K <= 0 || E < 1 || E > kMaxExperts || bm <= 0 ||
      (long long)T * K >= (1LL << 31) || R != (T * K + bm - 1) / bm + E)
    return (int)cudaErrorInvalidValue;
  const int n = T * K;
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_dispatch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dispatch_smem(kMaxExperts));
  if (attr != cudaSuccess) return (int)attr;
  moe_dispatch_kernel<<<1, kDispatchThreads, dispatch_smem(E),
                        (cudaStream_t)stream>>>(
      ids, ld, n, K, E, bm, R, ints, ints + E + 1, ints + E + 1 + n);
  return (int)cudaGetLastError();
}

// Bytes of moe_forward's scratch at these shapes.
extern "C" long long moe_scratch_bytes(int dtype, int T, int K, int E, int d,
                                       int f, int R) {
  const long long n = (long long)T * K, esize = dtype == 1 ? 2 : 4;
  return up256((E + 1 + n + 2LL * R) * 4) + up256(n * d * esize) +
         up256(n * f * esize) + n * d * 4;
}

// The whole top-k expert layer. dtype 0 float32, 1 bfloat16 (x, the
// weights, xs, h and out); ids (T, K) int64 with row stride ld; gates (T,
// K) float32 contiguous; w_gate, w_up (E, d, f); w_down (E, f, d);
// scratch: `scratch_bytes` bytes (at least moe_scratch_bytes), carved
// into ints (E + 1 + T*K + 2R int32), xs (T*K, d), h (T*K, f) and y
// (T*K, d) float32, each 256-byte aligned; out (T, d). Returns a
// cudaError_t (0 = launched).
extern "C" int moe_forward(int dtype, const void* x, const long long* ids,
                           long long ld, const float* gates,
                           const void* w_gate, const void* w_up,
                           const void* w_down, int T, int K, int E, int d,
                           int f, int bm, int R, void* scratch,
                           long long scratch_bytes, void* out, void* stream) {
  if ((dtype != 0 && dtype != 1) || bm != tile_rows(dtype) ||
      !shapes_ok(T, K, E, d, f, bm, R) ||
      scratch_bytes < moe_scratch_bytes(dtype, T, K, E, d, f, R))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = T * K;
  const int esize = dtype == 1 ? 2 : 4;
  char* base = static_cast<char*>(scratch);
  int* ints = reinterpret_cast<int*>(base);
  base += up256((long long)(E + 1 + n + 2 * R) * 4);
  void* xs = base;
  base += up256((long long)n * d * esize);
  void* h = base;
  base += up256((long long)n * f * esize);
  float* y = reinterpret_cast<float*>(base);
  const int* offsets = ints;
  const int* perm = ints + E + 1;
  const int* tiles = perm + n;
  int err = moe_dispatch(ids, ld, T, K, E, bm, R, ints, stream);
  if (err != 0) return err;
  const int vecs = d * esize / 16;
  moe_gather_kernel<<<rows_grid(n), 256, 0, st>>>(
      static_cast<const uint4*>(x), perm, static_cast<uint4*>(xs), n, K, vecs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dtype == 1) {
    CUtensorMap ta, tg, tu, th, td;
    if (!matrix_map(&ta, xs, n, d) || !weight_map(&tg, w_gate, E, d, f) ||
        !weight_map(&tu, w_up, E, d, f) || !matrix_map(&th, h, n, f) ||
        !weight_map(&td, w_down, E, f, d))
      return (int)cudaErrorInvalidValue;
    e = launch_wgmma<true>(ta, tg, tu, tiles, offsets, perm, gates, h, d, f,
                           R, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_wgmma<false>(th, td, td, tiles, offsets, perm, gates, y, f, d,
                            R, st);
    if (e != cudaSuccess) return (int)e;
    moe_combine_kernel<bf16><<<rows_grid(T), 256, 0, st>>>(
        y, static_cast<bf16*>(out), T, K, d);
  } else {
    e = launch_f32<true>(static_cast<const float*>(xs),
                         static_cast<const float*>(w_gate),
                         static_cast<const float*>(w_up), tiles, offsets,
                         perm, gates, static_cast<float*>(h), d, f, R, st);
    if (e != cudaSuccess) return (int)e;
    e = launch_f32<false>(static_cast<const float*>(h),
                          static_cast<const float*>(w_down), nullptr, tiles,
                          offsets, perm, gates, y, f, d, R, st);
    if (e != cudaSuccess) return (int)e;
    moe_combine_kernel<float><<<rows_grid(T), 256, 0, st>>>(
        y, static_cast<float*>(out), T, K, d);
  }
  return (int)cudaGetLastError();
}

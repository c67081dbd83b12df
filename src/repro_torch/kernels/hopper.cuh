// Helpers shared by the port's kernels for Hopper (sm_90a): PTX
// wrappers for mbarriers, cp.async, ldmatrix and mma.sync, the tile
// swizzle, and the
// two attention products of one K/V stage in the mma.sync m16n8k16
// fragment layout (bf16 on tensor cores, float32 on CUDA cores).
// Included by paged_attention/csrc/paged_attention.cu,
// flash_attention/csrc/flash_attention.cu, ssd_scan/csrc/ssd_scan.cu
// (the copies, dot4 and sm_count), msgq/csrc/msgq.cu and moe/csrc/moe.cu
// (the mbarriers); kernels/_build.py hashes every
// header under kernels/ into each library's key, so a changed header
// rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers: init with an arrival count, arrive with a transaction
// count, arrive, and wait for a phase of this parity (trap, a launch
// error and not a hang, if it has not completed after ~8 s).
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  }
}

// 16 bytes global -> shared; with ok false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when ok is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Element offset of 16-byte chunk c of row r in a tile of rows of HD
// elements: chunk c sits at chunk c ^ (r & 7), so the eight rows an
// ldmatrix reads fall in eight different bank groups.
template <typename T, int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + ((c ^ (r & 7)) * (16 / (int)sizeof(T)));
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// the two products of a stage of NK tokens, in the mma.sync m16n8k16
// fragment layout: lane (gid = lane / 4, tq = lane % 4) of warp w holds
// rows w*16 + gid and w*16 + gid + 8, columns 8n + 2tq and 8n + 2tq + 1
// of each 8-wide n-tile: s[n][0..1] (first row), s[n][2..3] (second row)
// ---------------------------------------------------------------------------

// s = Q K^T over the stage's NK tokens: bf16 on tensor cores.
template <int HD, int NK>
__device__ __forceinline__ void qk(float (&s)[NK / 8][4], const bf16* qs,
                                   const bf16* ks, int w, int lane) {
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + swz<bf16, HD>(w * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, ks + swz<bf16, HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The same in float32 on CUDA cores.
template <int HD, int NK>
__device__ __forceinline__ void qk(float (&s)[NK / 8][4], const float* qs,
                                   const float* ks, int w, int lane) {
  const int r0 = w * 16 + (lane >> 2), tq = lane & 3;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll(HD <= 128 ? HD / 4 : 4)
  for (int c = 0; c < HD / 4; ++c) {
    const float4 qa = *reinterpret_cast<const float4*>(qs + swz<float, HD>(r0, c));
    const float4 qb =
        *reinterpret_cast<const float4*>(qs + swz<float, HD>(r0 + 8, c));
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
      const int t = 8 * n + 2 * tq;
      const float4 k0 = *reinterpret_cast<const float4*>(ks + swz<float, HD>(t, c));
      const float4 k1 =
          *reinterpret_cast<const float4*>(ks + swz<float, HD>(t + 1, c));
      s[n][0] = dot4(qa, k0, s[n][0]);
      s[n][1] = dot4(qa, k1, s[n][1]);
      s[n][2] = dot4(qb, k0, s[n][2]);
      s[n][3] = dot4(qb, k1, s[n][3]);
    }
  }
}

// o += P V over the stage: p rounded to bf16 (as the Pallas kernels'
// p.astype(v.dtype)), V fragments by ldmatrix.trans.
template <int HD, int NK>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                   const float (&pr)[NK / 8][4],
                                   const bf16* vs, float*, int, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(pr[2 * kk][0], pr[2 * kk][1]);
    a[1] = pack_bf16(pr[2 * kk][2], pr[2 * kk][3]);
    a[2] = pack_bf16(pr[2 * kk + 1][0], pr[2 * kk + 1][1]);
    a[3] = pack_bf16(pr[2 * kk + 1][2], pr[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + swz<bf16, HD>(kk * 16 + (lane & 7) +
                                              (((lane >> 3) & 1) << 3),
                                          2 * dp + (lane >> 4)));
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// The same in float32: p goes through the warp's scratch rows (16 rows
// of NK + 1 floats a warp) so that each lane can read the full rows it
// needs.
template <int HD, int NK>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                   const float (&pr)[NK / 8][4],
                                   const float* vs, float* ps, int w,
                                   int lane) {
  constexpr int kPStride = NK + 1;
  const int gid = lane >> 2, tq = lane & 3;
  float* pa_row = ps + (w * 16 + gid) * kPStride;
  float* pb_row = pa_row + 8 * kPStride;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
    pa_row[8 * n + 2 * tq] = pr[n][0];
    pa_row[8 * n + 2 * tq + 1] = pr[n][1];
    pb_row[8 * n + 2 * tq] = pr[n][2];
    pb_row[8 * n + 2 * tq + 1] = pr[n][3];
  }
  __syncwarp();
#pragma unroll 2
  for (int t = 0; t < NK; ++t) {
    const float pa = pa_row[t], pb = pb_row[t];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + 2 * tq;
      const float2 v = *reinterpret_cast<const float2*>(
          vs + swz<float, HD>(t, col >> 2) + (col & 3));
      o[n][0] = fmaf(pa, v.x, o[n][0]);
      o[n][1] = fmaf(pa, v.y, o[n][1]);
      o[n][2] = fmaf(pb, v.x, o[n][2]);
      o[n][3] = fmaf(pb, v.y, o[n][3]);
    }
  }
}

// The current device's SM count (host side; read once).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

}  // namespace hopper

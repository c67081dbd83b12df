// Mamba2 SSD chunk scan for Hopper (sm_90a): the scan of every monolithic
// prefill and every prefill chunk of the SSM and hybrid families.
//
// Replaces the TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan/
// ssd_scan.py (via `ssd_scan_fwd`). Per (batch row b, head h) the f32 state
// (p, n) is carried through the chunks of length l in order; one chunk
// computes, with dA = dt * A and cum = cumsum(dA) over the chunk:
//   * the intra-chunk term  y_diag = ((C . B^T) o L) . (x * dt), with
//     L[i, j] = exp(cum_i - cum_j) for i >= j (only i >= j is formed, so
//     the exp of a positive difference above the diagonal never happens);
//   * the carried term      y_off  = exp(cum) o (C . state^T);
//   * the fold              state <- state * exp(cum_last)
//                                    + (x * dt)^T . (B o exp(cum_last - cum)).
// y = y_diag + y_off in x's dtype; the final state is written in f32.
// Accumulation is f32 throughout; x may be f32 or bf16, B and C f32 or
// bf16 (both the same), dt and A f32. ngroups = 1: B and C are shared by
// the heads.
//
// Where it departs from the Pallas kernel:
//   * The chunk grid is the caller's `l`, anchored at position 0, and is
//     never shrunk; a ragged S is allowed: positions >= S are masked as
//     exact no-ops (dt = x = B = C = 0, so their decay is exp(0) = 1 and
//     they add nothing), as the model's `ssd_chunked` pads them. Every
//     chunk's arithmetic depends only on its own inputs and the state it
//     is handed, in a fixed order (no atomics), so a scan split at chunk
//     boundaries and resumed from the returned state is bit-identical to
//     one call.
//   * Strided operands: x and y through (batch, head, position) strides,
//     dt through (batch, head, position), B and C through (batch,
//     position), each with a contiguous last dimension, so the model's
//     (B, S, H, p) and (B, S, H) activations are read and written in
//     place.
//
// What bounds it on this card: at mamba2's widths (l = 128, p = 64,
// n = 128) a chunk is ~7.4 MFLOP per (b, h) against ~0.1 MB of the
// (b, h)'s own bytes, so the scan is bound by operations; on the CUDA
// cores (no tensor cores here) by its own FMA and shared-memory issue rate.
// The design is the simple one:
//   * One CTA of 256 threads per (b, h): B * H CTAs (64 for a mamba2 chunk
//     dispatch of 2 rows, 256 for a static prefill of 8; hymba's 50 heads
//     give 100 and 400), each walking its chunks in order. Fewer CTAs than
//     the card has SMs leave SMs idle; that is later work.
//   * Shared memory, f32: the chunk's B (l x n, rows padded by one float
//     so a warp reading 32 rows at one column is conflict-free), x * dt
//     (l x p), the state (p x n, padded), and the score matrix tiled by
//     row blocks of R = min(l, 32) rows with their C rows: at mamba2's
//     widths 163 KB, where the whole l x l scores with all of C would need
//     over 256 KB. Set with cudaFuncSetAttribute.
//   * Loops over output elements with a block stride: the scores of a
//     row block (only the causal part), then its y rows, then, after the
//     last row block, the state fold (each thread owns its state
//     elements, so the fold is in place).
// Not yet done (later work): tensor cores (mma.sync / wgmma) for the four
// products, cp.async or TMA double buffering of the next chunk, and more
// CTAs per (b, h) (a split over p, or a parallel chunk-state pass) to fill
// the card at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a Hopper CTA's dynamic shared memory

struct Params {
  const void* x;     // (B, H, S, p) through x_s*
  const float* dt;   // (B, H, S) through dt_s*
  const float* A;    // (H,)
  const void* Bm;    // (B, S, n) through b_s*
  const void* Cm;    // (B, S, n) through c_s*
  const float* s0;   // (B, H, p, n) contiguous, or null for zeros
  void* y;           // (B, H, S, p) through y_s*
  float* fs;         // (B, H, p, n) contiguous
  long long x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, b_sb, b_ss, c_sb, c_ss,
      y_sb, y_sh, y_ss;
  int B, H, S, p, n, l, R;
};

__device__ __forceinline__ float load(const float* a) { return *a; }
__device__ __forceinline__ float load(const __nv_bfloat16* a) {
  return __bfloat162float(*a);
}
__device__ __forceinline__ void store(float* a, float v) { *a = v; }
__device__ __forceinline__ void store(__nv_bfloat16* a, float v) {
  *a = __float2bfloat16(v);
}

int row_block(int l) { return l < 32 ? l : 32; }

size_t smem_bytes(int p, int n, int l) {
  const size_t R = row_block(l);
  return sizeof(float) *
         ((size_t)l * (n + 1) + (size_t)l * p + (size_t)p * (n + 1) +
          R * (n + 1) + R * l + 4 * (size_t)l);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Params p) {
  extern __shared__ float smem[];
  const int P = p.p, N = p.n, Lc = p.l, R = p.R;
  const int NS = N + 1;  // padded row stride of the B, C and state tiles
  float* Bs = smem;               // Lc x NS: B of the chunk
  float* Xs = Bs + Lc * NS;       // Lc x P:  x * dt of the chunk
  float* St = Xs + Lc * P;        // P x NS:  the carried state
  float* Cs = St + P * NS;        // R x NS:  C of a row block
  float* Sc = Cs + R * NS;        // R x Lc:  scores of a row block
  float* cum = Sc + R * Lc;       // Lc: cumsum(dt * A)
  float* ecum = cum + Lc;         // Lc: exp(cum)
  float* wdec = ecum + Lc;        // Lc: exp(cum_last - cum)
  float* dts = wdec + Lc;         // Lc: dt

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float a = p.A[h];
  const TX* xg = static_cast<const TX*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const TB* bg = static_cast<const TB*>(p.Bm) + b * p.b_sb;
  const TB* cg = static_cast<const TB*>(p.Cm) + b * p.c_sb;
  TX* yg = static_cast<TX*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long sbase = (long long)blockIdx.x * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    St[(e / N) * NS + e % N] = p.s0 ? p.s0[sbase + e] : 0.f;
  }

  const int nchunks = (p.S + Lc - 1) / Lc;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Lc;
    for (int s = tid; s < Lc; s += kThreads) {
      const int t = t0 + s;
      dts[s] = t < p.S ? dtg[(long long)t * p.dt_ss] : 0.f;
    }
    // orders dts before its readers and the previous chunk's state fold
    // (which reads Xs, Bs, wdec) before they are overwritten
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int s = 0; s < Lc; ++s) {
        run += dts[s] * a;
        cum[s] = run;
      }
    }
    for (int e = tid; e < Lc * P; e += kThreads) {
      const int s = e / P, j = e % P;
      const int t = t0 + s;
      Xs[e] = t < p.S ? load(xg + (long long)t * p.x_ss + j) * dts[s] : 0.f;
    }
    for (int e = tid; e < Lc * N; e += kThreads) {
      const int s = e / N, k = e % N;
      const int t = t0 + s;
      Bs[s * NS + k] = t < p.S ? load(bg + (long long)t * p.b_ss + k) : 0.f;
    }
    __syncthreads();
    const float clast = cum[Lc - 1];
    for (int s = tid; s < Lc; s += kThreads) {
      ecum[s] = expf(cum[s]);
      wdec[s] = expf(clast - cum[s]);
    }
    // (ecum and wdec are read only after the row blocks' barriers)

    for (int i0 = 0; i0 < Lc; i0 += R) {
      const int rows = min(R, Lc - i0);
      for (int e = tid; e < rows * N; e += kThreads) {
        const int ii = e / N, k = e % N;
        const int t = t0 + i0 + ii;
        Cs[ii * NS + k] = t < p.S ? load(cg + (long long)t * p.c_ss + k) : 0.f;
      }
      __syncthreads();
      // scores of rows i0 .. i0 + rows - 1: only columns s <= i are
      // nonzero, so the block needs columns 0 .. i0 + rows - 1
      const int ncol = i0 + rows;
      for (int e = tid; e < rows * ncol; e += kThreads) {
        const int ii = e / ncol, s = e % ncol;
        const int i = i0 + ii;
        float v = 0.f;
        if (s <= i) {
          const float* cr = Cs + ii * NS;
          const float* br = Bs + s * NS;
          float dot = 0.f;
          for (int k = 0; k < N; ++k) dot = fmaf(cr[k], br[k], dot);
          v = dot * expf(cum[i] - cum[s]);
        }
        Sc[ii * Lc + s] = v;
      }
      __syncthreads();
      for (int e = tid; e < rows * P; e += kThreads) {
        const int ii = e / P, j = e % P;
        const int i = i0 + ii;
        const int t = t0 + i;
        if (t >= p.S) continue;
        const float* sr = Sc + ii * Lc;
        float diag = 0.f;
        for (int s = 0; s <= i; ++s) diag = fmaf(sr[s], Xs[s * P + j], diag);
        const float* cr = Cs + ii * NS;
        const float* sj = St + j * NS;
        float off = 0.f;
        for (int k = 0; k < N; ++k) off = fmaf(cr[k], sj[k], off);
        store(yg + (long long)t * p.y_ss + j, diag + off * ecum[i]);
      }
      // Cs and Sc are rewritten by the next row block; the state is
      // folded only after every row block has read it
      __syncthreads();
    }

    const float dlast = expf(clast);
    for (int e = tid; e < P * N; e += kThreads) {
      const int j = e / N, k = e % N;
      float acc = 0.f;
      for (int s = 0; s < Lc; ++s)
        acc = fmaf(Xs[s * P + j], Bs[s * NS + k] * wdec[s], acc);
      St[j * NS + k] = St[j * NS + k] * dlast + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    p.fs[sbase + e] = St[(e / N) * NS + e % N];
  }
}

template <typename TX, typename TB>
cudaError_t launch(const Params& p, void* stream) {
  const size_t smem = smem_bytes(p.p, p.n, p.l);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<TX, TB><<<p.B * p.H, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_b(const Params& p, int bc_dtype, void* stream) {
  if (bc_dtype == 0) return launch<TX, float>(p, stream);
  if (bc_dtype == 1) return launch<TX, __nv_bfloat16>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory of one CTA at these widths, in bytes; a launch that
// needs more than kMaxSmem returns cudaErrorInvalidValue.
extern "C" long long ssd_smem_bytes(int p, int n, int chunk) {
  return (long long)smem_bytes(p, n, chunk);
}

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (x; B and C). strides: 13
// element strides: x (batch, head, position), dt (batch, head, position),
// B (batch, position), C (batch, position), y (batch, head, position); the
// last dimension of x, B, C and y is contiguous. s0 may be null (zeros).
// Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan(int x_dtype, int bc_dtype, const void* x,
                        const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* s0, void* y, float* fs,
                        const long long* strides, int B, int H, int S, int p,
                        int n, int chunk, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Params q;
  q.x = x; q.dt = dt; q.A = A; q.Bm = Bm; q.Cm = Cm; q.s0 = s0; q.y = y;
  q.fs = fs;
  q.x_sb = strides[0]; q.x_sh = strides[1]; q.x_ss = strides[2];
  q.dt_sb = strides[3]; q.dt_sh = strides[4]; q.dt_ss = strides[5];
  q.b_sb = strides[6]; q.b_ss = strides[7];
  q.c_sb = strides[8]; q.c_ss = strides[9];
  q.y_sb = strides[10]; q.y_sh = strides[11]; q.y_ss = strides[12];
  q.B = B; q.H = H; q.S = S; q.p = p; q.n = n; q.l = chunk;
  q.R = row_block(chunk);
  if (x_dtype == 0) return (int)launch_b<float>(q, bc_dtype, stream);
  if (x_dtype == 1) return (int)launch_b<__nv_bfloat16>(q, bc_dtype, stream);
  return (int)cudaErrorInvalidValue;
}

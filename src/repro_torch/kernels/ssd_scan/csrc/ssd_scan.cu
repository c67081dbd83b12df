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
//                                    + (x * dt * exp(cum_last - cum))^T . B.
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
//     output element is summed in one fixed order (no atomics), whatever
//     CTA computes it, so a scan split at chunk boundaries and resumed
//     from the returned state is bit-identical to one call, and the column
//     split below does not change a bit of the result.
//   * Strided operands: x and y through (batch, head, position) strides,
//     dt through (batch, head, position), B and C through (batch,
//     position), each with a contiguous last dimension, so the model's
//     (B, S, H, p) and (B, S, H) activations are read and written in
//     place.
//   * l <= 128 and n <= 128 (the configs' ssm_chunk is 128; mamba2's n is
//     128, hymba's 16); a launch outside that, or one whose shared memory
//     exceeds a CTA's, returns cudaErrorInvalidValue.
//
// What bounds it on this card: at mamba2's widths (l = 128, p = 64,
// n = 128) a chunk is ~7.4 MFLOP per (b, h) against ~0.1 MB of the
// (b, h)'s own bytes: operations. The products stay on the CUDA cores in
// full f32 (a single-pass TF32 mma would not hold the float32 tolerance).
// The design:
//   1. More CTAs. y[:, j] and state row j depend only on x[:, j], the
//      state's row j and the shared C, B and dt, so each (b, h) is split by
//      columns of p into CTAs of PC = 16, 32 or 64 columns, each carrying
//      its own slice of the state through the chunks. The launch takes the
//      widest PC that still gives at least one CTA per SM (`plan`): a
//      mamba2 chunk dispatch of 2 rows (64 (b, h)) runs 256 CTAs of 16
//      columns, a static prefill of 8 rows 256 CTAs of 64. The split's
//      cost: each CTA forms C . B^T itself, ~1.3 M of its ~2 M FMAs at
//      PC = 16.
//   2. Register tiles. Each thread owns a tile of each product, so one
//      shared-memory load feeds several FMAs: C . B^T as 4 rows x 4
//      columns (float4 along n), y as one row x PC/8 columns (the diagonal
//      and carried terms of an output in one thread), the fold as PC/8
//      state rows x 4 columns (float4 along n).
//   3. A parallel cumsum: warp 0 scans dt * A (each lane a run of l/32
//      steps, then a shuffle scan across lanes), in a fixed order.
//   4. cp.async staging: B, x and the C rows of a row block go to shared
//      memory by 16-byte copies (ragged rows zero-filled by the copy), dt
//      by 4-byte ones. The next chunk's dt and its first C rows are in
//      flight while this chunk folds its state; x and B reuse their
//      buffers and follow the fold.
//   5. The l x l score matrix is formed by row blocks of 32 rows, only
//      its causal column blocks, into the buffer that held the block's C
//      rows (the carried term reads C first), so a 16-column CTA takes
//      about 101 KB of shared memory and two fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::dot4;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a Hopper CTA's dynamic shared memory
constexpr int kMaxChunk = 128;    // l: four 32-column blocks of scores
constexpr int kMaxState = 128;    // n padded: one float4 of n a lane
constexpr int kRB = 32;           // rows of a score row block

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
  int B, H, S, p, n, l;
  int np;      // n padded to a power of two >= 4
  int nsplit;  // CTAs per (b, h): ceil(p / PC)
  int vec_x, vec_bc, vec_s0;  // staged by 16-byte cp.async
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 a) {
  return __bfloat162float(a);
}
__device__ __forceinline__ void store(float* a, float v) { *a = v; }
__device__ __forceinline__ void store(__nv_bfloat16* a, float v) {
  *a = __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}

// Rows [0, rows) of a tile (row stride ds floats, `quads` float4 a row)
// from src (row stride ss elements): rows at or past `valid` and columns
// at or past `cols` are zeros. `vec`: T is float, cols % 4 == 0 and every
// row 16-byte aligned, so each float4 is one cp.async; otherwise plain
// loads (bf16 widened to f32).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ds, const T* src,
                                      long long ss, int rows, int valid,
                                      int cols, int quads, bool vec) {
  for (int e = threadIdx.x; e < rows * quads; e += kThreads) {
    const int r = e / quads, q = e - r * quads;
    float* d = dst + r * ds + 4 * q;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        const bool ok = r < valid && 4 * q < cols;
        cp_async16(d, ok ? src + r * ss + 4 * q : src, ok);
        continue;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * q + u;
      d[u] = r < valid && c < cols ? to_f32(src[r * ss + c]) : 0.f;
    }
  }
}

// dt of the chunk at t0 (zeros past S), by 4-byte cp.async.
__device__ __forceinline__ void stage_dt(float* dts, const float* dtg,
                                         long long dt_ss, int t0, int S,
                                         int L) {
  for (int s = threadIdx.x; s < L; s += kThreads) {
    const bool ok = t0 + s < S;
    cp_async4(dts + s, ok ? dtg + (long long)(t0 + s) * dt_ss : dtg, ok);
  }
}

// Scores C . B^T of a row block's rows gi + 4a (C rows in Cs) against
// the NB column blocks 32b + gs (B rows in Bs), over n in float4 steps:
// a warp's loads touch 4 C rows and 8 B rows, one shared-memory wavefront
// each.
template <int NB>
__device__ __forceinline__ void scores(float (&g)[4][4], const float* Cs,
                                       const float* Bs, int NSP, int NQ,
                                       int gi, int gs, int rows, int L) {
#pragma unroll
  for (int u = 0; u < 4; ++u) g[u][0] = g[u][1] = g[u][2] = g[u][3] = 0.f;
  for (int q = 0; q < NQ; ++q) {
    float4 cv[4], bv[NB];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      cv[u] = ld4(Cs + min(gi + 4 * u, rows - 1) * NSP + 4 * q);
#pragma unroll
    for (int v = 0; v < NB; ++v)
      bv[v] = ld4(Bs + min(gs + 32 * v, L - 1) * NSP + 4 * q);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < NB; ++v) g[u][v] = dot4(cv[u], bv[v], g[u][v]);
  }
}

// Shared-memory layout, in floats: B (l x NSP), the row-block buffer
// (C rows, then scores), x (l x PC), the state slice (PC x NSP), and
// cum, exp(cum), exp(cum_last - cum), dt (l each). NSP = np + 4: rows
// 16-byte aligned, and consecutive rows four banks apart.
struct Layout {
  int nsp, scs, rb, region, xs, st, vec;
  __host__ __device__ Layout(int np, int l, int pc) {
    nsp = np + 4;
    scs = l + 1;
    rb = l < kRB ? l : kRB;
    region = ((rb * (nsp > scs ? nsp : scs)) + 3) & ~3;
    xs = l * nsp + region;
    st = xs + l * pc;
    vec = st + pc * nsp;
  }
  __host__ __device__ int floats(int l) const { return vec + 4 * l; }
};

template <typename TX, typename TB, int PC>
__global__ void __launch_bounds__(kThreads, 2) ssd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.l, NQ = p.np / 4;
  const Layout lay(p.np, L, PC);
  const int NSP = lay.nsp, SCS = lay.scs, RB = lay.rb;
  float* Bs = smem;             // L x NSP: B of the chunk
  float* Rg = smem + L * NSP;   // RB x NSP C rows, then RB x SCS scores
  float* Xs = smem + lay.xs;    // L x PC: x, then x * dt, then * wdec
  float* St = smem + lay.st;    // PC x NSP: the state slice
  float* cum = smem + lay.vec;  // L: cumsum(dt * A)
  float* ecum = cum + L;        // L: exp(cum)
  float* wdec = ecum + L;       // L: exp(cum_last - cum)
  float* dts = wdec + L;        // L: dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % p.nsplit, bh = blockIdx.x / p.nsplit;
  const int b = bh / p.H, h = bh % p.H;
  const int j0 = split * PC, pc = min(PC, p.p - j0);  // this CTA's columns
  const float a = p.A[h];
  const TX* xg = static_cast<const TX*>(p.x) + b * p.x_sb + h * p.x_sh + j0;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const TB* bg = static_cast<const TB*>(p.Bm) + b * p.b_sb;
  const TB* cg = static_cast<const TB*>(p.Cm) + b * p.c_sb;
  TX* yg = static_cast<TX*>(p.y) + b * p.y_sb + h * p.y_sh + j0;
  const long long sbase = ((long long)bh * p.p + j0) * p.n;

  // thread tiles: scores (rows gi + 4a, columns gs + 32b), y (row yi,
  // columns yj + 8c), fold (state rows fj + fstep u, float4 fq of n)
  const int gi = 16 * (warp >> 2) + (lane >> 3);
  const int gs = 8 * (warp & 3) + (lane & 7);
  const int yi = tid >> 3, yj = tid & 7;
  const int fq = tid % NQ, fj = tid / NQ, fstep = kThreads / NQ;

  stage(St, NSP, p.s0 ? p.s0 + sbase : p.s0, (long long)p.n, PC,
        p.s0 ? pc : 0, p.n, NQ, p.vec_s0);
  const int nchunks = (p.S + L - 1) / L;
  if (nchunks > 0) {
    stage(Xs, PC, xg, p.x_ss, L, min(L, p.S), pc, PC / 4, p.vec_x);
    stage(Bs, NSP, bg, p.b_ss, L, min(L, p.S), p.n, NQ, p.vec_bc);
    stage(Rg, NSP, cg, p.c_ss, RB, min(RB, p.S), p.n, NQ, p.vec_bc);
    stage_dt(dts, dtg, p.dt_ss, 0, p.S, L);
  }

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * L, valid = min(L, p.S - t0);
    cp_async_wait_all();
    __syncthreads();  // the chunk's x, B, dt and first C rows landed
    for (int e = tid; e < L * PC; e += kThreads) Xs[e] *= dts[e / PC];
    if (warp == 0) {
      // cumsum(dt * A): lane runs of E steps, then a scan across lanes
      const int E = (L + 31) >> 5;
      float run = 0.f, part[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = lane * E + u;
        if (u < E && s < L) run += dts[s] * a;
        part[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = lane * E + u;
        if (u < E && s < L) cum[s] = excl + part[u];
      }
      __syncwarp();
      const float last = cum[L - 1];
      for (int s = lane; s < L; s += 32) {
        ecum[s] = expf(cum[s]);
        wdec[s] = expf(last - cum[s]);
      }
    }
    __syncthreads();
    const float clast = cum[L - 1];

    for (int i0 = 0; i0 < L; i0 += RB) {
      const int rows = min(RB, L - i0);
      if (i0 > 0) {
        stage(Rg, NSP, cg + (long long)(t0 + i0) * p.c_ss, p.c_ss, rows,
              valid - i0, p.n, NQ, p.vec_bc);
        cp_async_wait_all();
        __syncthreads();
      }
      // scores C . B^T of rows gi + 4a, columns gs + 32b (column blocks
      // 32b <= the block's last row only); and the carried term
      // C . state^T of row yi
      const int bmax = (i0 + rows - 1) >> 5;
      float g[4][4];
      switch (bmax) {  // only the column blocks the rows can see
        case 0: scores<1>(g, Rg, Bs, NSP, NQ, gi, gs, rows, L); break;
        case 1: scores<2>(g, Rg, Bs, NSP, NQ, gi, gs, rows, L); break;
        case 2: scores<3>(g, Rg, Bs, NSP, NQ, gi, gs, rows, L); break;
        default: scores<4>(g, Rg, Bs, NSP, NQ, gi, gs, rows, L); break;
      }
      float off[PC / 8];
#pragma unroll
      for (int k = 0; k < PC / 8; ++k) off[k] = 0.f;
      if (yi < rows) {
        for (int q = 0; q < NQ; ++q) {
          const float4 cq = ld4(Rg + yi * NSP + 4 * q);
#pragma unroll
          for (int k = 0; k < PC / 8; ++k)
            off[k] = dot4(cq, ld4(St + (yj + 8 * k) * NSP + 4 * q), off[k]);
        }
      }
      __syncthreads();  // every read of the C rows is done
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ii = gi + 4 * u, i = i0 + ii;
        if (ii >= rows) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int s = gs + 32 * v;
          if (v <= bmax && s < i0 + rows)
            Rg[ii * SCS + s] =
                s <= i ? g[u][v] * expf(cum[i] - cum[s]) : 0.f;
        }
      }
      __syncthreads();
      if (yi < rows) {
        const int i = i0 + yi;
        const float* pr = Rg + yi * SCS;
        float acc[PC / 8];
#pragma unroll
        for (int k = 0; k < PC / 8; ++k) acc[k] = 0.f;
        for (int s = 0; s <= i; ++s) {
          const float pv = pr[s];
          const float* xr = Xs + s * PC + yj;
#pragma unroll
          for (int k = 0; k < PC / 8; ++k) acc[k] = fmaf(pv, xr[8 * k], acc[k]);
        }
        if (i < valid) {
          TX* yr = yg + (long long)(t0 + i) * p.y_ss;
#pragma unroll
          for (int k = 0; k < PC / 8; ++k)
            if (yj + 8 * k < pc)
              store(yr + yj + 8 * k, acc[k] + off[k] * ecum[i]);
        }
      }
      __syncthreads();  // the scores are read before the next C rows land
    }

    // the next chunk's dt and first C rows fly while the state folds
    const bool more = c + 1 < nchunks;
    if (more) {
      stage(Rg, NSP, cg + (long long)(t0 + L) * p.c_ss, p.c_ss, RB,
            min(RB, p.S - t0 - L), p.n, NQ, p.vec_bc);
      stage_dt(dts, dtg, p.dt_ss, t0 + L, p.S, L);
    }
    for (int e = tid; e < L * PC; e += kThreads) Xs[e] *= wdec[e / PC];
    __syncthreads();
    const float dlast = expf(clast);
    float acc[PC / 8][4];
#pragma unroll
    for (int u = 0; u < PC / 8; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float4 bq = ld4(Bs + s * NSP + 4 * fq);
      const float* xr = Xs + s * PC + fj;
#pragma unroll
      for (int u = 0; u < PC / 8; ++u) {
        if (fj + fstep * u >= PC) break;
        const float xv = xr[fstep * u];
        acc[u][0] = fmaf(xv, bq.x, acc[u][0]);
        acc[u][1] = fmaf(xv, bq.y, acc[u][1]);
        acc[u][2] = fmaf(xv, bq.z, acc[u][2]);
        acc[u][3] = fmaf(xv, bq.w, acc[u][3]);
      }
    }
#pragma unroll
    for (int u = 0; u < PC / 8; ++u) {
      if (fj + fstep * u >= PC) break;
      float* sr = St + (fj + fstep * u) * NSP + 4 * fq;
      sr[0] = sr[0] * dlast + acc[u][0];
      sr[1] = sr[1] * dlast + acc[u][1];
      sr[2] = sr[2] * dlast + acc[u][2];
      sr[3] = sr[3] * dlast + acc[u][3];
    }
    __syncthreads();  // x and B are read; the next chunk may overwrite them
    if (more) {
      const int nv = min(L, p.S - t0 - L);
      stage(Xs, PC, xg + (long long)(t0 + L) * p.x_ss, p.x_ss, L, nv, pc,
            PC / 4, p.vec_x);
      stage(Bs, NSP, bg + (long long)(t0 + L) * p.b_ss, p.b_ss, L, nv, p.n,
            NQ, p.vec_bc);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < pc * p.n; e += kThreads) {
    const int j = e / p.n;
    p.fs[sbase + e] = St[j * NSP + (e - j * p.n)];
  }
}

int pow2_at_least(int v, int lo) {
  int r = lo;
  while (r < v) r *= 2;
  return r;
}

// Columns of p a CTA takes: the widest of 64, 32, 16 (and no wider than
// p needs) that still gives at least one CTA per SM.
int cols_per_cta(int B, int H, int p) {
  const long long bh = (long long)B * H;
  const int sms = hopper::sm_count();
  int pc = pow2_at_least(p, 16) < 64 ? pow2_at_least(p, 16) : 64;
  while (pc > 16 && bh * ((p + pc - 1) / pc) < sms) pc /= 2;
  return pc;
}

size_t smem_bytes(int n, int l, int pc) {
  return sizeof(float) *
         (size_t)Layout(pow2_at_least(n, 4), l, pc).floats(l);
}

template <typename TX, typename TB, int PC>
cudaError_t launch(const Params& p, void* stream) {
  const size_t smem = smem_bytes(p.n, p.l, PC);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  // once per instantiation, to the most a CTA may have (each launch asks
  // for its own size): the call costs host time on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<TX, TB, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return attr;
  ssd_kernel<TX, TB, PC><<<p.B * p.H * p.nsplit, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t launch_pc(const Params& p, int pc, void* stream) {
  if (pc == 16) return launch<TX, TB, 16>(p, stream);
  if (pc == 32) return launch<TX, TB, 32>(p, stream);
  if (pc == 64) return launch<TX, TB, 64>(p, stream);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_b(const Params& p, int bc_dtype, int pc, void* stream) {
  if (bc_dtype == 0) return launch_pc<TX, float>(p, pc, stream);
  if (bc_dtype == 1) return launch_pc<TX, __nv_bfloat16>(p, pc, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory of one CTA at these widths, in bytes, for the widest
// column split (64) that p can take; a launch that needs more than
// kMaxSmem returns cudaErrorInvalidValue.
extern "C" long long ssd_smem_bytes(int p, int n, int chunk) {
  const int pc = pow2_at_least(p, 16) < 64 ? pow2_at_least(p, 16) : 64;
  return (long long)smem_bytes(n, chunk, pc);
}

// The launch's shape for these widths on the current device: out[0] the
// columns of p a CTA takes, out[1] the CTAs, out[2] a CTA's shared memory
// in bytes.
extern "C" void ssd_plan(int B, int H, int p, int n, int chunk,
                         long long* out) {
  const int pc = cols_per_cta(B, H, p);
  out[0] = pc;
  out[1] = (long long)B * H * ((p + pc - 1) / pc);
  out[2] = (long long)smem_bytes(n, chunk, pc);
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
      chunk > kMaxChunk || n > kMaxState)
    return (int)cudaErrorInvalidValue;
  const int pc = cols_per_cta(B, H, p);
  Params q;
  q.x = x; q.dt = dt; q.A = A; q.Bm = Bm; q.Cm = Cm; q.s0 = s0; q.y = y;
  q.fs = fs;
  q.x_sb = strides[0]; q.x_sh = strides[1]; q.x_ss = strides[2];
  q.dt_sb = strides[3]; q.dt_sh = strides[4]; q.dt_ss = strides[5];
  q.b_sb = strides[6]; q.b_ss = strides[7];
  q.c_sb = strides[8]; q.c_ss = strides[9];
  q.y_sb = strides[10]; q.y_sh = strides[11]; q.y_ss = strides[12];
  q.B = B; q.H = H; q.S = S; q.p = p; q.n = n; q.l = chunk;
  q.np = pow2_at_least(n, 4);
  q.nsplit = (p + pc - 1) / pc;
  if ((long long)B * H * q.nsplit > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  q.vec_x = x_dtype == 0 && p % 4 == 0 && aligned16(x) && q.x_sb % 4 == 0 &&
            q.x_sh % 4 == 0 && q.x_ss % 4 == 0;
  q.vec_bc = bc_dtype == 0 && n % 4 == 0 && aligned16(Bm) && aligned16(Cm) &&
             q.b_sb % 4 == 0 && q.b_ss % 4 == 0 && q.c_sb % 4 == 0 &&
             q.c_ss % 4 == 0;
  q.vec_s0 = s0 != nullptr && n % 4 == 0 && aligned16(s0);
  if (x_dtype == 0) return (int)launch_b<float>(q, bc_dtype, pc, stream);
  if (x_dtype == 1)
    return (int)launch_b<__nv_bfloat16>(q, bc_dtype, pc, stream);
  return (int)cudaErrorInvalidValue;
}

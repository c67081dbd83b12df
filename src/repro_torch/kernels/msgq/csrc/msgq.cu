// Message-copy kernels for Hopper (sm_90a): the paper's interthread
// message protocols (§3.2) as copies inside one address space, and a
// collective's sequence of message rounds run in one launch.
//
// Replace the TPU kernels of src/repro/kernels/msgq/msgq.py:
//   * msgq_eager    <- `_eager_kernel` (via `eager_copy`): the message
//     passes through a bounded staging cell, src -> cell -> dst (the
//     Pallas kernel: one VMEM cell per grid step).
//   * msgq_one_copy <- `_one_copy_kernel` (via `one_copy`): the receiver
//     copies straight from the sender's buffer, with no staging.
//
// Both run a PROGRAM of message rounds (kernels/msgq/program.py). x holds
// R per-rank slabs of m bytes, `x_stride` bytes apart; out (and, for
// programs of several full-slab rounds, scratch) R contiguous slabs of m
// bytes. A round has entries (src, dst, src offset, dst offset) over
// segments of one length and one combine (Op): what dst's segment
// becomes from its own value a and the message b (zeros where src < 0):
// copy b, add a + b, max torch.maximum(a, b), replace (src < 0 ? a : b).
// A full-slab round names every rank once as dst and reads one buffer
// while it writes another (they alternate, ending in out); a segment
// round (the ring allreduce) updates in place, touching only what it
// names. A single message round of the comm layer is the program of one
// copy round, its pairs passed by value and its kernels specialised for
// it; a program's table lives on the card, cached by the wrapper. Rounds
// after the first read what earlier rounds wrote from other SMs: such
// loads are `ld.global.cg` or bulk copies (through L2); only the input,
// never written in a launch, takes the read-only path. Rounds are parted
// by a grid barrier of a cooperative launch (grid at most the co-resident
// CTAs, from the occupancy calculator with the same shared memory).
//
// The arithmetic is torch's on the card, bit for bit: f32 / f64 add
// rounds once; bf16 and f16 add in f32 and round once; integers wrap
// (added as unsigned); max returns a NaN operand (a first) and else
// fmax, as torch.maximum does; a rank that receives nothing combines
// zeros (-0.0 + 0.0 = +0.0; max lifts negatives to 0). The ring's
// in-place add (kAccumulate) is an atomic add an element, as torch's
// scatter_add does it: for bf16 and f16 a paired atomic that adds +0.0
// to the word's other half, so a program whose chunks do not fill whole
// words stages its messages first (program.py: Program._accumulate).
//
// msgq_eager (the cell pool in shared memory, moved by the TMA): each
// CTA rings through 2-4 slots of two cells (the message, and the
// receiver's own values where the combine needs them). One elected
// thread issues copy 1 (cp.async.bulk global -> shared, completing on the
// slot's mbarrier with the bytes as its transaction count) up to
// slots - 1 items ahead, so it overlaps copy 2 of earlier items; the
// threads combine on the cell (fence.proxy.async before the store reads
// what they wrote); copy 2 is cp.async.bulk shared -> global in a bulk
// group, whose read completion frees the slot, and whose full completion
// (wait_group 0, then a proxy fence) precedes the grid barrier. A
// persistent grid, sized from the SM count and the round's (cell x
// entry) items, strides over them. Bulk copies need 16-byte alignment of
// every address and size: where the access width (the wrapper's _width)
// is less than 16 the kernel takes its vector path instead, threads
// copying through one cell; which path ran is part of chip_smoke.py's
// row.
//
// msgq_one_copy: a direct copy; one warp a CTA moves one 4 KiB piece a
// step (at 16-byte width), eight independent 16-byte loads a lane (and
// the receiver's eight where the combine needs them) before the fused
// combine-and-store; the grid is one CTA a piece up to the co-resident
// limit, so a round of 132 pieces fills every SM. The staged variant
// (global -> shared -> global by bulk copies) is the eager kernel with a
// 16 KiB cell: slower than the direct copy at a 4 MiB message and at a
// 256 KiB-a-rank round (PERF.md §6), so the 1-copy protocol copies
// directly.
//
// What bounds them on this card: bytes (each read once from device
// memory, each written once, 3.35 TB/s) for large rounds; for the comm
// layer's rounds (64 B to 256 KiB a rank) the launch and, within a
// program, each round's copy latency and the grid barrier. Measured by
// chip_smoke.py phase 7 on an NVIDIA H100 80GB HBM3 at a 700.00 W power
// limit (CUDA events, median of 30, L2 flushed; PERF.md §6): an empty
// kernel 0.0051 ms; the eager 4 KiB ring round of 8 ranks 0.0068 ms,
// the 1-copy 64 KiB halo round 0.0065 ms; a 4 MiB message 0.0096 ms by
// the direct copy (0.0098 staged, 0.0102 eager with 4 KiB cells); the
// ring allreduce of 8 ranks at 1024 f32 a rank one launch of 0.0456 ms
// against 0.3955 ms for its 14 rounds one by one.
//
// Later work: a cluster of CTAs exchanging the ranks' cells through
// distributed shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "../../hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kEagerThreads = 128;
constexpr int kDirectThreads = 32;     // one warp: one piece a step
constexpr int kLoads = 8;              // independent loads a lane
constexpr int kMaxPairs = 256;         // entries of a by-value round
constexpr int kMaxCellBytes = 48 * 1024;
constexpr int kSlotBudget = 96 * 1024;       // shared memory of the ring
constexpr int kMaxCtasPerSm = 4;       // a program's grid: barrier cost
constexpr int kHeader = 8, kEntry = 4; // int64 words (program.py: Plan)

// kAccumulate: the ring's add in place, an atomic add an element as
// torch's scatter_add does it (program.py: Plan)
enum Op { kCopy = 0, kAdd = 1, kMax = 2, kReplace = 3, kAccumulate = 4 };

struct Args {
  const char* x;          // R slabs, x_stride bytes apart
  char* out;              // R contiguous slabs of m bytes
  char* scratch;          // the same, for ping-pong programs
  const long long* prog;  // the program's table on the card, or null
  long long x_stride;
  long long m;            // bytes a rank
  int nrounds;
  int cell;               // eager: bytes a cell
  int nslots;             // eager, bulk path: slots a CTA rings through
  int npairs;             // the by-value round (prog null)
  int nranks;             // R
  int src[kMaxPairs];
  int dst[kMaxPairs];
};

struct RoundDesc {
  int op, n, in, out;
  long long len;          // bytes a segment
  const long long* e;     // entries, or null: the by-value round
};

struct Entry {
  int src, dst;
  long long so, dof;
};

// kProgram false: the by-value round (one copy round from x to out),
// whose op and buffers the compiler then knows.
template <bool kProgram>
__device__ __forceinline__ RoundDesc round_desc(const Args& a, int r) {
  if constexpr (!kProgram) return {kCopy, a.npairs, 0, 1, a.m, nullptr};
  const long long* h = a.prog + (long long)r * kHeader;
  return {(int)__ldg(h), (int)__ldg(h + 1), (int)__ldg(h + 4),
          (int)__ldg(h + 5), __ldg(h + 3), a.prog + __ldg(h + 2)};
}

template <bool kProgram>
__device__ __forceinline__ Entry entry(const Args& a, const RoundDesc& rd,
                                       long long i) {
  if constexpr (!kProgram) return {a.src[i], a.dst[i], 0, 0};
  const long long* e = rd.e + i * kEntry;
  return {(int)__ldg(e), (int)__ldg(e + 1), __ldg(e + 2), __ldg(e + 3)};
}

__device__ __forceinline__ char* slab(const Args& a, int buf, int rank) {
  if (buf == 0) return const_cast<char*>(a.x) + rank * a.x_stride;
  return (buf == 1 ? a.out : a.scratch) + rank * a.m;
}

// A load from buffer `buf`: the input is never written in a launch and
// may take the read-only path; what a round wrote is read through L2.
template <typename V>
__device__ __forceinline__ V load(const V* p, int buf) {
  return buf == 0 ? __ldg(p) : __ldcg(p);
}

// Whether an entry reads the receiver's own segment.
__device__ __forceinline__ bool needs_own(int op, bool has_src) {
  return op == kAdd || op == kMax || (op == kReplace && !has_src);
}

// ---------------------------------------------------------------------------
// torch's add and maximum on the card, element by element
// ---------------------------------------------------------------------------

// add and max as torch's elementwise ops compute them; atomic_add as its
// scatter_add does, an atomic add an element. For bf16 and f16 that is
// its fastAtomicAdd: a paired atomic on the element's aligned 4-byte
// word, which adds +0.0 to the other half (so -0.0 there turns +0.0 and
// a NaN turns canonical), unless the element sits at index 0 of its row
// (odd address) or past numel - 1 (even address): then a scalar atomic.
// `index` is the element's index along the scattered dim (its segment's
// offset), `numel` the buffer's elements, as torch passes them.
template <typename T>
struct Num {  // integers (and the dtype-blind byte programs)
  typedef typename std::make_unsigned<T>::type U;
  static __device__ T add(T a, T b) { return (T)((U)a + (U)b); }
  static __device__ T max(T a, T b) { return a > b ? a : b; }
  static __device__ void atomic_add(T* p, T v, long long, long long) {
    if constexpr (sizeof(T) == 4)
      atomicAdd(reinterpret_cast<unsigned*>(p), (unsigned)v);
    else if constexpr (sizeof(T) == 8)
      atomicAdd(reinterpret_cast<unsigned long long*>(p),
                (unsigned long long)v);
    else
      __trap();  // bytes: the wrapper never adds them
  }
};

template <>
struct Num<float> {
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
  }
  static __device__ void atomic_add(float* p, float v, long long,
                                    long long) {
    atomicAdd(p, v);
  }
};

template <>
struct Num<double> {
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double max(double a, double b) {
    return a != a ? a : (b != b ? b : fmax(a, b));
  }
  static __device__ void atomic_add(double* p, double v, long long,
                                    long long) {
    atomicAdd(p, v);
  }
};

template <typename T, typename T2>
__device__ __forceinline__ void paired_atomic_add(T* p, T v, long long index,
                                                  long long numel) {
  T zero;
  memset(&zero, 0, sizeof(T));
  T2 pair;
  const bool low = reinterpret_cast<uintptr_t>(p) % sizeof(T2) == 0;
  if (low && index < numel - 1) {
    pair.x = v;
    pair.y = zero;
    atomicAdd(reinterpret_cast<T2*>(p), pair);
  } else if (!low && index > 0) {
    pair.x = zero;
    pair.y = v;
    atomicAdd(reinterpret_cast<T2*>(p - 1), pair);
  } else {
    atomicAdd(p, v);
  }
}

template <>
struct Num<__nv_bfloat16> {
  typedef __nv_bfloat16 T;
  static __device__ T add(T a, T b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  static __device__ T max(T a, T b) {
    const float fa = __bfloat162float(a), fb = __bfloat162float(b);
    return fa != fa ? a : (fb != fb ? b : __float2bfloat16_rn(fmaxf(fa, fb)));
  }
  static __device__ void atomic_add(T* p, T v, long long index,
                                    long long numel) {
    paired_atomic_add<T, __nv_bfloat162>(p, v, index, numel);
  }
};

template <>
struct Num<__half> {
  typedef __half T;
  static __device__ T add(T a, T b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  static __device__ T max(T a, T b) {
    const float fa = __half2float(a), fb = __half2float(b);
    return fa != fa ? a : (fb != fb ? b : __float2half_rn(fmaxf(fa, fb)));
  }
  static __device__ void atomic_add(T* p, T v, long long index,
                                    long long numel) {
    paired_atomic_add<T, __half2>(p, v, index, numel);
  }
};

// What the receiver's vector becomes from its own a and the message b
// (zeros when it has no sender).
template <typename T, typename V>
__device__ __forceinline__ V combine(int op, V a, V b, bool has_src) {
  if (op == kCopy) return b;
  if (op == kReplace) return has_src ? b : a;
  constexpr int N = sizeof(V) / sizeof(T);
  T ta[N], tb[N];
  memcpy(ta, &a, sizeof(V));
  memcpy(tb, &b, sizeof(V));
#pragma unroll
  for (int i = 0; i < N; ++i)
    ta[i] = op == kAdd ? Num<T>::add(ta[i], tb[i]) : Num<T>::max(ta[i], tb[i]);
  V r;
  memcpy(&r, ta, sizeof(V));
  return r;
}

// The add of a kAccumulate entry into the receiver, element by element;
// `index` its segment's element offset in the slab, `numel` the output's
// elements.
template <typename T, typename V>
__device__ __forceinline__ void accumulate(V* d, V b, long long index,
                                           long long numel) {
  constexpr int N = sizeof(V) / sizeof(T);
  T tb[N];
  memcpy(tb, &b, sizeof(V));
#pragma unroll
  for (int i = 0; i < N; ++i)
    Num<T>::atomic_add(reinterpret_cast<T*>(d) + i, tb[i], index, numel);
}

// ---------------------------------------------------------------------------
// bulk copies (the TMA) and mbarriers
// ---------------------------------------------------------------------------

using hopper::smem_addr;

using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// msgq_eager
// ---------------------------------------------------------------------------

// One round on the bulk path. `used` counts the items this CTA ran in
// earlier rounds: item g uses slot g % nslots, whose mbarrier completes
// its phase (g / nslots) & 1 for it.
template <typename T, bool kProgram>
__device__ void eager_round_bulk(const Args& a, const RoundDesc& rd,
                                 unsigned char* cells, uint64_t* bars,
                                 long long& used) {
  const long long cell = a.cell;
  const int nslots = a.nslots;
  const long long per = (rd.len + cell - 1) / cell;
  const long long items = per * rd.n;
  const long long nloc =
      items > blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const bool lead = threadIdx.x == 0;
  const long long numel = (long long)a.nranks * a.m / (long long)sizeof(T);

  auto issue = [&](long long k) {  // copy 1 of local item k (lead only)
    const long long it = blockIdx.x + k * gridDim.x;
    const long long ei = it / per;
    const long long off = (it - ei * per) * cell;
    const Entry en = entry<kProgram>(a, rd, ei);
    const unsigned n = (unsigned)min(cell, rd.len - off);
    const int slot = (int)((used + k) % nslots);
    unsigned char* msg = cells + (size_t)slot * 2 * cell;
    const bool has = en.src >= 0, own = needs_own(rd.op, has);
    const unsigned bar = smem_addr(bars + slot);
    mbar_expect_tx(bar, (has ? n : 0u) + (own ? n : 0u));
    if (has) bulk_load(msg, slab(a, rd.in, en.src) + en.so + off, n, bar);
    if (own)
      bulk_load(msg + cell, slab(a, rd.in, en.dst) + en.dof + off, n, bar);
  };

  if (lead) {
    // what earlier rounds stored, other CTAs' included, is read by the
    // async proxy from here on
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (long long k = 0; k < min((long long)nslots - 1, nloc); ++k)
      issue(k);
  }
  for (long long k = 0; k < nloc; ++k) {
    if (lead && k + nslots - 1 < nloc) {
      // the slot to refill held item k - 1, whose store was the last
      // committed: wait until it has read the cell
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      issue(k + nslots - 1);
    }
    const long long g = used + k;
    const int slot = (int)(g % nslots);
    mbar_wait(smem_addr(bars + slot), (unsigned)((g / nslots) & 1));
    const long long it = blockIdx.x + k * gridDim.x;
    const long long ei = it / per;
    const long long off = (it - ei * per) * cell;
    const Entry en = entry<kProgram>(a, rd, ei);
    const int n = (int)min(cell, rd.len - off);
    unsigned char* msg = cells + (size_t)slot * 2 * cell;
    const unsigned char* from = msg;
    const bool has = en.src >= 0;
    uint4* mv = reinterpret_cast<uint4*>(msg);
    if (rd.op == kAccumulate) {
      // copy 2 is the threads' atomic adds from the cell: no store
      uint4* d = reinterpret_cast<uint4*>(slab(a, rd.out, en.dst) + en.dof +
                                          off);
      for (int i = threadIdx.x; has && i < n / 16; i += kEagerThreads)
        accumulate<T>(d + i, mv[i], en.dof / (long long)sizeof(T), numel);
      __syncthreads();  // the cell is free once every thread has read it
      continue;
    }
    if (rd.op == kAdd || rd.op == kMax) {
      const uint4* ov = reinterpret_cast<const uint4*>(msg + cell);
      for (int i = threadIdx.x; i < n / 16; i += kEagerThreads)
        mv[i] = combine<T>(rd.op, ov[i], has ? mv[i] : uint4{0, 0, 0, 0},
                           has);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    } else if (!has && rd.op == kReplace) {
      from = msg + cell;  // a rank that receives nothing keeps its value
    } else if (!has) {
      for (int i = threadIdx.x; i < n / 16; i += kEagerThreads)
        mv[i] = uint4{0, 0, 0, 0};
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (lead) bulk_store(slab(a, rd.out, en.dst) + en.dof + off, from, n);
  }
  if (lead) {
    // every store of the round done and visible before the grid barrier
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  used += nloc;
}

// One round on the vector path (width < 16 bytes): the threads copy the
// sender's fragment into the cell and the cell out to the receiver.
template <typename V, typename T, bool kProgram>
__device__ void eager_round_vec(const Args& a, const RoundDesc& rd,
                                unsigned char* smem) {
  V* cell = reinterpret_cast<V*>(smem);
  const long long numel = (long long)a.nranks * a.m / (long long)sizeof(T);
  const long long per = (rd.len + a.cell - 1) / a.cell;
  const long long items = per * rd.n;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long ei = it / per;
    const long long off = (it - ei * per) * a.cell;
    const Entry en = entry<kProgram>(a, rd, ei);
    const int nv = (int)(min((long long)a.cell, rd.len - off) / sizeof(V));
    const bool has = en.src >= 0, own = needs_own(rd.op, has);
    const V* s = reinterpret_cast<const V*>(
        slab(a, rd.in, has ? en.src : 0) + en.so + off);
    const V* o =
        reinterpret_cast<const V*>(slab(a, rd.in, en.dst) + en.dof + off);
    V* d = reinterpret_cast<V*>(slab(a, rd.out, en.dst) + en.dof + off);
    // copy 1: the sender's fragment -> the staging cell
    for (int i = threadIdx.x; i < nv; i += kEagerThreads)
      cell[i] = has ? load(s + i, rd.in) : V{};
    __syncthreads();
    // copy 2: the cell -> the receiver, combined with its own values
    for (int i = threadIdx.x; i < nv; i += kEagerThreads) {
      if (rd.op == kAccumulate)
        accumulate<T>(d + i, cell[i], en.dof / (long long)sizeof(T), numel);
      else
        d[i] = combine<T>(rd.op, own ? load(o + i, rd.in) : V{}, cell[i],
                          has);
    }
    __syncthreads();
  }
}

template <typename V, typename T, bool kProgram>
__global__ void __launch_bounds__(kEagerThreads)
    eager_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kBulk = sizeof(V) == 16;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + (size_t)a.nslots * 2 * a.cell);
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < a.nslots; ++s) mbar_init(smem_addr(bars + s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  long long used = 0;
  for (int r = 0; r < a.nrounds; ++r) {
    const RoundDesc rd = round_desc<kProgram>(a, r);
    if constexpr (kBulk)
      eager_round_bulk<T, kProgram>(a, rd, smem, bars, used);
    else
      eager_round_vec<V, T, kProgram>(a, rd, smem);
    if (r + 1 < a.nrounds) cg::this_grid().sync();
  }
}

// ---------------------------------------------------------------------------
// msgq_one_copy
// ---------------------------------------------------------------------------

template <typename V, typename T, bool kProgram>
__global__ void __launch_bounds__(kDirectThreads)
    one_copy_kernel(const __grid_constant__ Args a) {
  constexpr long long kPiece = (long long)kDirectThreads * kLoads * sizeof(V);
  const int lane = threadIdx.x;
  const long long numel = (long long)a.nranks * a.m / (long long)sizeof(T);
  for (int r = 0; r < a.nrounds; ++r) {
    const RoundDesc rd = round_desc<kProgram>(a, r);
    const long long per = (rd.len + kPiece - 1) / kPiece;
    const long long items = per * rd.n;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const long long ei = it / per;
      const long long off = (it - ei * per) * kPiece;
      const Entry en = entry<kProgram>(a, rd, ei);
      const int nv = (int)(min(kPiece, rd.len - off) / (long long)sizeof(V));
      const bool has = en.src >= 0, own = needs_own(rd.op, has);
      const V* s = reinterpret_cast<const V*>(
          slab(a, rd.in, has ? en.src : 0) + en.so + off);
      const V* o =
          reinterpret_cast<const V*>(slab(a, rd.in, en.dst) + en.dof + off);
      V* d = reinterpret_cast<V*>(slab(a, rd.out, en.dst) + en.dof + off);
      V b[kLoads], x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = u * kDirectThreads + lane;
        b[u] = (has && i < nv) ? load(s + i, rd.in) : V{};
        x[u] = (own && i < nv) ? load(o + i, rd.in) : V{};
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = u * kDirectThreads + lane;
        if (i >= nv) continue;
        if (rd.op == kAccumulate)
          accumulate<T>(d + i, b[u], en.dof / (long long)sizeof(T), numel);
        else
          d[i] = combine<T>(rd.op, x[u], b[u], has);
      }
    }
    if (r + 1 < a.nrounds) cg::this_grid().sync();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Items of the largest round: entries x pieces of `unit` bytes.
long long max_items(const long long* shapes, int nrounds, long long unit) {
  long long most = 0;
  for (int r = 0; r < nrounds; ++r) {
    const long long n = shapes[2 * r], len = shapes[2 * r + 1];
    most = std::max(most, n * ((len + unit - 1) / unit));
  }
  return most;
}

// A persistent grid: one CTA an item up to the co-resident CTAs (at most
// kMaxCtasPerSm an SM for a program, whose grid barrier every CTA joins);
// a program of several rounds is a cooperative launch.
template <typename K>
cudaError_t launch_grid(K* fn, const Args& a, long long items, int threads,
                        size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const bool coop = a.nrounds > 1;
  const long long cap = (long long)hopper::sm_count() *
                        (coop ? std::min(occ, kMaxCtasPerSm) : occ);
  const unsigned grid = (unsigned)std::max(1LL, std::min(items, cap));
  if (!coop) {
    fn<<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel((const void*)fn, dim3(grid), dim3(threads),
                                    params, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename V, typename T, bool kProgram>
cudaError_t run(bool eager, Args& a, const long long* shapes,
                cudaStream_t stream) {
  if constexpr (sizeof(T) > sizeof(V)) {
    return cudaErrorInvalidValue;
  } else {
    if (!eager) {
      const long long piece = (long long)kDirectThreads * kLoads * sizeof(V);
      return launch_grid(one_copy_kernel<V, T, kProgram>, a,
                         max_items(shapes, a.nrounds, piece), kDirectThreads,
                         0, stream);
    }
    size_t smem = a.cell;
    a.nslots = 1;
    if (sizeof(V) == 16) {
      a.nslots = std::max(2, std::min(4, kSlotBudget / (2 * a.cell)));
      smem = (size_t)a.nslots * (2 * a.cell + sizeof(uint64_t));
    }
    return launch_grid(eager_kernel<V, T, kProgram>, a,
                       max_items(shapes, a.nrounds, a.cell), kEagerThreads,
                       smem, stream);
  }
}

// A by-value round is a copy: one instantiation of no dtype; a program's
// kernels combine in its dtype.
template <typename V>
cudaError_t by_dtype(int dtype, bool eager, Args& a, const long long* shapes,
                     cudaStream_t stream) {
  if (!a.prog) return run<V, uint8_t, false>(eager, a, shapes, stream);
  switch (dtype) {
    case 0: return run<V, uint8_t, true>(eager, a, shapes, stream);
    case 1: return run<V, float, true>(eager, a, shapes, stream);
    case 2: return run<V, __nv_bfloat16, true>(eager, a, shapes, stream);
    case 3: return run<V, __half, true>(eager, a, shapes, stream);
    case 4: return run<V, double, true>(eager, a, shapes, stream);
    case 5: return run<V, int32_t, true>(eager, a, shapes, stream);
    case 6: return run<V, int64_t, true>(eager, a, shapes, stream);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(bool eager, const void* x, void* out, void* scratch,
             long long x_stride, long long m, int nranks, const int* pairs,
             int npairs, const long long* prog, const long long* shapes,
             int nrounds, int cell, int vec, int dtype, void* stream) {
  if (m < 0 || nrounds < 1 || vec < 1 ||
      (eager && (cell <= 0 || cell > kMaxCellBytes || cell % vec)) ||
      (!prog && (npairs < 1 || npairs > kMaxPairs)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const char*>(x);
  a.out = static_cast<char*>(out);
  a.scratch = static_cast<char*>(scratch);
  a.prog = prog;
  a.x_stride = x_stride;
  a.m = m;
  a.nrounds = prog ? nrounds : 1;
  a.cell = cell;
  a.nslots = 1;
  a.npairs = prog ? 0 : npairs;
  a.nranks = nranks;
  long long inline_shape[2] = {npairs, m};
  if (!prog) {
    for (int i = 0; i < npairs; ++i) {
      a.src[i] = pairs[2 * i];
      a.dst[i] = pairs[2 * i + 1];
      if (a.dst[i] < 0) return (int)cudaErrorInvalidValue;
    }
    shapes = inline_shape;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return (int)by_dtype<uint4>(dtype, eager, a, shapes, st);
    case 8: return (int)by_dtype<uint2>(dtype, eager, a, shapes, st);
    case 4: return (int)by_dtype<uint32_t>(dtype, eager, a, shapes, st);
    case 2: return (int)by_dtype<uint16_t>(dtype, eager, a, shapes, st);
    case 1: return (int)by_dtype<uint8_t>(dtype, eager, a, shapes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: nranks slabs of m bytes, x_stride bytes apart; out (and scratch, which
// may be null when no round writes it): R contiguous slabs of m bytes.
// Either a by-value round of npairs (src, dst) slab indices, interleaved,
// src < 0 writing zeros (prog null), or a program: prog, its table on
// the card (program.py: Plan.words), shapes its rounds' (entries, bytes)
// on the host, nrounds its rounds. cell: the eager cell's bytes. vec: the
// access width in bytes (16, 8, 4, 2 or 1), which must divide every
// pointer, x_stride, m, every offset and segment, and the cell; 16 takes
// the bulk path. dtype: what add and max combine (0 bytes, 1 f32, 2 bf16,
// 3 f16, 4 f64, 5 int32, 6 int64). Returns a cudaError_t (0 = launched).
extern "C" int msgq_eager(const void* x, void* out, void* scratch,
                          long long x_stride, long long m, int nranks,
                          const int* pairs, int npairs, const long long* prog,
                          const long long* shapes, int nrounds, int cell,
                          int vec, int dtype, void* stream) {
  return dispatch(true, x, out, scratch, x_stride, m, nranks, pairs, npairs,
                  prog, shapes, nrounds, cell, vec, dtype, stream);
}

// The same arguments, without the cell.
extern "C" int msgq_one_copy(const void* x, void* out, void* scratch,
                             long long x_stride, long long m, int nranks,
                             const int* pairs, int npairs,
                             const long long* prog, const long long* shapes,
                             int nrounds, int vec, int dtype, void* stream) {
  return dispatch(false, x, out, scratch, x_stride, m, nranks, pairs, npairs,
                  prog, shapes, nrounds, 0, vec, dtype, stream);
}

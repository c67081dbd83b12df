// Message-copy kernels for Hopper (sm_90a): the paper's interthread
// message protocols (§3.2) as copies inside one address space.
//
// Replace the TPU kernels of src/repro/kernels/msgq/msgq.py:
//   * msgq_eager    <- `_eager_kernel` (via `eager_copy`): the message
//     passes through one bounded staging cell, src -> cell -> dst, one
//     cell per CTA (the Pallas kernel: one VMEM cell per grid step).
//   * msgq_one_copy <- `_one_copy_kernel` (via `one_copy`): the receiver
//     copies straight from the sender's buffer, with no staging.
//
// Both are dtype-blind byte copies over a message ROUND: x holds R
// per-rank slabs of m bytes, `x_stride` bytes apart; out holds R
// contiguous slabs of m bytes. For each (src, dst) pair, out[dst] =
// x[src]; a pair with src < 0 writes zeros there (a rank that receives
// nothing in the round gets zeros, as lax.ppermute gives it). A single
// message is the round R = 1, pairs = {(0, 0)}: what the TPU kernels
// compute. Grid: (cell or block of the message, pair).
//
// Where they depart from the Pallas kernels:
//   * Rounds: one launch moves every message of a round. On the TPU the
//     messages between ranks went between chips by XLA's
//     collective-permute; on one card a message between ranks is a copy
//     inside one address space, and these kernels are that copy.
//   * Ragged lengths: the last cell or block is masked, where the Pallas
//     kernels assert that the cell or block divides the length.
//   * Width: accesses are the widest of 16, 8, 4, 2 or 1 bytes that the
//     two base pointers, the slab stride, m and the cell all divide (the
//     wrapper picks it); every aligned path uses 16-byte vectors.
//
// What bounds them on this card: bytes. Each byte is read from device
// memory once and written once, at 3.35 TB/s, with no arithmetic. At the
// comm layer's sizes (64 B to 4 MiB a rank) a round costs mostly its
// launch. The design keeps enough bytes in flight for the large rounds:
// one CTA per (cell or 16 KiB block, pair), 256 threads; the 1-copy
// threads issue four independent 16-byte loads before their stores.
// Not yet done (later work): TMA bulk copies (cp.async.bulk), and
// folding many small rounds into one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 256;          // pairs one launch carries
constexpr int kMaxCellBytes = 48 * 1024; // static shared-memory limit
constexpr long long kBlockBytes = 16 * 1024;  // a 1-copy CTA's block
constexpr int kUnroll = 4;

// The round's pairs, passed by value (2 KB of kernel parameters), so a
// launch needs no copy of its pair table to the card.
struct Pairs {
  int src[kMaxPairs];
  int dst[kMaxPairs];
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
    eager_kernel(const char* __restrict__ x, char* __restrict__ out,
                 long long x_stride, long long m, int cell_bytes,
                 Pairs pairs) {
  extern __shared__ __align__(16) unsigned char cell_raw[];
  V* cell = reinterpret_cast<V*>(cell_raw);
  const int p = blockIdx.y;
  const long long off = (long long)blockIdx.x * cell_bytes;
  const long long n = min((long long)cell_bytes, m - off);
  if (n <= 0) return;  // uniform over the CTA: m = 0
  const int nv = (int)(n / (long long)sizeof(V));
  const int src = pairs.src[p];
  const V* s = src >= 0 ? reinterpret_cast<const V*>(
                              x + (long long)src * x_stride + off)
                        : nullptr;
  V* d = reinterpret_cast<V*>(out + (long long)pairs.dst[p] * m + off);
  // copy 1: the sender's fragment -> the staging cell
  for (int i = threadIdx.x; i < nv; i += kThreads)
    cell[i] = src >= 0 ? s[i] : V{};
  __syncthreads();
  // copy 2: the cell -> the receiver's buffer
  for (int i = threadIdx.x; i < nv; i += kThreads) d[i] = cell[i];
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    one_copy_kernel(const char* __restrict__ x, char* __restrict__ out,
                    long long x_stride, long long m, Pairs pairs) {
  const int p = blockIdx.y;
  const long long off = (long long)blockIdx.x * kBlockBytes;
  const long long n = min(kBlockBytes, m - off);
  if (n <= 0) return;
  const int nv = (int)(n / (long long)sizeof(V));
  const int src = pairs.src[p];
  const V* s = src >= 0 ? reinterpret_cast<const V*>(
                              x + (long long)src * x_stride + off)
                        : nullptr;
  V* d = reinterpret_cast<V*>(out + (long long)pairs.dst[p] * m + off);
  for (int base = 0; base < nv; base += kThreads * kUnroll) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      r[u] = (src >= 0 && i < nv) ? s[i] : V{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < nv) d[i] = r[u];
    }
  }
}

bool load_pairs(const int* table, int npairs, Pairs* pairs) {
  if (npairs <= 0 || npairs > kMaxPairs) return false;
  for (int i = 0; i < npairs; ++i) {
    pairs->src[i] = table[2 * i];
    pairs->dst[i] = table[2 * i + 1];
    if (pairs->dst[i] < 0) return false;
  }
  return true;
}

template <typename V>
cudaError_t launch_eager(const char* x, char* out, long long x_stride,
                         long long m, int cell_bytes, const Pairs& pairs,
                         int npairs, cudaStream_t stream) {
  const long long cells = (m + cell_bytes - 1) / cell_bytes;
  dim3 grid((unsigned)(cells > 0 ? cells : 1), (unsigned)npairs);
  eager_kernel<V><<<grid, kThreads, cell_bytes, stream>>>(
      x, out, x_stride, m, cell_bytes, pairs);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_one_copy(const char* x, char* out, long long x_stride,
                            long long m, const Pairs& pairs, int npairs,
                            cudaStream_t stream) {
  const long long blocks = (m + kBlockBytes - 1) / kBlockBytes;
  dim3 grid((unsigned)(blocks > 0 ? blocks : 1), (unsigned)npairs);
  one_copy_kernel<V><<<grid, kThreads, 0, stream>>>(x, out, x_stride, m,
                                                    pairs);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: R slabs of m bytes, x_stride bytes apart; out: contiguous slabs of m
// bytes. pairs: npairs (src, dst) slab indices, interleaved; src < 0
// writes zeros. vec: the access width in bytes (1, 2, 4, 8 or 16), which
// must divide both pointers, x_stride, m and cell_bytes. Returns a
// cudaError_t (0 = launched).
extern "C" int msgq_eager(const void* x, void* out, long long x_stride,
                          long long m, const int* pairs, int npairs,
                          int cell_bytes, int vec, void* stream) {
  Pairs p;
  if (m < 0 || cell_bytes <= 0 || cell_bytes > kMaxCellBytes ||
      !load_pairs(pairs, npairs, &p))
    return (int)cudaErrorInvalidValue;
  const char* xs = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return (int)launch_eager<uint4>(xs, o, x_stride, m, cell_bytes, p, npairs, st);
    case 8: return (int)launch_eager<uint2>(xs, o, x_stride, m, cell_bytes, p, npairs, st);
    case 4: return (int)launch_eager<uint32_t>(xs, o, x_stride, m, cell_bytes, p, npairs, st);
    case 2: return (int)launch_eager<uint16_t>(xs, o, x_stride, m, cell_bytes, p, npairs, st);
    case 1: return (int)launch_eager<uint8_t>(xs, o, x_stride, m, cell_bytes, p, npairs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int msgq_one_copy(const void* x, void* out, long long x_stride,
                             long long m, const int* pairs, int npairs,
                             int vec, void* stream) {
  Pairs p;
  if (m < 0 || !load_pairs(pairs, npairs, &p))
    return (int)cudaErrorInvalidValue;
  const char* xs = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return (int)launch_one_copy<uint4>(xs, o, x_stride, m, p, npairs, st);
    case 8: return (int)launch_one_copy<uint2>(xs, o, x_stride, m, p, npairs, st);
    case 4: return (int)launch_one_copy<uint32_t>(xs, o, x_stride, m, p, npairs, st);
    case 2: return (int)launch_one_copy<uint16_t>(xs, o, x_stride, m, p, npairs, st);
    case 1: return (int)launch_one_copy<uint8_t>(xs, o, x_stride, m, p, npairs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

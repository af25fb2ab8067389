// Bucket histogram for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/histogram.py::bucket_histogram
// (_hist_kernel). out[b] = #{i : ids[i] == b} for b in [0, P); ids outside
// [0, P) (the -1 padding) are skipped.
//
// Bound: bytes (4 B read per id, P * 4 B written). HBM runs at full rate
// only with ~15 KB of loads in flight on each SM (3.35 TB/s x ~0.6 us / 132
// SMs), so the design for the path's small P (P <= 8, the shuffles' 8
// shards) is about bytes in flight, and about doing the whole count in one
// launch:
//   - hist_regs: two blocks of 512 threads an SM (fewer when n is small).
//     Each thread issues 8 16-byte loads at once (128 B in flight, 128 KB
//     an SM; they stream past L1 and leave L2 first) and counts them in
//     registers: eight 8-bit counters in one 64-bit word (c += 1 << 8 id
//     for a valid id), widened into eight 32-bit counters after each step
//     of at most 32 ids. The thresholds: P <= 8 here (eight counters fit
//     one word), P <= 12288 in shared memory, else global. The warp reduces
//     with __reduce_add_sync, the block across its warps in shared memory,
//     and each block writes its P counts to its row of a scratch buffer that
//     the wrapper owns. The last block to finish (an atomicInc ticket that
//     wraps back to 0 by itself, so it is ready for the next call; zeroed
//     once, when the scratch is made) sums the rows (integers, so in any
//     order) and writes `out`: one launch, no memset. A view at any 4-byte
//     offset is read from its first 16-byte boundary, its ragged head and
//     tail with 4-byte loads.
//   - Larger P: each block keeps a private histogram in shared memory (P up
//     to 12288, 48 KB); within a warp, lanes holding the same id are grouped
//     with __match_any_sync and one leader adds the group's size, so a warp
//     issues at most P shared atomics per step instead of 32; each block
//     then adds its counts to `out` (zeroed by a memset first) once per
//     bucket. P too large for shared memory takes the same warp-aggregated
//     atomics straight to global memory.
// Integer counts in every path, so the result is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxSharedBuckets = 12288;  // 48 KB of int32 counters
constexpr int kRegBuckets = 8;     // P up to this: counters in registers
constexpr int kRegThreads = 512;
constexpr int kUnroll = 8;         // 16-byte loads a thread issues at once
constexpr int kRegBlocksPerSM = 2;
constexpr int kMaxRegBlocks = 1024;  // rows of the scratch
constexpr int kTicketInts = 32;    // the ticket, alone in its 128 B

// 1 << 8 id when id is in [0, P), else 0 (P <= 8)
__device__ __forceinline__ unsigned long long bump(int id, int P) {
  return (unsigned)id < (unsigned)P ? 1ull << (8 * id) : 0ull;
}

__global__ void __launch_bounds__(kRegThreads)
hist_regs(const int* __restrict__ ids, int* __restrict__ out, long long n,
          int P, unsigned* __restrict__ scratch) {
  __shared__ unsigned s_w[kRegThreads / 32][kRegBuckets];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // elements before ids from its 16-byte boundary
  const int head = (int)(((uintptr_t)ids & 15) >> 2);
  const int4* base = reinterpret_cast<const int4*>((uintptr_t)ids - 4 * head);
  const long long nv = n + head;
  const long long chunks = (nv + 3) >> 2;
  const long long stride = (long long)gridDim.x * kRegThreads;
  unsigned cnt[kRegBuckets];
#pragma unroll
  for (int k = 0; k < kRegBuckets; ++k) cnt[k] = 0;
  for (long long c0 = (long long)blockIdx.x * kRegThreads + threadIdx.x;
       c0 < chunks; c0 += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = 4 * (c0 + u * stride);  // element index from base
      if (e >= head && e + 4 <= nv) {
        v[u] = __ldcs(base + (e >> 2));  // read once: evict first
      } else {  // the ragged head or tail, or past the end
        int t[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          t[k] = (e + k >= head && e + k < nv) ? ids[e + k - head] : -1;
        v[u] = make_int4(t[0], t[1], t[2], t[3]);
      }
    }
    unsigned long long c8 = 0;  // at most 32 ids a step: no 8-bit overflow
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      c8 += bump(v[u].x, P) + bump(v[u].y, P) + bump(v[u].z, P) + bump(v[u].w, P);
#pragma unroll
    for (int k = 0; k < kRegBuckets; ++k) cnt[k] += (unsigned)(c8 >> (8 * k)) & 0xffu;
  }
#pragma unroll
  for (int k = 0; k < kRegBuckets; ++k) {
    const unsigned s = __reduce_add_sync(kFull, cnt[k]);
    if (lane == 0) s_w[warp][k] = s;
  }
  __syncthreads();
  unsigned* rows = scratch + kTicketInts;
  if (threadIdx.x < P) {
    unsigned t = 0;
    for (int w = 0; w < kRegThreads / 32; ++w) t += s_w[w][threadIdx.x];
    rows[blockIdx.x * kRegBuckets + threadIdx.x] = t;
    __threadfence();  // the row is visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicInc(scratch, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: every block's row is written; sum them per bucket
  const int k = threadIdx.x & (kRegBuckets - 1);
  unsigned acc = 0;
  for (int r = threadIdx.x / kRegBuckets; r < (int)gridDim.x;
       r += kRegThreads / kRegBuckets)
    acc += __ldcg(rows + r * kRegBuckets + k);
  acc += __shfl_xor_sync(kFull, acc, 8);
  acc += __shfl_xor_sync(kFull, acc, 16);
  if (lane < kRegBuckets) s_w[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < P) {
    unsigned t = 0;
    for (int w = 0; w < kRegThreads / 32; ++w) t += s_w[w][threadIdx.x];
    out[threadIdx.x] = (int)t;
  }
}

__device__ __forceinline__ void warp_add(int* hist, int id, bool valid) {
  int key = valid ? id : -1;
  unsigned peers = __match_any_sync(kFull, key);
  int leader = __ffs(peers) - 1;
  if (valid && (int)(threadIdx.x & 31) == leader)
    atomicAdd(&hist[id], __popc(peers));
}

__global__ void hist_shared(const int* __restrict__ ids, int* __restrict__ out,
                            long long n, int P) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < P; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  // uniform trip count across the block so every lane joins the match
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    long long i = base + threadIdx.x;
    int id = i < n ? ids[i] : -1;
    warp_add(sh, id, i < n && id >= 0 && id < P);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < P; b += blockDim.x) {
    int c = sh[b];
    if (c) atomicAdd(&out[b], c);
  }
}

__global__ void hist_global(const int* __restrict__ ids, int* __restrict__ out,
                            long long n, int P) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    long long i = base + threadIdx.x;
    int id = i < n ? ids[i] : -1;
    warp_add(out, id, i < n && id >= 0 && id < P);
  }
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev]) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  if (dev < 64) cached[dev] = sms;
  return sms;
}

}  // namespace

// int32 words of the scratch the small-P path needs (zeroed once by its
// owner, and left ready for the next call on the same stream by the kernel).
extern "C" int repro_histogram_scratch_ints() {
  return kTicketInts + kMaxRegBlocks * kRegBuckets;
}

// ids one block of the small-P path reads in one step (its unroll), and the
// most blocks it launches on the current device: the grid's step is the
// product.
extern "C" int repro_histogram_rows_per_step() { return kRegThreads * kUnroll * 4; }
extern "C" int repro_histogram_max_blocks() {
  const int sms = kRegBlocksPerSM * sm_count();
  return sms < kMaxRegBlocks ? sms : kMaxRegBlocks;
}

// ids: n int32; out: P int32 (every entry written). scratch: the buffer of
// repro_histogram_scratch_ints() words. Returns cudaGetLastError().
extern "C" int repro_histogram(const int* ids, int* out, long long n, int P,
                               void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= 0) return (int)cudaGetLastError();
  if (P <= kRegBuckets) {
    const long long head = ((uintptr_t)ids & 15) >> 2;
    const long long chunks = (n + head + 3) / 4;
    const long long want = (chunks + kRegThreads * kUnroll - 1) / (kRegThreads * kUnroll);
    const int cap = repro_histogram_max_blocks();
    const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
    hist_regs<<<blocks, kRegThreads, 0, s>>>(ids, out, n, P, (unsigned*)scratch);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(out, 0, sizeof(int) * (size_t)P, s);
  if (n > 0) {
    long long want = (n + kThreads - 1) / kThreads;
    int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
    if (P <= kMaxSharedBuckets)
      hist_shared<<<blocks, kThreads, sizeof(int) * P, s>>>(ids, out, n, P);
    else
      hist_global<<<blocks, kThreads, 0, s>>>(ids, out, n, P);
  }
  return (int)cudaGetLastError();
}

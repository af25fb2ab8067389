// Bucket histogram for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/histogram.py::bucket_histogram
// (_hist_kernel). out[b] = #{i : ids[i] == b} for b in [0, P); ids outside
// [0, P) (the -1 padding) are skipped.
//
// Bound: bytes (4 B read per id, P * 4 B written). With P = 8 on the
// shuffle path every id hits one of eight counters, so the limit in practice
// is atomic contention, not bandwidth. The design: each block keeps a private
// histogram in shared memory; within a warp, lanes holding the same id are
// grouped with __match_any_sync and one leader adds the group's size, so a
// warp issues at most P shared atomics per step instead of 32; each block
// then adds its counts to the global histogram once per bucket. Integer
// atomics make the result the same on every run. P too large for shared
// memory takes the same warp-aggregated atomics straight to global memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBuckets = 12288;  // 48 KB of int32 counters

__device__ __forceinline__ void warp_add(int* hist, int id, bool valid) {
  const unsigned full = 0xFFFFFFFFu;
  int key = valid ? id : -1;
  unsigned peers = __match_any_sync(full, key);
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

}  // namespace

// ids: n int32; out: P int32, zeroed here. Returns cudaGetLastError().
extern "C" int repro_histogram(const int* ids, int* out, long long n, int P,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= 0) return (int)cudaGetLastError();
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

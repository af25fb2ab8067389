// Bitonic (key, payload) tile sort for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/bitonic.py::bitonic_sort_tiles
// (_bitonic_kernel, _compare_exchange). Each power-of-two tile of T pairs is
// sorted ascending, lexicographically on (key, payload), by the same
// comparator network with the same directions as the TPU kernel: at stage
// 2^m, distance 2^p, pair i sits at lo = (i >> p) * 2^(p+1) + (i & (2^p - 1)),
// hi = lo + 2^p, ascending when bit (m-p-1) of (i >> p) is 0, and swaps
// unless (k_lo < k_hi) || (k_lo == k_hi && v_lo <= v_hi) equals that flag.
// Keys are int64: the port holds the unsigned 32-bit keys of the path
// (ordered_u32) in int64, and any int64 key sorts the same way.
//
// Bound: on the path the tile is at most 2048 pairs (24 KB held), so the
// kernel is bound by latency: log2(T)(log2(T)+1)/2 = 66 passes, each one
// __syncthreads() apart. The design keeps the whole tile in shared memory
// (one global read and one global write per pair), one block per tile and
// one thread per compare-exchange pair, so each pass is one step of every
// thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using K = long long;

__global__ void bitonic_tile(const K* __restrict__ keys,
                             const int* __restrict__ vals,
                             K* __restrict__ ko, int* __restrict__ vo,
                             int tile, int log_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  int* sv = reinterpret_cast<int*>(smem + (size_t)tile * sizeof(K));
  long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sk[i] = keys[base + i];
    sv[i] = vals[base + i];
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int m = 1; m <= log_t; ++m) {
    for (int p = m - 1; p >= 0; --p) {
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        int b = i >> p;
        int lo = (b << (p + 1)) + (i & ((1 << p) - 1));
        int hi = lo + (1 << p);
        bool asc = ((b >> (m - p - 1)) & 1) == 0;
        K klo = sk[lo], khi = sk[hi];
        int vlo = sv[lo], vhi = sv[hi];
        bool le = (klo < khi) || (klo == khi && vlo <= vhi);
        if (le != asc) {
          sk[lo] = khi;
          sk[hi] = klo;
          sv[lo] = vhi;
          sv[hi] = vlo;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    ko[base + i] = sk[i];
    vo[base + i] = sv[i];
  }
}

}  // namespace

// keys (int64) / payload (int32): n pairs, n a multiple of tile (a power of
// two in [2, 4096]). Returns cudaGetLastError().
extern "C" int repro_bitonic(const long long* keys, const int* payload,
                             long long* keys_out, int* payload_out, long long n,
                             int tile, void* stream) {
  if (n > 0) {
    int log_t = 0;
    while ((1 << log_t) < tile) ++log_t;
    int threads = tile / 2 < 1024 ? tile / 2 : 1024;
    size_t shmem = (size_t)tile * (sizeof(K) + sizeof(int));
    bitonic_tile<<<(unsigned int)(n / tile), threads, shmem,
                   (cudaStream_t)stream>>>(keys, payload, keys_out, payload_out,
                                           tile, log_t);
  }
  return (int)cudaGetLastError();
}

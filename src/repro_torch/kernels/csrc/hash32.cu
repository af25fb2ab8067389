// murmur3 fmix32 column hash for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/hash64.py::hash32 (_hash_kernel).
// out[i] = fmix32(bits(x[i]) ^ seed), with x int32/uint32/float32 read as its
// 32-bit pattern (so -0.0 != +0.0) and the result zero-extended to int64: the
// port holds unsigned 32-bit values in int64 (see kernels/ref.py).
//
// Bound: bytes. The function needs 8 B a row (a 4-byte value in, a u32 hash
// out) and ~10 integer ops, far below the card's operation rate. The int64
// holder writes 4 B more a row, so the kernel can reach at most 2/3 of that
// bound; it is kept because every consumer (hash_combine, % p, the hash
// join's sort and searchsorted) works on int64, and widening a u32 output
// there would cost a further 4 B read and 8 B write a row. The design keeps
// the traffic at one read and one write per row: one thread per 4 rows, a
// 16-byte load and two 16-byte stores when the pointers are aligned, scalar
// code on the ragged end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void hash32_kernel(const uint32_t* __restrict__ x,
                              long long* __restrict__ out, long long n,
                              uint32_t seed, int vec) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long base = q * 4;
  if (base >= n) return;
  if (vec && base + 3 < n) {
    uint4 v = reinterpret_cast<const uint4*>(x)[q];
    longlong2 a, b;
    a.x = (long long)fmix32(v.x ^ seed);
    a.y = (long long)fmix32(v.y ^ seed);
    b.x = (long long)fmix32(v.z ^ seed);
    b.y = (long long)fmix32(v.w ^ seed);
    reinterpret_cast<longlong2*>(out)[2 * q] = a;
    reinterpret_cast<longlong2*>(out)[2 * q + 1] = b;
    return;
  }
  for (long long i = base; i < base + 4 && i < n; ++i)
    out[i] = (long long)fmix32(x[i] ^ seed);
}

}  // namespace

// x: n 4-byte values; out: n int64. vec != 0 when both pointers are 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int repro_hash32(const void* x, void* out, long long n,
                            unsigned int seed, int vec, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long quads = (n + 3) / 4;
    long long blocks = (quads + threads - 1) / threads;
    hash32_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (long long*)out, n, seed, vec);
  }
  return (int)cudaGetLastError();
}

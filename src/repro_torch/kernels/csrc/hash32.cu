// murmur3 fmix32 hashes for Hopper (sm_90a): a column entry and a fused
// hash-partition entry.
//
// Both replace the Pallas kernel repro/kernels/hash64.py::hash32
// (_hash_kernel): fmix32(bits(x) ^ seed), with x int32/uint32/float32 read as
// its 32-bit pattern (so -0.0 != +0.0).
//
// Column entry (hash32_kernel): out[i] = fmix32(x[i] ^ seed) zero-extended to
// int64, the port's holder of unsigned 32-bit values (see kernels/ref.py),
// which the hash join's sort and searchsorted consume. Bound: bytes. The
// function needs 8 B a row (4 in, a u32 out) and ~10 integer ops; the int64
// holder writes 4 B more, so the kernel can reach at most 2/3 of that bound.
// One thread per 4 rows: a 16-byte load and two 16-byte stores when the
// pointers are aligned, scalar code on the ragged end.
//
// Partition entry (hash32_partition_kernel): the whole of hash_partition's
// destination in one pass, as the reference's XLA fuses it around the
// Pallas call (repro/core/ops_local.py:140-142):
//   pid[i] = -1                                         if i >= row_count
//            combine(fmix32(c0[i] ^ seed), ...) % P     otherwise
// with combine boost's hash_combine in u32 (h ^= h2 + 0x9E3779B9 + (h << 6)
// + (h >> 2), kernels/ref.py hash_combine_ref) and the u32 modulus. Bound:
// bytes: each key byte read once and a 4-byte pid written, 8 B a row for one
// key column, the column hash's own bound. The torch chain it replaces made
// six passes over ~66 B a row (int64 hash, int64 combine, % P, a cast, an
// int64 arange + compare, a where). row_count stays on the device: every
// thread reads the one int32. Column pointers travel in a fixed struct of
// kMaxCols pointers in the kernel's parameters (the wrapper raises above
// it); the column loops unroll to kMaxCols so every pointer is read from the
// parameters at a constant index, and the struct is never copied to local
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Cols {
  const uint32_t* p[kMaxCols];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t h2) {
  return h ^ (h2 + kGolden + (h << 6) + (h >> 2));
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

__device__ __forceinline__ int part(uint32_t h, long long row, long long rc,
                                    uint32_t p) {
  return row < rc ? (int)(h % p) : -1;
}

__global__ void hash32_partition_kernel(Cols cols, int ncols,
                                        int* __restrict__ pid, long long n,
                                        uint32_t seed, uint32_t p,
                                        const int* __restrict__ row_count,
                                        int vec) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long base = q * 4;
  if (base >= n) return;
  const long long rc = *row_count;
  if (vec && base + 3 < n) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(cols.p[0]) + q);
    uint32_t h0 = fmix32(v.x ^ seed), h1 = fmix32(v.y ^ seed);
    uint32_t h2 = fmix32(v.z ^ seed), h3 = fmix32(v.w ^ seed);
#pragma unroll
    for (int c = 1; c < kMaxCols; ++c) {
      if (c >= ncols) break;
      v = __ldg(reinterpret_cast<const uint4*>(cols.p[c]) + q);
      h0 = combine(h0, fmix32(v.x ^ seed));
      h1 = combine(h1, fmix32(v.y ^ seed));
      h2 = combine(h2, fmix32(v.z ^ seed));
      h3 = combine(h3, fmix32(v.w ^ seed));
    }
    int4 o = make_int4(part(h0, base, rc, p), part(h1, base + 1, rc, p),
                       part(h2, base + 2, rc, p), part(h3, base + 3, rc, p));
    reinterpret_cast<int4*>(pid)[q] = o;
    return;
  }
  for (long long i = base; i < base + 4 && i < n; ++i) {
    uint32_t h = fmix32(cols.p[0][i] ^ seed);
#pragma unroll
    for (int c = 1; c < kMaxCols; ++c) {
      if (c >= ncols) break;
      h = combine(h, fmix32(cols.p[c][i] ^ seed));
    }
    pid[i] = part(h, i, rc, p);
  }
}

unsigned int blocks_for(long long n) {
  long long quads = (n + 3) / 4;
  return (unsigned int)((quads + kThreads - 1) / kThreads);
}

}  // namespace

// x: n 4-byte values; out: n int64. vec != 0 when both pointers are 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int repro_hash32(const void* x, void* out, long long n,
                            unsigned int seed, int vec, void* stream) {
  if (n > 0)
    hash32_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (long long*)out, n, seed, vec);
  return (int)cudaGetLastError();
}

extern "C" int repro_hash32_partition_max_columns() { return kMaxCols; }

// cols: a host array of ncols (1..kMaxCols) device pointers, each to n 4-byte
// values; pid: n int32; row_count: one device int32; p >= 1. vec != 0 when
// every column pointer and pid are 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a bad ncols).
extern "C" int repro_hash32_partition(const void* const* cols, int ncols,
                                      void* pid, long long n, unsigned int seed,
                                      unsigned int p, const void* row_count,
                                      int vec, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || p == 0) return (int)cudaErrorInvalidValue;
  Cols c = {};
  for (int i = 0; i < ncols; ++i) c.p[i] = (const uint32_t*)cols[i];
  if (n > 0)
    hash32_partition_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        c, ncols, (int*)pid, n, seed, p, (const int*)row_count, vec);
  return (int)cudaGetLastError();
}

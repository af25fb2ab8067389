// Bitonic sorts for Hopper (sm_90a): the (key, payload) tile entry, a fused
// sort-permutation entry, and a latency probe.
//
// Both sorts replace the Pallas kernel repro/kernels/bitonic.py::
// bitonic_sort_tiles (_bitonic_kernel, _compare_exchange): the comparator
// network with the TPU kernel's directions. At stage 2^m, distance 2^p, the
// pair (i, i + 2^p) with bit p of i clear is put in ascending order when bit
// m of i is 0 and in descending order otherwise (bit m of i is bit m-p-1 of
// the TPU kernel's pair block b). The network has log2(T)(log2(T)+1)/2
// dependent passes, 66 for a 2048-pair tile.
//
// Bound: one SM. A tile is one block's work and the path sorts one tile of
// at most 2048 pairs, so bytes (24 KB) do not hold the time: the 66
// dependent passes and the instructions one SM issues for them do
// (chip_smoke.py's bitonic_bound takes the larger of the two). The first
// design ran every pass in shared memory behind __syncthreads() (66
// barriers, each pass a shared-memory round trip).
// This one holds kItems = 8 pairs a thread in registers, 256 pairs a warp,
// in two layouts of the tile's index bits (w warp, l lane, r register):
//   A: i = w << 8 | r << 5 | l        distances 1-16 are lane bits
//      (__shfl_xor_sync), 32-128 register bits (compare-exchange in
//      registers);
//   B: i = hi << 8 | mid << 4 | (l & 15), with loc = r | (l >> 4) << 3,
//      hi = loc & (2^H - 1), mid = loc >> H | w << (4 - H), H = log2(T) - 8:
//      distances 256 and up are register bits (and lane bit 4 at T = 4096).
// A stage whose distances reach 256 re-lays the tile out A -> B and back
// through shared memory, one barrier each (two buffers, so a store never
// overtakes another thread's load). A 2048-pair tile takes 6 barriers in
// place of 66; a 256-pair tile none. In both layouts lanes 0-15 hold
// consecutive indices, so the re-layouts' 8- and 16-byte shared accesses and
// the global accesses of layout A are free of bank conflicts and coalesced.
// The stages and passes unroll at compile time (template recursion), so
// every register index is a constant and the pairs never leave registers.
//
// Tile entry (bitonic_tile): int64 keys, int32 payloads, lexicographic on
// (key, payload): any int64 key, which the contract admits (sort_pairs pads
// with the int64 max), so it keeps the two-word comparator.
//
// Permutation entry (bitonic_perm): sort_permutation's bitonic branch in one
// launch. It reads one raw 4-byte key column (C <= 2048 rows) and the
// device row count, maps each key to ordered_u32 in registers, puts the u32
// max at rows >= row_count, pads to T = max(next_pow2(C), 256) and writes
// the first C sorted row indices as int64. Every key is a u32 and every
// payload a distinct row index < 2^31, so a pair packs exactly into one
// 64-bit word (key << 32 | index): one 64-bit compare and one 64-bit shuffle
// a step. Padding slots take key 0xFFFFFFFF and their own index >= C, so
// they sort after every real row, a real row with the u32 max key included.
//
// Probe (bitonic_probe): one warp times two dependent chains with clock64()
// and %globaltimer: a compare-exchange of two 64-bit words in registers
// (setp.lt.u64 + two selp.b64, the fewest instructions one dependent step of
// either sort can take), and a shuffle-compare-select step. chip_smoke.py
// takes the first for its latency bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogItems = 3;
constexpr int kItems = 1 << kLogItems;  // pairs a thread holds
constexpr int kLogLocal = kLogItems + 5;  // 256 pairs: a warp's span
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Pair {
  long long k;
  int v;
  int pad;  // 16 B: one aligned shared-memory access a pair
};

struct PairOps {
  using E = Pair;
  // branch-free (bitwise on the three compares): the short-circuit form
  // compiled to branches, which made the tile sort slower on the card
  static __device__ __forceinline__ bool less(const E& a, const E& b) {
    return (a.k < b.k) | ((a.k == b.k) & (a.v < b.v));
  }
  static __device__ __forceinline__ E shfl(const E& a, int mask) {
    E r;
    r.k = __shfl_xor_sync(kFull, a.k, mask);
    r.v = __shfl_xor_sync(kFull, a.v, mask);
    r.pad = 0;
    return r;
  }
};

struct PackedOps {
  using E = unsigned long long;
  static __device__ __forceinline__ bool less(E a, E b) { return a < b; }
  static __device__ __forceinline__ E shfl(E a, int mask) {
    return __shfl_xor_sync(kFull, a, mask);
  }
};

// the tile index of register r of lane l in warp w, in layout A or B
template <int L, bool B>
__device__ __forceinline__ int index_of(int w, int l, int r) {
  if constexpr (!B) {
    return w << kLogLocal | r << 5 | l;
  } else {
    constexpr int H = L - kLogLocal;
    int loc = r | (l >> 4) << kLogItems;
    int hi = loc & ((1 << H) - 1);
    int mid = loc >> H | w << (4 - H);
    return hi << kLogLocal | mid << 4 | (l & 15);
  }
}

// one pass at stage 2^M, distance 2^P, in layout A (P < 8) or B (P >= 8)
template <class Ops, int L, int M, int P, bool B>
__device__ __forceinline__ void one_pass(typename Ops::E (&x)[kItems], int w,
                                         int l) {
  using E = typename Ops::E;
  // index bit P as a register bit (RB >= 0) or a lane mask (LM)
  constexpr int RB = B ? (P - kLogLocal < kLogItems ? P - kLogLocal : -1)
                       : (P >= 5 ? P - 5 : -1);
  constexpr int LM = B ? 16 : 1 << P;
  if constexpr (RB >= 0) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (r & (1 << RB)) continue;
      constexpr int kStep = 1 << RB;
      const bool asc = ((index_of<L, B>(w, l, r) >> M) & 1) == 0;
      E a = x[r], b = x[r + kStep];
      // swap when the pair is out of the pass's order; a tie swaps or not,
      // and a full tie (key and payload) is two equal words either way
      const bool sw = Ops::less(b, a) == asc;
      x[r] = sw ? b : a;
      x[r + kStep] = sw ? a : b;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      E o = Ops::shfl(x[r], LM);
      const int i = index_of<L, B>(w, l, r);
      const bool asc = ((i >> M) & 1) == 0;
      const bool is_lo = ((i >> P) & 1) == 0;
      // the low element of an ascending pair (and the high one of a
      // descending pair) keeps the smaller of the two; a full tie keeps
      // an equal word either way
      const bool take = Ops::less(o, x[r]) == (is_lo == asc);
      x[r] = take ? o : x[r];
    }
  }
}

template <class Ops, int L, int M, int P, int PEnd, bool B>
__device__ __forceinline__ void passes(typename Ops::E (&x)[kItems], int w,
                                       int l) {
  if constexpr (P >= PEnd) {
    one_pass<Ops, L, M, P, B>(x, w, l);
    passes<Ops, L, M, P - 1, PEnd, B>(x, w, l);
  }
}

// store in one layout, one barrier, load in the other
template <class Ops, int L, bool FromB>
__device__ __forceinline__ void relayout(typename Ops::E (&x)[kItems], int w,
                                         int l, typename Ops::E* buf) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) buf[index_of<L, FromB>(w, l, r)] = x[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) x[r] = buf[index_of<L, !FromB>(w, l, r)];
}

template <class Ops, int L, int M>
__device__ __forceinline__ void stages(typename Ops::E (&x)[kItems], int w,
                                       int l, typename Ops::E* s0,
                                       typename Ops::E* s1) {
  if constexpr (M <= L) {
    if constexpr (M - 1 >= kLogLocal) {
      relayout<Ops, L, false>(x, w, l, s0);
      passes<Ops, L, M, M - 1, kLogLocal, true>(x, w, l);
      relayout<Ops, L, true>(x, w, l, s1);
      passes<Ops, L, M, kLogLocal - 1, 0, false>(x, w, l);
    } else {
      passes<Ops, L, M, M - 1, 0, false>(x, w, l);
    }
    stages<Ops, L, M + 1>(x, w, l, s0, s1);
  }
}

template <class E, int L>
constexpr size_t smem_bytes() {
  return L > kLogLocal ? 2 * ((size_t)1 << L) * sizeof(E) : 0;
}

template <int L>
__global__ void __launch_bounds__(1 << (L - kLogItems), 1)
    bitonic_tile(const long long* __restrict__ keys,
                 const int* __restrict__ vals, long long* __restrict__ ko,
                 int* __restrict__ vo) {
  extern __shared__ __align__(16) unsigned char smem[];
  Pair* s0 = reinterpret_cast<Pair*>(smem);
  Pair* s1 = s0 + (1 << L);
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x << L;
  Pair x[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = base + index_of<L, false>(w, l, r);
    x[r].k = keys[i];
    x[r].v = vals[i];
    x[r].pad = 0;
  }
  stages<PairOps, L, 1>(x, w, l, s0, s1);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = base + index_of<L, false>(w, l, r);
    ko[i] = x[r].k;
    vo[i] = x[r].v;
  }
}

// ordered_u32 of a 4-byte key: dtype 0 int32, 1 uint32, 2 float32
__device__ __forceinline__ uint32_t ordered_u32(uint32_t u, int dtype) {
  if (dtype == 0) return u ^ 0x80000000u;
  if (dtype == 2) return (u >> 31) ? ~u : (u ^ 0x80000000u);
  return u;
}

template <int L>
__global__ void __launch_bounds__(1 << (L - kLogItems), 1)
    bitonic_perm(const uint32_t* __restrict__ keys, int dtype, int c,
                 const int* __restrict__ row_count,
                 long long* __restrict__ perm) {
  using E = unsigned long long;
  extern __shared__ __align__(16) unsigned char smem[];
  E* s0 = reinterpret_cast<E*>(smem);
  E* s1 = s0 + (1 << L);
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rc = *row_count;
  E x[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = index_of<L, false>(w, l, r);
    uint32_t k = 0xFFFFFFFFu;
    if (i < c && i < rc) k = ordered_u32(keys[i], dtype);
    x[r] = (E)k << 32 | (uint32_t)i;
  }
  stages<PackedOps, L, 1>(x, w, l, s0, s1);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = index_of<L, false>(w, l, r);
    if (i < c) perm[i] = (long long)(x[r] & 0xFFFFFFFFull);
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// out[0], out[1]: clock64 cycles and globaltimer ns of `steps` dependent
// register compare-exchanges; out[2], out[3]: the same for shuffle steps;
// out[4]: the chains' result (kept live).
__global__ void bitonic_probe(unsigned long long a0, int steps,
                              long long* out) {
  unsigned long long a = a0 ^ threadIdx.x, b = a0 * 0x9E3779B97F4A7C15ull;
  long long c0 = clock64();
  unsigned long long g0 = global_ns();
#pragma unroll 8
  for (int s = 0; s < steps; ++s) {
    unsigned long long lo, hi;
    asm volatile(
        "{ .reg .pred p; setp.lt.u64 p, %3, %2; selp.b64 %0, %3, %2, p; "
        "selp.b64 %1, %2, %3, p; }"
        : "=l"(lo), "=l"(hi)
        : "l"(a), "l"(b));
    a = hi;
    b = lo;
  }
  long long c1 = clock64();
  unsigned long long g1 = global_ns();
#pragma unroll 8
  for (int s = 0; s < steps; ++s) {
    unsigned long long o = __shfl_xor_sync(kFull, a, 1);
    asm volatile("{ .reg .pred p; setp.lt.u64 p, %1, %2; selp.b64 %0, %1, %2, p; }"
                 : "=l"(a)
                 : "l"(o), "l"(a));
  }
  long long c2 = clock64();
  unsigned long long g2 = global_ns();
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)(g1 - g0);
    out[2] = c2 - c1;
    out[3] = (long long)(g2 - g1);
    out[4] = (long long)(a ^ b);
  }
}

template <int L>
int launch_tile(const long long* keys, const int* payload, long long* ko,
                int* vo, long long n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Pair, L>();
  if constexpr (smem > 48 * 1024) {
    // once a device: a call on every launch would stall the stream behind
    // the host's attribute call
    static unsigned done = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (!(done >> dev & 1u)) {
      e = cudaFuncSetAttribute(bitonic_tile<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      done |= 1u << dev;
    }
  }
  bitonic_tile<L><<<(unsigned int)(n >> L), 1 << (L - kLogItems), smem,
                    stream>>>(keys, payload, ko, vo);
  return (int)cudaGetLastError();
}

template <int L>
int launch_perm(const uint32_t* keys, int dtype, int c, const int* row_count,
                long long* perm, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<unsigned long long, L>();
  static_assert(smem <= 48 * 1024, "the permutation entry's tiles fit 48 KB");
  bitonic_perm<L><<<1, 1 << (L - kLogItems), smem, stream>>>(
      keys, dtype, c, row_count, perm);
  return (int)cudaGetLastError();
}

}  // namespace

// keys (int64) / payload (int32): n pairs, n a multiple of tile (a power of
// two in [256, 4096]). Returns cudaGetLastError() (cudaErrorInvalidValue for
// another tile).
extern "C" int repro_bitonic(const long long* keys, const int* payload,
                             long long* keys_out, int* payload_out, long long n,
                             int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  switch (tile) {
    case 256: return launch_tile<8>(keys, payload, keys_out, payload_out, n, s);
    case 512: return launch_tile<9>(keys, payload, keys_out, payload_out, n, s);
    case 1024: return launch_tile<10>(keys, payload, keys_out, payload_out, n, s);
    case 2048: return launch_tile<11>(keys, payload, keys_out, payload_out, n, s);
    case 4096: return launch_tile<12>(keys, payload, keys_out, payload_out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// keys: c (1..2048) 4-byte values of dtype 0 int32, 1 uint32, 2 float32;
// row_count: one device int32; perm: c int64. Returns cudaGetLastError()
// (cudaErrorInvalidValue for c or dtype out of range).
extern "C" int repro_bitonic_permutation(const void* keys, int dtype, int c,
                                         const void* row_count, void* perm,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* k = (const uint32_t*)keys;
  const int* rc = (const int*)row_count;
  long long* out = (long long*)perm;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (c >= 1 && c <= 256) return launch_perm<8>(k, dtype, c, rc, out, s);
  if (c > 256 && c <= 512) return launch_perm<9>(k, dtype, c, rc, out, s);
  if (c > 512 && c <= 1024) return launch_perm<10>(k, dtype, c, rc, out, s);
  if (c > 1024 && c <= 2048) return launch_perm<11>(k, dtype, c, rc, out, s);
  return (int)cudaErrorInvalidValue;
}

// One warp of the probe (see bitonic_probe); out: 5 int64 on the device.
extern "C" int repro_bitonic_probe(unsigned long long seed, int steps, void* out,
                                   void* stream) {
  bitonic_probe<<<1, 32, 0, (cudaStream_t)stream>>>(seed, steps,
                                                     (long long*)out);
  return (int)cudaGetLastError();
}

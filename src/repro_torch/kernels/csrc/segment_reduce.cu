// Segmented sum/min/max for Hopper (sm_90a), run-based and deterministic.
//
// Replaces the Pallas kernel repro/kernels/segment_reduce.py::
// segment_reduce_tiles (_seg_kernel). out[g] = op(values[i] : ids[i] == g)
// for g in [0, G); ids outside [0, G) are skipped; empty segments hold the
// op's identity (0, +max, -max). The TPU kernel compares every row with every
// segment (a one-hot product, O(N * G)); at G = capacity (millions of slots
// on the groupby path) that is quadratic, so this kernel does not carry it
// over. It needs each in-range id's rows to be one contiguous run (runs of
// out-of-range ids may lie anywhere), which the caller promises or the
// wrapper arranges (kernels/segment_reduce.py).
//
// Bound: bytes. Each row is read once (4 B value + 4 B id) and each segment
// written once (4 B); the fold is one add/min/max per row.
//
// Design: every range of rows, from one lane's four up to the whole input,
// is summarised by the same fixed-size record: the id and partial fold of
// its first run and of its last run, and whether one run covers it all.
// Two neighbouring records merge in O(1): a run that now lies wholly inside
// the merged range is complete and is written out; only the first and the
// last run stay open. Three launches on one stream:
//   1. fill: out[g] = identity for every g, 16-byte stores.
//   2. pass 1: a 256-thread block owns a 4096-row tile; each warp owns 512
//      consecutive rows, read as four 128-row chunks with 16-byte loads
//      (a lane holds 4 consecutive rows of each chunk: coalesced, no shared
//      memory). A lane folds its 4 rows; the 32 lanes' records merge in a
//      binary tree over shuffles; the warp's 4 chunks merge in row order; the
//      8 warps' records merge in a binary tree, and the tile's record goes to
//      scratch. A chunk that is one run from end to end (the common case on
//      sorted data) skips the record tree for one shuffle vote, and its fold
//      for an out-of-range run (groupby's -1 tail) is never computed.
//   3. pass 2: one 1024-thread block merges the tiles' records: each thread
//      folds its ceil(tiles / 1024) consecutive tiles in order, then a binary
//      tree over threads (shuffles, then one warp over the 32 warps' records)
//      writes every run that crosses a tile edge; the root writes the first
//      and the last run of the input. Nothing walks block after block.
// Every segment is written by exactly one thread, with no atomics, and the
// order of every fold is fixed by the data's layout alone, so results are the
// same from run to run. Summation order of a float sum: each lane's 4 rows in
// row order; the lanes of a 128-row chunk in a binary tree (neighbours, then
// pairs of pairs); the 4 chunks of a warp in row order; the 8 warps of a tile
// in a binary tree; the tiles as pass 2 merges them. That differs from the
// TPU's MXU order and from the plain version's, so float sums agree bit for
// bit only on integer-valued data. Every written value is op(identity, fold),
// so a float sum of -0.0 rows is +0.0, as in the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;                   // 128-row chunks a warp
constexpr int kWarpRows = kChunks * 128;     // 512
constexpr int kRows = kWarps * kWarpRows;    // 4096 rows a tile
constexpr int kMergeThreads = 1024;          // pass 2
constexpr unsigned kFull = 0xffffffffu;

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

template <typename T, int OP>
struct Fold;

template <int OP>
struct Fold<float, OP> {
  __device__ static float ident() {
    return OP == OP_SUM ? 0.0f : (OP == OP_MIN ? INFINITY : -INFINITY);
  }
  // NaN-first: a NaN on the left wins, one on the right replaces a number
  __device__ static float apply(float a, float b) {
    if (OP == OP_SUM) return a + b;
    if (OP == OP_MIN) return (isnan(a) || a < b) ? a : b;
    return (isnan(a) || a > b) ? a : b;
  }
};

template <int OP>
struct Fold<int, OP> {
  __device__ static int ident() {
    return OP == OP_SUM ? 0 : (OP == OP_MIN ? INT32_MAX : INT32_MIN);
  }
  __device__ static int apply(int a, int b) {
    if (OP == OP_SUM) return (int)((unsigned)a + (unsigned)b);  // wraps
    if (OP == OP_MIN) return a < b ? a : b;
    return a > b ? a : b;
  }
};

__device__ __forceinline__ bool in_range(int g, int G) {
  return (unsigned)g < (unsigned)G;
}

// A range of rows: its first run (id fid, partial fold f) and its last run
// (lid, l); single when one run covers the range (then fid == lid, f == l).
template <typename T>
struct Piece {
  int fid, lid;
  T f, l;
  int single;
};

template <typename T, int OP>
__device__ __forceinline__ void emit(T* out, int g, int G, T v) {
  if (in_range(g, G)) out[g] = Fold<T, OP>::apply(Fold<T, OP>::ident(), v);
}

// The record of range a followed by range b; writes the runs that the merge
// closes (a's last and b's first, joined or not, unless they stay open as
// the merged range's first or last run).
template <typename T, int OP>
__device__ __forceinline__ Piece<T> merge(const Piece<T>& a, const Piece<T>& b,
                                          T* out, int G) {
  Piece<T> r{a.fid, b.lid, a.f, b.l, 0};
  if (a.lid == b.fid) {  // one run across the edge
    const T j = Fold<T, OP>::apply(a.l, b.f);
    if (a.single) r.f = j;
    if (b.single) r.l = j;
    r.single = a.single & b.single;
    if (!a.single && !b.single) emit<T, OP>(out, a.lid, G, j);
  } else {
    if (!a.single) emit<T, OP>(out, a.lid, G, a.l);
    if (!b.single) emit<T, OP>(out, b.fid, G, b.f);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ Piece<T> shfl_down(const Piece<T>& p, int off) {
  return {__shfl_down_sync(kFull, p.fid, off), __shfl_down_sync(kFull, p.lid, off),
          __shfl_down_sync(kFull, p.f, off), __shfl_down_sync(kFull, p.l, off),
          __shfl_down_sync(kFull, p.single, off)};
}

// Binary tree over the records of lanes [0, width) of a warp (every lane
// calls it); lane 0 returns the merged record.
template <typename T, int OP>
__device__ __forceinline__ Piece<T> warp_merge(Piece<T> p, int width, T* out,
                                               int G) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= width) break;
    const Piece<T> q = shfl_down(p, off);
    if ((lane & (2 * off - 1)) == 0 && lane + off < width)
      p = merge<T, OP>(p, q, out, G);
  }
  return p;
}

template <typename T, int OP>
__global__ void seg_fill(T* __restrict__ out, int G) {
  int4 pat;
  T* pp = reinterpret_cast<T*>(&pat);
  pp[0] = pp[1] = pp[2] = pp[3] = Fold<T, OP>::ident();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = G / 4;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = first; i < n4; i += stride) out4[i] = pat;
  for (long long g = n4 * 4 + first; g < G; g += stride) out[g] = pp[0];
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    seg_pass1(const T* __restrict__ vals, const int* __restrict__ ids, long long n,
              int G, int vec, T* __restrict__ out, int* __restrict__ t_fid,
              int* __restrict__ t_lid, T* __restrict__ t_f, T* __restrict__ t_l,
              int* __restrict__ t_single) {
  using F = Fold<T, OP>;
  __shared__ Piece<T> s_warp[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long w0 = (long long)blockIdx.x * kRows + (long long)warp * kWarpRows;

  // every load first: 4 rows of each chunk a lane, 16 bytes each; rows past
  // n read as an out-of-range run
  int id[kChunks][4];
  T v[kChunks][4];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const long long r = w0 + j * 128 + 4 * lane;
    if (vec && r + 4 <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids + r));
      const int4 b = __ldg(reinterpret_cast<const int4*>(vals + r));
      id[j][0] = a.x, id[j][1] = a.y, id[j][2] = a.z, id[j][3] = a.w;
      const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = bv[e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r + e < n;
        id[j][e] = ok ? ids[r + e] : -1;
        v[j][e] = ok ? vals[r + e] : F::ident();
      }
    }
  }

  Piece<T> carry{-1, -1, F::ident(), F::ident(), 1};
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    Piece<T> p{id[j][0], id[j][0], v[j][0], v[j][0], 1};
#pragma unroll
    for (int e = 1; e < 4; ++e)
      p = merge<T, OP>(p, Piece<T>{id[j][e], id[j][e], v[j][e], v[j][e], 1}, out, G);
    const int id0 = __shfl_sync(kFull, p.fid, 0);
    Piece<T> c;
    if (__all_sync(kFull, p.single && p.fid == id0)) {
      // one run through the chunk: fold it in the same tree, unless it is
      // out of range (then it is never written, so never folded)
      T total = p.f;
      if (in_range(id0, G)) {
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const T o = __shfl_down_sync(kFull, total, off);
          if ((lane & (2 * off - 1)) == 0) total = F::apply(total, o);
        }
      }
      c = Piece<T>{id0, id0, total, total, 1};
    } else {
      c = warp_merge<T, OP>(p, 32, out, G);
    }
    if (lane == 0) carry = j == 0 ? c : merge<T, OP>(carry, c, out, G);
  }

  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    Piece<T> p = s_warp[lane < kWarps ? lane : 0];
    p = warp_merge<T, OP>(p, kWarps, out, G);
    if (lane == 0) {
      t_fid[blockIdx.x] = p.fid;
      t_lid[blockIdx.x] = p.lid;
      t_f[blockIdx.x] = p.f;
      t_l[blockIdx.x] = p.l;
      t_single[blockIdx.x] = p.single;
    }
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kMergeThreads)
    seg_pass2(T* __restrict__ out, int G, int ntiles, const int* __restrict__ t_fid,
              const int* __restrict__ t_lid, const T* __restrict__ t_f,
              const T* __restrict__ t_l, const int* __restrict__ t_single) {
  using F = Fold<T, OP>;
  __shared__ Piece<T> s_p[kMergeThreads / 32];
  __shared__ int s_has[kMergeThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto load = [&](int i) {
    return Piece<T>{t_fid[i], t_lid[i], t_f[i], t_l[i], t_single[i]};
  };
  // thread t folds tiles [t per, (t + 1) per) in order; the threads that
  // hold tiles are a prefix, so a record with tiles never follows one without
  const int per = (ntiles + kMergeThreads - 1) / kMergeThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, ntiles);
  int has = lo < hi;
  Piece<T> p{-1, -1, F::ident(), F::ident(), 1};
  if (has) {
    p = load(lo);
    for (int i = lo + 1; i < hi; ++i) p = merge<T, OP>(p, load(i), out, G);
  }
  auto tree = [&](int width) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off >= width) break;
      const Piece<T> q = shfl_down(p, off);
      const int qhas = __shfl_down_sync(kFull, has, off);
      if ((lane & (2 * off - 1)) == 0 && lane + off < width && qhas)
        p = merge<T, OP>(p, q, out, G);
    }
  };
  tree(32);
  if (lane == 0) {
    s_p[warp] = p;
    s_has[warp] = has;
  }
  __syncthreads();
  if (warp != 0) return;
  p = s_p[lane];
  has = s_has[lane];
  tree(kMergeThreads / 32);
  if (lane == 0 && has) {  // the input's first and last runs are complete
    emit<T, OP>(out, p.fid, G, p.f);
    if (!p.single) emit<T, OP>(out, p.lid, G, p.l);
  }
}

template <typename T, int OP>
void launch(const void* vals, const int* ids, void* out, long long n, int G,
            void* scratch_t, int* scratch_i, cudaStream_t s) {
  if (G > 0) {
    const long long want = ((long long)G / 4 + 255) / 256;
    const int blocks = (int)(want < 1 ? 1 : (want < 132 * 8 ? want : 132 * 8));
    seg_fill<T, OP><<<blocks, 256, 0, s>>>((T*)out, G);
  }
  if (n <= 0) return;
  const int ntiles = (int)((n + kRows - 1) / kRows);
  T* t_f = (T*)scratch_t;
  T* t_l = t_f + ntiles;
  int* t_fid = scratch_i;
  int* t_lid = scratch_i + ntiles;
  int* t_single = scratch_i + 2 * ntiles;
  const int vec = ((uintptr_t)vals % 16 == 0) && ((uintptr_t)ids % 16 == 0);
  seg_pass1<T, OP><<<ntiles, kThreads, 0, s>>>((const T*)vals, ids, n, G, vec,
                                                (T*)out, t_fid, t_lid, t_f, t_l,
                                                t_single);
  seg_pass2<T, OP><<<1, kMergeThreads, 0, s>>>((T*)out, G, ntiles, t_fid, t_lid,
                                               t_f, t_l, t_single);
}

}  // namespace

// Rows per pass-1 tile; the wrapper sizes the scratch from it.
extern "C" int repro_segment_reduce_rows_per_block() { return kRows; }

// vals: n float32 (is_float) or int32; ids: n int32 whose in-range ids each
// form one contiguous run; out: G values, 16-byte aligned. op 0 = sum, 1 =
// min, 2 = max. scratch_t: 2 * ntiles values of the same type, scratch_i:
// 3 * ntiles int32, ntiles = ceil(n / rows_per_block). Returns
// cudaGetLastError().
extern "C" int repro_segment_reduce(const void* vals, const int* ids, void* out,
                                    long long n, int G, int op, int is_float,
                                    void* scratch_t, int* scratch_i,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_float) {
    if (op == OP_SUM)
      launch<float, OP_SUM>(vals, ids, out, n, G, scratch_t, scratch_i, s);
    else if (op == OP_MIN)
      launch<float, OP_MIN>(vals, ids, out, n, G, scratch_t, scratch_i, s);
    else
      launch<float, OP_MAX>(vals, ids, out, n, G, scratch_t, scratch_i, s);
  } else {
    if (op == OP_SUM)
      launch<int, OP_SUM>(vals, ids, out, n, G, scratch_t, scratch_i, s);
    else if (op == OP_MIN)
      launch<int, OP_MIN>(vals, ids, out, n, G, scratch_t, scratch_i, s);
    else
      launch<int, OP_MAX>(vals, ids, out, n, G, scratch_t, scratch_i, s);
  }
  return (int)cudaGetLastError();
}

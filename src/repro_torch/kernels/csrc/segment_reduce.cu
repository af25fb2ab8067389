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
// wrapper arranges (kernels/segment_reduce.py). Values are int32, float32 or
// float64; every fold, partial and scratch record is in the values' type.
//
// Bound: bytes. Each row's id is read once (4 B), the value of each row in a
// 128-row chunk that holds an in-range id is read once (4 B, or 8 B for
// float64), and each segment is written once (4 B or 8 B); the fold is one
// add/min/max per row read. A chunk whose ids are all out of range (the
// bulk of groupby's -1 tail) costs its ids alone.
//
// Design: every range of rows, from one lane's four up to the whole input,
// is summarised by the same fixed-size record: the id and partial fold of
// its first run and of its last run, and whether one run covers it all.
// Two neighbouring records merge in O(1): a run that now lies wholly inside
// the merged range is complete and is written out; only the first and the
// last run stay open. Three launches on one stream:
//   1. fill: out[g] = identity for every g, 16-byte stores (4 values, or 2
//      float64, a store).
//   2. pass 1: a 256-thread block owns a 4096-row tile; each warp owns 512
//      consecutive rows, read as four 128-row chunks with 16-byte loads
//      (a lane holds 4 consecutive rows of each chunk: one load of ids and
//      one of values, two for float64; coalesced, no shared memory). The
//      warp loads its 4 chunks' ids first, then the values of each chunk
//      where some lane holds an in-range id (a warp vote); a chunk with
//      none is never folded into anything written, so its values are not
//      read. A lane folds its 4 rows; the 32 lanes' records merge in a
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
struct Fold<double, OP> {
  __device__ static double ident() {
    return OP == OP_SUM ? 0.0 : (OP == OP_MIN ? (double)INFINITY : -(double)INFINITY);
  }
  // NaN-first, as the float instance
  __device__ static double apply(double a, double b) {
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

// values of T in one 16-byte vector: 4, or 2 for float64
template <typename T>
constexpr int kPerVec = 16 / (int)sizeof(T);

template <typename T, int OP>
__global__ void seg_fill(T* __restrict__ out, int G) {
  constexpr int kPer = kPerVec<T>;
  int4 pat;
  T* pp = reinterpret_cast<T*>(&pat);
#pragma unroll
  for (int e = 0; e < kPer; ++e) pp[e] = Fold<T, OP>::ident();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = G / kPer;
  int4* outv = reinterpret_cast<int4*>(out);
  for (long long i = first; i < nvec; i += stride) outv[i] = pat;
  for (long long g = nvec * kPer + first; g < G; g += stride) out[g] = pp[0];
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

  // the ids first: 4 rows of each chunk a lane, one 16-byte load; rows
  // past n read as an out-of-range run
  int id[kChunks][4];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const long long r = w0 + j * 128 + 4 * lane;
    if (vec && r + 4 <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids + r));
      id[j][0] = a.x, id[j][1] = a.y, id[j][2] = a.z, id[j][3] = a.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) id[j][e] = r + e < n ? ids[r + e] : -1;
    }
  }
  // then the values of each chunk that holds an in-range id (16-byte loads,
  // two for float64); a chunk without one is never folded into anything
  // written, so it keeps the identity
  constexpr int kPer = kPerVec<T>;
  T v[kChunks][4];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const long long r = w0 + j * 128 + 4 * lane;
    bool live = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) live |= in_range(id[j][e], G);
    if (__any_sync(kFull, live)) {
      if (vec && r + 4 <= n) {
#pragma unroll
        for (int k = 0; k < 4 / kPer; ++k) {
          const int4 b = __ldg(reinterpret_cast<const int4*>(vals + r) + k);
          const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
          for (int e = 0; e < kPer; ++e) v[j][k * kPer + e] = bv[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][e] = r + e < n ? vals[r + e] : F::ident();
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = F::ident();
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

// one block a launch: it may take all 64 registers a thread of 1024 may
// have (the float64 records spill at the default's 32)
template <typename T, int OP>
__global__ void __launch_bounds__(kMergeThreads, 1)
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
    const long long want = ((long long)G / kPerVec<T> + 255) / 256;
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

enum { DTYPE_INT32 = 0, DTYPE_FLOAT32 = 1, DTYPE_FLOAT64 = 2 };

template <typename T>
void launch_op(const void* vals, const int* ids, void* out, long long n, int G,
               int op, void* scratch_t, int* scratch_i, cudaStream_t s) {
  if (op == OP_SUM)
    launch<T, OP_SUM>(vals, ids, out, n, G, scratch_t, scratch_i, s);
  else if (op == OP_MIN)
    launch<T, OP_MIN>(vals, ids, out, n, G, scratch_t, scratch_i, s);
  else
    launch<T, OP_MAX>(vals, ids, out, n, G, scratch_t, scratch_i, s);
}

}  // namespace

// Rows per pass-1 tile; the wrapper sizes the scratch from it.
extern "C" int repro_segment_reduce_rows_per_block() { return kRows; }

// vals: n values of the type dtype names (0 int32, 1 float32, 2 float64);
// ids: n int32 whose in-range ids each form one contiguous run; out: G
// values of that type, 16-byte aligned. op 0 = sum, 1 = min, 2 = max.
// scratch_t: 2 * ntiles values of the same type, scratch_i: 3 * ntiles
// int32, ntiles = ceil(n / rows_per_block). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another dtype or op.
extern "C" int repro_segment_reduce(const void* vals, const int* ids, void* out,
                                    long long n, int G, int op, int dtype,
                                    void* scratch_t, int* scratch_i,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (op < OP_SUM || op > OP_MAX) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_INT32)
    launch_op<int>(vals, ids, out, n, G, op, scratch_t, scratch_i, s);
  else if (dtype == DTYPE_FLOAT32)
    launch_op<float>(vals, ids, out, n, G, op, scratch_t, scratch_i, s);
  else if (dtype == DTYPE_FLOAT64)
    launch_op<double>(vals, ids, out, n, G, op, scratch_t, scratch_i, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

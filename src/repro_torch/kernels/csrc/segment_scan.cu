// Segmented inclusive/exclusive running sum/min/max for Hopper (sm_90a):
// reduce-then-scan, deterministic.
//
// Replaces the Pallas kernel repro/kernels/segment_scan.py::
// segment_scan_tiles (_scan_kernel), the hot path of every window function
// (rank, dense_rank, cumsum, cummax, running_mean). out[i] = op(values[j] :
// j <= i in the same segment), j < i when exclusive; a row with no
// in-segment predecessor holds the op's identity (0, +max, -max). A segment
// is a maximal run of equal ids (-1 padding included), so the ids need only
// form contiguous runs. The TPU kernel builds a (1024, 1024) triangular
// same-segment mask per block and carries the running value from one grid
// step to the next, which needs a grid that runs in order; Hopper's blocks
// run in no order, so this kernel does not carry that over.
//
// Bound: bytes. Each row is read once (4 B value + 4 B id) and written once
// (4 B): 12 B a row. The operator is one add/min/max per row.
//
// Design: the scan runs over pairs (f, v): f says a segment starts in the
// range, v is op over the range's rows after its last segment start. The
// pair operator (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2)) is
// associative. Row i starts a segment when i == 0 or ids[i] != ids[i-1].
// Three launches on one stream:
//   1. reduce: block b owns rows [b*R, (b+1)*R), R = 256 threads x 16 rows,
//      staged through shared memory (padded, so the threads' runs of 16 rows
//      read without bank conflicts) with coalesced loads. Each thread folds
//      its 16 rows in row order; the threads' pairs combine by warp shuffles
//      and then across the 8 warps in warp order. Block b writes its pair.
//   2. carry: one block of 1024 threads scans the block pairs in block
//      order (each thread folds a contiguous slice of blocks, the threads
//      combine as in 1, each thread re-walks its slice) and writes each
//      block's carry-in: op over the rows since the last segment start
//      before the block.
//   3. scan: each block folds its rows again as in 1, takes each thread's
//      exclusive prefix over the threads before it, folds the block's carry
//      into the prefix of the rows before the block's first segment start,
//      and each thread writes its 16 outputs, inclusive or exclusive, through
//      shared memory with coalesced stores.
// With one block, launches 1 and 2 are skipped. No atomics: the order of
// every fold is fixed by the layout alone, so a run gives the same bits
// every time. Float sum order for row i: the carry (the block pairs of the
// blocks before, folded per carry thread in block order and then across
// those threads by the shuffle tree), then the thread pairs before row i's
// thread in its block (shuffle tree within a warp, then warps in order),
// then row i's thread's rows in row order. The plain version adds in a
// log-step tree and the TPU kernel on the MXU, so float sums agree bit for
// bit only where every partial sum is exact: integer-valued data whose
// partial sums stay below 2**24. Internally a float sum starts from -0.0
// (the true identity of +), so -0.0 rows keep their sign as in the plain
// version; an exclusive scan's segment-start rows hold +0.0, as there.
// int32 sums wrap (unsigned arithmetic). min/max propagate NaN and keep the
// first NaN's bits, as the plain version's select does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kRows = kThreads * kItems;
constexpr int kPadded = kRows + kRows / 32;
constexpr int kCarryThreads = 1024;

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

template <typename T, int OP>
struct Fold;

template <int OP>
struct Fold<float, OP> {
  // identity inside the scan (-0.0 + x == x for every x, -0.0 included)
  __device__ static float ident() {
    return OP == OP_SUM ? -0.0f : (OP == OP_MIN ? INFINITY : -INFINITY);
  }
  // what an exclusive scan writes at a segment's first row
  __device__ static float init() {
    return OP == OP_SUM ? 0.0f : ident();
  }
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
  __device__ static int init() { return ident(); }
  __device__ static int apply(int a, int b) {
    if (OP == OP_SUM) return (int)((unsigned)a + (unsigned)b);  // wraps
    if (OP == OP_MIN) return a < b ? a : b;
    return a > b ? a : b;
  }
};

// shared-memory slot of row r of a block: one pad word every 32 rows
__device__ __forceinline__ int pad(int r) { return r + (r >> 5); }

// The segmented pair (f, v) of the rows [a, b) combined with (f2, v2) of the
// rows right after: (f | f2, f2 ? v2 : op(v, v2)).
template <typename T, int OP>
__device__ __forceinline__ void combine(int& f, T& v, int f2, T v2) {
  v = f2 ? v2 : Fold<T, OP>::apply(v, v2);
  f |= f2;
}

// Exclusive scan of one pair per thread over the NT threads of the block,
// in thread order. On return (f, v) is the pair of the threads before this
// one ((0, ident) for thread 0). s_f, s_v: NT / 32 slots of shared memory.
template <typename T, int OP, int NT>
__device__ void block_exclusive_scan(int& f, T& v, int* s_f, T* s_v) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int fi = f;
  T vi = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int fo = __shfl_up_sync(kFull, fi, d);
    T vo = __shfl_up_sync(kFull, vi, d);
    if (lane >= d) {  // (fo, vo) covers the threads just before
      int f2 = fi;
      T v2 = vi;
      fi = fo;
      vi = vo;
      combine<T, OP>(fi, vi, f2, v2);
    }
  }
  if (lane == 31) {
    s_f[warp] = fi;
    s_v[warp] = vi;
  }
  int fe = __shfl_up_sync(kFull, fi, 1);
  T ve = __shfl_up_sync(kFull, vi, 1);
  if (lane == 0) {
    fe = 0;
    ve = Fold<T, OP>::ident();
  }
  __syncthreads();
  int fw = 0;
  T vw = Fold<T, OP>::ident();
  for (int w = 0; w < warp; ++w) combine<T, OP>(fw, vw, s_f[w], s_v[w]);
  combine<T, OP>(fw, vw, fe, ve);
  f = fw;
  v = vw;
  __syncthreads();  // s_f / s_v may be reused after this
}

// Loads block b's rows into shared memory and returns the id of the row
// before the block (the first row of the array starts a segment anyway).
template <typename T>
__device__ int load_block(const T* __restrict__ vals, const int* __restrict__ ids,
                          long long blk0, int rows, int* s_id, T* s_v) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    s_id[pad(i)] = ids[blk0 + i];
    s_v[pad(i)] = vals[blk0 + i];
  }
  int prev = blk0 > 0 ? ids[blk0 - 1] : 0;
  __syncthreads();
  return prev;
}

// This thread's pair over its rows [r0, r0 + cnt) of the block.
template <typename T, int OP>
__device__ void thread_pair(const int* s_id, const T* s_v, int r0, int cnt,
                            long long blk0, int prev, int& f, T& v) {
  f = 0;
  v = Fold<T, OP>::ident();
  for (int i = 0; i < cnt; ++i) {
    int r = r0 + i;
    int id = s_id[pad(r)];
    int before = r > 0 ? s_id[pad(r - 1)] : prev;
    T x = s_v[pad(r)];
    if ((blk0 == 0 && r == 0) || id != before) {
      f = 1;
      v = x;
    } else {
      v = Fold<T, OP>::apply(v, x);
    }
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
scan_reduce(const T* __restrict__ vals, const int* __restrict__ ids,
            long long n, int* __restrict__ blk_f, T* __restrict__ blk_v) {
  __shared__ int s_id[kPadded];
  __shared__ T s_v[kPadded];
  __shared__ int w_f[kThreads / 32];
  __shared__ T w_v[kThreads / 32];
  const long long blk0 = (long long)blockIdx.x * kRows;
  const int rows = (int)(n - blk0 < kRows ? n - blk0 : kRows);
  const int prev = load_block(vals, ids, blk0, rows, s_id, s_v);
  const int r0 = threadIdx.x * kItems;
  const int cnt = max(0, min(kItems, rows - r0));
  int f;
  T v;
  thread_pair<T, OP>(s_id, s_v, r0, cnt, blk0, prev, f, v);
  int fx = f;
  T vx = v;
  block_exclusive_scan<T, OP, kThreads>(fx, vx, w_f, w_v);
  if (threadIdx.x == kThreads - 1) {  // the exclusive prefix + its own pair
    combine<T, OP>(fx, vx, f, v);
    blk_f[blockIdx.x] = fx;
    blk_v[blockIdx.x] = vx;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kCarryThreads)
scan_carry(const int* __restrict__ blk_f, const T* __restrict__ blk_v,
           int nblocks, T* __restrict__ carry) {
  __shared__ int w_f[kCarryThreads / 32];
  __shared__ T w_v[kCarryThreads / 32];
  const int per = (nblocks + kCarryThreads - 1) / kCarryThreads;
  const int lo = min(nblocks, (int)threadIdx.x * per);
  const int hi = min(nblocks, lo + per);
  int f = 0;
  T v = Fold<T, OP>::ident();
  for (int b = lo; b < hi; ++b) combine<T, OP>(f, v, blk_f[b], blk_v[b]);
  block_exclusive_scan<T, OP, kCarryThreads>(f, v, w_f, w_v);
  for (int b = lo; b < hi; ++b) {
    carry[b] = v;
    combine<T, OP>(f, v, blk_f[b], blk_v[b]);
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
scan_apply(const T* __restrict__ vals, const int* __restrict__ ids, long long n,
           const T* __restrict__ carry, int inclusive, T* __restrict__ out) {
  using F = Fold<T, OP>;
  __shared__ int s_id[kPadded];
  __shared__ T s_v[kPadded];
  __shared__ int w_f[kThreads / 32];
  __shared__ T w_v[kThreads / 32];
  const long long blk0 = (long long)blockIdx.x * kRows;
  const int rows = (int)(n - blk0 < kRows ? n - blk0 : kRows);
  const int prev = load_block(vals, ids, blk0, rows, s_id, s_v);
  const int r0 = threadIdx.x * kItems;
  const int cnt = max(0, min(kItems, rows - r0));
  int f;
  T v;
  thread_pair<T, OP>(s_id, s_v, r0, cnt, blk0, prev, f, v);
  block_exclusive_scan<T, OP, kThreads>(f, v, w_f, w_v);
  // the rows before the block's first segment start continue the carry
  T run = f ? v : F::apply(blockIdx.x > 0 ? carry[blockIdx.x] : F::ident(), v);
  for (int i = 0; i < cnt; ++i) {
    int r = r0 + i;
    int id = s_id[pad(r)];
    int before = r > 0 ? s_id[pad(r - 1)] : prev;
    T x = s_v[pad(r)];
    bool head = (blk0 == 0 && r == 0) || id != before;
    T excl = head ? F::init() : run;
    run = head ? x : F::apply(run, x);
    s_v[pad(r)] = inclusive ? run : excl;  // only this thread reads row r's value
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) out[blk0 + i] = s_v[pad(i)];
}

template <typename T, int OP>
void launch(const void* vals, const int* ids, void* out, long long n,
            int inclusive, void* scratch_t, int* scratch_i, cudaStream_t s) {
  if (n <= 0) return;
  const long long nb = (n + kRows - 1) / kRows;
  const int nblocks = (int)nb;
  T* blk_v = (T*)scratch_t;
  T* carry = blk_v + nblocks;
  if (nblocks > 1) {
    scan_reduce<T, OP><<<nblocks, kThreads, 0, s>>>((const T*)vals, ids, n,
                                                     scratch_i, blk_v);
    scan_carry<T, OP><<<1, kCarryThreads, 0, s>>>(scratch_i, blk_v, nblocks,
                                                  carry);
  }
  scan_apply<T, OP><<<nblocks, kThreads, 0, s>>>((const T*)vals, ids, n, carry,
                                                  inclusive, (T*)out);
}

}  // namespace

// Rows per block; the wrapper sizes the scratch from it.
extern "C" int repro_segment_scan_rows_per_block() { return kRows; }

// vals: n float32 (is_float) or int32; ids: n int32 forming contiguous runs;
// out: n values of the same type. op 0 = sum, 1 = min, 2 = max; inclusive
// 0 or 1. scratch_t: 2 * nblocks values of the same type, scratch_i:
// nblocks int32, nblocks = ceil(n / rows_per_block). Returns
// cudaGetLastError().
extern "C" int repro_segment_scan(const void* vals, const int* ids, void* out,
                                  long long n, int op, int is_float,
                                  int inclusive, void* scratch_t,
                                  int* scratch_i, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_float) {
    if (op == OP_SUM)
      launch<float, OP_SUM>(vals, ids, out, n, inclusive, scratch_t, scratch_i, s);
    else if (op == OP_MIN)
      launch<float, OP_MIN>(vals, ids, out, n, inclusive, scratch_t, scratch_i, s);
    else
      launch<float, OP_MAX>(vals, ids, out, n, inclusive, scratch_t, scratch_i, s);
  } else {
    if (op == OP_SUM)
      launch<int, OP_SUM>(vals, ids, out, n, inclusive, scratch_t, scratch_i, s);
    else if (op == OP_MIN)
      launch<int, OP_MIN>(vals, ids, out, n, inclusive, scratch_t, scratch_i, s);
    else
      launch<int, OP_MAX>(vals, ids, out, n, inclusive, scratch_t, scratch_i, s);
  }
  return (int)cudaGetLastError();
}

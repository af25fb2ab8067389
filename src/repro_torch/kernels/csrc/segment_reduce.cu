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
// Design (three launches on one stream):
//   1. fill: out[g] = identity for every g.
//   2. pass 1: block b owns rows [b*R, (b+1)*R), R = 256 threads x 16 rows,
//      staged through shared memory with coalesced loads. Each thread folds
//      its 16 rows in row order into runs of equal ids. A run that starts and
//      ends inside the thread is written straight to out. The thread that
//      holds the first row of a run that leaves it walks the following
//      threads' leading pieces in thread order and writes the total, unless
//      the run reaches the end of the block and continues into the next one:
//      then the partial goes to the block's "open last run". Thread 0 of a
//      block whose first row continues a run from the block before sums that
//      run's piece in this block the same way ("first piece", and whether the
//      run runs through the whole block).
//   3. pass 2: one thread per block with an open last run adds the first
//      pieces of the following blocks in block order until the run ends, and
//      writes the total.
// Every segment is written by exactly one thread, with no atomics, and the
// order of every fold is fixed by the data's layout alone, so results are the
// same from run to run. Summation order for a float sum: the rows of each
// 16-row thread piece in row order, then the pieces in thread order, then
// the 4096-row block pieces in block order. That differs from the TPU's MXU
// order, so float sums agree bit for bit only on integer-valued data.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kRows = kThreads * kItems;

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

template <typename T, int OP>
struct Fold;

template <int OP>
struct Fold<float, OP> {
  __device__ static float ident() {
    return OP == OP_SUM ? 0.0f : (OP == OP_MIN ? INFINITY : -INFINITY);
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
  __device__ static int apply(int a, int b) {
    if (OP == OP_SUM) return (int)((unsigned)a + (unsigned)b);  // wraps
    if (OP == OP_MIN) return a < b ? a : b;
    return a > b ? a : b;
  }
};

__device__ __forceinline__ bool in_range(int g, int G) {
  return (unsigned)g < (unsigned)G;
}

template <typename T, int OP>
__global__ void seg_fill(T* __restrict__ out, int G) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += stride)
    out[g] = Fold<T, OP>::ident();
}

template <typename T, int OP>
__global__ void seg_pass1(const T* __restrict__ vals, const int* __restrict__ ids,
                          long long n, int G, T* __restrict__ out,
                          T* __restrict__ blk_first, T* __restrict__ blk_last,
                          int* __restrict__ blk_through,
                          int* __restrict__ blk_last_id,
                          int* __restrict__ blk_last_open) {
  using F = Fold<T, OP>;
  __shared__ int s_id[kRows];
  __shared__ T s_v[kRows];
  __shared__ int t_fid[kThreads], t_cnt[kThreads], t_single[kThreads];
  __shared__ T t_fsum[kThreads];

  const long long blk0 = (long long)blockIdx.x * kRows;
  const long long left = n - blk0;
  const int rows = (int)(left < kRows ? left : kRows);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    s_id[i] = ids[blk0 + i];
    s_v[i] = vals[blk0 + i];
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int r0 = t * kItems;
  const int cnt = rows - r0 < 0 ? 0 : (rows - r0 < kItems ? rows - r0 : kItems);
  int fid = -1, lid = -1;
  T fsum = F::ident(), lsum = F::ident();
  bool single = true;
  if (cnt > 0) {
    int cur = s_id[r0];
    T acc = F::apply(F::ident(), s_v[r0]);
    bool have_first = false;
    for (int i = 1; i < cnt; ++i) {
      int id = s_id[r0 + i];
      T v = s_v[r0 + i];
      if (id == cur) {
        acc = F::apply(acc, v);
      } else {
        if (!have_first) {
          fid = cur;
          fsum = acc;
          have_first = true;
        } else if (in_range(cur, G)) {
          out[cur] = acc;  // a run wholly inside this thread
        }
        cur = id;
        acc = F::apply(F::ident(), v);
      }
    }
    lid = cur;
    lsum = acc;
    single = !have_first;
    if (single) {
      fid = cur;
      fsum = acc;
    }
  }
  t_fid[t] = fid;
  t_fsum[t] = fsum;
  t_cnt[t] = cnt;
  t_single[t] = single ? 1 : 0;
  __syncthreads();
  if (cnt == 0) return;  // no barrier follows

  // does this thread's first row start its run?
  bool head;
  if (r0 > 0)
    head = s_id[r0 - 1] != fid;
  else
    head = blk0 == 0 || ids[blk0 - 1] != fid;
  if (!single && head && in_range(fid, G)) out[fid] = fsum;

  // Walk the pieces after thread t of the run `g`, whose piece in thread t
  // ends at that thread's last row. Returns the total; *open is set when
  // the run reaches the block's last row and goes on into the next block.
  auto walk = [&](int g, T total, bool* open) -> T {
    int u = t + 1;
    bool to_end = true;
    while (u < kThreads && t_cnt[u] > 0) {
      if (t_fid[u] != g) {
        to_end = false;
        break;
      }
      total = F::apply(total, t_fsum[u]);
      if (!t_single[u]) {
        to_end = false;
        break;
      }
      ++u;
    }
    *open = to_end && rows == kRows && blk0 + kRows < n && ids[blk0 + kRows] == g;
    return total;
  };

  if (!single || head) {  // this thread holds the first row of its last run
    bool open;
    T total = walk(lid, lsum, &open);
    if (open) {
      blk_last[blockIdx.x] = total;
      blk_last_id[blockIdx.x] = lid;
      blk_last_open[blockIdx.x] = 1;
    } else if (in_range(lid, G)) {
      out[lid] = total;
    }
  }
  if (t == 0 && !head) {  // the run continued from the block before
    bool open = false;
    T total = single ? walk(fid, fsum, &open) : fsum;
    blk_first[blockIdx.x] = total;
    blk_through[blockIdx.x] = open ? 1 : 0;
  }
}

template <typename T, int OP>
__global__ void seg_pass2(T* __restrict__ out, int G, int nblocks,
                          const T* __restrict__ blk_first,
                          const T* __restrict__ blk_last,
                          const int* __restrict__ blk_through,
                          const int* __restrict__ blk_last_id,
                          const int* __restrict__ blk_last_open) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks || !blk_last_open[b]) return;
  T total = blk_last[b];
  for (int c = b + 1; c < nblocks; ++c) {
    total = Fold<T, OP>::apply(total, blk_first[c]);
    if (!blk_through[c]) break;
  }
  int g = blk_last_id[b];
  if (in_range(g, G)) out[g] = total;
}

template <typename T, int OP>
void launch(const void* vals, const int* ids, void* out, long long n, int G,
            void* scratch_t, int* scratch_i, cudaStream_t s) {
  if (G > 0) {
    long long want = ((long long)G + 255) / 256;
    int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    seg_fill<T, OP><<<blocks, 256, 0, s>>>((T*)out, G);
  }
  if (n <= 0) return;
  int nblocks = (int)((n + kRows - 1) / kRows);
  T* blk_first = (T*)scratch_t;
  T* blk_last = blk_first + nblocks;
  int* blk_through = scratch_i;
  int* blk_last_id = scratch_i + nblocks;
  int* blk_last_open = scratch_i + 2 * nblocks;
  cudaMemsetAsync(scratch_i, 0, sizeof(int) * 3 * (size_t)nblocks, s);
  seg_pass1<T, OP><<<nblocks, kThreads, 0, s>>>(
      (const T*)vals, ids, n, G, (T*)out, blk_first, blk_last, blk_through,
      blk_last_id, blk_last_open);
  seg_pass2<T, OP><<<(nblocks + 255) / 256, 256, 0, s>>>(
      (T*)out, G, nblocks, blk_first, blk_last, blk_through, blk_last_id,
      blk_last_open);
}

}  // namespace

// Rows per pass-1 block; the wrapper sizes the scratch from it.
extern "C" int repro_segment_reduce_rows_per_block() { return kRows; }

// vals: n float32 (is_float) or int32; ids: n int32 whose in-range ids each
// form one contiguous run; out: G values. op 0 = sum, 1 = min, 2 = max.
// scratch_t: 2 * nblocks values of the same type, scratch_i: 3 * nblocks
// int32, nblocks = ceil(n / rows_per_block). Returns cudaGetLastError().
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

// Segmented inclusive/exclusive running sum/min/max for Hopper (sm_90a):
// a single-pass scan with decoupled look-back, deterministic.
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
// Design (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016). The scan runs over pairs (f, v): f
// says a segment starts in the range, v is op over the range's rows after
// its last segment start. The pair operator (f1, v1) . (f2, v2) =
// (f1 | f2, f2 ? v2 : op(v1, v2)) is associative. Row i starts a segment
// when i == 0 or ids[i] != ids[i-1]. One launch: a persistent grid of one
// block an SM, each of 15 row warps and one look-back warp, over tiles of
// 7680 rows (a warp's 512 rows in 4 chunks of 128, lane l holding rows
// 4 l .. 4 l + 3 of each, so every 16-byte load and store of a warp covers
// 512 consecutive bytes; loads and stores stream past L1 and leave L2
// first).
//   1. Tiles come from an atomic ticket, drawn two ahead, so every tile a
//      block waits on belongs to a block that has already started.
//   2. In iteration i the row warps fold tile T_i (its rows arrived during
//      iteration i - 1), publish its aggregate A at once, send out T_{i+1}'s
//      loads, then take T_{i-1}'s carry from the look-back warp and write
//      T_{i-1}'s rows. A tile that holds a segment start publishes its
//      inclusive prefix P = A at once: nothing before a segment start
//      matters.
//   3. A tile's status is one 64-bit word: the 32 value bits, the call's
//      epoch, the segment-start flag and A or P. It is stored and read with
//      relaxed GPU-scope accesses: one access, so flag and value never
//      tear, and coherent in L2, never an L1 copy. (No other memory is
//      published through it; a release store would wait for the thread's
//      loads of the next tile.) A word of another call's epoch reads as
//      not ready, so the words are zeroed only when the wrapper makes them;
//      the last block to finish resets the ticket.
//   4. The look-back warp reads the 288 words before the tile in one round
//      trip, waits until every word up to the nearest P is ready, and lane
//      0 folds from that P through the A values after it in tile order: the
//      carry is the sequential left fold (((P_k . A_{k+1}) . A_{k+2}) ...).
//      By induction every P is the left fold of all tile aggregates in tile
//      order, so where a look-back stops changes no bit. The -1 tail is one
//      segment over thousands of tiles; the look-back stops at the nearest
//      P, not at the segment's start. The tile then publishes P = carry . A.
//   5. Tiles start at the inputs' first 16-byte boundary, so a view at any
//      4-byte offset keeps 16-byte accesses when ids, values and out share
//      that offset; otherwise every access is 4 bytes.
// Float sum order for row i: the carry (the left fold of the aggregates of
// the tiles before, in tile order); then the pair of the tile's rows before
// row i's group of 4: the warps before (a shuffle tree over the warps'
// pairs) combined with the chunks before in the warp (in order) and the
// lanes before in the chunk (a shuffle tree); then the group's rows in row
// order. The same inputs at the same addresses give the same bits on every
// run. The plain version adds in a log-step tree and the TPU kernel on the
// MXU, so float sums agree bit for bit only where every partial sum is
// exact: integer-valued data whose partial sums stay below 2**24.
// Internally a float sum starts from -0.0 (the true identity of +), so
// -0.0 rows keep their sign as in the plain version; an exclusive scan's
// segment-start rows hold +0.0, as there. int32 sums wrap (unsigned
// arithmetic). min/max propagate NaN and keep the first NaN's bits, as the
// plain version's select does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 15 row warps and the look-back warp: 16 warps, 4 on each quarter of the
// SM, which leaves 128 registers a thread (a 17th warp would cap it at 96)
constexpr int kRowThreads = 480;
constexpr int kThreads = kRowThreads + 32;
constexpr int kItems = 16;  // rows a thread: four 16-byte loads of each input
constexpr int kRows = kRowThreads * kItems;
constexpr int kWarps = kRowThreads / 32;  // the row warps
constexpr int kMinBlocks = 1;    // blocks an SM: the persistent grid
// look-back windows of 32 tiles a read: a block has at most two tiles
// between aggregate and prefix, so the nearest P lies within 2 x 132 tiles
constexpr int kLookWindows = 9;
constexpr unsigned kFull = 0xffffffffu;

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };
// status of a tile's word: nothing yet, its aggregate, its inclusive prefix
enum : uint64_t { ST_NONE = 0, ST_AGG = 1, ST_PREFIX = 2 };

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
  __device__ static float from_bits(int x) { return __int_as_float(x); }
  __device__ static int to_bits(float x) { return __float_as_int(x); }
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
  __device__ static int from_bits(int x) { return x; }
  __device__ static int to_bits(int x) { return x; }
};

// The segmented pair (f, v) of the rows [a, b) combined with (f2, v2) of the
// rows right after: (f | f2, f2 ? v2 : op(v, v2)).
template <typename T, int OP>
__device__ __forceinline__ void combine(int& f, T& v, int f2, T v2) {
  v = f2 ? v2 : Fold<T, OP>::apply(v, v2);
  f |= f2;
}

// A status word carries its value with it, so no other memory is ordered
// by it: relaxed loads and stores at GPU scope (coherent in L2, never an L1
// copy; one 64-bit access, so flag and value never tear). A release store
// would wait for the thread's prefetch loads of the next tile.
__device__ __forceinline__ uint64_t ld_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// status word: value bits 32-63, the call's epoch bits 3-31, flag bit 2,
// status bits 0-1. A word of another call (another epoch) reads as ST_NONE,
// so the words need no reset between calls.
constexpr unsigned kEpochMask = (1u << 29) - 1;

template <typename T, int OP>
__device__ __forceinline__ uint64_t pack(uint64_t status, int f, T v, unsigned epoch) {
  return ((uint64_t)(uint32_t)Fold<T, OP>::to_bits(v) << 32) |
         ((uint64_t)(epoch & kEpochMask) << 3) | ((uint64_t)(f & 1) << 2) | status;
}

__device__ __forceinline__ uint64_t status_of(uint64_t w, unsigned epoch) {
  return ((unsigned)(w >> 3) & kEpochMask) == (epoch & kEpochMask) ? (w & 3) : ST_NONE;
}

// Run by one whole warp for tile b >= 1: the inclusive pair of tiles [0, b),
// the same in every lane. Each lane reads kLookWindows words at once, lane l
// of window q the tile hi - 32 q - l, so one round trip covers 32 x
// kLookWindows tiles. A tile with a segment start publishes P at once, so
// every A word has its flag clear: from the nearest P the carry is op over
// the A values in tile order. The lanes stage the values in shared memory
// (s_look, 32 x kLookWindows words) and lane 0 folds them.
template <typename T, int OP>
__device__ __forceinline__ void look_back(const uint64_t* status, unsigned epoch,
                                          long long b, uint32_t* s_look, int& fc,
                                          T& vc) {
  constexpr int K = kLookWindows;
  const int lane = threadIdx.x & 31;
  long long hi = b - 1;  // the nearest tile of the group, read by lane 0
  uint64_t w[K];
  int top = -1;  // the distance from hi of the nearest P
  for (;;) {
    for (;;) {  // spin until the group is ready up to its nearest P
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const long long t = hi - 32 * q - lane;
        // tile 0 is always a P, so a look-back never passes it; were it
        // to, the tiles before 0 read as an empty prefix and end it
        w[q] = t >= 0 ? ld_status(status + t)
                      : pack<T, OP>(ST_PREFIX, 0, Fold<T, OP>::ident(), epoch);
      }
      bool ready = true;
      top = -1;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (top < 0) {
          const uint64_t st = status_of(w[q], epoch);
          const unsigned rd = __ballot_sync(kFull, st != ST_NONE);
          const unsigned pm = __ballot_sync(kFull, st == ST_PREFIX);
          const unsigned need = pm ? ((pm & (0u - pm)) << 1) - 1u : kFull;
          ready = ready && (rd & need) == need;
          if (pm) top = 32 * q + __ffs(pm) - 1;
        }
      }
      if (ready) break;
    }
    if (top >= 0) break;
    hi -= 32 * K;
  }
  // from the nearest P (its flag is set, but for the empty prefix before
  // tile 0) through the A's after it, in tile order
  fc = hi - top >= 0;
  vc = Fold<T, OP>::ident();
  for (long long h = hi;;) {
#pragma unroll
    for (int q = 0; q < K; ++q) s_look[32 * q + lane] = (uint32_t)(w[q] >> 32);
    __syncwarp();
    if (lane == 0) {
      int i = top >= 0 ? top : 32 * K;
      if (top >= 0) vc = Fold<T, OP>::from_bits((int)s_look[top]);
      for (--i; i >= 0; --i)
        vc = Fold<T, OP>::apply(vc, Fold<T, OP>::from_bits((int)s_look[i]));
    }
    __syncwarp();
    h += 32 * K;
    if (h >= b) break;
    // a group read before the one that held the P, nearer to b: every
    // word is ready, and one may have become a P since
#pragma unroll
    for (int q = 0; q < K; ++q) w[q] = ld_status(status + (h - 32 * q - lane));
    top = -1;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const unsigned pm = __ballot_sync(kFull, status_of(w[q], epoch) == ST_PREFIX);
      if (top < 0 && pm) top = 32 * q + __ffs(pm) - 1;
    }
    if (top >= 0) fc = 1;
  }
  fc = __shfl_sync(kFull, fc, 0);
  vc = __shfl_sync(kFull, vc, 0);
}

// A warp owns kWarpRows consecutive rows of its tile, in kChunks chunks of
// 128: lane l holds rows 4 l .. 4 l + 3 of each chunk, so every load and
// store of the warp covers 512 consecutive bytes.
constexpr int kChunks = kItems / 4;
constexpr int kWarpRows = 32 * kItems;

// Loads this lane's rows of the warp's rows from wr (16-byte loads where the
// inputs allow; rows outside [0, n) read as id 0 and the identity) and, for
// lane 0, the id of the row before wr.
template <typename T, int OP>
__device__ __forceinline__ void load_rows(const T* __restrict__ vals,
                                          const int* __restrict__ ids,
                                          long long n, long long wr, int vec,
                                          int (&id)[kItems], T (&x)[kItems],
                                          int& prev) {
  using F = Fold<T, OP>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const long long r = wr + 128 * j + 4 * lane;
    if (vec && r >= 0 && r + 4 <= n) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(ids + r));
      const int4 c = __ldcs(reinterpret_cast<const int4*>(vals + r));
      id[4 * j] = a.x; id[4 * j + 1] = a.y; id[4 * j + 2] = a.z; id[4 * j + 3] = a.w;
      x[4 * j] = F::from_bits(c.x);
      x[4 * j + 1] = F::from_bits(c.y);
      x[4 * j + 2] = F::from_bits(c.z);
      x[4 * j + 3] = F::from_bits(c.w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = r + e >= 0 && r + e < n;
        id[4 * j + e] = in ? ids[r + e] : 0;
        x[4 * j + e] = in ? vals[r + e] : F::ident();
      }
    }
  }
  prev = (lane == 0 && wr >= 1 && wr <= n) ? ids[wr - 1] : 0;
}

// Inclusive scan of one pair per lane over the warp, in lane order (a
// shuffle tree), over the first `width` lanes that matter.
template <typename T, int OP, int WIDTH>
__device__ __forceinline__ void warp_scan(int& f, T& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < WIDTH; d <<= 1) {
    const int fo = __shfl_up_sync(kFull, f, d);
    const T vo = __shfl_up_sync(kFull, v, d);
    if (lane >= d) {  // (fo, vo) covers the lanes just before
      const int f2 = f;
      const T v2 = v;
      f = fo;
      v = vo;
      combine<T, OP>(f, v, f2, v2);
    }
  }
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// named barriers: 1 among the row warps; 2-3 "T_i's aggregate is in
// s_agg" and 4-5 "T_i's carry is in s_cv", by the parity of i
enum { BAR_ROWS = 1, BAR_AGG = 2, BAR_CARRY = 4 };

// Called by thread 0 after the block's last ticket: the last block of the
// grid to get here resets the ticket, and this count, for the next call.
__device__ __forceinline__ void finish(unsigned int* ticket) {
  __threadfence();  // the block's tickets are taken before it is counted
  if (atomicAdd(ticket + 1, 1u) == gridDim.x - 1) {
    ticket[0] = 0;
    ticket[1] = 0;
  }
}

// A persistent grid, warp-specialised. Each block walks its tiles T_0,
// T_1, ... from the ticket. Its 15 row warps hold the rows: in iteration i
// they fold T_i (its rows arrived during iteration i - 1) and publish its
// aggregate, send out the loads of T_{i+1}, then take T_{i-1}'s carry and
// write T_{i-1}'s rows. The look-back warp finds each tile's carry while
// the row warps work on the next: an aggregate is published as soon as its
// rows arrive, and neither the loads nor the writes wait on a look-back.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_lookback(const T* __restrict__ vals, const int* __restrict__ ids,
              long long n, long long tiles, int head, int vec, int inclusive,
              unsigned epoch, unsigned int* __restrict__ ticket,
              uint64_t* __restrict__ status,
              T* __restrict__ out) {
  using F = Fold<T, OP>;
  __shared__ long long s_tile[2];      // T_{i+1}, T_{i+2}, by parity
  __shared__ int s_f[2][kWarps];       // the warps' pairs, by parity of i
  __shared__ T s_v[2][kWarps];
  __shared__ long long s_agg_tile[2];  // T_i (-1: no more tiles)
  __shared__ int s_agg_f[2], s_agg_first[2];
  __shared__ T s_agg_v[2];
  __shared__ T s_cv[2];
  __shared__ uint32_t s_look[32 * kLookWindows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    s_tile[0] = atomicAdd(ticket, 1u);
    s_tile[1] = atomicAdd(ticket, 1u);
  }
  __syncthreads();
  long long b = s_tile[0];  // T_i
  if (b >= tiles) {
    if (threadIdx.x == 0) finish(ticket);
    return;
  }

  if (warp == kWarps) {  // the look-back warp
    for (int j = 0;; ++j) {
      bar_sync(BAR_AGG + (j & 1), kThreads);
      const long long bj = s_agg_tile[j & 1];
      if (bj < 0) break;
      const int fa = s_agg_f[j & 1];
      const T va = s_agg_v[j & 1];
      int fc = 0;
      T vc = F::ident();
      // a tile whose first row starts a segment needs no carry
      if (bj > 0 && !s_agg_first[j & 1]) look_back<T, OP>(status, epoch, bj, s_look, fc, vc);
      if (lane == 0) {
        if (!fa) {  // (else its aggregate went out as its inclusive prefix)
          int fp = fc;
          T vp = vc;
          combine<T, OP>(fp, vp, fa, va);
          st_status(status + bj, pack<T, OP>(ST_PREFIX, fp, vp, epoch));
        }
        s_cv[j & 1] = vc;
      }
      bar_arrive(BAR_CARRY + (j & 1), kThreads);
    }
    return;
  }

  // the row warps
  const long long wofs = (long long)warp * kWarpRows - head;  // + b * kRows
  int id[kItems], prev0;
  T xl[kItems];  // the rows of T_i, then those of T_{i+1} in flight
  load_rows<T, OP>(vals, ids, n, b * kRows + wofs, vec, id, xl, prev0);
  unsigned next_ticket = 0;
  long long bprev = -1;
  // T_{i-1}, waiting for its carry: its rows, segment starts (bit 4 j + e:
  // row e of chunk j) and the pair of the tile's rows before each chunk's
  T xc[kItems];
  unsigned heads_c = 0;
  int pf_c[kChunks];
  T pv_c[kChunks];
  for (int it = 0;; ++it) {
    const int par = it & 1;
    const bool have = b < tiles;  // the same in the whole block
    unsigned heads = 0;
    int pf[kChunks];
    T pv[kChunks];
    T xq[kItems];
    if (have) {
      // 1. segment starts, and this lane's pair of each chunk in row order
      const long long wr = b * kRows + wofs;
      int f[kChunks];
      T v[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        // the id of the row before: the previous lane's last, the last
        // lane's of the chunk before, or (chunk 0) a load
        int prev = __shfl_up_sync(kFull, id[4 * j + 3], 1);
        const int last = __shfl_sync(kFull, id[j > 0 ? 4 * j - 1 : 0], 31);
        if (lane == 0) prev = j > 0 ? last : prev0;
        f[j] = 0;
        v[j] = F::ident();
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const long long r = wr + 128 * j + 4 * lane + e;
          xq[i] = xl[i];
          if (r >= 0 && r < n) {
            if (r == 0 || id[i] != (e ? id[i - 1] : prev)) {
              heads |= 1u << i;
              f[j] = 1;
              v[j] = xl[i];
            } else {
              v[j] = F::apply(v[j], xl[i]);
            }
          }
        }
      }
      // 2. within the warp: each chunk's lanes by a shuffle tree, then the
      // chunks in order; across the warps: a shuffle tree over their pairs
      int fi[kChunks];
      T vi[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        fi[j] = f[j];
        vi[j] = v[j];
        warp_scan<T, OP, 32>(fi[j], vi[j]);
      }
      int fw = 0;  // the warp's chunks before chunk j, then all of them
      T vw = F::ident();
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        int fe = __shfl_up_sync(kFull, fi[j], 1);
        T ve = __shfl_up_sync(kFull, vi[j], 1);
        if (lane == 0) {
          fe = 0;
          ve = F::ident();
        }
        pf[j] = fw;
        pv[j] = vw;
        combine<T, OP>(pf[j], pv[j], fe, ve);  // the warp's rows before
        combine<T, OP>(fw, vw, __shfl_sync(kFull, fi[j], 31),
                       __shfl_sync(kFull, vi[j], 31));
      }
      if (lane == 0) {
        s_f[par][warp] = fw;
        s_v[par][warp] = vw;
      }
      if (threadIdx.x == 0 && it > 0) s_tile[par ^ 1] = next_ticket;
      bar_sync(BAR_ROWS, kRowThreads);
      int fs = lane < kWarps ? s_f[par][lane] : 0;
      T vs = lane < kWarps ? s_v[par][lane] : F::ident();
      warp_scan<T, OP, kWarps>(fs, vs);
      // the warps before this one
      int fx = __shfl_sync(kFull, fs, (warp + 31) & 31);
      T vx = __shfl_sync(kFull, vs, (warp + 31) & 31);
      if (warp == 0) {
        fx = 0;
        vx = F::ident();
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        int f2 = fx;
        T v2 = vx;
        combine<T, OP>(f2, v2, pf[j], pv[j]);
        pf[j] = f2;
        pv[j] = v2;
      }
      // 3. T_i's aggregate goes out at once; a segment start in it makes
      // it the inclusive prefix
      const int fa = __shfl_sync(kFull, fs, kWarps - 1);
      const T va = __shfl_sync(kFull, vs, kWarps - 1);
      if (threadIdx.x == 0) {
        st_status(status + b, fa ? pack<T, OP>(ST_PREFIX, 1, va, epoch)
                                 : pack<T, OP>(ST_AGG, 0, va, epoch));
        s_agg_tile[par] = b;
        s_agg_f[par] = fa;
        s_agg_v[par] = va;
        s_agg_first[par] = (int)(heads & 1u);
      }
    } else if (threadIdx.x == 0) {
      s_agg_tile[par] = -1;
    }
    bar_arrive(BAR_AGG + par, kThreads);
    // the loads of T_{i+1} go out now, and the ticket of T_{i+2}
    const long long bn = have ? s_tile[par ^ 1] : tiles;
    if (bn < tiles) {
      load_rows<T, OP>(vals, ids, n, bn * kRows + wofs, vec, id, xl, prev0);
      if (threadIdx.x == 0) next_ticket = atomicAdd(ticket, 1u);
    }

    // 4. T_{i-1}'s rows: the carry continues those before its first
    // segment start
    if (it > 0) {
      bar_sync(BAR_CARRY + (par ^ 1), kThreads);
      const T cv = s_cv[par ^ 1];
      const long long wr = bprev * kRows + wofs;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        T run = pf_c[j] ? pv_c[j] : F::apply(cv, pv_c[j]);
        T o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const bool h = (heads_c >> i) & 1u;
          const T excl = h ? F::init() : run;
          run = h ? xc[i] : F::apply(run, xc[i]);
          o[e] = inclusive ? run : excl;
        }
        const long long r = wr + 128 * j + 4 * lane;
        if (vec && r >= 0 && r + 4 <= n) {
          __stcs(reinterpret_cast<int4*>(out + r),
                 make_int4(F::to_bits(o[0]), F::to_bits(o[1]), F::to_bits(o[2]),
                           F::to_bits(o[3])));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (r + e >= 0 && r + e < n) out[r + e] = o[e];
        }
      }
    }
    if (!have) break;
    bprev = b;
    b = bn;
    heads_c = heads;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      pf_c[j] = pf[j];
      pv_c[j] = pv[j];
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) xc[i] = xq[i];
  }
  if (threadIdx.x == 0) finish(ticket);
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

template <typename T, int OP>
void launch(const void* vals, const int* ids, void* out, long long n,
            int inclusive, void* scratch, unsigned epoch, cudaStream_t s) {
  // rows before the first 16-byte boundary of the inputs: tile 0 starts
  // that many rows before row 0, so every tile's loads are aligned
  const uintptr_t pv = (uintptr_t)vals, pi = (uintptr_t)ids, po = (uintptr_t)out;
  const int vec = ((pv ^ pi) & 15) == 0 && ((pv ^ po) & 15) == 0 && (pv & 3) == 0;
  const int head = vec ? (int)((pv & 15) >> 2) : 0;
  const long long tiles = (n + head + kRows - 1) / kRows;
  const long long resident = (long long)kMinBlocks * sm_count();
  uint64_t* words = (uint64_t*)scratch;
  scan_lookback<T, OP><<<(unsigned)(tiles < resident ? tiles : resident), kThreads, 0, s>>>(
      (const T*)vals, ids, n, tiles, head, vec, inclusive, epoch,
      (unsigned int*)words, words + 1, (T*)out);
}

}  // namespace

// Rows per tile; the wrapper sizes the scratch from it.
extern "C" int repro_segment_scan_rows_per_block() { return kRows; }

// The epochs a scratch can take before its words must be zeroed again.
extern "C" int repro_segment_scan_epochs() { return (int)kEpochMask; }

// vals: n float32 (is_float) or int32; ids: n int32 forming contiguous runs;
// out: n values of the same type. op 0 = sum, 1 = min, 2 = max; inclusive
// 0 or 1. scratch: ceil((n + 3) / rows_per_block) + 1 64-bit words, zeroed
// when made and used by one stream (the ticket, left at 0 by every call,
// and one status word a tile); epoch: this call's, 1 to
// repro_segment_scan_epochs(), other than the last call's on the scratch.
// Returns cudaGetLastError().
extern "C" int repro_segment_scan(const void* vals, const int* ids, void* out,
                                  long long n, int op, int is_float,
                                  int inclusive, void* scratch, unsigned epoch,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (is_float) {
      if (op == OP_SUM)
        launch<float, OP_SUM>(vals, ids, out, n, inclusive, scratch, epoch, s);
      else if (op == OP_MIN)
        launch<float, OP_MIN>(vals, ids, out, n, inclusive, scratch, epoch, s);
      else
        launch<float, OP_MAX>(vals, ids, out, n, inclusive, scratch, epoch, s);
    } else {
      if (op == OP_SUM)
        launch<int, OP_SUM>(vals, ids, out, n, inclusive, scratch, epoch, s);
      else if (op == OP_MIN)
        launch<int, OP_MIN>(vals, ids, out, n, inclusive, scratch, epoch, s);
      else
        launch<int, OP_MAX>(vals, ids, out, n, inclusive, scratch, epoch, s);
    }
  }
  return (int)cudaGetLastError();
}

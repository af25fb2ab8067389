// Causal or bidirectional GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). q (B, S, H, hd), k and v (B, S, KV, hd),
// out (B, S, H, hd), all contiguous in that public layout (no transposing
// copies). Query head h reads KV head h / (H / KV), as the TPU kernel's
// index map does, so K/V are never replicated in memory.
// out = softmax(q k^T * scale [+ causal mask]) v with scale = 1/sqrt(hd)
// (passed in), applied in log2 units with exp2; masked scores are -1e30; an
// online softmax keeps the running max m, sum l and the accumulator in fp32;
// out = acc / max(l, 1e-30) in q's dtype. Any S >= 1 (the TPU kernel needs S
// to be a multiple of its block): rows past S are zero and their columns
// masked, so every S the TPU kernel takes gives the same function.
//
// Bound: operations. At the serving path's shape (B 4, S 1024, H 32, KV 8,
// hd 128, causal) the s(s+1)/2 unmasked (query, key) pairs need 34.4 GFLOP
// on the bf16 tensor cores against 84 MB of q, k, v and out.
//
// Design, bf16 (the serving path): Hopper's asynchronous units, warp
// specialised, persistent. One CTA an SM, of three warpgroups; CTA i walks
// the work tiles i, i + grid, ... A work tile is (128-row query tile, head,
// batch), ordered query tile first from the last one down, so the longest
// causal rows start first.
//   - Producer warpgroup (setmaxnreg down to 24 registers): one thread
//     issues TMA copies, each work tile's Q, then its 128-row K and V tiles
//     into a ring of two stages, each with its own `full` mbarrier (K and V
//     apart, so q k^T starts before V lands) and `empty` mbarrier (K and V
//     apart, so K is refilled as soon as its q k^T is done). The ring runs
//     on across work tiles, and Q has a full/empty pair of its own, so the
//     next tile's Q and first K/V load while the consumers finish this one.
//     The tensor maps are 4-D, (hd, heads, S, B), so a copy addresses KV
//     head h / (H / KV) by coordinate and TMA fills rows past S with zeros:
//     no other batch's rows are read, and any S works. A box is 128 rows x
//     64 columns (one 128-byte swizzle span), so hd 128 takes two boxes.
//   - Two consumer warpgroups (setmaxnreg up to 240), 64 query rows each.
//     S = q k^T is wgmma m64n128k16 with both operands in shared memory,
//     K-major, 128-byte swizzled, as TMA wrote them. The online softmax
//     runs in registers in the accumulator's layout: a thread holds rows r
//     and r + 8, each shared by a quad, so a row max takes two xor
//     shuffles. P is rounded to bf16 (as the reference's einsum attention
//     rounds its probabilities) into the register A operand of o += p v,
//     wgmma m64n{hd}k16 with V as the transposed (MN-major) B operand read
//     in its natural (kv rows, hd) layout: V is never copied. Inside a
//     warpgroup, kv tile n's q k^T is issued together with tile n - 1's
//     p v, and tile n's softmax runs while that p v finishes; across the
//     two warpgroups, one's softmax overlaps the other's products.
//   - Under causal only the diagonal tile is masked; tiles above it are
//     never loaded.
//   - Epilogue: each consumer writes its 64 output rows, divided by the
//     row sums, into a staging tile in the swizzled layout and one thread
//     hands it to a TMA store (rows past S are not written), which drains
//     while the next work tile runs.
// Shared memory: Q 32 KiB + 2 stages x (K + V) 128 KiB + output staging 32
// KiB at hd 128 (96 KiB in all at hd 64). No atomics: every sum's order is fixed by the layout
// (wgmma's fixed reduction order, the quad shuffles), and a work tile is
// computed by one CTA whatever the grid, so a run gives the same bits
// every time.
// Design, fp32 (tests only): FMA loops over synchronously staged 64-row
// tiles, 128 threads a 64-row query tile; see flash_fwd_f32.
// Later work: ping-pong scheduling of the two consumers, and skipping the
// half of the diagonal tile that the first consumer's rows never see.
#include <cuda.h>  // CUtensorMap and the tensor-map enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp specialised
// ---------------------------------------------------------------------------

constexpr int kTile = 128;                 // query rows a work tile, K/V rows a tile
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kWg = 128;                   // threads a warpgroup
constexpr int kFlashThreads = 3 * kWg;     // producer + two consumers
constexpr int kBoxCols = 64;               // bf16 columns in a 128-byte span
constexpr int kBoxBytes = kTile * 128;     // one 128 x 64 box, 16 KiB
constexpr int kConsumerThreads = 2 * kWg;

template <int HD>
struct Layout {  // byte offsets from a 1024-byte aligned shared base
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kO = kV + kStages * kTileBytes;  // output staging
  static constexpr int kBar = kO + kTileBytes;
  // mbarriers: Q full, Q empty; per stage K full, V full, K empty, V empty
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages);
  static constexpr int kSmem = kBytes + 1024;  // slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one TMA box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// one box of shared memory to a 4-D tensor map (rows past the map's end
// are not written)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until this thread's stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// shared-memory writes of this thread become visible to TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier for the `count` threads that name barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous products
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units. K-major operands (Q, K):
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO unused.
// MN-major operand (V): each 128-byte row holds 64 hd columns of one kv
// row; 8-row atoms 1024 bytes apart along kv (SBO), the next 64 hd columns
// one box (16 KiB) on (LBO).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 128, fp32) = [d +] a b^T, a and b bf16 in shared memory, both
// K-major with the 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += a b, a bf16 in registers (the accumulator's
// layout, in pairs), b bf16 in shared memory, MN-major with the 128-byte
// swizzle (the transposed B operand)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += a b, a bf16 in registers (the accumulator's
// layout, in pairs), b bf16 in shared memory, MN-major with the 128-byte
// swizzle (the transposed B operand)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two floats as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// 2^x (the MUFU unit; flushes denormal results to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one 64 x 128 score tile in the accumulator's layout:
// sc[4 j + e] is row r0 + 8 (e >> 1), column 8 j + c2 + (e & 1). Raw
// scores in, probabilities out; m (log2 units) and corr per row half.
// `edge` masks columns past S and, under causal, above the diagonal.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&corr)[2], float (&rs)[2],
                                             float sl2, bool edge, int row0, int col0,
                                             int S, int causal) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = col0 + 8 * (i >> 2) + (i & 1);
      if (col >= S || (causal && col > row)) sc[i] = kNegInf;
    }
  }
  float mx[2] = {sc[0], sc[2]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h] * sl2);  // log2 units
    corr[h] = ex2(m[h] - mn);
    m[h] = mn;
    rs[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], sl2, -m[h]));
    sc[i] = p;
    rs[h] += p;
  }
}

// the probabilities as bf16 pairs: those of two neighbouring 8-column
// score tiles are the register A fragment of one 16-deep step of p v
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_f32(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

// Work tile w of the persistent grid: query tiles from the last one down
// (the longest causal rows first), every (head, batch) of one query tile
// before the next
struct Work {
  int h, b, q0, nk;
};

__device__ __forceinline__ Work work_tile(int w, int S, int H, int B, int causal) {
  const int nq = (S + kTile - 1) / kTile;
  const int level = w / (H * B), hb = w % (H * B);
  Work t;
  t.h = hb % H;
  t.b = hb / H;
  t.q0 = (nq - 1 - level) * kTile;
  t.nk = causal ? t.q0 / kTile + 1 : nq;  // under causal: up to the diagonal
  return t;
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int B, int S, int H,
                   int KV, float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t sO = base + L::kO;
  // mbarriers: Q full, Q empty; per stage K full, V full, K empty, V empty
  const uint32_t bar_q = base + L::kBar, bar_q_empty = bar_q + 8;
  auto bar = [&](int kind, int s) { return bar_q + 8u * (2 + kind * kStages + s); };
  enum { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };
  const int works = ((S + kTile - 1) / kTile) * H * B;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(K_FULL, s), 1);
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), kConsumerThreads);
      mbar_init(bar(V_EMPTY, s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ---- producer: one thread issues every copy. The K/V ring's count
    // `it` runs on across work tiles, so the next tile's Q and first K/V
    // load while the consumers finish this one. A fresh barrier passes the
    // wait for parity 1, so the first round of each ring goes straight on.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0, j = 0;
      for (int w = blockIdx.x; w < works; w += gridDim.x, ++j) {
        const Work t = work_tile(w, S, H, B, causal);
        const int kvh = t.h / (H / KV);
        mbar_wait(bar_q_empty, (j & 1) ^ 1);
        mbar_expect_tx(bar_q, L::kTileBytes);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(sQ + x * kBoxBytes, &tq, x * kBoxCols, t.h, t.q0, t.b, bar_q);
        for (int n = 0; n < t.nk; ++n, ++it) {
          const int s = it % kStages;
          const uint32_t free_parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(bar(K_EMPTY, s), free_parity);
          mbar_expect_tx(bar(K_FULL, s), L::kTileBytes);
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(sK + s * L::kTileBytes + x * kBoxBytes, &tk, x * kBoxCols,
                        kvh, n * kTile, t.b, bar(K_FULL, s));
          mbar_wait(bar(V_EMPTY, s), free_parity);
          mbar_expect_tx(bar(V_FULL, s), L::kTileBytes);
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(sV + s * L::kTileBytes + x * kBoxBytes, &tv, x * kBoxCols,
                        kvh, n * kTile, t.b, bar(V_FULL, s));
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows q0 + 64 c .. + 63 ----
  setmaxnreg_inc<240>();
  const int c = threadIdx.x / kWg - 1;
  const int lt = threadIdx.x % kWg;
  const int warp = lt / 32, lane = lt % 32;
  const int r0 = 64 * c + 16 * warp + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c2 = 2 * (lane % 4);                  // columns c2, c2 + 1 of each 8
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  float acc[HD / 2];
  float sc[64];
  uint32_t pa[8][4];
  int it = 0;  // K/V ring position, as the producer counts it

  // S = q k^T of ring slot `slot` into sc: 64 x 128, hd / 16 steps of depth
  // 16 (32 bytes of a 128-byte row; the second box holds columns 64..127)
  auto issue_qk = [&](int slot) {
    const uint32_t kt = sK + (slot % kStages) * L::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128(sc, gmma_desc(sQ + off + c * 64 * 128, 16, 1024),
                    gmma_desc(kt + off, 16, 1024), kk > 0);
    }
  };
  // o += p v of ring slot `slot`: 8 steps of 16 kv rows (2 KiB of V each)
  auto issue_pv = [&](int slot) {
    const uint32_t vt = sV + (slot % kStages) * L::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_pv<HD>(acc, pa[kk], gmma_desc(vt + kk * 16 * 128, kBoxBytes, 1024));
  };
  auto fence_sc = [&] {
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
  };
  auto fence_acc = [&] {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
  };
  auto parity = [](int slot) { return (uint32_t)((slot / kStages) & 1); };

  int j = 0;
  for (int w = blockIdx.x; w < works; w += gridDim.x, ++j) {
    const Work t = work_tile(w, S, H, B, causal);
    const int nk = t.nk, row0 = t.q0 + r0, first = it;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2], corr[2], rs[2];

    // kv tile 0: q k^T, then its softmax
    mbar_wait(bar_q, j & 1);
    mbar_wait(bar(K_FULL, first % kStages), parity(first));
    fence_sc();
    wgmma_fence();
    issue_qk(first);
    wgmma_commit();
    wgmma_wait<0>();
    fence_sc();
    mbar_arrive(bar(K_EMPTY, first % kStages));
    if (nk == 1) mbar_arrive(bar_q_empty);  // Q's last use in this tile
    softmax_tile(sc, m, corr, rs, sl2, nk == 1, row0, c2, S, causal);
    l[0] = rs[0];
    l[1] = rs[1];
    pack_p(pa, sc);

    // kv tile n's q k^T runs beside tile n - 1's p v; tile n's softmax runs
    // while that p v finishes
    for (int n = 1; n < nk; ++n) {
      const int cur = first + n, prev = cur - 1;
      mbar_wait(bar(K_FULL, cur % kStages), parity(cur));
      fence_sc();
      fence_acc();
      wgmma_fence();
      issue_qk(cur);
      wgmma_commit();
      mbar_wait(bar(V_FULL, prev % kStages), parity(prev));
      issue_pv(prev);
      wgmma_commit();
      wgmma_wait<1>();  // q k^T of tile n has landed
      fence_sc();
      mbar_arrive(bar(K_EMPTY, cur % kStages));
      if (n == nk - 1) mbar_arrive(bar_q_empty);
      softmax_tile(sc, m, corr, rs, sl2, n == nk - 1, row0, n * kTile + c2, S,
                   causal);
      wgmma_wait<0>();  // p v of tile n - 1 has landed
      fence_acc();
      mbar_arrive(bar(V_EMPTY, prev % kStages));
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      // l is this thread's share of the row sum; the quad adds at the end
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
      pack_p(pa, sc);
    }
    // the last kv tile's p v
    const int last = first + nk - 1;
    mbar_wait(bar(V_FULL, last % kStages), parity(last));
    fence_acc();
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    mbar_arrive(bar(V_EMPTY, last % kStages));
    it += nk;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
    }
    const float d0 = 1.f / fmaxf(l[0], 1e-30f), d1 = 1.f / fmaxf(l[1], 1e-30f);
    // epilogue: this warpgroup's 64 rows into the staging tile in TMA's
    // 128-byte swizzled layout (16-byte chunk k of row r at chunk k ^ (r % 8):
    // a warp's 8 rows land on 32 distinct banks), then one TMA store a box.
    // The staging tile is free once the last tile's stores have read it.
    const int wg_bar = 1 + c;  // named barriers 1 and 2, one a warpgroup
    if (lt == 0) bulk_wait_read();
    named_sync(wg_bar, kWg);
    const int rr = r0 % 8;  // rows r0 and r0 + 8 share their swizzle phase
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      const uint32_t chunk = (uint32_t)(((jj % 8) ^ rr) * 16 + c2 * 2);
      const uint32_t row_a = sO + (jj / 8) * kBoxBytes + r0 * 128 + chunk;
      st_shared_u32(row_a, pack_f32(acc[4 * jj] * d0, acc[4 * jj + 1] * d0));
      st_shared_u32(row_a + 8 * 128,
                    pack_f32(acc[4 * jj + 2] * d1, acc[4 * jj + 3] * d1));
    }
    fence_async_shared();
    named_sync(wg_bar, kWg);
    if (lt == 0) {
      for (int x = 0; x < L::kBoxes; ++x)
        tma_store_4d(&to, sO + x * kBoxBytes + c * 64 * 128, x * kBoxCols, t.h,
                     t.q0 + 64 * c, t.b);
      bulk_commit();
    }
  }
  if (lt == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiled)p
                                                                  : nullptr;
  }();
  return fn;
}

// (hd, heads, S, B) bf16, boxes of 64 columns x 1 head x `rows` rows x 1
// batch, 128-byte swizzle; rows past S read as zeros and are not written
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd,
              int rows = kTile) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                        int S, int H, int KV, float scale, int causal,
                        cudaStream_t stream) {
  // the shared-memory opt-in above the 48 KB default is a property of the
  // function, so each instance sets it once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<HD>::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, B, S, H, HD) || !make_map(&tk, k, B, S, KV, HD) ||
      !make_map(&tv, v, B, S, KV, HD) || !make_map(&to, o, B, S, H, HD, 64))
    return cudaErrorInvalidValue;
  // persistent: one CTA an SM (the shared memory allows no more), each
  // walking work tiles blockIdx.x, + gridDim.x, ...
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const long long works = (long long)((S + kTile - 1) / kTile) * H * B;
  const int grid = (int)(works < sms ? works : sms);
  flash_fwd_bf16<HD><<<grid, kFlashThreads, Layout<HD>::kSmem, stream>>>(
      tq, tk, tv, to, B, S, H, KV, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA loops
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;  // query rows a CTA, K/V rows a tile
constexpr int kF32Threads = 128;

__device__ __forceinline__ int kv_tiles_f32(int S, int q0, int causal) {
  const int all = (S + kF32Rows - 1) / kF32Rows;
  if (!causal) return all;
  const int last = (q0 + kF32Rows - 1) / kF32Rows;  // the tile holding the diagonal
  return last + 1 < all ? last + 1 : all;
}

template <int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0, int S,
                                              int hd) {
  for (int i = threadIdx.x; i < kF32Rows * hd; i += kF32Threads) {
    const int r = i / hd, c = i % hd;
    dst[r * LD + c] = row0 + r < S ? src[(long long)(row0 + r) * row_stride + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int H,
                  int KV, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int LDP = kF32Rows + 1;
  extern __shared__ float smf[];
  float* Qs = smf;
  float* Ks = Qs + kF32Rows * LD;
  float* Vs = Ks + kF32Rows * LD;
  float* Ps = Vs + kF32Rows * LD;

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const float* qb = q + ((long long)b * S * H + h) * HD;
  const float* kb = k + ((long long)b * S * KV + kvh) * HD;
  const float* vb = v + ((long long)b * S * KV + kvh) * HD;
  float* ob = o + ((long long)b * S * H + h) * HD;

  load_tile_f32<LD>(Qs, qb, q_stride, q0, S, HD);

  const int r = threadIdx.x >> 1, par = threadIdx.x & 1;
  const float* qrow = Qs + r * LD;
  float* prow = Ps + r * LDP;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int nk = kv_tiles_f32(S, q0, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kF32Rows;
    __syncthreads();
    load_tile_f32<LD>(Ks, kb, kv_stride, k0, S, HD);
    load_tile_f32<LD>(Vs, vb, kv_stride, k0, S, HD);
    __syncthreads();

    // score columns 2j + par of row r
    float s[kF32Rows / 2];
#pragma unroll
    for (int j = 0; j < kF32Rows / 2; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kF32Rows / 2; ++j)
        s[j] = fmaf(qd, Ks[(2 * j + par) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Rows / 2; ++j) {
      const int col = k0 + 2 * j + par;
      float x = s[j] * scale;
      if (col >= S || (causal && col > q0 + r)) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kF32Rows / 2; ++j) {
      const float p = expf(s[j] - m);
      rs += p;
      prow[2 * j + par] = p;
    }
    l = l * corr + rs;  // this thread's share; the pair adds at the end
    __syncwarp();       // row r's probabilities come from this thread pair
    // output columns 2i + par of row r
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr;
    for (int j = 0; j < kF32Rows; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * LD + par;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = fmaf(p, vrow[2 * i], acc[i]);
    }
  }
  l += __shfl_xor_sync(kFull, l, 1);
  const float den = fmaxf(l, 1e-30f);
  if (q0 + r < S) {
    float* orow = ob + (long long)(q0 + r) * q_stride + par;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) orow[2 * i] = acc[i] / den;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                       int S, int H, int KV, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem =
      ((size_t)3 * kF32Rows * (HD + 1) + (size_t)kF32Rows * (kF32Rows + 1)) *
      sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, H, B);
  flash_fwd_f32<HD><<<grid, kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KV, scale,
      causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int S, int H, int KV, float scale, int causal, int is_bf16,
                     cudaStream_t stream) {
  if (is_bf16) return launch_bf16<HD>(q, k, v, o, B, S, H, KV, scale, causal, stream);
  return launch_f32<HD>(q, k, v, o, B, S, H, KV, scale, causal, stream);
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, KV, hd), out (B, S, H, hd): contiguous,
// 16-byte aligned, bf16 (is_bf16) or fp32; hd 64 or 128; H % KV == 0;
// B, S >= 1. scale is 1/sqrt(hd). Returns cudaGetLastError() (or
// cudaErrorInvalidValue for an hd without an instance, or when a tensor map
// cannot be made).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int S, int H, int KV, int hd,
                                     float scale, int causal, int is_bf16,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64)
    return (int)dispatch<64>(q, k, v, out, B, S, H, KV, scale, causal, is_bf16, s);
  if (hd == 128)
    return (int)dispatch<128>(q, k, v, out, B, S, H, KV, scale, causal, is_bf16, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a CTA of the bf16 kernel asks for at head dim hd
// (0 for an hd without an instance).
extern "C" int repro_flash_attention_smem(int hd) {
  return hd == 64 ? Layout<64>::kSmem : (hd == 128 ? Layout<128>::kSmem : 0);
}

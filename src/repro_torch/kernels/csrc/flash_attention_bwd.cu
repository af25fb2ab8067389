// Causal or bidirectional GQA flash attention, backward, for Hopper (sm_90a).
//
// The TPU kernel repro/kernels/flash_attention.py::flash_attention has no
// gradient; the reference trains through autodiff of its einsum attention
// (repro/models/layers.py::_sdpa). This is the gradient of the forward's
// function, out = softmax(q k^T * scale [+ causal mask]) v, from the
// forward's out and its row log-sum-exp lse (the training instance of
// csrc/flash_attention.cu), in three launches:
//   1. flash_bwd_dot: D = rowsum(dO o) in fp32, (B, H, S); one warp a row.
//   2. flash_bwd_dkdv: one CTA per (64-row key tile, KV head, batch). It
//      holds its K and V tiles in shared memory and loops over the G query
//      heads of its KV head and, for each, over the query tiles that reach
//      it (under causal, from its own tile on). Per query tile it recomputes
//      P^T = exp(scale K Q^T - lse) (exactly 0 where masked: past S or
//      above the diagonal), dP^T = V dO^T, dS^T = P^T (dP^T - D), and adds
//      P^T dO into dV and dS^T Q into dK, in fp32 registers. dK and dV of a
//      KV head sum over its G query heads inside one CTA: no atomics.
//   3. flash_bwd_dq: one CTA per (64-row query tile, head, batch), looping
//      over the key tiles that reach it: P, dP and dS again, dQ += dS K.
// dQ and dK are scaled by `scale` once, at the end. Every sum's order is
// fixed by the loops and the tile layout, and every output element is
// written by one CTA, so a run gives the same bits every time. Any S >= 1:
// rows past S read as zeros and are not written.
//
// Bound: operations. The five products of the gradient (q k^T recomputed,
// dO v^T, p^T dO, dS^T q, dS k) are 2.5 times the forward's two; at the
// training path's shape (B 2, S 1024, H 32, KV 8, hd 64, causal) that is
// 21.5 GFLOP on the bf16 tensor cores against 42 MB of q, k, v, o, dO
// read and dq, dk, dv written. This design recomputes q k^T and dO v^T in
// the dQ pass as well (seven products in all; eight past hd 128, below).
//
// Design, bf16 (the training path): four warps a CTA, each owning 16 rows
// of the 64-row tile, with mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// Tiles are staged synchronously into padded shared rows (hd + 8 bf16: the
// 8 rows a fragment load touches fall on distinct banks). Operands whose
// contraction runs along a shared row (K Q^T, V dO^T, Q K^T, dO V^T) are
// read as 32-bit pairs; those contracted across rows (dO and Q under
// P^T dO and dS^T Q, K under dS K) through ldmatrix.trans. P and dS go from
// the accumulators' layout straight into the A operand of the next product,
// rounded to bf16 (as the reference's einsum attention rounds its
// probabilities). Later work: wgmma with TMA-fed rings, as the forward.
// Head dims 16, 64, 128 and 160. At hd 16 each product over hd is one
// 16-deep step and the ldmatrix.trans operands one 16-column pair. At hd
// 160 one dK/dV CTA would hold 2 x 80 fp32 accumulators a thread beside the
// P and dS fragments (hd 128's 2 x 64 already take 253 registers), so past
// hd 128 flash_bwd_dkdv runs as two launches over the same grid: the first
// accumulates dV alone (P^T dO), the second dK alone (dS^T, which needs P
// again). That recomputes K Q^T once more (8 products in all, not 7) and
// reads Q and dO twice; it keeps one CTA the only writer of each output
// element, the fixed order of every sum, and exact zeros where masked.
// Design, fp32 (tests only): FMA loops over the same tiles, two threads a
// row, as the forward's fp32 path; past hd 128 it splits dK and dV the
// same way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows of a query or key tile
constexpr int kThreads = 128;  // four warps
// what one flash_bwd_dkdv launch accumulates, a bit each: both gradients
// up to hd 128, dV and then dK in two launches past it
constexpr int kDv = 1, kDk = 2, kDkDv = kDv | kDk;
template <int HD>
constexpr bool split_dkdv() {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 160, "head dims of 16-deep steps");
  return HD > 128;
}
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO o)
// ---------------------------------------------------------------------------

// rows = B * S * H in o's (B, S, H) order; 8 warps a block, one a row
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ delta, int S, int H, int hd, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps
  const int lane = threadIdx.x % 32;
  const T* a = o + row * hd;
  const T* b = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(a[d]), to_f(b[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const long long h = row % H, bs = row / H;
    delta[((bs / S) * H + h) * S + bs % S] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices, transposed: the B operands of two n8 products
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows of a (.., S, heads, HD) tensor from row `row0` on (rows past S as
// zeros) into shared rows of LD bf16, 16 bytes a thread a step
template <int HD, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride,
                                          int row0, int S) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// s (16 x 64) = A B^T over HD: A the warp's 16 rows of `a` (shared, [row][HD]),
// B the 64 rows of `b` (shared, [row][HD]); both contracted along a row
template <int HD, int LD>
__device__ __forceinline__ void rows_by_rows(float (&s)[8][4], const bf16* a, int arow,
                                             const bf16* b, int g, int c2) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int k0 = kk * 16 + c2;
    uint32_t fa[4];
    fa[0] = ld_u32(a + (arow + g) * LD + k0);
    fa[1] = ld_u32(a + (arow + g + 8) * LD + k0);
    fa[2] = ld_u32(a + (arow + g) * LD + k0 + 8);
    fa[3] = ld_u32(a + (arow + g + 8) * LD + k0 + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* brow = b + (nt * 8 + g) * LD + k0;
      mma16816(s[nt], fa, ld_u32(brow), ld_u32(brow + 8));
    }
  }
}

// the 16 x 64 accumulator tile as bf16 A operands of four 16-deep steps
__device__ __forceinline__ void to_a(uint32_t (&fa)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fa[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    fa[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    fa[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    fa[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc (16 x HD) += A (16 x 64, registers) B, B the 64 rows of `b` (shared,
// [row][HD]) contracted across rows, read transposed by ldmatrix
template <int HD, int LD>
__device__ __forceinline__ void acc_across_rows(float (&acc)[HD / 8][4],
                                                const uint32_t (&fa)[4][4],
                                                const bf16* b, int lane) {
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, smem_u32(b + (kk * 16 + lrow) * LD + np * 16 + lcol));
      mma16816(acc[2 * np], fa[kk], fb[0], fb[1]);
      mma16816(acc[2 * np + 1], fa[kk], fb[2], fb[3]);
    }
}

// the warp's 16 x HD accumulator, times `mul`, to rows `row` and `row + 8`
// of a (.., S, heads, HD) tensor (rows past S are not written)
template <int HD>
__device__ __forceinline__ void store_acc(bf16* dst, long long stride, int row, int S,
                                          const float (&acc)[HD / 8][4], float mul,
                                          int c2) {
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + c2;
    if (row < S)
      *reinterpret_cast<uint32_t*>(dst + (long long)row * stride + col) =
          pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    if (row + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (long long)(row + 8) * stride + col) =
          pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

template <int HD>
struct BwdSmem {
  static constexpr int LD = HD + 8;  // bf16 a shared row (bank-conflict padding)
  static constexpr int kTile = kRows * LD;
  // four bf16 tiles and two 64-float vectors
  static constexpr int kBytes = 4 * kTile * 2 + 2 * kRows * 4;
};

template <int HD, int PARTS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                        int KV, float scale, int causal) {
  using L = BwdSmem<HD>;
  constexpr int LD = L::LD;
  constexpr bool kWantV = PARTS & kDv, kWantK = PARTS & kDk;
  extern __shared__ __align__(16) unsigned char smem_dkdv[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_dkdv);
  bf16* Vs = Ks + L::kTile;
  bf16* Qs = Vs + L::kTile;
  bf16* dOs = Qs + L::kTile;
  float* Ls = reinterpret_cast<float*>(dOs + L::kTile);  // lse in log2 units
  float* Ds = Ls + kRows;

  const int jt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = jt * kRows, G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int wrow = 16 * warp;  // the warp's first row in the key tile
  const int kv_a = k0 + wrow + g, kv_b = kv_a + 8;
  const float sl2 = scale * kLog2e;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long kv_off = ((long long)b * S * KV + kvh) * HD;

  load_rows<HD, LD>(Ks, k + kv_off, kv_stride, k0, S);
  if constexpr (kWantK) load_rows<HD, LD>(Vs, v + kv_off, kv_stride, k0, S);

  float acc_k[HD / 8][4], acc_v[HD / 8][4];  // the one not wanted is dead
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.f;

  const int nq = (S + kRows - 1) / kRows;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const long long q_off = ((long long)b * S * H + h) * HD;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = causal ? jt : 0; qt < nq; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // every warp is done with the last query tile
      load_rows<HD, LD>(Qs, q + q_off, q_stride, q0, S);
      load_rows<HD, LD>(dOs, dout + q_off, q_stride, q0, S);
      if (threadIdx.x < kRows) {
        const int qi = q0 + threadIdx.x;
        Ls[threadIdx.x] = qi < S ? lrow[qi] * kLog2e : 0.f;
        Ds[threadIdx.x] = qi < S ? drow[qi] : 0.f;
      }
      __syncthreads();

      float p[8][4], ds[8][4];
      uint32_t fa[4][4];
      rows_by_rows<HD, LD>(p, Ks, wrow, Qs, g, c2);  // S^T = K Q^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + c2 + (e & 1);  // query column in the tile
          const int kvr = e < 2 ? kv_a : kv_b;
          const bool live = q0 + qc < S && (!causal || kvr <= q0 + qc);
          p[nt][e] = live ? exp2f(fmaf(p[nt][e], sl2, -Ls[qc])) : 0.f;
        }
      if constexpr (kWantV) {
        to_a(fa, p);
        acc_across_rows<HD, LD>(acc_v, fa, dOs, lane);  // dV += P^T dO
      }
      if constexpr (kWantK) {
        rows_by_rows<HD, LD>(ds, Vs, wrow, dOs, g, c2);  // dP^T = V dO^T
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[nt][e] = p[nt][e] * (ds[nt][e] - Ds[nt * 8 + c2 + (e & 1)]);
        to_a(fa, ds);
        acc_across_rows<HD, LD>(acc_k, fa, Qs, lane);  // dK += dS^T Q
      }
    }
  }
  if constexpr (kWantK) store_acc<HD>(dk + kv_off, kv_stride, kv_a, S, acc_k, scale, c2);
  if constexpr (kWantV) store_acc<HD>(dv + kv_off, kv_stride, kv_a, S, acc_v, 1.f, c2);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, int S, int H, int KV, float scale,
                      int causal) {
  using L = BwdSmem<HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem_dq[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_dq);
  bf16* dOs = Qs + L::kTile;
  bf16* Ks = dOs + L::kTile;
  bf16* Vs = Ks + L::kTile;

  const int nq = (S + kRows - 1) / kRows;
  const int it = nq - 1 - (int)blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = it * kRows, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int wrow = 16 * warp;
  const int qa = q0 + wrow + g;  // this thread's rows qa and qa + 8
  const float sl2 = scale * kLog2e;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long q_off = ((long long)b * S * H + h) * HD;
  const long long kv_off = ((long long)b * S * KV + kvh) * HD;
  const float* lrow = lse + ((long long)b * H + h) * S;
  const float* drow = delta + ((long long)b * H + h) * S;
  const float lse2[2] = {qa < S ? lrow[qa] * kLog2e : 0.f,
                         qa + 8 < S ? lrow[qa + 8] * kLog2e : 0.f};
  const float dd[2] = {qa < S ? drow[qa] : 0.f, qa + 8 < S ? drow[qa + 8] : 0.f};

  load_rows<HD, LD>(Qs, q + q_off, q_stride, q0, S);
  load_rows<HD, LD>(dOs, dout + q_off, q_stride, q0, S);

  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int nk = causal ? it + 1 : nq;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kRows;
    __syncthreads();  // every warp is done with the last key tile
    load_rows<HD, LD>(Ks, k + kv_off, kv_stride, k0, S);
    load_rows<HD, LD>(Vs, v + kv_off, kv_stride, k0, S);
    __syncthreads();

    float p[8][4], ds[8][4];
    rows_by_rows<HD, LD>(p, Qs, wrow, Ks, g, c2);    // S = Q K^T
    rows_by_rows<HD, LD>(ds, dOs, wrow, Vs, g, c2);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + nt * 8 + c2 + (e & 1);  // key column
        const int hi = e >> 1;
        const bool live = kc < S && (!causal || kc <= qa + 8 * hi);
        const float pe = live ? exp2f(fmaf(p[nt][e], sl2, -lse2[hi])) : 0.f;
        ds[nt][e] = pe * (ds[nt][e] - dd[hi]);
      }
    uint32_t da[4][4];
    to_a(da, ds);
    acc_across_rows<HD, LD>(acc, da, Ks, lane);  // dQ += dS K
  }
  store_acc<HD>(dq + q_off, q_stride, qa, S, acc, scale, c2);
}

// ---------------------------------------------------------------------------
// fp32: FMA loops (tests only)
// ---------------------------------------------------------------------------

template <int LD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long stride, int row0, int S, int hd) {
  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int r = i / hd, c = i % hd;
    dst[r * LD + c] = row0 + r < S ? src[(long long)(row0 + r) * stride + c] : 0.f;
  }
}

template <int HD>
constexpr size_t f32_smem() {
  return ((size_t)4 * kRows * (HD + 1) + (size_t)2 * kRows * (kRows + 1) + 2 * kRows) *
         sizeof(float);
}

// thread pair r (threads 2r, 2r + 1) owns key row r of the tile; `par`
// picks its columns 2i + par
template <int HD, int PARTS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KV,
                       float scale, int causal) {
  constexpr int LD = HD + 1, LDP = kRows + 1;
  constexpr bool kWantV = PARTS & kDv, kWantK = PARTS & kDk;
  extern __shared__ float smem_dkdv_f32[];
  float* Ks = smem_dkdv_f32;
  float* Vs = Ks + kRows * LD;
  float* Qs = Vs + kRows * LD;
  float* dOs = Qs + kRows * LD;
  float* Pt = dOs + kRows * LD;
  float* dSt = Pt + kRows * LDP;
  float* Ls = dSt + kRows * LDP;
  float* Ds = Ls + kRows;

  const int jt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = jt * kRows, G = H / KV;
  const int r = threadIdx.x >> 1, par = threadIdx.x & 1;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long kv_off = ((long long)b * S * KV + kvh) * HD;
  load_rows_f32<LD>(Ks, k + kv_off, kv_stride, k0, S, HD);
  if constexpr (kWantK) load_rows_f32<LD>(Vs, v + kv_off, kv_stride, k0, S, HD);

  float ak[HD / 2], av[HD / 2];  // the one not wanted is dead
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) ak[i] = av[i] = 0.f;
  const int nq = (S + kRows - 1) / kRows;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const long long q_off = ((long long)b * S * H + h) * HD;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = causal ? jt : 0; qt < nq; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();
      load_rows_f32<LD>(Qs, q + q_off, q_stride, q0, S, HD);
      load_rows_f32<LD>(dOs, dout + q_off, q_stride, q0, S, HD);
      if (threadIdx.x < kRows) {
        const int qi = q0 + threadIdx.x;
        Ls[threadIdx.x] = qi < S ? lrow[qi] : 0.f;
        Ds[threadIdx.x] = qi < S ? drow[qi] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kRows / 2; ++j) {
        const int c = 2 * j + par;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(Ks[r * LD + d], Qs[c * LD + d], s);
          if constexpr (kWantK) dp = fmaf(Vs[r * LD + d], dOs[c * LD + d], dp);
        }
        const bool live = q0 + c < S && (!causal || k0 + r <= q0 + c);
        const float p = live ? expf(s * scale - Ls[c]) : 0.f;
        Pt[r * LDP + c] = p;
        dSt[r * LDP + c] = p * (dp - Ds[c]);
      }
      __syncwarp();  // row r's columns come from this thread pair
      for (int c = 0; c < kRows; ++c) {
        const float p = Pt[r * LDP + c], ds = dSt[r * LDP + c];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) {
          if constexpr (kWantV) av[i] = fmaf(p, dOs[c * LD + 2 * i + par], av[i]);
          if constexpr (kWantK) ak[i] = fmaf(ds, Qs[c * LD + 2 * i + par], ak[i]);
        }
      }
    }
  }
  if (k0 + r < S) {
    float* dkr = dk + kv_off + (long long)(k0 + r) * kv_stride + par;
    float* dvr = dv + kv_off + (long long)(k0 + r) * kv_stride + par;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      if constexpr (kWantK) dkr[2 * i] = ak[i] * scale;
      if constexpr (kWantV) dvr[2 * i] = av[i];
    }
  }
}

// thread pair r owns query row r of the tile
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int S, int H, int KV, float scale, int causal) {
  constexpr int LD = HD + 1, LDP = kRows + 1;
  extern __shared__ float smem_dq_f32[];
  float* Qs = smem_dq_f32;
  float* dOs = Qs + kRows * LD;
  float* Ks = dOs + kRows * LD;
  float* Vs = Ks + kRows * LD;
  float* dSs = Vs + kRows * LD;

  const int nq = (S + kRows - 1) / kRows;
  const int it = nq - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = it * kRows, kvh = h / (H / KV);
  const int r = threadIdx.x >> 1, par = threadIdx.x & 1;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long q_off = ((long long)b * S * H + h) * HD;
  const long long kv_off = ((long long)b * S * KV + kvh) * HD;
  const long long lrow = ((long long)b * H + h) * S + q0 + r;
  const float lse_r = q0 + r < S ? lse[lrow] : 0.f;
  const float d_r = q0 + r < S ? delta[lrow] : 0.f;
  load_rows_f32<LD>(Qs, q + q_off, q_stride, q0, S, HD);
  load_rows_f32<LD>(dOs, dout + q_off, q_stride, q0, S, HD);

  float aq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) aq[i] = 0.f;
  const int nk = causal ? it + 1 : nq;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kRows;
    __syncthreads();
    load_rows_f32<LD>(Ks, k + kv_off, kv_stride, k0, S, HD);
    load_rows_f32<LD>(Vs, v + kv_off, kv_stride, k0, S, HD);
    __syncthreads();
    for (int j = 0; j < kRows / 2; ++j) {
      const int c = 2 * j + par;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        s = fmaf(Qs[r * LD + d], Ks[c * LD + d], s);
        dp = fmaf(dOs[r * LD + d], Vs[c * LD + d], dp);
      }
      const bool live = k0 + c < S && (!causal || k0 + c <= q0 + r);
      const float p = live ? expf(s * scale - lse_r) : 0.f;
      dSs[r * LDP + c] = p * (dp - d_r);
    }
    __syncwarp();
    for (int c = 0; c < kRows; ++c) {
      const float ds = dSs[r * LDP + c];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) aq[i] = fmaf(ds, Ks[c * LD + 2 * i + par], aq[i]);
    }
  }
  if (q0 + r < S) {
    float* dqr = dq + q_off + (long long)(q0 + r) * q_stride + par;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqr[2 * i] = aq[i] * scale;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// one launch of the dK/dV kernel for the gradients PARTS; the shared-memory
// opt-in above the 48 KB default is set once an instance
template <typename T, int HD, int PARTS>
cudaError_t launch_dkdv(const T* q, const T* k, const T* v, const T* dout,
                        const float* lse, const float* delta, T* dk, T* dv, int B, int S,
                        int H, int KV, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, KV, B);
  if constexpr (sizeof(T) == 2) {
    constexpr int smem = BwdSmem<HD>::kBytes;
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkdv_bf16<HD, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dkdv_bf16<HD, PARTS><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, H, KV, scale, causal);
  } else {
    constexpr int smem = (int)f32_smem<HD>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkdv_f32<HD, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    flash_bwd_dkdv_f32<HD, PARTS><<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, H, KV, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* o, const T* dout,
                       const float* lse, float* delta, T* dq, T* dk, T* dv, int B, int S,
                       int H, int KV, float scale, int causal, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  // the shared-memory opt-in above the 48 KB default, once an instance
  constexpr int smem_dq =
      kBf16 ? BwdSmem<HD>::kBytes
            : (int)(((size_t)4 * kRows * (HD + 1) + (size_t)kRows * (kRows + 1)) *
                    sizeof(float));
  static const cudaError_t attr = [] {
    if constexpr (kBf16)
      return cudaFuncSetAttribute(flash_bwd_dq_bf16<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    else
      return cudaFuncSetAttribute(flash_bwd_dq_f32<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  }();
  if (attr != cudaSuccess) return attr;

  const long long rows = (long long)B * S * H;
  flash_bwd_dot<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, delta, S, H,
                                                                     HD, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (split_dkdv<HD>()) {
    e = launch_dkdv<T, HD, kDv>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale,
                                causal, stream);
    if (e != cudaSuccess) return e;
    e = launch_dkdv<T, HD, kDk>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale,
                                causal, stream);
  } else {
    e = launch_dkdv<T, HD, kDkDv>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale,
                                  causal, stream);
  }
  if (e != cudaSuccess) return e;
  const dim3 grid_q((S + kRows - 1) / kRows, H, B);
  if constexpr (kBf16)
    flash_bwd_dq_bf16<HD><<<grid_q, kThreads, smem_dq, stream>>>(
        q, k, v, dout, lse, delta, dq, S, H, KV, scale, causal);
  else
    flash_bwd_dq_f32<HD><<<grid_q, kThreads, smem_dq, stream>>>(
        q, k, v, dout, lse, delta, dq, S, H, KV, scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq,
                         void* dk, void* dv, int B, int S, int H, int KV, float scale,
                         int causal, int is_bf16, cudaStream_t s) {
  if (is_bf16)
    return launch_bwd<bf16, HD>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                (const bf16*)o, (const bf16*)dout, lse, delta, (bf16*)dq,
                                (bf16*)dk, (bf16*)dv, B, S, H, KV, scale, causal, s);
  return launch_bwd<float, HD>((const float*)q, (const float*)k, (const float*)v,
                               (const float*)o, (const float*)dout, lse, delta, (float*)dq,
                               (float*)dk, (float*)dv, B, S, H, KV, scale, causal, s);
}

}  // namespace

// The gradient of the forward's out = softmax(q k^T * scale) v: q, dq (B, S,
// H, hd); k, v, dk, dv (B, S, KV, hd); o, dout (B, S, H, hd); lse (B, H, S)
// fp32 from the training forward; delta (B, H, S) fp32 scratch. Contiguous,
// 16-byte aligned, all bf16 (is_bf16) or all fp32; hd 16, 64, 128 or 160;
// H % KV == 0; B, S >= 1. Three launches on `stream` (four at hd 160);
// returns cudaGetLastError() after the first that fails
// (cudaErrorInvalidValue for an hd without an instance).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* delta, void* dq, void* dk, void* dv, int B,
                                         int S, int H, int KV, int hd, float scale,
                                         int causal, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return (int)dispatch_bwd<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                                   KV, scale, causal, is_bf16, s);
    case 64:
      return (int)dispatch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                                   KV, scale, causal, is_bf16, s);
    case 128:
      return (int)dispatch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                                    KV, scale, causal, is_bf16, s);
    case 160:
      return (int)dispatch_bwd<160>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                                    KV, scale, causal, is_bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a CTA of the bf16 dK/dV or dQ kernel asks for at
// head dim hd (0 for an hd without an instance).
extern "C" int repro_flash_attention_bwd_smem(int hd) {
  switch (hd) {
    case 16: return BwdSmem<16>::kBytes;
    case 64: return BwdSmem<64>::kBytes;
    case 128: return BwdSmem<128>::kBytes;
    case 160: return BwdSmem<160>::kBytes;
    default: return 0;
  }
}

// Causal or bidirectional GQA flash attention, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: repro/kernels/flash_attention.py::flash_attention
// has no gradient, and the reference trains through autodiff of its einsum
// attention (repro/models/layers.py::_sdpa). This is the gradient of the
// forward's function, out = softmax(q k^T * scale [+ causal mask]) v, from
// the forward's out and its row log-sum-exp lse (the training instance of
// csrc/flash_attention.cu). q, dq (B, S, H, dqk); o, dout (B, S, H, dv); k,
// dk (B, S, KV, dqk); v, dv (B, S, KV, dv), contiguous; query head h reads
// KV head h / (H / KV). The q k width dqk and the p v width dv are equal
// but for MLA's (96, 64) and (24, 16).
//
// Bound: operations. The five products of the gradient (q k^T recomputed,
// dO v^T, p^T dO, dS^T q, dS k) are 2.5 times the forward's two: at the
// training path's shape (B 2, S 1024, H 32, KV 8, hd 64, causal) 21.5
// GFLOP on the bf16 tensor cores (0.0217 ms at 989 TFLOP/s) against 42 MB
// of q, k, v, o, dO read and dq, dk, dv written (0.0104 ms at 3.35 TB/s).
// At unequal widths the five are 2 (3 dqk + 2 dv) FLOPs a pair: at MLA's
// training microbatch (B 1, 40/40 heads, 96/64) 17.5 GFLOP (0.0177 ms)
// against 52.6 MB (0.0157 ms). The dQ pass recomputes q k^T and dO v^T:
// seven products in all.
//
// Design, bf16 (the training path): the forward's machinery (sm90.cuh:
// TMA, mbarrier rings, wgmma, setmaxnreg), five launches (six where dK/dV
// is split).
//   1. flash_bwd_prep: D = rowsum(dO o) and lse log2 e, fp32, (B, H, Sp),
//      Sp = S rounded up to 64, plus 64: D 0 and lse +inf past S, so a query
//      row past S gets P exactly 0 with no mask. Two lanes a row of o and
//      dO, so a warp's loads cover whole sectors.
//   2. flash_bwd_dkdv_bf16, persistent, warp specialised, three warpgroups.
//      A work item is (64-row key tile, KV head, batch, group of query
//      heads). The producer warpgroup (setmaxnreg down to 40) has one thread
//      load the item's K and V once by TMA, then stream its query tiles,
//      N rows of Q and dO with their N lse and D values (a bulk copy),
//      through a ring of three stages with full/empty mbarriers that runs
//      on across items. N is 128 where both widths are <= 64 and 64 above
//      (registers and shared memory). The two consumer warpgroups (setmaxnreg up to 232)
//      split each query tile's four products by role, over all 64 keys:
//        consumer 0: S^T = K Q^T (wgmma m64nN, both operands K-major in
//          shared memory), P^T = exp2(S^T scale log2 e - lse) in registers
//          (scores above the diagonal set to -inf first, so P^T is exactly
//          0 there), P^T handed to consumer 1, then dV += P^T dO (P^T from
//          registers as bf16, dO the MN-major B operand: the forward's p v);
//        consumer 1: dP^T = V dO^T (m64nN, K-major), dS^T = P^T (dP^T - D)
//          in registers, then dK += dS^T Q (register A, Q MN-major: the tile
//          that S^T reads K-major).
//      P^T crosses in fp32, as each thread holds it (thread t of one
//      warpgroup holds the elements thread t of the other needs): 64 x N a
//      step, two buffers between named barriers, 16-byte stores and loads
//      with no bank conflicts, so dS uses the fp32 P as the reference does.
//      Inside a consumer, step n's first product is issued beside step n -
//      1's accumulation, and step n's exponentials or dS run while that
//      accumulation finishes. A consumer holds one gradient, 64 x its width
//      (dV: dv, dK: dqk) padded to whole 64-column boxes (96 fp32 a thread
//      at hd 160; the array is sized by the wider, dK's at 96/64), beside
//      N / 2 for S^T or dP^T and N / 4 for the bf16 operand, so one launch
//      takes every width pair with no spills (ptxas: 168 registers at the
//      launch bound). Shared memory: 180 KiB at hd <= 64, 163 at 128, 227
//      at 160 (K 24 + V 24, 3 x (Q 24 + dO 24), P^T 2 x 16), 131 at 96/64.
//   3. Balance. Under causal, key tile jt meets (S - 64 jt) / N query
//      tiles a query head, so items differ up to S / 64 times. Items are
//      ordered longest first and dealt to the persistent CTAs in a snake
//      (CTA i takes item i, then item 2 grid - 1 - i, ...), which evens the
//      sums: at the path's shape 256 items on 132 SMs, the longest CTA 36
//      steps against an average of 34.9. Where the items are fewer than the
//      SMs (B 1, S 1024, KV 8: 128 items, the longest 64 steps against an
//      average of 33 at hd 160), each KV head's G query heads split into ns
//      groups (ns a power of two dividing G, the least that gives as many
//      items as SMs; under no mask, only where twice as many still fit in
//      one round); each item then writes fp32 partials of dK and dV, and
//      flash_bwd_sum adds the ns partials in a fixed order (2 ns B S KV hd x
//      4 bytes of workspace: 21 MB at hd 160, B 1, ns 2, 256 items, the
//      longest CTA 34 steps against 33). At ns 1 the consumers write dK
//      scale and dV in bf16 from registers. Rows past S are not written.
//   4. flash_bwd_dq_bf16, the same machinery: an item is (128-row query
//      tile, head, batch), 64 rows a consumer, the longest causal rows
//      first, snake-dealt; the producer loads its Q and dO once and streams
//      N-row K and V tiles through a ring (three
//      stages, two at hd 160). A step: S = Q K^T and dP = dO V^T (m64nN,
//      K-major), dS = P (dP - D) in registers (keys past S and above the
//      diagonal masked, only on the tiles that hold them), dQ += dS K
//      (register A, K MN-major). dQ is written times scale, in bf16.
//   5. A consistent D. D comes from the bf16 o, which the forward took
//      from bf16 P, so sum_j dS_ij, zero in exact arithmetic, is not: D is
//      ~2^-8 off, relative, and the sums over a row (dQ_i = sum_j dS_ij
//      k_j) or a column (dK_j = sum_i dS_ij q_i) carry that error times
//      the keys' or the queries' common component, which the true
//      gradients do not see (softmax ignores a shift of every key, and the
//      dK of a row sum to zero). At whisper-base's random initialisation,
//      where the attention is nearly flat over 1024 keys, that was 10-20
//      times the plain backward's dQ error, and the last decoder block's
//      wk gradient 0.22 of its largest from the fp32 run's where the plain
//      attention's is 0.03. So the dQ launch runs before the dK/dV launch
//      and, at its end, adds each row's fp32 sum of dS to D (the D that
//      makes sum_j P_ij (dP_ij - D_i) zero, in this P and dP), which the
//      dK/dV launch then reads. dQ itself was taken with the old D: since
//      sum_j dS_ij k_j = sum_j dS_ij (k_j - c_i) for any c_i while the row
//      sums to zero, it also sums each row's bf16 dS (r_i, what the
//      product took) and writes dQ = scale (dS K - r_i c_i), c_i the mean
//      of the keys row i sees: the prefix mean under causal, all S keys
//      else. Two small launches make the centres first, fp32 (B, S, KV,
//      dqk): flash_bwd_key_sums, each 16-row key chunk's column sums, then
//      flash_bwd_key_centres, the prefix means (under no mask only the
//      last row's), a block a (chunk, KV head, batch) and a thread a column
//      in both. Under causal they read K twice and write 4 bytes a key
//      element; else they read K once.
// The consumers release a ring stage with one mbarrier arrival a warp. No
// atomics: every output element is written by one CTA, and every sum's
// order is fixed by the item, the loops and wgmma, so a run gives the same
// bits every time. Any S >= 1: TMA reads rows past S as zeros. Width pairs
// (dqk, dv) (16, 16), (64, 64), (128, 128), (160, 160) and MLA's (96, 64)
// and (24, 16); a tile sits in shared memory as whole 64-column boxes at
// its own width (Q, K at dqk; V, dO at dv: 16 and 24 -> 64, 96 -> 128,
// 160 -> 192; TMA fills the padding with zeros): the products over a width
// stop at its last 16-column step (S^T and S over dqk, ceil(dqk / 16)
// steps, at 24 the second reading zeros past 24; dP^T and dP over dv), the
// accumulations run over the padded width of what they write (dV over dv,
// dK and dQ over dqk: n128 at 96, a third of those products over zeros,
// since the transposed B operand's 128-byte swizzle takes whole 64-column
// boxes). D = rowsum(dO o) runs over dv.
// Design, fp32 (tests only): FMA loops over synchronously staged 64-row
// tiles, two threads a row; past hd 128 dK and dV take a launch each.
#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp specialised
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 3 * kWg;  // producer + two consumers
constexpr int kConsumerThreads = 2 * kWg;
constexpr int kConsumerWarps = kConsumerThreads / 32;
// named barriers of the P^T handoff: full, then empty, one a buffer (0 is
// __syncthreads')
constexpr int kPFullBar = 1, kPEmptyBar = 3;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 384 x 168 in all
constexpr int kBox64 = 64 * 128;    // one 64-row x 64-column box, 8 KiB
constexpr int kBox128 = 128 * 128;  // one 128-row box, 16 KiB
constexpr int kKeyRows = 64;        // keys of a dK/dV item
constexpr int kDqRows = 128;        // queries of a dQ item, 64 a consumer

// S padded for the lse and D rows: past the last 64-row tile one more, so
// a 128-row ring tile that starts at a multiple of 64 stays inside
__host__ __device__ __forceinline__ int padded_rows(int S) {
  return (S + 63) / 64 * 64 + 64;
}

// the widths as whole 64-column boxes: q k's DQK (Q, K; dQ and dK) and p
// v's DV (V, O, dO; dV), and the width N of the tiles the consumers'
// first products run over (queries of a dK/dV ring tile, keys of a dQ
// ring tile): 128 where the registers and shared memory allow, so a
// step's fixed costs (barriers, the P^T handoff) come half as often
template <int DQK, int DV>
struct Tiles {
  static_assert(DQK % 8 == 0 && DQK >= 16 && DQK <= 3 * kBoxCols,
                "q k widths of 16-byte rows, padded to at most three boxes");
  static_assert(DV % 16 == 0 && DV >= 16 && DV <= 3 * kBoxCols,
                "p v widths of 16-column steps, padded to at most three boxes");
  static constexpr int kQkBoxes = (DQK + kBoxCols - 1) / kBoxCols;
  static constexpr int kVBoxes = (DV + kBoxCols - 1) / kBoxCols;
  static constexpr int kQkCols = kQkBoxes * kBoxCols;  // dK's and dQ's width
  static constexpr int kVCols = kVBoxes * kBoxCols;    // dV's width
  static constexpr int kQkSteps = (DQK + 15) / 16;     // 16-deep steps over DQK
  static constexpr int kVSteps = DV / 16;              // and over DV
  static constexpr int kN = DQK <= 64 && DV <= 64 ? 128 : 64;
};

// dK/dV: byte offsets from a 1024-byte aligned shared base
template <int DQK, int DV>
struct DkdvLayout {
  using T = Tiles<DQK, DV>;
  static constexpr int kN = T::kN;
  static constexpr int kKBytes = T::kQkBoxes * kBox64;      // 64 keys
  static constexpr int kVBytes = T::kVBoxes * kBox64;
  static constexpr int kQBytes = T::kQkBoxes * kN * 128;    // N queries
  static constexpr int kDoBytes = T::kVBoxes * kN * 128;
  static constexpr int kStages = 3;
  static constexpr int kK = 0, kV = kKBytes;
  static constexpr int kRing = kKBytes + kVBytes;
  static constexpr int kStageBytes = kQBytes + kDoBytes;  // Q, then dO
  static constexpr int kPBytes = 64 * kN * 4;             // a P^T tile in fp32
  static constexpr int kP = kRing + kStages * kStageBytes;
  static constexpr int kVecBytes = 2 * kN * 4;        // a stage's lse, then D
  static constexpr int kVec = kP + 2 * kPBytes;
  static constexpr int kBar = kVec + kStages * kVecBytes;
  // mbarriers: K/V full, K/V empty; per stage full, empty
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages);
  static constexpr int kSmem = kBytes + 1024;  // slack to align the base
  static_assert(kSmem <= kMaxSmem, "the plan exceeds a block's shared memory");
};

// dQ: byte offsets from a 1024-byte aligned shared base
template <int DQK, int DV>
struct DqLayout {
  using T = Tiles<DQK, DV>;
  static constexpr int kN = T::kN;
  static constexpr int kQBytes = T::kQkBoxes * kBox128;   // 128 queries
  static constexpr int kDoBytes = T::kVBoxes * kBox128;
  static constexpr int kKBytes = T::kQkBoxes * kN * 128;  // N keys
  static constexpr int kVBytes = T::kVBoxes * kN * 128;
  static constexpr int kStages = T::kQkBoxes + T::kVBoxes > 4 ? 2 : 3;
  static constexpr int kQ = 0, kDo = kQBytes;
  static constexpr int kRing = kQBytes + kDoBytes;  // per stage: K, then V
  static constexpr int kBar = kRing + kStages * (kKBytes + kVBytes);
  // mbarriers: Q full, Q empty; per stage full, empty
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages);
  static constexpr int kSmem = kBytes + 1024;
  static_assert(kSmem <= kMaxSmem, "the plan exceeds a block's shared memory");
};

// one arrival a warp on an mbarrier that counts warps, once every lane of
// the warp is done with what the arrival releases
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// 1. D = rowsum(dO o) and lse log2 e into (B, H, Sp); past S, D 0 and lse
// +inf. o and dO are read as they lie, (B S H) rows of DV: two lanes a row,
// so each load of a warp covers whole 32-byte sectors of 16 rows, and a lane
// has DV / 16 loads of each in flight; a shuffle closes the sums. rows = B S H.
template <int DV>
__global__ void __launch_bounds__(256)
    flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   float* __restrict__ lse2, int B, int S, int H, long long rows) {
  constexpr int kChunks = DV / 16;  // 16-byte loads a lane and tensor
  const int lane = threadIdx.x % 32, half = lane & 1;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const int Sp = padded_rows(S);
  for (long long base = tid / 32 * 16; base < rows; base += threads / 32 * 16) {
    const long long r = base + lane / 2;
    float acc = 0.f;
    if (r < rows) {
      const uint4* a = reinterpret_cast<const uint4*>(o + r * DV) + half;
      const uint4* g = reinterpret_cast<const uint4*>(dout + r * DV) + half;
      uint4 x[kChunks], y[kChunks];
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        x[i] = a[2 * i];
        y[i] = g[2 * i];
      }
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x[i]);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 fx = __bfloat1622float2(xp[k]), fy = __bfloat1622float2(yp[k]);
          acc = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    if (r < rows && half == 0) {
      const long long bs = r / H, bh = bs / S * H + r % H;
      const int s = (int)(bs % S);
      delta[bh * Sp + s] = acc;
      lse2[bh * Sp + s] = lse[bh * S + s] * kLog2e;
    }
  }
  const long long pads = (long long)B * H * (Sp - S);
  for (long long i = tid; i < pads; i += threads) {
    const long long at = i / (Sp - S) * Sp + S + i % (Sp - S);
    delta[at] = 0.f;
    lse2[at] = INFINITY;
  }
}

// the bf16 A operand of N / 16 steps of depth 16 from a 64 x N tile in the
// accumulator's layout (x[4 j + e]: row r0 + 8 (e >> 1), column 8 j + c2 +
// (e & 1))
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&fa)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) fa[kk][e] = pack_f32(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// rs[h] += the sum of the bf16 values a pack_a tile holds in row r0 + 8 h
// (four partial sums, so the adds are four short chains)
template <int N>
__device__ __forceinline__ void add_row_sums(float (&rs)[2], const uint32_t (&fa)[N / 16][4]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&fa[kk][e]));
      p[e] += f.x + f.y;
    }
  rs[0] += p[0] + p[2];
  rs[1] += p[1] + p[3];
}

// d (64 x N) = a b^T over a width of STEPS 16-column steps: a 64 rows and
// b N rows of tiles K-major in whole boxes, kBoxA and kBoxB bytes apart,
// none over the padding past the last step
template <int STEPS, int N, int kBoxA, int kBoxB>
__device__ __forceinline__ void issue_rows_by_rows(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;  // 16 columns, 32 of a row's 128 bytes
    const uint64_t da = gmma_desc(a + (kk / 4) * kBoxA + in_box, 16, 1024);
    const uint64_t db = gmma_desc(b + (kk / 4) * kBoxB + in_box, 16, 1024);
    if constexpr (N == 128)
      wgmma_ss_n128(d, da, db, kk > 0);
    else
      wgmma_ss_n64(d, da, db, kk > 0);
  }
}

// acc (64 x C, a padded width) += fa (64 x K of the contraction,
// registers) b, b K rows of a tile whose boxes are kBox bytes apart
// (MN-major)
template <int C, int K, int kBox>
__device__ __forceinline__ void issue_accumulate(float (&acc)[C / 2],
                                                 const uint32_t (&fa)[K / 16][4],
                                                 uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_pv<C, kBox>(acc, fa[kk], b + kk * 16 * 128);
}

// rows row_a and row_a + 8 of a gradient tile, W columns of the
// accumulator's layout (acc[4 j + e]: row row_a + 8 (e >> 1), column 8 j +
// c2 + (e & 1)) times mul, into bf16 rows `stride` elements apart (rows
// past S not written)
template <int W, int A>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[A],
                                           long long stride, int row_a, int S, int c2,
                                           float mul) {
#pragma unroll
  for (int jj = 0; jj < W / 8; ++jj) {
    const int col = 8 * jj + c2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(dst + row_a * stride + col) =
          pack_f32(acc[4 * jj] * mul, acc[4 * jj + 1] * mul);
    if (row_a + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (row_a + 8) * stride + col) =
          pack_f32(acc[4 * jj + 2] * mul, acc[4 * jj + 3] * mul);
  }
}
// the same rows as fp32 partials
template <int W, int A>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[A],
                                           long long stride, int row_a, int S, int c2) {
#pragma unroll
  for (int jj = 0; jj < W / 8; ++jj) {
    const int col = 8 * jj + c2;
    if (row_a < S)
      *reinterpret_cast<float2*>(dst + row_a * stride + col) =
          make_float2(acc[4 * jj], acc[4 * jj + 1]);
    if (row_a + 8 < S)
      *reinterpret_cast<float2*>(dst + (row_a + 8) * stride + col) =
          make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(x[i]);
}
template <int K>
__device__ __forceinline__ void fence_all(uint32_t (&fa)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(fa[kk][e]);
}

// A dK/dV work item: keys k0 .. k0 + 63 of KV head kvh, batch b, against
// query heads h0 .. h0 + nh - 1, each from query row q_start on
struct KvItem {
  int k0, kvh, b, split, h0, nh, q_start;
};

// item w: key tile first (the longest causal item first), then KV head,
// batch and head group
__device__ __forceinline__ KvItem kv_item(int w, int KV, int B, int G, int ns,
                                          int causal) {
  const int per = KV * B * ns, jt = w / per, r = w % per;
  KvItem t;
  t.k0 = jt * kKeyRows;
  t.split = r % ns;
  t.kvh = (r / ns) % KV;
  t.b = (r / ns) / KV;
  t.nh = G / ns;
  t.h0 = t.kvh * G + t.split * t.nh;
  t.q_start = causal ? t.k0 : 0;  // under causal: from the diagonal on
  return t;
}

// 2. dK and dV. Consumer 0 holds dV (DV wide), consumer 1 dK (DQK wide),
// each for the item's 64 keys; the ring's query tiles (N rows) pass both.
template <int DQK, int DV>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse2, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ part, int B, int S, int H, int KV, int ns,
                        float scale, int causal) {
  using L = DkdvLayout<DQK, DV>;
  using T = Tiles<DQK, DV>;
  constexpr int N = L::kN;
  constexpr int kBoxN = N * 128;  // a box of a ring tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  auto sQ = [&](int s) { return base + L::kRing + s * L::kStageBytes; };
  auto sDo = [&](int s) { return sQ(s) + L::kQBytes; };
  const uint32_t bar0 = base + L::kBar, kv_full = bar0, kv_empty = bar0 + 8;
  auto full = [&](int s) { return bar0 + 16 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 16 + 8 * (L::kStages + s); };
  const int G = H / KV, Sp = padded_rows(S);
  const int works = ((S + kKeyRows - 1) / kKeyRows) * KV * B * ns;
  // query tiles a head of item t
  auto tiles_of = [&](const KvItem& t) { return (S - t.q_start + N - 1) / N; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ---- producer: one thread issues every copy. A fresh barrier passes
    // the wait for parity 1, so the first round of each ring goes straight on.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, j = 0;
      for (int r = 0; r * (int)gridDim.x < works; ++r) {
        const int w = snake(r);
        if (w >= works) continue;
        const KvItem t = kv_item(w, KV, B, G, ns, causal);
        mbar_wait(kv_empty, (j & 1) ^ 1);
        mbar_expect_tx(kv_full, L::kKBytes + L::kVBytes);
        for (int x = 0; x < T::kQkBoxes; ++x)
          tma_load_4d(sK + x * kBox64, &tk, x * kBoxCols, t.kvh, t.k0, t.b, kv_full);
        for (int x = 0; x < T::kVBoxes; ++x)
          tma_load_4d(sV + x * kBox64, &tv, x * kBoxCols, t.kvh, t.k0, t.b, kv_full);
        ++j;
        const int nt = tiles_of(t);
        for (int hh = 0; hh < t.nh; ++hh) {
          const int h = t.h0 + hh;
          const long long vec = ((long long)t.b * H + h) * Sp;
          for (int m = 0; m < nt; ++m, ++it) {
            const int s = it % L::kStages, q0 = t.q_start + m * N;
            mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
            mbar_expect_tx(full(s), L::kStageBytes + L::kVecBytes);
            for (int x = 0; x < T::kQkBoxes; ++x)
              tma_load_4d(sQ(s) + x * kBoxN, &tq, x * kBoxCols, h, q0, t.b, full(s));
            for (int x = 0; x < T::kVBoxes; ++x)
              tma_load_4d(sDo(s) + x * kBoxN, &tdo, x * kBoxCols, h, q0, t.b, full(s));
            const uint32_t sv = base + L::kVec + s * L::kVecBytes;
            bulk_load(sv, lse2 + vec + q0, N * 4, full(s));
            bulk_load(sv + N * 4, delta + vec + q0, N * 4, full(s));
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 0 runs S^T, P^T and dV; 1 runs dP^T, dS^T and dK ----
  setmaxnreg_inc<kConsumerRegs>();
  // Each role's code is compiled for it (``role``, a compile-time 0 or 1):
  // a wgmma issued in a branch on a runtime role sits on a path the
  // compiler must treat as divergent, and it then serializes the products.
  auto consume = [&](auto role) {
    constexpr int c = decltype(role)::value;
    const int lt = threadIdx.x % kWg;
    const int warp = lt / 32, lane = lt % 32;
    const int r0 = 16 * warp + lane / 4;  // rows r0 and r0 + 8 of the key tile
    const int c2 = 2 * (lane % 4);        // columns c2, c2 + 1 of each 8
    const float sl2 = scale * kLog2e;

    constexpr int kCols = c == 0 ? T::kVCols : T::kQkCols;
    float acc[kCols / 2];  // dV (consumer 0, DV padded) or dK (1, DQK padded)
    float x[N / 2];        // S^T then P^T, or dP^T then dS^T
    uint32_t fa[N / 16][4];  // the bf16 A operand of the accumulation
    int it = 0, j = 0;     // ring position and item count, as the producer counts
    int total = 0;         // ring steps of this CTA in all
    for (int r = 0; r * (int)gridDim.x < works; ++r) {
      const int w = snake(r);
      if (w >= works) continue;
      const KvItem t = kv_item(w, KV, B, G, ns, causal);
      total += t.nh * tiles_of(t);
    }

    // the first product of ring slot `slot`: K Q^T over DQK or V dO^T over
    // DV
    auto issue_first = [&](int slot) {
      const int s = slot % L::kStages;
      if constexpr (c == 0)
        issue_rows_by_rows<T::kQkSteps, N, kBox64, kBoxN>(x, sK, sQ(s));
      else
        issue_rows_by_rows<T::kVSteps, N, kBox64, kBoxN>(x, sV, sDo(s));
    };
    // the accumulation of ring slot `slot`: dV += P^T dO (DV wide) or dK +=
    // dS^T Q (DQK wide)
    auto issue_acc = [&](int slot) {
      issue_accumulate<kCols, N, kBoxN>(acc, fa, c == 0 ? sDo(slot % L::kStages)
                                                        : sQ(slot % L::kStages));
    };
    // this thread's N / 4 of a step's lse (consumer 0) or D (consumer 1)
    // values, by column: v[2 j + e] is column 8 j + c2 + e
    float v[N / 4];
    // v of ring slot `slot`, read as its stage lands and before its products
    // are issued, so that the loads do not queue behind the products'
    // shared-memory reads
    auto column_values = [&](int slot) {
      const float2* src = reinterpret_cast<const float2*>(
          gbase + L::kVec + (slot % L::kStages) * L::kVecBytes + c * N * 4);
  #pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const float2 p = src[(8 * jj + c2) / 2];
        v[2 * jj] = p.x;
        v[2 * jj + 1] = p.y;
      }
    };
    // between the first product and the accumulation of ring slot `slot`:
    // consumer 0 turns S^T into P^T (diag: the causal diagonal tile) and
    // hands it over, consumer 1 takes it and turns dP^T into dS^T
    auto middle = [&](int slot, bool diag) {
      const int buf = slot & 1;
      float4* pt = reinterpret_cast<float4*>(gbase + L::kP + buf * L::kPBytes);
      if (c == 0) {
        if (diag) {  // scores above the diagonal to -inf, so P^T is exactly 0
  #pragma unroll
          for (int i = 0; i < N / 2; ++i)
            if (r0 + 8 * ((i >> 1) & 1) > 8 * (i >> 2) + c2 + (i & 1)) x[i] = -INFINITY;
        }
  #pragma unroll
        for (int i = 0; i < N / 2; ++i) x[i] = ex2(fmaf(x[i], sl2, -v[2 * (i >> 2) + (i & 1)]));
        if (slot >= 2) named_sync(kPEmptyBar + buf, kConsumerThreads);
  #pragma unroll
        for (int i = 0; i < N / 8; ++i)
          pt[i * kWg + lt] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
        named_arrive(kPFullBar + buf, kConsumerThreads);
      } else {
        named_sync(kPFullBar + buf, kConsumerThreads);
  #pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          const float4 p = pt[i * kWg + lt];
          const float pe[4] = {p.x, p.y, p.z, p.w};
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * i + e;
            x[k] = pe[e] * (x[k] - v[2 * (k >> 2) + (k & 1)]);
          }
        }
        // consumer 0 waits for this buffer again only if it has a step two on
        if (slot + 2 < total) named_arrive(kPEmptyBar + buf, kConsumerThreads);
      }
    };
    auto parity = [](int slot) { return (uint32_t)((slot / L::kStages) & 1); };

    for (int r = 0; r * (int)gridDim.x < works; ++r) {
      const int w = snake(r);
      if (w >= works) continue;
      const KvItem t = kv_item(w, KV, B, G, ns, causal);
      const int per_head = tiles_of(t), steps = t.nh * per_head, first = it;
  #pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
      mbar_wait(kv_full, j & 1);

      // query tile 0 of the item: the first product, then the middle
      mbar_wait(full(first % L::kStages), parity(first));
      column_values(first);
      fence_all(x);
      wgmma_fence();
      issue_first(first);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(x);
      if (steps == 1) warp_arrive(kv_empty);  // K and V's last use in this item
      middle(first, causal != 0);
      pack_a<N>(fa, x);

      // tile n's first product runs beside tile n - 1's accumulation; tile n's
      // middle runs while that accumulation finishes
      for (int n = 1; n < steps; ++n) {
        const int cur = first + n, prev = cur - 1;
        mbar_wait(full(cur % L::kStages), parity(cur));
        column_values(cur);
        fence_all(x);
        fence_all(acc);
        fence_all(fa);
        wgmma_fence();
        issue_first(cur);
        wgmma_commit();
        issue_acc(prev);
        wgmma_commit();
        wgmma_wait<1>();  // the first product of tile n has landed
        fence_all(x);
        if (n == steps - 1) warp_arrive(kv_empty);
        middle(cur, causal && n % per_head == 0);
        wgmma_wait<0>();  // the accumulation of tile n - 1 has landed
        fence_all(acc);
        fence_all(fa);
        warp_arrive(empty(prev % L::kStages));
        pack_a<N>(fa, x);
      }
      const int last = first + steps - 1;
      fence_all(acc);
      fence_all(fa);
      wgmma_fence();
      issue_acc(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
      warp_arrive(empty(last % L::kStages));
      it += steps;
      ++j;

      // epilogue: rows k0 + r0 and k0 + r0 + 8, from registers; rows past S
      // are not written. dV rows are KV x DV apart, dK rows KV x DQK.
      const int row_a = t.k0 + r0;
      const long long row = (long long)t.b * S * KV + t.kvh;  // (b, key 0, kvh)
      const long long nv = (long long)B * S * KV * DV, nk = (long long)B * S * KV * DQK;
      if constexpr (c == 0) {
        if (ns == 1)
          store_rows<DV>(dv + row * DV, acc, (long long)KV * DV, row_a, S, c2, 1.f);
        else  // partials: dV [split][B][S][KV][DV], then dK's, fp32
          store_rows<DV>(part + t.split * nv + row * DV, acc, (long long)KV * DV,
                         row_a, S, c2);
      } else {
        if (ns == 1)
          store_rows<DQK>(dk + row * DQK, acc, (long long)KV * DQK, row_a, S, c2, scale);
        else  // partials: dK [split][B][S][KV][DQK] after dV's
          store_rows<DQK>(part + ns * nv + t.split * nk + row * DQK, acc,
                          (long long)KV * DQK, row_a, S, c2);
      }
    }
  };
  if (threadIdx.x / kWg == 1)
    consume(std::integral_constant<int, 0>{});
  else
    consume(std::integral_constant<int, 1>{});
}

// the ns fp32 partials of dV (nv4 float4s a split) and then of dK (nk4
// a split) added in order into bf16 dv and dk (dk times scale); four
// elements a thread a step
__global__ void __launch_bounds__(256)
    flash_bwd_sum(const float4* __restrict__ part, uint2* __restrict__ dk,
                  uint2* __restrict__ dv, long long nv4, long long nk4, int ns,
                  float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nv4 + nk4;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_k = i >= nv4;
    const long long at = is_k ? i - nv4 : i, n4 = is_k ? nk4 : nv4;
    const float4* src = part + (is_k ? ns * nv4 : 0) + at;
    float4 a = src[0];
    for (int s = 1; s < ns; ++s) {
      const float4 b = src[s * n4];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const float mul = is_k ? scale : 1.f;
    (is_k ? dk : dv)[at] =
        make_uint2(pack_f32(a.x * mul, a.y * mul), pack_f32(a.z * mul, a.w * mul));
  }
}

// 5. dQ's key centres (launched before dQ): each kKeyChunk-row key chunk's
// column sums into (B, nch, KV, DQK), then the prefix means into (B, S,
// KV, DQK), fp32. A block a (chunk, KV head, batch), a thread a column: a
// warp's loads take a row's DQK contiguous bf16.
constexpr int kKeyChunk = 16;
template <int DQK>
__global__ void __launch_bounds__((DQK + 31) / 32 * 32)
    flash_bwd_key_sums(const bf16* __restrict__ k, float* __restrict__ sums, int S, int KV) {
  const int d = threadIdx.x, ch = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  if (d >= DQK) return;
  const int t0 = ch * kKeyChunk, t1 = min(t0 + kKeyChunk, S);
  const long long step = (long long)KV * DQK;
  const bf16* col = k + ((long long)b * S * KV + kv) * DQK + d;
  float acc = 0.f;
#pragma unroll
  for (int t = t0; t < t1; ++t) acc += __bfloat162float(col[t * step]);
  sums[(((long long)b * gridDim.x + ch) * KV + kv) * DQK + d] = acc;
}
template <int DQK>
__global__ void __launch_bounds__((DQK + 31) / 32 * 32)
    flash_bwd_key_centres(const bf16* __restrict__ k, const float* __restrict__ sums,
                          float* __restrict__ cent, int S, int KV, int causal) {
  const int d = threadIdx.x, ch = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  if (d >= DQK) return;
  const int t0 = ch * kKeyChunk, t1 = min(t0 + kKeyChunk, S);
  const long long step = (long long)KV * DQK;
  const long long at = ((long long)b * S * KV + kv) * DQK + d;
  float acc = 0.f;
  if (!causal) {  // every row's centre is row S - 1's: the last chunk's block alone
    if (ch != (int)gridDim.x - 1) return;
#pragma unroll 8
    for (int c = 0; c <= ch; ++c)
      acc += sums[(((long long)b * gridDim.x + c) * KV + kv) * DQK + d];
    cent[at + (S - 1) * step] = acc / (float)S;
    return;
  }
#pragma unroll 8
  for (int c = 0; c < ch; ++c) acc += sums[(((long long)b * gridDim.x + c) * KV + kv) * DQK + d];
#pragma unroll
  for (int t = t0; t < t1; ++t) {
    acc += __bfloat162float(k[at + t * step]);
    cent[at + t * step] = acc / (float)(t + 1);
  }
}

// 4. dQ. Consumer c holds dQ (DQK wide) of query rows q0 + 64 c .. + 63;
// the ring's key tiles (N rows) pass both.
template <int DQK, int DV>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse2, float* __restrict__ delta,
                      const float* __restrict__ cent, bf16* __restrict__ dq, int B, int S,
                      int H, int KV, float scale, int causal) {
  using L = DqLayout<DQK, DV>;
  using T = Tiles<DQK, DV>;
  constexpr int kCols = T::kQkCols, N = L::kN;
  constexpr int kBoxN = N * 128;  // a box of a ring tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sDo = base + L::kDo;
  auto sK = [&](int s) { return base + L::kRing + s * (L::kKBytes + L::kVBytes); };
  auto sV = [&](int s) { return sK(s) + L::kKBytes; };
  const uint32_t bar0 = base + L::kBar, q_full = bar0, q_empty = bar0 + 8;
  auto full = [&](int s) { return bar0 + 16 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 16 + 8 * (L::kStages + s); };
  const int nq = (S + kDqRows - 1) / kDqRows, nk = (S + N - 1) / N;
  const int works = nq * H * B, Sp = padded_rows(S);
  // item w: query tiles from the last one down (the longest causal rows
  // first), then head and batch; its key tiles up to the diagonal
  auto item = [&](int w, int& q0, int& h, int& b, int& nkt) {
    const int level = w / (H * B), hb = w % (H * B);
    h = hb % H;
    b = hb / H;
    q0 = (nq - 1 - level) * kDqRows;
    const int diag = (q0 + kDqRows - 1) / N + 1;
    nkt = causal && diag < nk ? diag : nk;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ---- producer: each item's Q and dO once, then its K/V tiles through
    // the ring, which runs on across items
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, j = 0;
      for (int r = 0; r * (int)gridDim.x < works; ++r) {
        const int w = snake(r);
        if (w >= works) continue;
        int q0, h, b, nkt;
        item(w, q0, h, b, nkt);
        const int kvh = h / (H / KV);
        mbar_wait(q_empty, (j & 1) ^ 1);
        mbar_expect_tx(q_full, L::kQBytes + L::kDoBytes);
        for (int x = 0; x < T::kQkBoxes; ++x)
          tma_load_4d(sQ + x * kBox128, &tq, x * kBoxCols, h, q0, b, q_full);
        for (int x = 0; x < T::kVBoxes; ++x)
          tma_load_4d(sDo + x * kBox128, &tdo, x * kBoxCols, h, q0, b, q_full);
        ++j;
        for (int n = 0; n < nkt; ++n, ++it) {
          const int s = it % L::kStages;
          mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), L::kKBytes + L::kVBytes);
          for (int x = 0; x < T::kQkBoxes; ++x)
            tma_load_4d(sK(s) + x * kBoxN, &tk, x * kBoxCols, kvh, n * N, b, full(s));
          for (int x = 0; x < T::kVBoxes; ++x)
            tma_load_4d(sV(s) + x * kBoxN, &tv, x * kBoxCols, kvh, n * N, b, full(s));
        }
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<kConsumerRegs>();
  const int c = threadIdx.x / kWg - 1;
  const int lt = threadIdx.x % kWg;
  const int warp = lt / 32, lane = lt % 32;
  const int r0 = 64 * c + 16 * warp + lane / 4;  // rows r0 and r0 + 8 of the item
  const int c2 = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;

  float acc[kCols / 2];    // dQ, DQK padded
  float rs[2], rf[2];      // rows r0 and r0 + 8's sums of the bf16 and fp32 dS
  float x[N / 2], y[N / 2];  // S then P then dS; dP
  uint32_t fa[N / 16][4];  // dS in bf16, the A operand of dQ += dS K
  int it = 0, j = 0;

  auto issue_first = [&](int slot) {  // S = Q K^T over DQK, dP = dO V^T over DV
    const int s = slot % L::kStages;
    issue_rows_by_rows<T::kQkSteps, N, kBox128, kBoxN>(x, sQ + c * 64 * 128, sK(s));
    issue_rows_by_rows<T::kVSteps, N, kBox128, kBoxN>(y, sDo + c * 64 * 128, sV(s));
  };
  auto issue_acc = [&](int slot) {  // dQ += dS K
    issue_accumulate<kCols, N, kBoxN>(acc, fa, sK(slot % L::kStages));
  };
  auto parity = [](int slot) { return (uint32_t)((slot / L::kStages) & 1); };

  for (int r = 0; r * (int)gridDim.x < works; ++r) {
    const int w = snake(r);
    if (w >= works) continue;
    int q0, h, b, nkt;
    item(w, q0, h, b, nkt);
    const int row0 = q0 + r0;
    const long long vec = ((long long)b * H + h) * Sp + row0;
    // rows past S: lse +inf and D 0 (padded), so P is 0
    const float l2[2] = {lse2[vec], lse2[vec + 8]};
    const float dd[2] = {delta[vec], delta[vec + 8]};
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
    rs[0] = rs[1] = rf[0] = rf[1] = 0.f;
    mbar_wait(q_full, j & 1);

    // dS of key tile n from S and dP: scores past S and above the diagonal
    // to -inf first, so P is exactly 0 there
    auto middle = [&](int n) {
      const int k0 = n * N;
      if (k0 + N > S || (causal && k0 + N - 1 > q0 + 64 * c)) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + c2 + (i & 1);
          if (col >= S || (causal && col > row0 + 8 * ((i >> 1) & 1))) x[i] = -INFINITY;
        }
      }
      float p[4] = {0.f, 0.f, 0.f, 0.f};  // x[i] is row r0 + 8 ((i >> 1) & 1)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int hf = (i >> 1) & 1;
        x[i] = ex2(fmaf(x[i], sl2, -l2[hf])) * (y[i] - dd[hf]);
        p[i & 3] += x[i];
      }
      rf[0] += p[0] + p[1];
      rf[1] += p[2] + p[3];
    };

    const int first = it;
    mbar_wait(full(first % L::kStages), parity(first));
    fence_all(x);
    fence_all(y);
    wgmma_fence();
    issue_first(first);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(x);
    fence_all(y);
    if (nkt == 1) warp_arrive(q_empty);  // Q and dO's last use in this item
    middle(0);
    pack_a<N>(fa, x);
    add_row_sums<N>(rs, fa);

    for (int n = 1; n < nkt; ++n) {
      const int cur = first + n, prev = cur - 1;
      mbar_wait(full(cur % L::kStages), parity(cur));
      fence_all(x);
      fence_all(y);
      fence_all(acc);
      fence_all(fa);
      wgmma_fence();
      issue_first(cur);
      wgmma_commit();
      issue_acc(prev);
      wgmma_commit();
      wgmma_wait<1>();
      fence_all(x);
      fence_all(y);
      if (n == nkt - 1) warp_arrive(q_empty);
      middle(n);
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(fa);
      warp_arrive(empty(prev % L::kStages));
      pack_a<N>(fa, x);
      add_row_sums<N>(rs, fa);
    }
    const int last = first + nkt - 1;
    fence_all(acc);
    fence_all(fa);
    wgmma_fence();
    issue_acc(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(acc);
    warp_arrive(empty(last % L::kStages));
    it += nkt;
    ++j;

    // epilogue: D += the row's fp32 dS sum, for the dK/dV launch; dQ =
    // scale (dS K - r c), r the row's bf16 dS sum, c its key centre (the
    // sums over the quad that holds the row; rows past S have both 0)
    const int kvh = h / (H / KV);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(kFull, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(kFull, rs[hf], 2);
      rf[hf] += __shfl_xor_sync(kFull, rf[hf], 1);
      rf[hf] += __shfl_xor_sync(kFull, rf[hf], 2);
      if (lane % 4 == 0 && row0 + 8 * hf < S) delta[vec + 8 * hf] = dd[hf] + rf[hf];
      const int crow = causal ? min(row0 + 8 * hf, S - 1) : S - 1;
      const float* cr = cent + (((long long)b * S + crow) * KV + kvh) * DQK + c2;
#pragma unroll
      for (int jj = 0; jj < DQK / 8; ++jj) {
        const float2 cc = *reinterpret_cast<const float2*>(cr + 8 * jj);
        acc[4 * jj + 2 * hf] -= rs[hf] * cc.x;
        acc[4 * jj + 2 * hf + 1] -= rs[hf] * cc.y;
      }
    }
    // dQ times scale, rows past S not written
    store_rows<DQK>(dq + ((long long)b * S * H + h) * DQK, acc, (long long)H * DQK, row0,
                    S, c2, scale);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA loops (tests only)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;      // rows of a query or key tile
constexpr int kThreads = 128;  // four warps
// what one flash_bwd_dkdv_f32 launch accumulates, a bit each: both gradients
// where their registers allow (up to hd 128), dV and then dK in two launches
// past it
constexpr int kDv = 1, kDk = 2, kDkDv = kDv | kDk;
template <int DQK, int DV>
constexpr bool split_dkdv() {
  return DQK / 2 + DV / 2 > 128;
}

// D = rowsum(dO o) in (B, H, S); rows = B * S * H in o's (B, S, H) order;
// 8 warps a block, one a row
__global__ void __launch_bounds__(256)
    flash_bwd_dot(const float* __restrict__ o, const float* __restrict__ dout,
                  float* __restrict__ delta, int S, int H, int hd, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps
  const int lane = threadIdx.x % 32;
  const float* a = o + row * hd;
  const float* b = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(a[d], b[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const long long h = row % H, bs = row / H;
    delta[((bs / S) * H + h) * S + bs % S] = acc;
  }
}


template <int LD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long stride, int row0, int S, int hd) {
  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int r = i / hd, c = i % hd;
    dst[r * LD + c] = row0 + r < S ? src[(long long)(row0 + r) * stride + c] : 0.f;
  }
}

template <int DQK, int DV>
constexpr size_t f32_smem() {
  return ((size_t)2 * kRows * (DQK + 1) + (size_t)2 * kRows * (DV + 1) +
          (size_t)2 * kRows * (kRows + 1) + 2 * kRows) *
         sizeof(float);
}

// thread pair r (threads 2r, 2r + 1) owns key row r of the tile; `par`
// picks its columns 2i + par
template <int DQK, int DV, int PARTS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KV,
                       float scale, int causal) {
  constexpr int LDQ = DQK + 1, LDV = DV + 1, LDP = kRows + 1;
  constexpr bool kWantV = PARTS & kDv, kWantK = PARTS & kDk;
  extern __shared__ float smem_dkdv_f32[];
  float* Ks = smem_dkdv_f32;
  float* Qs = Ks + kRows * LDQ;
  float* Vs = Qs + kRows * LDQ;
  float* dOs = Vs + kRows * LDV;
  float* Pt = dOs + kRows * LDV;
  float* dSt = Pt + kRows * LDP;
  float* Ls = dSt + kRows * LDP;
  float* Ds = Ls + kRows;

  const int jt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = jt * kRows, G = H / KV;
  const int r = threadIdx.x >> 1, par = threadIdx.x & 1;
  const long long kv_row = (long long)b * S * KV + kvh;  // (b, key 0, kvh)
  load_rows_f32<LDQ>(Ks, k + kv_row * DQK, (long long)KV * DQK, k0, S, DQK);
  if constexpr (kWantK) load_rows_f32<LDV>(Vs, v + kv_row * DV, (long long)KV * DV, k0, S, DV);

  float ak[DQK / 2], av[DV / 2];  // the one not wanted is dead
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) ak[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) av[i] = 0.f;
  const int nq = (S + kRows - 1) / kRows;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const long long q_row = (long long)b * S * H + h;  // (b, query 0, h)
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = causal ? jt : 0; qt < nq; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();
      load_rows_f32<LDQ>(Qs, q + q_row * DQK, (long long)H * DQK, q0, S, DQK);
      load_rows_f32<LDV>(dOs, dout + q_row * DV, (long long)H * DV, q0, S, DV);
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
        for (int d = 0; d < DQK; ++d) s = fmaf(Ks[r * LDQ + d], Qs[c * LDQ + d], s);
        if constexpr (kWantK) {
#pragma unroll 8
          for (int d = 0; d < DV; ++d) dp = fmaf(Vs[r * LDV + d], dOs[c * LDV + d], dp);
        }
        const bool live = q0 + c < S && (!causal || k0 + r <= q0 + c);
        const float p = live ? expf(s * scale - Ls[c]) : 0.f;
        Pt[r * LDP + c] = p;
        dSt[r * LDP + c] = p * (dp - Ds[c]);
      }
      __syncwarp();  // row r's columns come from this thread pair
      for (int c = 0; c < kRows; ++c) {
        const float p = Pt[r * LDP + c], ds = dSt[r * LDP + c];
        if constexpr (kWantV) {
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) av[i] = fmaf(p, dOs[c * LDV + 2 * i + par], av[i]);
        }
        if constexpr (kWantK) {
#pragma unroll
          for (int i = 0; i < DQK / 2; ++i)
            ak[i] = fmaf(ds, Qs[c * LDQ + 2 * i + par], ak[i]);
        }
      }
    }
  }
  if (k0 + r < S) {
    float* dkr = dk + (kv_row + (long long)(k0 + r) * KV) * DQK + par;
    float* dvr = dv + (kv_row + (long long)(k0 + r) * KV) * DV + par;
    if constexpr (kWantK) {
#pragma unroll
      for (int i = 0; i < DQK / 2; ++i) dkr[2 * i] = ak[i] * scale;
    }
    if constexpr (kWantV) {
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) dvr[2 * i] = av[i];
    }
  }
}

// thread pair r owns query row r of the tile
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int S, int H, int KV, float scale, int causal) {
  constexpr int LDQ = DQK + 1, LDV = DV + 1, LDP = kRows + 1;
  extern __shared__ float smem_dq_f32[];
  float* Qs = smem_dq_f32;
  float* Ks = Qs + kRows * LDQ;
  float* dOs = Ks + kRows * LDQ;
  float* Vs = dOs + kRows * LDV;
  float* dSs = Vs + kRows * LDV;

  const int nq = (S + kRows - 1) / kRows;
  const int it = nq - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = it * kRows, kvh = h / (H / KV);
  const int r = threadIdx.x >> 1, par = threadIdx.x & 1;
  const long long q_row = (long long)b * S * H + h;     // (b, query 0, h)
  const long long kv_row = (long long)b * S * KV + kvh;  // (b, key 0, kvh)
  const long long lrow = ((long long)b * H + h) * S + q0 + r;
  const float lse_r = q0 + r < S ? lse[lrow] : 0.f;
  const float d_r = q0 + r < S ? delta[lrow] : 0.f;
  load_rows_f32<LDQ>(Qs, q + q_row * DQK, (long long)H * DQK, q0, S, DQK);
  load_rows_f32<LDV>(dOs, dout + q_row * DV, (long long)H * DV, q0, S, DV);

  float aq[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) aq[i] = 0.f;
  const int nk = causal ? it + 1 : nq;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kRows;
    __syncthreads();
    load_rows_f32<LDQ>(Ks, k + kv_row * DQK, (long long)KV * DQK, k0, S, DQK);
    load_rows_f32<LDV>(Vs, v + kv_row * DV, (long long)KV * DV, k0, S, DV);
    __syncthreads();
    for (int j = 0; j < kRows / 2; ++j) {
      const int c = 2 * j + par;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < DQK; ++d) s = fmaf(Qs[r * LDQ + d], Ks[c * LDQ + d], s);
#pragma unroll 8
      for (int d = 0; d < DV; ++d) dp = fmaf(dOs[r * LDV + d], Vs[c * LDV + d], dp);
      const bool live = k0 + c < S && (!causal || k0 + c <= q0 + r);
      const float p = live ? expf(s * scale - lse_r) : 0.f;
      dSs[r * LDP + c] = p * (dp - d_r);
    }
    __syncwarp();
    for (int c = 0; c < kRows; ++c) {
      const float ds = dSs[r * LDP + c];
#pragma unroll
      for (int i = 0; i < DQK / 2; ++i) aq[i] = fmaf(ds, Ks[c * LDQ + 2 * i + par], aq[i]);
    }
  }
  if (q0 + r < S) {
    float* dqr = dq + (q_row + (long long)(q0 + r) * H) * DQK + par;
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) dqr[2 * i] = aq[i] * scale;
  }
}


// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

// the dK/dV launch's head groups a KV head: powers of two dividing G, the
// least that gives as many items as SMs under causal (items of unequal
// length), or the most that keeps the items no more than the SMs under no
// mask (equal items: a second round would cost as much as a split saves)
int dkdv_splits(int B, int S, int KV, int G, int causal) {
  const long long items = (long long)((S + kKeyRows - 1) / kKeyRows) * KV * B;
  const long long sms = sm_count();
  int ns = 1;
  while (G % (2 * ns) == 0 && (causal ? items * ns < sms : 2 * items * ns <= sms)) ns *= 2;
  return ns;
}

// floats of workspace the backward takes: D and lse log2 e (B, H, Sp),
// where dK/dV is split its partials (dV's then dK's), then dQ's key centres
// (B, S, KV, dqk) and chunk sums (B, ceil(S / 16), KV, dqk); D (B, H, S) in
// fp32
long long split_floats(int B, int S, int KV, int dqk, int dv, int ns) {
  return ns > 1 ? (long long)ns * B * S * KV * (dqk + dv) : 0;
}
long long bwd_workspace(int B, int S, int H, int KV, int dqk, int dv, int causal,
                        int is_bf16) {
  if (!is_bf16) return (long long)B * H * S;
  const int ns = dkdv_splits(B, S, KV, H / KV, causal);
  return 2LL * B * H * padded_rows(S) + split_floats(B, S, KV, dqk, dv, ns) +
         (long long)B * KV * dqk * (S + (S + kKeyChunk - 1) / kKeyChunk);
}

int grid_of(long long works) { return (int)(works < sm_count() ? works : sm_count()); }

template <int DQK, int DV>
cudaError_t launch_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                            const bf16* dout, const float* lse, float* ws, bf16* dq,
                            bf16* dk, bf16* dv, int B, int S, int H, int KV, float scale,
                            int causal, cudaStream_t stream) {
  using LK = DkdvLayout<DQK, DV>;
  using LQ = DqLayout<DQK, DV>;
  // the shared-memory opt-in above the 48 KB default, once an instance
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<DQK, DV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               LK::kSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dq_bf16<DQK, DV>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::kSmem);
  }();
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)B * H * padded_rows(S);
  const int ns = dkdv_splits(B, S, KV, H / KV, causal);
  float* delta = ws;
  float* lse2 = ws + rows;
  float* part = lse2 + rows;
  float* cent = part + split_floats(B, S, KV, DQK, DV, ns);
  float* sums = cent + (long long)B * S * KV * DQK;
  // 16 rows a warp, 128 a block
  const long long prep_blocks = ((long long)B * S * H + 127) / 128;
  flash_bwd_prep<DV><<<(unsigned)(prep_blocks < 16LL * sm_count() ? prep_blocks
                                                                  : 16LL * sm_count()),
                       256, 0, stream>>>(o, dout, lse, delta, lse2, B, S, H,
                                         (long long)B * S * H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 chunks((S + kKeyChunk - 1) / kKeyChunk, KV, B);
  constexpr int kKeyThreads = (DQK + 31) / 32 * 32;
  flash_bwd_key_sums<DQK><<<chunks, kKeyThreads, 0, stream>>>(k, sums, S, KV);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_key_centres<DQK><<<chunks, kKeyThreads, 0, stream>>>(k, sums, cent, S, KV, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // dK/dV: K and V 64 rows a box, Q and dO N; dQ: Q and dO 128, K and V N.
  // Q and K are DQK wide, V and dO DV.
  constexpr int N = Tiles<DQK, DV>::kN;
  CUtensorMap tq, tk, tv, tdo, tq2, tk2, tv2, tdo2;
  if (!make_map(&tq, q, B, S, H, DQK, N) || !make_map(&tk, k, B, S, KV, DQK, kKeyRows) ||
      !make_map(&tv, v, B, S, KV, DV, kKeyRows) || !make_map(&tdo, dout, B, S, H, DV, N) ||
      !make_map(&tq2, q, B, S, H, DQK, kDqRows) || !make_map(&tk2, k, B, S, KV, DQK, N) ||
      !make_map(&tv2, v, B, S, KV, DV, N) || !make_map(&tdo2, dout, B, S, H, DV, kDqRows))
    return cudaErrorInvalidValue;

  // dQ first: it leaves the consistent D for the dK/dV launch
  const long long q_works = (long long)((S + kDqRows - 1) / kDqRows) * H * B;
  flash_bwd_dq_bf16<DQK, DV><<<grid_of(q_works), kBwdThreads, LQ::kSmem, stream>>>(
      tq2, tk2, tv2, tdo2, lse2, delta, cent, dq, B, S, H, KV, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long kv_works = (long long)((S + kKeyRows - 1) / kKeyRows) * KV * B * ns;
  flash_bwd_dkdv_bf16<DQK, DV><<<grid_of(kv_works), kBwdThreads, LK::kSmem, stream>>>(
      tq, tk, tv, tdo, lse2, delta, dk, dv, part, B, S, H, KV, ns, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (ns > 1) {
    const long long nv4 = (long long)B * S * KV * DV / 4, nk4 = (long long)B * S * KV * DQK / 4;
    const long long blocks = (nv4 + nk4 + 255) / 256, cap = 8LL * sm_count();
    flash_bwd_sum<<<(unsigned)(blocks < cap ? blocks : cap), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(part), reinterpret_cast<uint2*>(dk),
        reinterpret_cast<uint2*>(dv), nv4, nk4, ns, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// one launch of the fp32 dK/dV kernel for the gradients PARTS; the
// shared-memory opt-in above the 48 KB default is set once an instance
template <int DQK, int DV, int PARTS>
cudaError_t launch_dkdv_f32(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse, const float* delta,
                            float* dk, float* dv, int B, int S, int H, int KV, float scale,
                            int causal, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, KV, B);
  constexpr int smem = (int)f32_smem<DQK, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32<DQK, DV, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dkdv_f32<DQK, DV, PARTS><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, KV, scale, causal);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                           const float* dout, const float* lse, float* delta, float* dq,
                           float* dk, float* dv, int B, int S, int H, int KV, float scale,
                           int causal, cudaStream_t stream) {
  constexpr int smem_dq = (int)(((size_t)2 * kRows * (DQK + 1) + (size_t)2 * kRows * (DV + 1) +
                                 (size_t)kRows * (kRows + 1)) *
                                sizeof(float));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_f32<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (attr != cudaSuccess) return attr;

  const long long rows = (long long)B * S * H;
  flash_bwd_dot<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, delta, S, H, DV,
                                                                 rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (split_dkdv<DQK, DV>()) {
    e = launch_dkdv_f32<DQK, DV, kDv>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale,
                                      causal, stream);
    if (e != cudaSuccess) return e;
    e = launch_dkdv_f32<DQK, DV, kDk>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale,
                                      causal, stream);
  } else {
    e = launch_dkdv_f32<DQK, DV, kDkDv>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV,
                                        scale, causal, stream);
  }
  if (e != cudaSuccess) return e;
  const dim3 grid_q((S + kRows - 1) / kRows, H, B);
  flash_bwd_dq_f32<DQK, DV><<<grid_q, kThreads, smem_dq, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, KV, scale, causal);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* ws, void* dq, void* dk,
                         void* dv, int B, int S, int H, int KV, float scale, int causal,
                         int is_bf16, cudaStream_t s) {
  if (is_bf16)
    return launch_bwd_bf16<DQK, DV>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                    (const bf16*)o, (const bf16*)dout, lse, ws, (bf16*)dq,
                                    (bf16*)dk, (bf16*)dv, B, S, H, KV, scale, causal, s);
  return launch_bwd_f32<DQK, DV>((const float*)q, (const float*)k, (const float*)v,
                                 (const float*)o, (const float*)dout, lse, ws, (float*)dq,
                                 (float*)dk, (float*)dv, B, S, H, KV, scale, causal, s);
}

// the width pairs with an instance, as one key
constexpr int width_key(int dqk, int dv) { return dqk * 1024 + dv; }

}  // namespace

// The gradient of the forward's out = softmax(q k^T * scale) v: q, dq (B, S,
// H, dqk); k, dk (B, S, KV, dqk); v, dv (B, S, KV, dv); o, dout (B, S, H,
// dv); lse (B, H, S) fp32 from the training forward; workspace fp32 scratch
// of repro_flash_attention_bwd_workspace floats. Contiguous, 16-byte
// aligned, all bf16 (is_bf16) or all fp32; (dqk, dv) one of (16, 16), (64,
// 64), (128, 128), (160, 160), (96, 64), (24, 16); H % KV == 0; B, S >= 1.
// bf16: five launches on `stream` (six where dK/dV is split); fp32: three
// (four where dK and dV take a launch each). Returns cudaGetLastError()
// after the first that fails (cudaErrorInvalidValue for a width pair
// without an instance, or when a tensor map cannot be made).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* workspace, void* dq, void* dk, void* dv,
                                         int B, int S, int H, int KV, int dqk, int dvw,
                                         float scale, int causal, int is_bf16,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FLASH_BWD_CASE(A, C)                                                  \
  case width_key(A, C):                                                            \
    return (int)dispatch_bwd<A, C>(q, k, v, o, dout, lse, workspace, dq, dk, dv, B, S, \
                                   H, KV, scale, causal, is_bf16, s);
  switch (width_key(dqk, dvw)) {
    REPRO_FLASH_BWD_CASE(16, 16)
    REPRO_FLASH_BWD_CASE(64, 64)
    REPRO_FLASH_BWD_CASE(128, 128)
    REPRO_FLASH_BWD_CASE(160, 160)
    REPRO_FLASH_BWD_CASE(96, 64)
    REPRO_FLASH_BWD_CASE(24, 16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD_CASE
}

// fp32 floats of workspace repro_flash_attention_bwd takes for these
// arguments (it depends on the card's SM count where dK/dV is split).
extern "C" long long repro_flash_attention_bwd_workspace(int B, int S, int H, int KV,
                                                         int dqk, int dv, int causal,
                                                         int is_bf16) {
  return bwd_workspace(B, S, H, KV, dqk, dv, causal, is_bf16);
}

// The dK/dV splits of the bf16 backward at these shapes (1: none).
extern "C" int repro_flash_attention_bwd_splits(int B, int S, int H, int KV, int causal) {
  return dkdv_splits(B, S, KV, H / KV, causal);
}

// Dynamic shared memory a CTA of the bf16 dK/dV (kernel 0) or dQ (kernel 1)
// launch asks for at widths (dqk, dv) (0 for a pair without an instance).
extern "C" int repro_flash_attention_bwd_smem(int dqk, int dv, int kernel) {
#define REPRO_FLASH_BWD_SMEM(A, C) \
  case width_key(A, C):            \
    return kernel ? DqLayout<A, C>::kSmem : DkdvLayout<A, C>::kSmem;
  switch (width_key(dqk, dv)) {
    REPRO_FLASH_BWD_SMEM(16, 16)
    REPRO_FLASH_BWD_SMEM(64, 64)
    REPRO_FLASH_BWD_SMEM(128, 128)
    REPRO_FLASH_BWD_SMEM(160, 160)
    REPRO_FLASH_BWD_SMEM(96, 64)
    REPRO_FLASH_BWD_SMEM(24, 16)
    default:
      return 0;
  }
#undef REPRO_FLASH_BWD_SMEM
}

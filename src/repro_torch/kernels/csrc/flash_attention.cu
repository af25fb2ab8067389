// Causal or bidirectional GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). q (B, S, H, hd), k (B, S, KV, hd), v
// (B, S, KV, dv), out (B, S, H, dv), all contiguous in that public layout
// (no transposing copies); dv = hd but for MLA's widths (below). Query head
// h reads KV head h / (H / KV), as the TPU kernel's index map does, so K/V
// are never replicated in memory.
// out = softmax(q k^T * scale [+ causal mask]) v with scale = 1/sqrt(hd)
// (passed in), applied in log2 units with exp2; masked scores are -1e30; an
// online softmax keeps the running max m, sum l and the accumulator in fp32;
// out = acc / max(l, 1e-30) in q's dtype. Any S >= 1 (the TPU kernel needs S
// to be a multiple of its block): rows past S are zero and their columns
// masked, so every S the TPU kernel takes gives the same function.
//
// Bound: operations. At the serving path's shape (B 4, S 1024, H 32, KV 8,
// hd 128, causal) the s(s+1)/2 unmasked (query, key) pairs need 34.4 GFLOP
// on the bf16 tensor cores against 84 MB of q, k, v and out. At MLA's
// (minicpm3-4b's prefill layer: B 4, 40/40 heads, 96/64) group size 1
// shares no K/V tile and the bytes bound it: 105 MB (0.0313 ms at 3.35
// TB/s) against 26.9 GFLOP (0.0272 ms).
//
// Design, bf16 (the serving path): Hopper's asynchronous units, warp
// specialised, persistent. One CTA an SM, of three warpgroups; CTA i walks
// the work tiles i, i + grid, ... A work tile is (128-row query tile, head,
// batch), ordered query tile first from the last one down, so the longest
// causal rows start first, and dealt to the CTAs in a snake (i, then
// 2 grid - 1 - i, ...), so each CTA's causal work stays near the mean.
//   - Producer warpgroup (setmaxnreg down to 24 registers): one thread
//     issues TMA copies, each work tile's Q, then its 128-row K and V tiles
//     into a ring of stages, each with its own `full` mbarrier (K and V
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
//     wgmma m64n{dv}k16 with V as the transposed (MN-major) B operand read
//     in its natural (kv rows, dv) layout: V is never copied. Inside a
//     warpgroup, kv tile n's q k^T is issued together with tile n - 1's
//     p v, and tile n's softmax runs while that p v finishes; across the
//     two warpgroups, one's softmax overlaps the other's products.
//   - Under causal only the diagonal tile is masked; tiles above it are
//     never loaded.
//   - Epilogue: each consumer writes its 64 output rows, divided by the
//     row sums, into a staging tile in the swizzled layout and one thread
//     hands it to a TMA store (rows past S are not written), which drains
//     while the next work tile runs.
// Width pairs (q k width DQK, p v width DV): (16, 16), (64, 64), (128,
// 128) and (160, 160) for the GQA configs, and MLA's (96, 64) for
// minicpm3-4b (q and k are concat(nope 64, rope 32), v is 64 wide; scale
// 1/sqrt(96)) and (24, 16) for its reduced (TINY) config. Q and K tiles
// are DQK wide, V, the accumulators, the staging tile and the output DV
// wide, each sitting in shared memory as whole 64-column boxes, so a width
// that is not a multiple of 64 is padded there: 16 and 24 to 64 columns,
// 96 to 128, 160 to 192. The box past the width reads past the tensor
// map's first dimension, and TMA fills those columns with zeros (the row
// strides, 2 x the width bytes, are multiples of 16, as TMA needs).
// q k^T runs ceil(DQK / 16) steps of depth 16 and stops there (one at 16,
// two at 24, whose second step reads columns 24-31 as zeros on both sides,
// six at 96, ten at 160), so the padding costs nothing there; p v runs
// over the padded DV (n64 at 16, 64; n128 + n64 at 160), whose extra
// output columns are zeros that the output map clips on store. That is
// idle tensor work: p v does 20% more products at hd 160 (10% of the
// kernel's), and the kernel 2.5x the products at hd 16, which only the
// reduced (TINY) configs run. At (96, 64) nothing of p v is padded: q k^T
// runs at 96 and p v at 64, where padding v to 96 (or all three to 128)
// on the host would copy tensors and run 50-100% more p v products. The
// other way for narrow widths,
// boxes of 32 or 16 columns with a 64- or 32-byte swizzle, needs its own
// descriptor mode for both products and leaves the hd 64/128 code alone no
// more than this does; the padding keeps one layout for every width.
// Shared memory: Q 32 KiB + 2 stages x (K + V) 128 KiB + output staging 32
// KiB at hd 128 (96 KiB in all at hd 16 and 64; at (96, 64) Q 32 + 2 x (K
// 32 + V 16) + staging 16 = 144 KiB). At hd 160 a padded tile is
// 48 KiB, and two stages would take 288 KiB of the 227 KB a block may use:
// that dim runs ONE stage (Q 48 + K 48 + V 48 + staging 48 = 192 KiB).
// K and V keep separate barriers, so tile n's K still loads while tile
// n - 1's p v reads V, and the producer issues K of tile n + 1 ahead of V
// of tile n (K0 V0 K1 K2 V1 K3 V2 ..): K's slot frees when q k^T of tile n
// is done, V's only when p v of tile n - 1 is. What one stage costs is that
// a K load overlaps only the softmax and the p v in flight, and a V load
// only the next q k^T, where two stages keep a whole tile ahead. The
// consumers' registers at hd 160: 96
// accumulators, the 64-float score tile and the 32-register P operand, all
// live while the products run, under the 240 of setmaxnreg. No atomics:
// every sum's order is fixed by the layout
// (wgmma's fixed reduction order, the quad shuffles), and a work tile is
// computed by one CTA whatever the grid, so a run gives the same bits
// every time.
// Design, fp32 (tests only): FMA loops over synchronously staged 64-row
// tiles, 128 threads a 64-row query tile; see flash_fwd_f32.
// Training: a second bf16 instance (the LSE template flag) also writes each
// row's natural-log sum of exp(scaled scores), (m + log2 l) ln 2, to lse (B,
// H, S) fp32, for the backward in flash_attention_bwd.cu; the fp32 kernel
// writes it when given a pointer. The serving instance is unchanged.
// Later work: ping-pong scheduling of the two consumers, and skipping the
// half of the diagonal tile that the first consumer's rows never see.
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp specialised
// ---------------------------------------------------------------------------

constexpr int kTile = 128;                 // query rows a work tile, K/V rows a tile
constexpr int kFlashThreads = 3 * kWg;     // producer + two consumers
constexpr int kBoxBytes = kTile * 128;     // one 128 x 64 box, 16 KiB
constexpr int kConsumerThreads = 2 * kWg;

// The shared-memory plan at widths (DQK, DV): Q and K tiles of whole
// 64-column boxes at DQK, V and the output staging tile at DV (each padded
// up), a K/V ring of two stages where they fit, else one
template <int DQK, int DV>
struct Layout {  // byte offsets from a 1024-byte aligned shared base
  static_assert(DQK % 8 == 0 && DQK >= 16 && DQK <= 3 * kBoxCols,
                "q k widths of 16-byte rows, padded to at most three boxes");
  static_assert(DV % 16 == 0 && DV >= 16 && DV <= 3 * kBoxCols,
                "p v widths of 16-column steps, padded to at most three boxes");
  static constexpr int kQkBoxes = (DQK + kBoxCols - 1) / kBoxCols;
  static constexpr int kVBoxes = (DV + kBoxCols - 1) / kBoxCols;
  static constexpr int kCols = kVBoxes * kBoxCols;  // p v's width
  static constexpr int kQkSteps = (DQK + 15) / 16;  // q k^T's 16-deep steps
  static constexpr int kQkBytes = kQkBoxes * kBoxBytes;  // a Q or K tile
  static constexpr int kVBytes = kVBoxes * kBoxBytes;    // a V or staging tile
  static constexpr int kStages =
      kQkBytes + 2 * (kQkBytes + kVBytes) + kVBytes + 8 * 10 + 1024 <= kMaxSmem
          ? 2 : 1;  // K/V ring depth
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQkBytes;
  static constexpr int kV = kK + kStages * kQkBytes;
  static constexpr int kO = kV + kStages * kVBytes;  // output staging
  static constexpr int kBar = kO + kVBytes;
  // mbarriers: Q full, Q empty; per stage K full, V full, K empty, V empty
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages);
  static constexpr int kSmem = kBytes + 1024;  // slack to align the base
  static_assert(kSmem <= kMaxSmem, "the plan exceeds a block's shared memory");
};


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

// LSE: the training instance, which also writes each row's natural-log
// sum of exp(scaled scores) to lse (B, H, S) fp32; the serving instance
// (LSE false) compiles without that store (lse unused).
template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int B, int S, int H,
                   int KV, float scale, int causal, float* __restrict__ lse) {
  using L = Layout<DQK, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t sO = base + L::kO;
  // mbarriers: Q full, Q empty; per stage K full, V full, K empty, V empty
  const uint32_t bar_q = base + L::kBar, bar_q_empty = bar_q + 8;
  auto bar = [&](int kind, int s) {
    return bar_q + 8u * (2 + kind * L::kStages + s);
  };
  enum { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };
  const int works = ((S + kTile - 1) / kTile) * H * B;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumerThreads);
    for (int s = 0; s < L::kStages; ++s) {
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
      for (int r = 0; r * (int)gridDim.x < works; ++r) {
        const int w = snake(r);
        if (w >= works) continue;
        const Work t = work_tile(w, S, H, B, causal);
        const int kvh = t.h / (H / KV);
        mbar_wait(bar_q_empty, (j & 1) ^ 1);
        mbar_expect_tx(bar_q, L::kQkBytes);
        for (int x = 0; x < L::kQkBoxes; ++x)
          tma_load_4d(sQ + x * kBoxBytes, &tq, x * kBoxCols, t.h, t.q0, t.b, bar_q);
        // kv tile n of this work tile into ring position it + n: K (v 0) or
        // V (v 1), once the consumers have freed its slot
        auto load = [&](int v, int n) {
          const int pos = it + n, s = pos % L::kStages;
          mbar_wait(bar(v ? V_EMPTY : K_EMPTY, s), ((pos / L::kStages) & 1) ^ 1);
          const int bytes = v ? L::kVBytes : L::kQkBytes;
          mbar_expect_tx(bar(v ? V_FULL : K_FULL, s), bytes);
          const uint32_t dst = (v ? sV : sK) + s * bytes;
          for (int x = 0; x < (v ? L::kVBoxes : L::kQkBoxes); ++x)
            tma_load_4d(dst + x * kBoxBytes, v ? &tv : &tk, x * kBoxCols, kvh,
                        n * kTile, t.b, bar(v ? V_FULL : K_FULL, s));
        };
        if constexpr (L::kStages == 1) {
          // one stage: K of tile n + 1 goes ahead of V of tile n. Its slot
          // frees when q k^T of tile n is done, V's only when p v of tile
          // n - 1 is (issued a step later), so K loads while the softmax
          // and that p v run: K0 V0 K1 K2 V1 K3 V2 .. V(nk-1)
          load(0, 0);
          load(1, 0);
          for (int n = 1; n < t.nk; ++n) {
            load(0, n);
            if (n >= 2) load(1, n - 1);
          }
          if (t.nk >= 2) load(1, t.nk - 1);
        } else {
          for (int n = 0; n < t.nk; ++n) {
            load(0, n);
            load(1, n);
          }
        }
        it += t.nk;
        ++j;
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

  float acc[L::kCols / 2];
  float sc[64];
  uint32_t pa[8][4];
  int it = 0;  // K/V ring position, as the producer counts it

  // S = q k^T of ring slot `slot` into sc: 64 x 128, ceil(DQK / 16) steps
  // of depth 16 (32 bytes of a 128-byte row; box x holds columns 64 x .. 64
  // x + 63), none over the padding past DQK's last 16-column step
  auto issue_qk = [&](int slot) {
    const uint32_t kt = sK + (slot % L::kStages) * L::kQkBytes;
#pragma unroll
    for (int kk = 0; kk < L::kQkSteps; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128(sc, gmma_desc(sQ + off + c * 64 * 128, 16, 1024),
                    gmma_desc(kt + off, 16, 1024), kk > 0);
    }
  };
  // o += p v of ring slot `slot`: 8 steps of 16 kv rows (2 KiB of V a box
  // each), over the padded DV
  auto issue_pv = [&](int slot) {
    const uint32_t vt = sV + (slot % L::kStages) * L::kVBytes;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_pv<L::kCols, kBoxBytes>(acc, pa[kk], vt + kk * 16 * 128);
  };
  auto fence_sc = [&] {
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
  };
  auto fence_acc = [&] {
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pa[kk][e]);
  };
  auto parity = [](int slot) { return (uint32_t)((slot / L::kStages) & 1); };

  int j = 0;
  for (int r = 0; r * (int)gridDim.x < works; ++r) {
    const int w = snake(r);
    if (w >= works) continue;
    const Work t = work_tile(w, S, H, B, causal);
    const int nk = t.nk, row0 = t.q0 + r0, first = it;
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2], corr[2], rs[2];

    // kv tile 0: q k^T, then its softmax
    mbar_wait(bar_q, j & 1);
    mbar_wait(bar(K_FULL, first % L::kStages), parity(first));
    fence_sc();
    wgmma_fence();
    issue_qk(first);
    wgmma_commit();
    wgmma_wait<0>();
    fence_sc();
    mbar_arrive(bar(K_EMPTY, first % L::kStages));
    if (nk == 1) mbar_arrive(bar_q_empty);  // Q's last use in this tile
    softmax_tile(sc, m, corr, rs, sl2, nk == 1, row0, c2, S, causal);
    l[0] = rs[0];
    l[1] = rs[1];
    pack_p(pa, sc);

    // kv tile n's q k^T runs beside tile n - 1's p v; tile n's softmax runs
    // while that p v finishes
    for (int n = 1; n < nk; ++n) {
      const int cur = first + n, prev = cur - 1;
      mbar_wait(bar(K_FULL, cur % L::kStages), parity(cur));
      fence_sc();
      fence_acc();
      wgmma_fence();
      issue_qk(cur);
      wgmma_commit();
      mbar_wait(bar(V_FULL, prev % L::kStages), parity(prev));
      issue_pv(prev);
      wgmma_commit();
      wgmma_wait<1>();  // q k^T of tile n has landed
      fence_sc();
      mbar_arrive(bar(K_EMPTY, cur % L::kStages));
      if (n == nk - 1) mbar_arrive(bar_q_empty);
      softmax_tile(sc, m, corr, rs, sl2, n == nk - 1, row0, n * kTile + c2, S,
                   causal);
      wgmma_wait<0>();  // p v of tile n - 1 has landed
      fence_acc();
      mbar_arrive(bar(V_EMPTY, prev % L::kStages));
#pragma unroll
      for (int i = 0; i < L::kCols / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      // l is this thread's share of the row sum; the quad adds at the end
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
      pack_p(pa, sc);
    }
    // the last kv tile's p v
    const int last = first + nk - 1;
    mbar_wait(bar(V_FULL, last % L::kStages), parity(last));
    fence_acc();
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    mbar_arrive(bar(V_EMPTY, last % L::kStages));
    it += nk;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
    }
    const float d0 = 1.f / fmaxf(l[0], 1e-30f), d1 = 1.f / fmaxf(l[1], 1e-30f);
    if constexpr (LSE) {
      // sum_j exp(scale s_j) = 2^m l: the log-sum-exp of rows r0, r0 + 8 in
      // natural units, once a quad
      if ((lane & 3) == 0) {
        float* lrow = lse + ((long long)t.b * H + t.h) * S;
        if (row0 < S) lrow[row0] = (m[0] + log2f(l[0])) * kLn2;
        if (row0 + 8 < S) lrow[row0 + 8] = (m[1] + log2f(l[1])) * kLn2;
      }
    }
    // epilogue: this warpgroup's 64 rows into the staging tile in TMA's
    // 128-byte swizzled layout (16-byte chunk k of row r at chunk k ^ (r % 8):
    // a warp's 8 rows land on 32 distinct banks), then one TMA store a box.
    // The staging tile is free once the last tile's stores have read it.
    const int wg_bar = 1 + c;  // named barriers 1 and 2, one a warpgroup
    if (lt == 0) bulk_wait_read();
    named_sync(wg_bar, kWg);
    const int rr = r0 % 8;  // rows r0 and r0 + 8 share their swizzle phase
#pragma unroll
    for (int jj = 0; jj < DV / 8; ++jj) {
      const uint32_t chunk = (uint32_t)(((jj % 8) ^ rr) * 16 + c2 * 2);
      const uint32_t row_a = sO + (jj / 8) * kBoxBytes + r0 * 128 + chunk;
      st_shared_u32(row_a, pack_f32(acc[4 * jj] * d0, acc[4 * jj + 1] * d0));
      st_shared_u32(row_a + 8 * 128,
                    pack_f32(acc[4 * jj + 2] * d1, acc[4 * jj + 3] * d1));
    }
    fence_async_shared();
    named_sync(wg_bar, kWg);
    if (lt == 0) {
      for (int x = 0; x < L::kVBoxes; ++x)
        tma_store_4d(&to, sO + x * kBoxBytes + c * 64 * 128, x * kBoxCols, t.h,
                     t.q0 + 64 * c, t.b);
      bulk_commit();
    }
    ++j;
  }
  if (lt == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------


template <int DQK, int DV, bool LSE>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int S, int H, int KV, float scale, int causal,
                        cudaStream_t stream) {
  using L = Layout<DQK, DV>;
  // the shared-memory opt-in above the 48 KB default is a property of the
  // function, so each instance sets it once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<DQK, DV, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, B, S, H, DQK) || !make_map(&tk, k, B, S, KV, DQK) ||
      !make_map(&tv, v, B, S, KV, DV) || !make_map(&to, o, B, S, H, DV, 64))
    return cudaErrorInvalidValue;
  // persistent: one CTA an SM (the shared memory allows no more), each
  // taking work tiles blockIdx.x, 2 grid - 1 - blockIdx.x, ... (snake)
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const long long works = (long long)((S + kTile - 1) / kTile) * H * B;
  const int grid = (int)(works < sms ? works : sms);
  flash_fwd_bf16<DQK, DV, LSE><<<grid, kFlashThreads, L::kSmem, stream>>>(
      tq, tk, tv, to, B, S, H, KV, scale, causal, lse);
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

// shared memory of the fp32 kernel: Q and K tiles at DQK, V at DV, P
template <int DQK, int DV>
constexpr size_t f32_smem() {
  return ((size_t)2 * kF32Rows * (DQK + 1) + (size_t)kF32Rows * (DV + 1) +
          (size_t)kF32Rows * (kF32Rows + 1)) *
         sizeof(float);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int H,
                  int KV, float scale, int causal, float* __restrict__ lse) {
  constexpr int LDQ = DQK + 1, LDV = DV + 1;
  constexpr int LDP = kF32Rows + 1;
  extern __shared__ float smf[];
  float* Qs = smf;
  float* Ks = Qs + kF32Rows * LDQ;
  float* Vs = Ks + kF32Rows * LDQ;
  float* Ps = Vs + kF32Rows * LDV;

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const float* qb = q + ((long long)b * S * H + h) * DQK;
  const float* kb = k + ((long long)b * S * KV + kvh) * DQK;
  const float* vb = v + ((long long)b * S * KV + kvh) * DV;
  float* ob = o + ((long long)b * S * H + h) * DV;

  load_tile_f32<LDQ>(Qs, qb, (long long)H * DQK, q0, S, DQK);

  const int r = threadIdx.x >> 1, par = threadIdx.x & 1;
  const float* qrow = Qs + r * LDQ;
  float* prow = Ps + r * LDP;
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int nk = kv_tiles_f32(S, q0, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kF32Rows;
    __syncthreads();
    load_tile_f32<LDQ>(Ks, kb, (long long)KV * DQK, k0, S, DQK);
    load_tile_f32<LDV>(Vs, vb, (long long)KV * DV, k0, S, DV);
    __syncthreads();

    // score columns 2j + par of row r
    float s[kF32Rows / 2];
#pragma unroll
    for (int j = 0; j < kF32Rows / 2; ++j) s[j] = 0.f;
    for (int d = 0; d < DQK; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kF32Rows / 2; ++j)
        s[j] = fmaf(qd, Ks[(2 * j + par) * LDQ + d], s[j]);
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
    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr;
    for (int j = 0; j < kF32Rows; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * LDV + par;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = fmaf(p, vrow[2 * i], acc[i]);
    }
  }
  l += __shfl_xor_sync(kFull, l, 1);
  const float den = fmaxf(l, 1e-30f);
  if (lse != nullptr && par == 0 && q0 + r < S)
    lse[((long long)b * H + h) * S + q0 + r] = m + logf(l);
  if (q0 + r < S) {
    float* orow = ob + (long long)(q0 + r) * H * DV + par;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) orow[2 * i] = acc[i] / den;
  }
}

template <int DQK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int S, int H, int KV, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem<DQK, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, H, B);
  flash_fwd_f32<DQK, DV><<<grid, kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KV, scale,
      causal, lse);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     int B, int S, int H, int KV, float scale, int causal, int is_bf16,
                     cudaStream_t stream) {
  if (!is_bf16)
    return launch_f32<DQK, DV>(q, k, v, o, lse, B, S, H, KV, scale, causal, stream);
  if (lse != nullptr)
    return launch_bf16<DQK, DV, true>(q, k, v, o, lse, B, S, H, KV, scale, causal,
                                      stream);
  return launch_bf16<DQK, DV, false>(q, k, v, o, nullptr, B, S, H, KV, scale, causal,
                                     stream);
}

// the width pairs with an instance, as one key
constexpr int width_key(int dqk, int dv) { return dqk * 1024 + dv; }

}  // namespace

// q (B, S, H, dqk), k (B, S, KV, dqk), v (B, S, KV, dv), out (B, S, H,
// dv): contiguous, 16-byte aligned, bf16 (is_bf16) or fp32; (dqk, dv) one
// of (16, 16), (64, 64), (128, 128), (160, 160), (96, 64), (24, 16); H % KV
// == 0; B, S >= 1. scale is 1/sqrt(dqk). lse: null (serving), or (B, H, S)
// fp32 that receives each row's log-sum-exp of the scaled scores
// (training). Returns cudaGetLastError() (or cudaErrorInvalidValue for a
// width pair without an instance, or when a tensor map cannot be made).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, float* lse, int B, int S, int H, int KV,
                                     int dqk, int dv, float scale, int causal,
                                     int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FLASH_CASE(A, C) \
  case width_key(A, C):        \
    return (int)dispatch<A, C>(q, k, v, out, lse, B, S, H, KV, scale, causal, is_bf16, s);
  switch (width_key(dqk, dv)) {
    REPRO_FLASH_CASE(16, 16)
    REPRO_FLASH_CASE(64, 64)
    REPRO_FLASH_CASE(128, 128)
    REPRO_FLASH_CASE(160, 160)
    REPRO_FLASH_CASE(96, 64)
    REPRO_FLASH_CASE(24, 16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

// Dynamic shared memory a CTA of the bf16 kernel asks for at widths (dqk,
// dv) (0 for a pair without an instance).
extern "C" int repro_flash_attention_smem(int dqk, int dv) {
  switch (width_key(dqk, dv)) {
    case width_key(16, 16): return Layout<16, 16>::kSmem;
    case width_key(64, 64): return Layout<64, 64>::kSmem;
    case width_key(128, 128): return Layout<128, 128>::kSmem;
    case width_key(160, 160): return Layout<160, 160>::kSmem;
    case width_key(96, 64): return Layout<96, 64>::kSmem;
    case width_key(24, 16): return Layout<24, 16>::kSmem;
    default: return 0;
  }
}

// Causal or bidirectional GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). q (B, S, H, hd), k and v (B, S, KV, hd),
// out (B, S, H, hd), all contiguous in that public layout and read strided
// (no transposing copies). Query head h reads KV head h / (H / KV), as the
// TPU kernel's index map does, so K/V are never replicated in memory.
// out = softmax(q k^T * scale [+ causal mask]) v with scale = 1/sqrt(hd)
// (passed in), masked scores set to -1e30, an online softmax (running
// max m, sum l and accumulator in fp32) and out = acc / max(l, 1e-30) in
// q's dtype. Any S >= 1: rows and columns past S are masked here (the TPU
// kernel needs S to be a multiple of its block), so every S the TPU kernel
// takes gives the same function.
//
// Bound: operations at the serving path's shape (B 4, S 1024, H 32, hd
// 128, causal: 34.4 GFLOP of products against 84 MB of q, k, v and out).
//
// Design: one CTA of 128 threads per (64-row query tile, head, batch);
// query tiles are walked from the last one down, so the longest causal rows
// start first. The CTA walks 64-row K/V tiles staged in shared memory (rows
// zero-filled past S); under causal it stops at the diagonal tile, which it
// masks. No atomics: the order of every sum is fixed by the layout, so a
// run gives the same bits every time.
//   bf16 (the serving path): each warp owns 16 query rows and runs
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate) for q k^T and for p v.
//     The q fragments stay in registers; the score fragment of q k^T is
//     reused as the A operand of p v, rounded to bf16 (as the reference's
//     einsum attention rounds its probabilities to bf16 before p v). m, l
//     and the accumulator stay fp32; the softmax runs in log2 units
//     (exp2). K/V tiles are double-buffered: cp.async 16-byte copies of
//     tile k+1 fly while tile k is computed, one barrier a tile.
//     Shared-memory rows are padded by 8 elements, so fragment loads hit 32
//     distinct banks.
//   fp32 (tests): FMA loops over synchronously staged tiles. Thread pair
//     (2r, 2r+1) owns query row r and splits the score columns and the
//     output columns between them by parity; probabilities go through
//     shared memory for p v. Rows padded by one float.
// Shared memory a CTA: bf16 45 KiB (hd 64) or 85 KiB (hd 128), fp32 65 or
// 113 KiB; each instance opts in above the 48 KiB default once, with
// cudaFuncSetAttribute.
// wgmma, TMA and warp specialisation are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;  // query rows a CTA
constexpr int kBk = 64;  // K/V rows a tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int kv_tiles(int S, int q0, int causal) {
  const int all = (S + kBk - 1) / kBk;
  if (!causal) return all;
  const int last = (q0 + kBq - 1) / kBk;  // the tile holding the diagonal
  return last + 1 < all ? last + 1 : all;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// 16-byte global -> shared copy that bypasses registers (and L1); with
// ok false it writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 64 rows of HD bf16 from rows row0.. of a strided matrix into shared rows of
// LD elements, asynchronously; rows at or past S are zero.
template <int HD, int LD>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const uint16_t* src,
                                               long long row_stride, int row0,
                                               int S) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kBk * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * LD + c * 8,
               src + (long long)(ok ? row0 + r : 0) * row_stride + c * 8, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int S,
                   int H, int KV, float scale, int causal) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Kbuf = Qs + kBq * LD;      // two stages of K
  uint16_t* Vbuf = Kbuf + 2 * kBk * LD;  // two stages of V

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const uint16_t* qb = q + ((long long)b * S * H + h) * HD;
  const uint16_t* kb = k + ((long long)b * S * KV + kvh) * HD;
  const uint16_t* vb = v + ((long long)b * S * KV + kvh) * HD;
  uint16_t* ob = o + ((long long)b * S * H + h) * HD;

  load_tile_bf16<HD, LD>(Qs, qb, q_stride, q0, S);
  load_tile_bf16<HD, LD>(Kbuf, kb, kv_stride, 0, S);
  load_tile_bf16<HD, LD>(Vbuf, vb, kv_stride, 0, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint16_t* p0 = Qs + r0 * LD + ks * 16 + t4 * 2;
    const uint16_t* p1 = p0 + 8 * LD;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int nk = kv_tiles(S, q0, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBk;
    // tile kt has landed, and every warp is done with tile kt - 1, whose
    // stage the next tile's copies now fill while this one is computed
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nk) {
      const int nxt = (kt + 1) & 1;
      load_tile_bf16<HD, LD>(Kbuf + nxt * kBk * LD, kb, kv_stride, k0 + kBk, S);
      load_tile_bf16<HD, LD>(Vbuf + nxt * kBk * LD, vb, kv_stride, k0 + kBk, S);
      cp_async_commit();
    }
    const uint16_t* Ks = Kbuf + (kt & 1) * kBk * LD;
    const uint16_t* Vs = Vbuf + (kt & 1) * kBk * LD;

    float s[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < kBk / 8; ++nt) {
        const uint16_t* kp = Ks + (nt * 8 + g) * LD + ks * 16 + t4 * 2;
        mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }

    // scale, mask, new running max (rows r0 and r0 + 8 are shared by the
    // four threads of a quad)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + (e >> 1) * 8;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * sl2;  // scores in log2 units
        if (col >= S || (causal && col > row)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    // l is this thread's share of the row sum; the quad adds at the end
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // acc += p v: the C fragments of two neighbouring 8-column score tiles
    // are the A fragment of one 16-deep step
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const uint16_t* vp = Vs + (kk * 16 + t4 * 2) * LD + dt * 8 + g;
        mma_bf16(acc[dt], pa, pack_u16(vp[0], vp[LD]),
                 pack_u16(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * q_stride + col) =
          pack_f32(acc[dt][0] / d0, acc[dt][1] / d0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row1 * q_stride + col) =
          pack_f32(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA loops
// ---------------------------------------------------------------------------

template <int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0, int S,
                                              int hd) {
  for (int i = threadIdx.x; i < kBk * hd; i += kThreads) {
    const int r = i / hd, c = i % hd;
    dst[r * LD + c] = row0 + r < S ? src[(long long)(row0 + r) * row_stride + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int H,
                  int KV, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int LDP = kBk + 1;
  extern __shared__ float smf[];
  float* Qs = smf;
  float* Ks = Qs + kBq * LD;
  float* Vs = Ks + kBk * LD;
  float* Ps = Vs + kBk * LD;

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBq;
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

  const int nk = kv_tiles(S, q0, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();
    load_tile_f32<LD>(Ks, kb, kv_stride, k0, S, HD);
    load_tile_f32<LD>(Vs, vb, kv_stride, k0, S, HD);
    __syncthreads();

    // score columns 2j + par of row r
    float s[kBk / 2];
#pragma unroll
    for (int j = 0; j < kBk / 2; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kBk / 2; ++j)
        s[j] = fmaf(qd, Ks[(2 * j + par) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBk / 2; ++j) {
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
    for (int j = 0; j < kBk / 2; ++j) {
      const float p = expf(s[j] - m);
      rs += p;
      prow[2 * j + par] = p;
    }
    l = l * corr + rs;  // this thread's share; the pair adds at the end
    __syncwarp();       // row r's probabilities come from this thread pair
    // output columns 2i + par of row r
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr;
    for (int j = 0; j < kBk; ++j) {
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

// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, int, int, int,
                                  float, int),
                   cudaError_t attr, size_t smem, const void* q, const void* k,
                   const void* v, void* o, int B, int S, int H, int KV, float scale,
                   int causal, cudaStream_t stream) {
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBq - 1) / kBq, H, B);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                           (T*)o, S, H, KV, scale, causal);
  return cudaGetLastError();
}

// The shared-memory opt-in above the 48 KB default is a property of the
// function, so each instance sets it once (the statics below).
template <int HD>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int S, int H, int KV, float scale, int causal, int is_bf16,
                     cudaStream_t stream) {
  if (is_bf16) {
    constexpr size_t smem = (size_t)(kBq + 4 * kBk) * (HD + 8) * sizeof(uint16_t);
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return launch<uint16_t>(flash_fwd_bf16<HD>, attr, smem, q, k, v, o, B, S, H, KV,
                            scale, causal, stream);
  }
  constexpr size_t smem =
      ((size_t)(kBq + 2 * kBk) * (HD + 1) + (size_t)kBq * (kBk + 1)) * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return launch<float>(flash_fwd_f32<HD>, attr, smem, q, k, v, o, B, S, H, KV, scale,
                       causal, stream);
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, KV, hd), out (B, S, H, hd): contiguous,
// 16-byte aligned, bf16 (is_bf16) or fp32; hd 64 or 128; H % KV == 0;
// B, S >= 1. scale is 1/sqrt(hd). Returns cudaGetLastError() (or
// cudaErrorInvalidValue for an hd without an instance).
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

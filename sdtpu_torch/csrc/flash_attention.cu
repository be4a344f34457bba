// Non-causal flash attention over head-major (B*H, L, D) bf16 tensors with
// an f32 online softmax.
//
// * C (flash_attention_launch) replaces sdtpu/kernels/flash_attention.py:
//   flash_attention_packed -> _flash_attention_packed_impl -> _kernel
//   (pallas_call at :267), used by the UNet's self-attention
//   (ops/attention.py) and the VAE mid-block's single-head attention
//   (models/vae.py).
// * F (flash_attention_stats_launch) replaces flash_attention.py:
//   flash_attention_stats -> _kernel(emit_stats=True) (pallas_call at :379),
//   the per-KV-block primitive of ring attention (parallel/ring_attention.py):
//   the same output, normalised over this KV block only, plus each row's
//   max m of the scaled scores and sum l = sum exp(s_j - m), both f32.
// * H (flash_attention_legacy_launch) replaces tools/probe_flash_vpu.py:
//   legacy_flash -> _legacy_kernel (pallas_call at :105), the TPU round-2
//   body kept as a probe.  It runs on C's D <= 160 design below (same plan,
//   tiles, ring and fragments) with only the softmax body swapped, so that
//   H against C prices that body and nothing else.
//
// What C and F compute, per (batch*head, query row), exactly as before:
//   s_j = q . k_j (f32 MMA); keys past Lk are -inf, compared only on the
//     key tile that holds them;
//   running raw max m, p_j = exp2(s_j * c - m * c) with c = log2(e)/sqrt(D)
//     (the scale folded into the subtract as one FFMA, as FlashAttention-2
//     does; ex2.approx.ftz: an input below -126 gives 0, not a denormal);
//   l = sum p_j in f32; acc = sum bf16(p_j) * v_j (P rounded to bf16 before
//     P.V, as the TPU kernel does); out = bf16(acc * (1/l)), 1/l -> 1 where
//     l == 0;
//   F also writes m * c * ln 2 (the natural-log max of s/sqrt(D)) and l.
// What H computes (the TPU's _legacy_kernel, tools/probe_flash_vpu.py:49-98):
//   s_j = f32(q . k_j) * (1/sqrt(D)), the scale its own multiply after the
//     MMA; every key column is compared with the run-time Lk on EVERY tile,
//     a masked one set to NEG_BIG = -0.7 * FLT_MAX (finite, so
//     e(NEG_BIG - m) is 0 and never NaN);
//   running max m of the scaled s, p_j = __expf(s_j - m) (natural units:
//     ex2.approx of (s - m) * log2(e), one multiply more than C's FFMA);
//   l, acc and out as C (P rounded to bf16, 1/l -> 1 where l == 0).
// The head dim is taken as it is: zero-padded to the MMA depth DP inside
// shared memory only (cp.async src-size 0); the output holds D columns.
//
// What bounds it on the H100: at D = 40 the exponential units (16 per clock
// per SM: one exp2 per score costs more than the 4*D tensor operations per
// score), above that the tensor cores and, with mma.sync, the shared-memory
// bandwidth that feeds them (an ldmatrix.x4 moves 512 bytes in 4 clocks of
// the SM's 128 B/clock; one m16n8k16 takes about one clock of the SM's
// tensor rate).  K and V are re-read from L2 by every query tile, so the
// device memory is not the limit at any main-path shape.  What the design
// does about the first version's gaps:
//   * a 2-stage ring of K/V tiles in dynamic shared memory, filled by
//     16-byte cp.async.cg (zero-filled past Lk and past D): the next tile is
//     in flight while the current one is consumed, one barrier per tile;
//   * fragments by ldmatrix.x4 (Q, K) and ldmatrix.x4.trans (V, read
//     row-major straight into the P.V B operand: no transpose in shared
//     memory); rows padded by 16 bytes, so every ldmatrix is conflict-free;
//   * Q held in registers for the whole key loop where DP <= 80;
//   * two independent 16-row tiles per warp at the long sequences (128
//     query rows per block of 4 warps, DP <= 48), sharing every K and V
//     fragment, so one tile's exponentials issue beside the other's MMAs;
//     64 rows (one tile per warp) where 128 would give fewer blocks than
//     SMs (kernels/flash_attention.py:plan_flash).  Smaller tiles that fill
//     the card at the short sequences (16 rows, one warp per block) ran
//     slower than 64-row tiles on fewer SMs at every such main-path and
//     ring shape on the card: each warp then issues all of its tile's
//     copies alone;
//   * 128 keys per tile where DP <= 80 (the 4096- and 1024-token levels),
//     which halves the barriers, row reductions and accumulator rescales per
//     key; at DP = 160 a 128-key tile lost at the ring's 64-key shards;
//   * D > 160 (the VAE's 512): 8 warps on 64 query rows, each warp 16 rows
//     x 256 output columns (S computed by both warps of a row pair), Q in
//     shared memory, 32-key tiles, 195 KB of shared memory: one block of 8
//     warps per SM.  The keys are split over `splits` blocks (plan_flash:
//     at least one block per SM, fewest waves per split); each writes its
//     unnormalised f32 acc, m and l, and the merge kernel combines them in
//     split order with the ring's exact rule (a second launch, counted on
//     its own as flash_attention_merge).
// What is left: TMA and wgmma (the full tensor rate needs wgmma), and a
// smem-staged, coalesced output store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int REG_NW = 4;       // warps per block, D <= 160
constexpr int MT2_MAX_DP = 48;  // the largest depth with two row tiles per warp
constexpr int QREG_MAX_DP = 80; // the largest depth with Q held in registers
constexpr int KV128_MAX_DP = 80;  // the largest depth with 128-key tiles (else 64)
constexpr int WIDE_DP = 512;    // D > 160
constexpr int WIDE_NW = 8;
constexpr int WIDE_BQ = 64;
constexpr int WIDE_BKV = 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// -0.7 * FLT_MAX rounded to f32, the JAX package's _NEG_BIG (H's mask)
__device__ __forceinline__ float neg_big() { return __int_as_float(0xff333332); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b0,
                                         const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + ROWS) of a (L, D) row-major bf16 matrix into shared memory
// at row stride LD elements, DP columns; rows >= L and columns >= D are
// zero-filled.  D % 8 == 0, so a 16-byte chunk is all in or all out.
template <int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int r0, int L, int D,
                                          int tid) {
  constexpr int VPR = DP / 8;
#pragma unroll 4
  for (int i = tid; i < ROWS * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r0 + r < L && c < D;
    cp_async16(dst + (r * LD + c) * 2, ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 16 : 0);
  }
}

// The online-softmax step of one 16-row tile over NS 8-key n-tiles of raw
// scores s (the accumulator layout of m16n8k16: this thread holds rows g
// and g + 8, keys 2t and 2t + 1 of each n-tile).  Masks keys >= Lk when
// `mask`, updates m (raw units) and l, turns s into bf16 P as the A
// operand of P.V (pa), and returns each row's rescale factor.
template <int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                             uint32_t (&pa)[NS / 2][4], float (&alpha)[2],
                                             bool mask, int key0, int Lk, float scale) {
  if (mask) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + nt * 8 + (e & 1) >= Lk) s[nt][e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // every key tile holds at least one key < Lk, so m_new is finite
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = ex2((m[h] - m_new) * scale);  // m = -inf on the first tile: 0
    m[h] = m_new;
    ms[h] = m_new * scale;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = ex2(fmaf(s[nt][e], scale, -ms[e >> 1]));
      l[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int j = 0; j < NS / 2; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// H's online-softmax step, in place of softmax_step: s = raw * scale
// (scale = 1/sqrt(D), a multiply of its own), every key >= Lk set to
// NEG_BIG on every tile, the running max m of the scaled scores (natural
// units), p = __expf(s - m).  Same outputs as softmax_step.
template <int NS>
__device__ __forceinline__ void softmax_step_legacy(float (&s)[NS][4], float (&m)[2],
                                                    float (&l)[2], uint32_t (&pa)[NS / 2][4],
                                                    float (&alpha)[2], int key0, int Lk,
                                                    float scale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = key0 + nt * 8 + (e & 1) < Lk ? s[nt][e] * scale : neg_big();
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = __expf(m[h] - m_new);  // m = -inf on the first tile: 0
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
      l[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int j = 0; j < NS / 2; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// Quad-reduce l, then write one 16-row tile's output (and F's m, l).
template <int NO, bool STATS>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], const float (&m)[2],
                                           float (&l)[2], bf16* ob, float* m_out, float* l_out,
                                           int r0, int col0, int Lq, int D, float scale,
                                           bool write_stats, int t) {
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
  }
  const int r1 = r0 + 8;
  if (STATS && write_stats && t == 0) {
    if (r0 < Lq) {
      m_out[r0] = m[0] * scale * LN2;
      l_out[r0] = l[0];
    }
    if (r1 < Lq) {
      m_out[r1] = m[1] * scale * LN2;
      l_out[r1] = l[1];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    const int col = col0 + nt * 8 + 2 * t;
    if (col >= D) continue;  // D % 8 == 0, so col + 1 < D here
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
}

// ---------------------------------------------------------------- D <= 160 --

template <int DP, int MT, int BKV>
struct RegPlan {
  static constexpr int NT = REG_NW * 32;
  static constexpr int BQ = REG_NW * 16 * MT;
  static constexpr int LD = DP + 8;  // row stride (bf16): 16 bytes of padding
  static constexpr bool QREG = DP <= QREG_MAX_DP;
  static constexpr int KV_ELEMS = BKV * LD;  // one K or V tile
  static constexpr size_t SMEM = (size_t(BQ) * LD + 4 * KV_ELEMS) * 2;  // Q + 2 x (K, V)
};

// grid = (ceil(Lq / BQ), BH); 4 warps, each MT 16-row tiles, BKV keys a tile.
// LEGACY: H's softmax body (softmax_step_legacy) in place of C's.
template <int DP, int MT, int BKV, bool STATS, bool LEGACY>
__global__ void __launch_bounds__(REG_NW * 32) flash_reg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out, int Lq, int Lk,
    int D, float scale) {
  using P = RegPlan<DP, MT, BKV>;
  constexpr int NT = P::NT, BQ = P::BQ, LD = P::LD;
  constexpr int KS = DP / 16;   // k-steps of S = Q K^T
  constexpr int NS = BKV / 8;   // S n-tiles per key tile
  constexpr int NO = DP / 8;    // output n-tiles
  constexpr int QR = P::QREG ? MT : 1, QK = P::QREG ? KS : 1;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + BQ * LD * 2;  // stage st: K at kv_s + st * 4 * KV bytes, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + bh * Lq * D;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  // ldmatrix lane offsets: A (Q) and V^T share one pattern, K another
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int wrow = warp * 16 * MT;
  const int ntiles = (Lk + BKV - 1) / BKV;

  load_tile<BQ, DP, LD, NT>(q_s, qb, q0, Lq, D, tid);
  load_tile<BKV, DP, LD, NT>(kv_s, kb, 0, Lk, D, tid);
  load_tile<BKV, DP, LD, NT>(kv_s + P::KV_ELEMS * 2, vb, 0, Lk, D, tid);
  cp_async_commit();

  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  uint32_t qf[QR][QK][4];

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed for every thread; tile it-1 is consumed
    if (it + 1 < ntiles) {
      const uint32_t st = kv_s + ((it + 1) & 1) * 4 * P::KV_ELEMS;
      load_tile<BKV, DP, LD, NT>(st, kb, (it + 1) * BKV, Lk, D, tid);
      load_tile<BKV, DP, LD, NT>(st + P::KV_ELEMS * 2, vb, (it + 1) * BKV, Lk, D, tid);
      cp_async_commit();
    }
    if (P::QREG && it == 0) {
#pragma unroll
      for (int mt = 0; mt < QR; ++mt)
#pragma unroll
        for (int kk = 0; kk < QK; ++kk)
          ldsm_x4(qf[mt][kk], q_s + ((wrow + 16 * mt + a_row) * LD + kk * 16 + a_col) * 2);
    }
    const uint32_t ks = kv_s + (it & 1) * 4 * P::KV_ELEMS;
    const uint32_t vs = ks + P::KV_ELEMS * 2;

    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (P::QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[mt][r] = qf[P::QREG ? mt : 0][P::QREG ? kk : 0][r];
        } else {
          ldsm_x4(a[mt], q_s + ((wrow + 16 * mt + a_row) * LD + kk * 16 + a_col) * 2);
        }
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks + ((np * 16 + b_row) * LD + kk * 16 + b_col) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    const int k0 = it * BKV;
    const bool mask = k0 + BKV > Lk;  // block-uniform
    uint32_t pa[MT][NS / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float alpha[2];
      if constexpr (LEGACY)
        softmax_step_legacy<NS>(s[mt], m[mt], l[mt], pa[mt], alpha, k0 + 2 * t, Lk, scale);
      else
        softmax_step<NS>(s[mt], m[mt], l[mt], pa[mt], alpha, mask, k0 + 2 * t, Lk, scale);
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        acc[mt][nt][0] *= alpha[0];
        acc[mt][nt][1] *= alpha[0];
        acc[mt][nt][2] *= alpha[1];
        acc[mt][nt][3] *= alpha[1];
      }
    }
    // O += P V: each V fragment feeds every row tile of the warp
#pragma unroll
    for (int j = 0; j < NS / 2; ++j)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + ((j * 16 + a_row) * LD + np * 16 + a_col) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], pa[mt][j], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], pa[mt][j], b[2], b[3]);
        }
      }
  }

  const int g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<NO, STATS>(acc[mt], m[mt], l[mt], o + bh * Lq * D, m_out + (STATS ? bh * Lq : 0),
                          l_out + (STATS ? bh * Lq : 0), q0 + wrow + 16 * mt + g, 0, Lq, D,
                          scale, true, t);
}

template <int DP, int MT, int BKV, bool STATS, bool LEGACY>
cudaError_t launch_reg(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                       int BH, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  using P = RegPlan<DP, MT, BKV>;
  auto kern = flash_reg_kernel<DP, MT, BKV, STATS, LEGACY>;
  if (P::SMEM > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Lq + P::BQ - 1) / P::BQ, BH);
  kern<<<grid, P::NT, P::SMEM, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                    static_cast<const bf16*>(v), static_cast<bf16*>(o), m, l, Lq,
                                    Lk, D, scale);
  return cudaGetLastError();
}

// The query tile bq the plan chose: 128 (two row tiles per warp, DP <= 48)
// or 64 (one); anything else is refused.
template <int DP, bool STATS, bool LEGACY = false>
cudaError_t by_tile(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                    int BH, int Lq, int Lk, int D, int bq, float sc, cudaStream_t s) {
  constexpr int BKV = DP <= KV128_MAX_DP ? 128 : 64;
  if (bq == 128) {
    if constexpr (DP <= MT2_MAX_DP) return launch_reg<DP, 2, BKV, STATS, LEGACY>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
    return cudaErrorInvalidValue;
  }
  if (bq == 64) return launch_reg<DP, 1, BKV, STATS, LEGACY>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  return cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- D > 160 --

struct WidePlan {
  static constexpr int NT = WIDE_NW * 32;
  static constexpr int LD = WIDE_DP + 8;
  static constexpr int KV_ELEMS = WIDE_BKV * LD;
  static constexpr size_t SMEM = (size_t(WIDE_BQ) * LD + 4 * KV_ELEMS) * 2;  // 199,680 B
};

// grid = (ceil(Lq / 64), splits, BH).  Warp w: rows 16 * (w & 3), output
// columns 256 * (w >> 2) .. + 255.  Split sp takes key tiles
// [sp * n / splits, (sp + 1) * n / splits) of the n = ceil(Lk / 32); with
// splits > 1 it writes ws: acc (splits, BH, Lq, 512) f32 unnormalised, then
// m (splits, BH, Lq) in log2 units (m * c), then l (splits, BH, Lq).
template <bool STATS>
__global__ void __launch_bounds__(WIDE_NW * 32, 1) flash_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ ws, int Lq, int Lk, int D, float scale) {
  using P = WidePlan;
  constexpr int NT = P::NT, LD = P::LD, BQ = WIDE_BQ, BK = WIDE_BKV;
  constexpr int KS = WIDE_DP / 16;  // 32 k-steps
  constexpr int NS = BK / 8;        // 4 S n-tiles
  constexpr int NO = 256 / 8;       // 32 output n-tiles per warp

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + BQ * LD * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3, g = lane >> 2;
  const int splits = gridDim.y, sp = blockIdx.y;
  const int BH = gridDim.z;
  const size_t bh = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + bh * Lq * D;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int wrow = (warp & 3) * 16, col0 = (warp >> 2) * 256;
  const int n_all = (Lk + BK - 1) / BK;
  const int t_begin = (int)((long long)sp * n_all / splits);
  const int t_end = (int)((long long)(sp + 1) * n_all / splits);

  load_tile<BQ, WIDE_DP, LD, NT>(q_s, qb, q0, Lq, D, tid);
  load_tile<BK, WIDE_DP, LD, NT>(kv_s, kb, t_begin * BK, Lk, D, tid);
  load_tile<BK, WIDE_DP, LD, NT>(kv_s + P::KV_ELEMS * 2, vb, t_begin * BK, Lk, D, tid);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = t_begin; it < t_end; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < t_end) {
      const uint32_t st = kv_s + ((it + 1 - t_begin) & 1) * 4 * P::KV_ELEMS;
      load_tile<BK, WIDE_DP, LD, NT>(st, kb, (it + 1) * BK, Lk, D, tid);
      load_tile<BK, WIDE_DP, LD, NT>(st + P::KV_ELEMS * 2, vb, (it + 1) * BK, Lk, D, tid);
      cp_async_commit();
    }
    const uint32_t ks = kv_s + ((it - t_begin) & 1) * 4 * P::KV_ELEMS;
    const uint32_t vs = ks + P::KV_ELEMS * 2;

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_s + ((wrow + a_row) * LD + kk * 16 + a_col) * 2);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks + ((np * 16 + b_row) * LD + kk * 16 + b_col) * 2);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    const int k0 = it * BK;
    uint32_t pa[NS / 2][4];
    float alpha[2];
    softmax_step<NS>(s, m, l, pa, alpha, k0 + BK > Lk, k0 + 2 * t, Lk, scale);
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NS / 2; ++j)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + ((j * 16 + a_row) * LD + col0 + np * 16 + a_col) * 2);
        mma_bf16(acc[2 * np], pa[j], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa[j], b[2], b[3]);
      }
  }

  const int r0 = q0 + wrow + g;
  if (splits == 1) {
    store_rows<NO, STATS>(acc, m, l, o + bh * Lq * D, m_out + (STATS ? bh * Lq : 0),
                          l_out + (STATS ? bh * Lq : 0), r0, col0, Lq, D, scale, warp < 4, t);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t rows = (size_t)BH * Lq;
  const size_t row0 = (size_t)sp * rows + bh * Lq;  // this split's first row of this head
  float* wa = ws + row0 * WIDE_DP;
  float* wm = ws + (size_t)splits * rows * WIDE_DP + row0;
  float* wl = wm + (size_t)splits * rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= Lq) continue;
    if (warp < 4 && t == 0) {
      wm[r] = m[h] * scale;
      wl[r] = l[h];
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(wa + (size_t)r * WIDE_DP + col) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

template <bool STATS>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                        float* ws, int BH, int Lq, int Lk, int D, int splits, float scale,
                        cudaStream_t s) {
  using P = WidePlan;
  auto kern = flash_wide_kernel<STATS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + WIDE_BQ - 1) / WIDE_BQ, splits, BH);
  kern<<<grid, P::NT, P::SMEM, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                    static_cast<const bf16*>(v), static_cast<bf16*>(o), m, l, ws,
                                    Lq, Lk, D, scale);
  return cudaGetLastError();
}

// The merge of the wide plan's key splits, one thread per (row, 4 output
// columns), in split order: M = max_s m_s, w_s = exp2(m_s - M),
// L = sum_s w_s l_s, out = bf16(sum_s w_s acc_s * (1/L)) with 1/L -> 1 where
// L == 0; STATS also writes M * ln 2 and L.
template <bool STATS>
__global__ void __launch_bounds__(256) flash_merge_kernel(const float* __restrict__ ws,
                                                          bf16* __restrict__ o,
                                                          float* __restrict__ m_out,
                                                          float* __restrict__ l_out, long long rows,
                                                          int D, int splits) {
  const int groups = D / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * groups) return;
  const long long row = i / groups;
  const int c = (int)(i % groups) * 4;
  const float* wm = ws + (size_t)splits * rows * WIDE_DP;
  const float* wl = wm + (size_t)splits * rows;
  float mx = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, wm[sp * rows + row]);
  float L = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    const float w = ex2(wm[sp * rows + row] - mx);
    L = fmaf(w, wl[sp * rows + row], L);
    const float4 x = *reinterpret_cast<const float4*>(ws + (sp * rows + row) * WIDE_DP + c);
    a[0] = fmaf(w, x.x, a[0]);
    a[1] = fmaf(w, x.y, a[1]);
    a[2] = fmaf(w, x.z, a[2]);
    a[3] = fmaf(w, x.w, a[3]);
  }
  const float inv = L == 0.f ? 1.f : 1.f / L;
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0] * inv, a[1] * inv);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2] * inv, a[3] * inv);
  uint2 pk;
  pk.x = *reinterpret_cast<uint32_t*>(&lo);
  pk.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o + row * D + c) = pk;
  if (STATS && c == 0) {
    m_out[row] = mx * LN2;
    l_out[row] = L;
  }
}

template <bool STATS>
int dispatch(const void* q, const void* k, const void* v, void* o, float* m, float* l, float* ws,
             int BH, int Lq, int Lk, int D, int bq, int splits, void* stream) {
  if (D % 8 || D <= 0 || D > WIDE_DP || Lq <= 0 || Lk <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const float sc = LOG2E / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 160) {
    const int n_tiles = (Lk + WIDE_BKV - 1) / WIDE_BKV;
    if (bq != WIDE_BQ || splits < 1 || splits > n_tiles || splits > 65535 ||
        (splits > 1 && ws == nullptr))
      return (int)cudaErrorInvalidValue;
    return (int)launch_wide<STATS>(q, k, v, o, m, l, ws, BH, Lq, Lk, D, splits, sc, s);
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  if (D <= 32) return (int)by_tile<32, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 48) return (int)by_tile<48, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 64) return (int)by_tile<64, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 80) return (int)by_tile<80, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 96) return (int)by_tile<96, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 128) return (int)by_tile<128, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, bq, sc, s);
  return (int)by_tile<160, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, bq, sc, s);
}

// Kernel H's dispatch: C's D <= 160 plans with H's body.
int dispatch_legacy(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
                    int D, int bq, void* stream) {
  if (D % 8 || D <= 0 || D > 160 || Lq <= 0 || Lk <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const float sc = 1.f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr float* no = nullptr;
  if (D <= 32) return (int)by_tile<32, false, true>(q, k, v, o, no, no, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 48) return (int)by_tile<48, false, true>(q, k, v, o, no, no, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 64) return (int)by_tile<64, false, true>(q, k, v, o, no, no, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 80) return (int)by_tile<80, false, true>(q, k, v, o, no, no, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 96) return (int)by_tile<96, false, true>(q, k, v, o, no, no, BH, Lq, Lk, D, bq, sc, s);
  if (D <= 128) return (int)by_tile<128, false, true>(q, k, v, o, no, no, BH, Lq, Lk, D, bq, sc, s);
  return (int)by_tile<160, false, true>(q, k, v, o, no, no, BH, Lq, Lk, D, bq, sc, s);
}

}  // namespace

// The tiles the plan (kernels/flash_attention.py:plan_flash) must assume:
// 0 the largest depth with 128-row tiles, 1 query rows and 2 keys per tile
// of the wide plan, 3 its padded depth.
extern "C" int flash_attention_tile(int i) {
  switch (i) {
    case 0: return MT2_MAX_DP;
    case 1: return WIDE_BQ;
    case 2: return WIDE_BKV;
    case 3: return WIDE_DP;
  }
  return -1;
}

// Kernel C.  q: (BH, Lq, D), k/v: (BH, Lk, D), o: (BH, Lq, D), all bf16 and
// contiguous; D a multiple of 8 and at most 512; (bq, splits) from the plan,
// ws the wide plan's f32 workspace of splits * BH * Lq * 514 floats where
// splits > 1 (else null).  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* ws, int BH, int Lq, int Lk, int D, int bq, int splits,
                                      void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, static_cast<float*>(ws), BH, Lq, Lk, D,
                         bq, splits, stream);
}

// Kernel F: as C, plus m and l, each (BH, Lq) f32 and contiguous (written
// by the merge where splits > 1).
extern "C" int flash_attention_stats_launch(const void* q, const void* k, const void* v, void* o,
                                            void* m, void* l, void* ws, int BH, int Lq, int Lk,
                                            int D, int bq, int splits, void* stream) {
  return dispatch<true>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
                        static_cast<float*>(ws), BH, Lq, Lk, D, bq, splits, stream);
}

// The merge of a wide call's key splits: ws as written by C or F, o (BH, Lq,
// D) bf16; m and l (BH, Lq) f32 for F, both null for C.
extern "C" int flash_attention_merge_launch(const void* ws, void* o, void* m, void* l, int BH,
                                            int Lq, int D, int splits, void* stream) {
  if (D % 8 || D <= 160 || D > WIDE_DP || Lq <= 0 || BH <= 0 || splits < 2 ||
      (m == nullptr) != (l == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)BH * Lq, n = rows * (D / 4);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  bf16* out = static_cast<bf16*>(o);
  if (m != nullptr)
    flash_merge_kernel<true><<<blocks, 256, 0, s>>>(w, out, static_cast<float*>(m),
                                                    static_cast<float*>(l), rows, D, splits);
  else
    flash_merge_kernel<false><<<blocks, 256, 0, s>>>(w, out, nullptr, nullptr, rows, D, splits);
  return (int)cudaGetLastError();
}

// Kernel H: as C's arguments without the workspace and the splits; D a
// multiple of 8 and at most 160, bq the query tile from the plan.
extern "C" int flash_attention_legacy_launch(const void* q, const void* k, const void* v,
                                             void* o, int BH, int Lq, int Lk, int D, int bq,
                                             void* stream) {
  return dispatch_legacy(q, k, v, o, BH, Lq, Lk, D, bq, stream);
}

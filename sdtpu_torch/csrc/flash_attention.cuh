// The flash-attention kernel template shared by flash_attention.cu (kernels
// C, F and H) and flash_nq.cu (kernel I): non-causal attention over
// head-major (B*H, L, D) bf16 tensors with an f32 online softmax.
//
// What it computes, per (batch*head, query row):
//   s_j = q . k_j * scale                   (f32, after the MMA)
//   running max m, running sum l = sum e(s_j - m) in f32
//   acc = sum bf16(e(s_j - m)) * v_j        (P rounded to bf16 before P.V,
//                                            as the TPU kernels do)
//   out = bf16(acc * (1/l)), with 1/l -> 1 where l == 0 (acc is 0 there)
// MODE picks the exponential, the mask and what is written:
//   MODE_C, MODE_STATS: e = exp2f, scale = log2(e)/sqrt(D) (log2 units);
//     keys past Lk are -inf, compared only on the tile that holds them
//     (k0 + BKV > Lk), as the TPU kernel masks only where there is padding.
//     MODE_STATS also writes m (back in natural-log units) and l.
//   MODE_LEGACY (kernel H): e = __expf, scale = 1/sqrt(D) (natural units);
//     every key column is compared with the run-time Lk on EVERY tile and a
//     masked one set to NEG_BIG = -0.7 * FLT_MAX, finite, so e(NEG_BIG - m)
//     is 0 and never NaN.  __expf is ex2.approx of x * log2(e): exactly the
//     exp2 of C plus the multiply that C's folded scale saves, which is the
//     difference the TPU probe measured.  The accurate expf would add a
//     range reduction that neither TPU body had.
//   MODE_NQ (kernel I): e = __expf and scale = 1/sqrt(D) as H, the key mask
//     only on the tile that holds keys past Lk, as C (NEG_BIG there).
// The head dim is taken as it is: zero-padded to the MMA depth DP inside
// shared memory only; the output holds exactly D columns.
//
// Tiling: one block per (batch*head, tile of NW*16*MT query rows); each of
// the NW warps owns MT independent 16-row tiles, each with its own m, l and
// output accumulator in registers (the S accumulator's layout is the P
// operand's layout, so S and P never leave registers).  Per KV tile the
// warp issues the S = Q K^T MMAs of all its MT row tiles first, then runs
// softmax and P.V tile by tile, so one tile's exponentials can issue while
// the next tile's MMAs are in flight.  Only the current K tile and a
// transposed V tile sit in shared memory, shared by every warp.  Loads are
// synchronous 16-byte loads (no cp.async/TMA ring, no wgmma).
//
// OSMEM (D = 512, kernel C only): a 64 x 512 f32 accumulator does not fit
// in registers, so 32-row query tiles of 2 warps and 32-key tiles keep it
// in dynamic shared memory (each thread owns a fixed float4 slice, so there
// are no bank conflicts), 173 KB per block after cudaFuncSetAttribute.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

enum { MODE_C = 0, MODE_STATS = 1, MODE_LEGACY = 2, MODE_NQ = 3 };

// -0.7 * FLT_MAX rounded to f32, the JAX package's _NEG_BIG
__device__ __forceinline__ float neg_big() { return __int_as_float(0xff333332); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MODE>
__device__ __forceinline__ float expo(float x) {
  if (MODE == MODE_C || MODE == MODE_STATS) return exp2f(x);
  return __expf(x);
}

template <int DP, int NW, int MT, int BKV, bool OSMEM>
struct Plan {
  static_assert(!OSMEM || MT == 1, "the shared-memory accumulator plan has one row tile");
  static constexpr int NT = NW * 32;
  static constexpr int BQ = NW * 16 * MT;
  static constexpr int LDQ = DP + 8;   // Q and K row stride (bf16)
  static constexpr int LDV = BKV + 8;  // transposed V row stride (bf16)
  static constexpr size_t Q_BYTES = size_t(BQ) * LDQ * 2;
  static constexpr size_t K_BYTES = size_t(BKV) * LDQ * 2;
  static constexpr size_t V_BYTES = size_t(DP) * LDV * 2;
  // each thread owns DP/8 float4 accumulator slices (16 rows x DP per warp)
  static constexpr size_t O_BYTES = OSMEM ? size_t(NT) * (DP / 8) * 16 : 0;
  static constexpr size_t SMEM = Q_BYTES + K_BYTES + V_BYTES + O_BYTES;
};

template <int DP, int NW, int MT, int BKV, bool OSMEM, int MODE>
__global__ void __launch_bounds__(NW * 32) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out,
    int Lq, int Lk, int D, float scale) {
  using P = Plan<DP, NW, MT, BKV, OSMEM>;
  constexpr int NT = P::NT, BQ = P::BQ, LDQ = P::LDQ, LDV = P::LDV;
  constexpr int VPR = DP / 8;   // 16-byte vectors per padded row
  constexpr int NS = BKV / 8;   // S n-tiles per key tile
  constexpr int NO = DP / 8;    // output n-tiles
  constexpr int NOR = OSMEM ? 1 : NO;  // output n-tiles held in registers

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + P::Q_BYTES);
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(smem + P::Q_BYTES + P::K_BYTES);
  float4* Ot = reinterpret_cast<float4*>(smem + P::Q_BYTES + P::K_BYTES + P::V_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + bh * Lq * D;
  const __nv_bfloat16* kb = k + bh * Lk * D;
  const __nv_bfloat16* vb = v + bh * Lk * D;
  __nv_bfloat16* ob = o + bh * Lq * D;

  for (int i = tid; i < BQ * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Lq && c < D)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(&Qs[r * LDQ + c]) = val;
  }

  float oreg[MT][NOR][4];
  if (OSMEM) {
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) Ot[nt * NT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NOR; ++nt)
        oreg[mt][nt][0] = oreg[mt][nt][1] = oreg[mt][nt][2] = oreg[mt][nt][3] = 0.f;
  }
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = -INFINITY;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }
  // this thread's rows in row tile mt: row0 + 16 * mt and row0 + 16 * mt + 8
  const int row0 = warp * 16 * MT + g;

  for (int k0 = 0; k0 < Lk; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int i = tid; i < BKV * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < Lk && c < D) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDQ + c]) = kv;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T for every row tile of this warp; each K fragment is loaded
    // once and feeds all MT tiles.
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* pq = &Qs[(row0 + 16 * mt) * LDQ + kk + 2 * t];
        a[mt][0] = ld32(pq);
        a[mt][1] = ld32(pq + 8 * LDQ);
        a[mt][2] = ld32(pq + 8);
        a[mt][3] = ld32(pq + 8 * LDQ + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const __nv_bfloat16* pk = &Ks[(nt * 8 + g) * LDQ + kk + 2 * t];
        const uint32_t b0 = ld32(pk), b1 = ld32(pk + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(s[mt][nt], a[mt], b0, b1);
      }
    }

    // The key mask: on every tile in MODE_LEGACY, else only on the tile
    // that holds keys past Lk (block-uniform, so no divergence).
    const bool mask = MODE == MODE_LEGACY || k0 + BKV > Lk;
    const float masked = (MODE == MODE_C || MODE == MODE_STATS) ? -INFINITY : neg_big();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
      if (mask) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + nt * 8 + 2 * t + (e & 1);
            s[mt][nt][e] = key < Lk ? s[mt][nt][e] * scale : masked;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][nt][e]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][nt][e] *= scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][nt][e]);
          }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[mt][h], mx[h]);
        alpha[h] = expo<MODE>(m_r[mt][h] - m_new);
        m_r[mt][h] = m_new;
        l_r[mt][h] *= alpha[h];
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] = expo<MODE>(s[mt][nt][e] - m_r[mt][e >> 1]);
          l_r[mt][e >> 1] += s[mt][nt][e];
        }
      // P as the A operand of P.V (bf16), straight from the S registers.
      uint32_t pa[NS / 2][4];
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        pa[j][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
        pa[j][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
        pa[j][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
        pa[j][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        float c[4];
        if (OSMEM) {
          const float4 f = Ot[nt * NT + tid];
          c[0] = f.x; c[1] = f.y; c[2] = f.z; c[3] = f.w;
        } else {
          c[0] = oreg[mt][OSMEM ? 0 : nt][0]; c[1] = oreg[mt][OSMEM ? 0 : nt][1];
          c[2] = oreg[mt][OSMEM ? 0 : nt][2]; c[3] = oreg[mt][OSMEM ? 0 : nt][3];
        }
        c[0] *= alpha[0]; c[1] *= alpha[0]; c[2] *= alpha[1]; c[3] *= alpha[1];
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          const __nv_bfloat16* pv = &Vt[(nt * 8 + g) * LDV + j * 16 + 2 * t];
          mma_bf16(c, pa[j], ld32(pv), ld32(pv + 8));
        }
        if (OSMEM) {
          Ot[nt * NT + tid] = make_float4(c[0], c[1], c[2], c[3]);
        } else {
          oreg[mt][OSMEM ? 0 : nt][0] = c[0]; oreg[mt][OSMEM ? 0 : nt][1] = c[1];
          oreg[mt][OSMEM ? 0 : nt][2] = c[2]; oreg[mt][OSMEM ? 0 : nt][3] = c[3];
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[mt][h] += __shfl_xor_sync(0xffffffffu, l_r[mt][h], 1);
      l_r[mt][h] += __shfl_xor_sync(0xffffffffu, l_r[mt][h], 2);
      inv[h] = l_r[mt][h] == 0.f ? 1.f : 1.f / l_r[mt][h];
    }
    const int r0 = q0 + row0 + 16 * mt, r1 = r0 + 8;
    if (MODE == MODE_STATS && t == 0) {
      // m_r is in log2 units (scores scaled by log2(e)/sqrt(D)); ln 2 turns
      // it back into the natural-log max of the scaled scores
      constexpr float LN2 = 0.6931471805599453f;
      if (r0 < Lq) {
        m_out[bh * Lq + r0] = m_r[mt][0] * LN2;
        l_out[bh * Lq + r0] = l_r[mt][0];
      }
      if (r1 < Lq) {
        m_out[bh * Lq + r1] = m_r[mt][1] * LN2;
        l_out[bh * Lq + r1] = l_r[mt][1];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col >= D) continue;  // D % 8 == 0, so col + 1 < D here
      float c[4];
      if (OSMEM) {
        const float4 f = Ot[nt * NT + tid];
        c[0] = f.x; c[1] = f.y; c[2] = f.z; c[3] = f.w;
      } else {
        c[0] = oreg[mt][OSMEM ? 0 : nt][0]; c[1] = oreg[mt][OSMEM ? 0 : nt][1];
        c[2] = oreg[mt][OSMEM ? 0 : nt][2]; c[3] = oreg[mt][OSMEM ? 0 : nt][3];
      }
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + col) =
            __floats2bfloat162_rn(c[0] * inv[0], c[1] * inv[0]);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + col) =
            __floats2bfloat162_rn(c[2] * inv[1], c[3] * inv[1]);
    }
  }
}

template <int DP, int NW, int MT, int BKV, bool OSMEM, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* m,
                   float* l, int BH, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  using P = Plan<DP, NW, MT, BKV, OSMEM>;
  auto kern = flash_kernel<DP, NW, MT, BKV, OSMEM, MODE>;
  if (P::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Lq + P::BQ - 1) / P::BQ, BH);
  kern<<<grid, P::NT, P::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), m, l,
      Lq, Lk, D, scale);
  return cudaGetLastError();
}

}  // namespace flash

// Non-causal flash attention over head-major (B*H, L, D) bf16 tensors with
// an f32 online softmax, in two compile-time modes of one kernel:
//
// * C (STATS = false) replaces sdtpu/kernels/flash_attention.py:
//   flash_attention_packed -> _flash_attention_packed_impl -> _kernel, used
//   by the UNet's self-attention (ops/attention.py) and the VAE mid-block's
//   single-head attention (models/vae.py).
// * F (STATS = true) replaces sdtpu/kernels/flash_attention.py:
//   flash_attention_stats -> _kernel(emit_stats=True), the per-KV-block
//   primitive of ring attention (parallel/ring_attention.py): the same
//   output, normalised over this KV block only, plus each row's running max
//   m of the scaled scores and running sum l = sum exp(s_j - m), both f32,
//   from which the ring merges its blocks exactly.  Both plans write them:
//   one row's l is spread over the four lanes of an mma.sync quad (each
//   lane sums its own key columns), so the quad reduces it before lane 0
//   writes m and l once.
//
// What it computes, per (batch*head, query row):
//   s_j = q . k_j / sqrt(D)                 (f32, keys j < Lk only)
//   running max m, running sum l = sum exp(s_j - m) in f32
//   acc = sum bf16(exp(s_j - m)) * v_j      (P rounded to bf16 before P.V,
//                                            as the TPU kernel does)
//   out = bf16(acc * (1/l)), with 1/l -> 1 where l == 0 (acc is 0 there)
//   F only: m_out = m (natural-log units), l_out = l
// The head dim is taken as it is (40/80/160/512 on the main path): it is
// zero-padded to the MMA depth inside shared memory only (40 -> 48), and the
// output holds exactly D columns.
//
// What bounds it on the H100 at the main path's shapes: the tensor cores.
// At L = 4096 keys the two products do 4*L*D operations per query row
// against 4*D bytes of q and out, and K/V are re-read from L2, not device
// memory, so every shape is above the ~295 op/byte ridge.  The design is the
// FlashAttention-2 register scheme with mma.sync m16n8k16: one block per
// (batch*head, tile of 16*NW query rows), each warp owns 16 rows; S and P
// stay in registers (the S accumulator's layout is the P operand's layout),
// only the current K tile and a transposed V tile sit in shared memory.
// Loads are synchronous 16-byte loads (no cp.async/TMA ring, no wgmma):
// those are the known gaps to the bound.  F at the ring's shard shapes (a
// quarter of the rows against a quarter of the keys, n = 4) has a sixteenth
// of a C call's work on a quarter of its grid (16 blocks at D = 160), so
// there it is bound by too few blocks and by the host-side launch loop.
//
// D <= 160 keeps the output accumulator in registers (64-row query tiles,
// 64-key tiles).  The VAE's D = 512 does not fit that plan (a 64 x 512 f32
// accumulator alone is 128 KB), so it gets its own tiling: 32-row query
// tiles of 2 warps, 32-key tiles, and the accumulator in dynamic shared
// memory (each thread owns a fixed float4 slice, so there are no bank
// conflicts), 173 KB per block after cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <int DP, int NW, int BKV, bool OSMEM>
struct Plan {
  static constexpr int NT = NW * 32;
  static constexpr int BQ = NW * 16;
  static constexpr int LDQ = DP + 8;   // Q and K row stride (bf16)
  static constexpr int LDV = BKV + 8;  // transposed V row stride (bf16)
  static constexpr size_t Q_BYTES = size_t(BQ) * LDQ * 2;
  static constexpr size_t K_BYTES = size_t(BKV) * LDQ * 2;
  static constexpr size_t V_BYTES = size_t(DP) * LDV * 2;
  // each thread owns DP/8 float4 accumulator slices (16 rows x DP per warp)
  static constexpr size_t O_BYTES = OSMEM ? size_t(NT) * (DP / 8) * 16 : 0;
  static constexpr size_t SMEM = Q_BYTES + K_BYTES + V_BYTES + O_BYTES;
};

template <int DP, int NW, int BKV, bool OSMEM, bool STATS>
__global__ void __launch_bounds__(NW * 32) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out,
    int Lq, int Lk, int D, float scale_log2) {
  using P = Plan<DP, NW, BKV, OSMEM>;
  constexpr int NT = P::NT, BQ = P::BQ, LDQ = P::LDQ, LDV = P::LDV;
  constexpr int VPR = DP / 8;   // 16-byte vectors per padded row
  constexpr int NS = BKV / 8;   // S n-tiles per key tile
  constexpr int NO = DP / 8;    // output n-tiles

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

  float oreg[OSMEM ? 1 : NO][4];
  if (OSMEM) {
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) Ot[nt * NT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int nt = 0; nt < (OSMEM ? 1 : NO); ++nt)
      oreg[nt][0] = oreg[nt][1] = oreg[nt][2] = oreg[nt][3] = 0.f;
  }
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int row = warp * 16 + g;  // this thread's rows: row, row + 8

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

    // S = Q K^T for this warp's 16 rows x BKV keys.
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      const __nv_bfloat16* pq = &Qs[row * LDQ + kk + 2 * t];
      a[0] = ld32(pq);
      a[1] = ld32(pq + 8 * LDQ);
      a[2] = ld32(pq + 8);
      a[3] = ld32(pq + 8 * LDQ + 8);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const __nv_bfloat16* pk = &Ks[(nt * 8 + g) * LDQ + kk + 2 * t];
        mma_bf16(s[nt], a, ld32(pk), ld32(pk + 8));
      }
    }

    // Online softmax (log2 domain); keys past Lk are masked out.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = key < Lk ? s[nt][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[nt][e];
      }
    // P as the A operand of P.V (bf16), straight from the S registers.
    uint32_t pa[NS / 2][4];
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      float c[4];
      if (OSMEM) {
        const float4 f = Ot[nt * NT + tid];
        c[0] = f.x; c[1] = f.y; c[2] = f.z; c[3] = f.w;
      } else {
        c[0] = oreg[OSMEM ? 0 : nt][0]; c[1] = oreg[OSMEM ? 0 : nt][1];
        c[2] = oreg[OSMEM ? 0 : nt][2]; c[3] = oreg[OSMEM ? 0 : nt][3];
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
        oreg[OSMEM ? 0 : nt][0] = c[0]; oreg[OSMEM ? 0 : nt][1] = c[1];
        oreg[OSMEM ? 0 : nt][2] = c[2]; oreg[OSMEM ? 0 : nt][3] = c[3];
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    inv[h] = l_r[h] == 0.f ? 1.f : 1.f / l_r[h];
  }
  const int r0 = q0 + row, r1 = r0 + 8;
  if (STATS && t == 0) {
    // m_r is in log2 units (scores scaled by log2(e)/sqrt(D)); ln 2 turns
    // it back into the natural-log max of the scaled scores
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < Lq) {
      m_out[bh * Lq + r0] = m_r[0] * LN2;
      l_out[bh * Lq + r0] = l_r[0];
    }
    if (r1 < Lq) {
      m_out[bh * Lq + r1] = m_r[1] * LN2;
      l_out[bh * Lq + r1] = l_r[1];
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
      c[0] = oreg[OSMEM ? 0 : nt][0]; c[1] = oreg[OSMEM ? 0 : nt][1];
      c[2] = oreg[OSMEM ? 0 : nt][2]; c[3] = oreg[OSMEM ? 0 : nt][3];
    }
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + col) =
          __floats2bfloat162_rn(c[0] * inv[0], c[1] * inv[0]);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + col) =
          __floats2bfloat162_rn(c[2] * inv[1], c[3] * inv[1]);
  }
}

template <int DP, int NW, int BKV, bool OSMEM, bool STATS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* m,
                   float* l, int BH, int Lq, int Lk, int D, float scale_log2,
                   cudaStream_t s) {
  using P = Plan<DP, NW, BKV, OSMEM>;
  auto kern = flash_kernel<DP, NW, BKV, OSMEM, STATS>;
  if (P::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Lq + P::BQ - 1) / P::BQ, BH);
  kern<<<grid, P::NT, P::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), m, l,
      Lq, Lk, D, scale_log2);
  return cudaGetLastError();
}

template <bool STATS>
int dispatch(const void* q, const void* k, const void* v, void* o, float* m, float* l,
             int BH, int Lq, int Lk, int D, void* stream) {
  if (D % 8 || D <= 0 || D > 512 || Lq <= 0 || Lk <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const float sl = 1.4426950408889634f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch<32, 4, 64, false, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
  if (D <= 48) return (int)launch<48, 4, 64, false, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
  if (D <= 64) return (int)launch<64, 4, 64, false, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
  if (D <= 80) return (int)launch<80, 4, 64, false, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
  if (D <= 96) return (int)launch<96, 4, 64, false, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
  if (D <= 128) return (int)launch<128, 4, 64, false, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
  if (D <= 160) return (int)launch<160, 4, 64, false, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
  return (int)launch<512, 2, 32, true, STATS>(q, k, v, o, m, l, BH, Lq, Lk, D, sl, s);
}

}  // namespace

// Kernel C.  q: (BH, Lq, D), k/v: (BH, Lk, D), o: (BH, Lq, D), all bf16 and
// contiguous.  D must be a multiple of 8 and at most 512.  Returns a
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int BH, int Lq, int Lk, int D,
                                      void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, BH, Lq, Lk, D, stream);
}

// Kernel F: as C, plus m and l, each (BH, Lq) f32 and contiguous.
extern "C" int flash_attention_stats_launch(const void* q, const void* k, const void* v,
                                            void* o, void* m, void* l, int BH, int Lq,
                                            int Lk, int D, void* stream) {
  return dispatch<true>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l), BH,
                        Lq, Lk, D, stream);
}

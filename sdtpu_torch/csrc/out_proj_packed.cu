// Attention out-projection with the residual add, read straight from the
// head-major attention output:
//
//   out[b, l, c] = bf16( (sum_h sum_j o[b, h, l, j] * w[h, j, c] + bias[c])
//                        + residual[b, l, c] )
//
// accumulated in f32 and rounded once, to the residual's dtype (bf16).
//
// Replaces the TPU kernel sdtpu/kernels/flash_attention.py: out_proj_packed
// -> _out_proj_kernel, which the flash route of the self-attention
// (ops/attention.py) takes with SDTPU_PACKED_OUT_PROJ=1 wherever it has a
// residual: each UNet attn1 and the VAE mid-block attention.  There the
// kernel sums the heads over a sequential grid axis into an f32 scratch;
// here the heads are part of the contraction: one GEMM with M = B*L rows,
// N = C columns and K = H*D, where row m = (b, l) and k = (h, j) gather
// o[b, h, l, j].  D % 8 == 0, so an aligned 8-element vector of K never
// straddles two heads, and no permuted copy of o is made.  The port keeps
// the real head dim (40/80/160/512 on the main path), so K has no padding.
//
// What bounds it on the H100 at the main path's shapes: device memory.
// K = C (320..1280) against o, residual and out of B*L*C bf16 each gives
// about C/3 operations per byte, under the ~295 op/byte bf16 ridge for
// every shape but C = 1280, which sits near it.  The design is a plain
// mma.sync m16n8k16 tile GEMM: 64x64 output tiles of 4 warps (2x2, each
// 32x32), K in chunks of 64 through shared memory with synchronous 16-byte
// loads, W transposed into shared memory on the way in (the B operand of
// row.col wants k contiguous), bias and residual added in the epilogue.
// No cp.async/TMA ring and no wgmma: those are the known gaps to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, KC = 64, NT = 128;
constexpr int LDS = KC + 8;  // shared row stride (bf16) of both tiles

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NT) out_proj_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, int H, int L, int D, int C, int M) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDS];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bt[BN * LDS];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = H * D;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < BM * (KC / 8); i += NT) {
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      const int kk = k0 + c, m = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && kk < K) {
        const int h = kk / D, j = kk - h * D, b = m / L, l = m - b * L;
        val = *reinterpret_cast<const uint4*>(o + ((size_t)(b * H + h) * L + l) * D + j);
      }
      *reinterpret_cast<uint4*>(&As[r * LDS + c]) = val;
    }
    for (int i = tid; i < KC * (BN / 8); i += NT) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int kk = k0 + r, n = n0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kk < K && n < C) val = *reinterpret_cast<const uint4*>(w + (size_t)kk * C + n);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bt[(c + j) * LDS + r] = e[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* pa = &As[(wm + mt * 16 + g) * LDS + kk + 2 * t];
        a[mt][0] = ld32(pa);
        a[mt][1] = ld32(pa + 8 * LDS);
        a[mt][2] = ld32(pa + 8);
        a[mt][3] = ld32(pa + 8 * LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* pb = &Bt[(wn + nt * 8 + g) * LDS + kk + 2 * t];
        const uint32_t b0 = ld32(pb), b1 = ld32(pb + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  // epilogue: (acc + bias) + residual in f32, one rounding to bf16
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + 2 * t;
    if (col >= C) continue;  // C % 8 == 0, so col + 1 < C here
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm + mt * 16 + g + hr * 8;
        if (row >= M) continue;
        const size_t off = (size_t)row * C + col;
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + off));
        *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(
            (acc[mt][nt][2 * hr] + b0) + r.x, (acc[mt][nt][2 * hr + 1] + b1) + r.y);
      }
  }
}

}  // namespace

// o: (B, H, L, D), w: (H, D, C), residual and out: (B, L, C), all bf16 and
// contiguous; bias: (C,) f32 or null.  D and C must be multiples of 8.
// Returns a cudaError_t.
extern "C" int out_proj_packed_launch(const void* o, const void* w, const void* bias,
                                      const void* residual, void* out, int B, int H, int L,
                                      int D, int C, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || C <= 0 || D % 8 || C % 8)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * L;
  if (M > 0x7fffffffLL - BM || (long long)H * D > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (C + BN - 1) / BN);
  out_proj_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), H, L, D, C, (int)M);
  return (int)cudaGetLastError();
}

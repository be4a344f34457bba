// 3x3 same-pad stride-1 convolution as an implicit GEMM, with the fused
// GroupNorm(+temb)+SiLU prologue, the bias + residual epilogue, optional
// per-channel output moments, and (compile-time UPSAMPLE) a nearest-2x
// upsample folded into the input load.
//
// Replaces the TPU kernel sdtpu/kernels/conv2d.py:conv3x3_gemm_slab ->
// _slab_kernel (reached through gn_silu_conv3x3_slab for the resnets and
// through ops/conv.py:nearest_up_conv2d for the up-blocks).
//
// Kernel E, conv3x3_gemm_launch below, replaces the whole-map TPU kernel
// sdtpu/kernels/conv2d.py:conv3x3_gemm -> _kernel (pallas_call at :606),
// reached through ops/conv.py:conv2d(impl="gemm") where plan_co_tile
// accepts the shape.  It is this kernel with no prologue, no residual, no
// moments and a null bias: the f32 accumulator rounded once to bf16, the
// bias added afterwards in bf16 by the caller, as the TPU kernel leaves it
// to XLA.  Holding the whole padded map in one grid cell is a VMEM
// artefact of the TPU version; here the map is tiled like every other
// conv, so its bound and its gaps are this kernel's (below).
//
// What it computes, per output pixel p = (b, y, x) and output channel co:
//   in(b, u, v, ci) = x(b, u, v, ci)                       (UPSAMPLE: x(b, u/2, v/2, ci))
//   yv = bf16(silu(in * a[b, ci] + c[b, ci]))              (HAS_PRO; else in)
//   yv = 0 where (u, v) is outside the H x W output map    (pad AFTER the prologue)
//   acc = sum_{dy, dx, ci} yv(b, y+dy-1, x+dx-1, ci) * w[dy, dx, ci, co]   (f32)
//   out = bf16(acc + bias[co] + res(b, y, x, co))
//   STATS: part[b, m_tile, 0/1, co] = sum over the tile's pixels of out, out^2
//          (of the bf16-rounded value); the wrapper sums the tiles and
//          divides by H*W.  No atomics, so the moments are deterministic.
//
// What bounds it on the H100 at the main path's shapes: the tensor cores.
// K = 9*Ci is 2880..23040 and every map is at least 16x16x2 pixels, so the
// GEMM does 30..900 operations per byte it must move, above the card's
// ~295 op/byte ridge.  This first version is a plain tiled GEMM: a 128x64
// output tile per 256-thread block, a 32-channel K step staged through
// shared memory with synchronous 16-byte loads, and mma.sync m16n8k16 bf16
// with f32 accumulators in registers (each warp owns a 32x32 sub-tile).  The
// prologue runs on the way into shared memory, so the normalized map never
// exists in device memory; the upsampled map never exists either.  It does
// not overlap loads with the MMAs (no cp.async/TMA ring, no wgmma): that,
// and re-running the prologue's exp once per tap and per 64-channel output
// tile, are the known gaps to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per K step
constexpr int NT = 256;      // 8 warps: 4 along M x 2 along N
constexpr int LDS = BK + 8;  // shared row stride in bf16 (conflict-free frags)

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool UPSAMPLE, bool HAS_PRO, bool HAS_RES, bool STATS>
__global__ void __launch_bounds__(NT) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ x,    // (B, Hin, Win, Ci)
    const __nv_bfloat16* __restrict__ w,    // (3, 3, Ci, Co)
    const float* __restrict__ bias,         // (Co), or null (kernel E)
    const float* __restrict__ pa,           // (B, Ci) prologue scale
    const float* __restrict__ pc,           // (B, Ci) prologue offset
    const __nv_bfloat16* __restrict__ res,  // (B, H, W, Co)
    __nv_bfloat16* __restrict__ out,        // (B, H, W, Co)
    float* __restrict__ part,               // (B, n_mtiles, 2, Co)
    int H, int W, int Ci, int Co) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDS];  // [pixel][ci]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * LDS];  // [co][ci]
  __shared__ float red[2][4][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int HW = H * W;
  const int mt = blockIdx.x, b = blockIdx.z;
  const int m0 = mt * BM, n0 = blockIdx.y * BN;
  const int Hin = UPSAMPLE ? H / 2 : H, Win = UPSAMPLE ? W / 2 : W;
  const __nv_bfloat16* xb = x + (size_t)b * Hin * Win * Ci;

  // A loader: rows ar and ar + 64 of the tile, channels ac..ac+7.
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  int py[2], px[2];
  bool pv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = m0 + ar + r * 64;
    pv[r] = p < HW;
    py[r] = p / W;
    px[r] = p - py[r] * W;
  }
  // B loader: input channel row bk, output channels bn..bn+7.
  const int bk = tid >> 3, bn = (tid & 7) * 8;
  const bool bn_ok = n0 + bn < Co;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const __nv_bfloat16* src[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int iy = py[r] + dy, ix = px[r] + dx;
      const bool ok = pv[r] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      if (UPSAMPLE) {
        iy >>= 1;
        ix >>= 1;
      }
      src[r] = ok ? xb + ((size_t)iy * Win + ix) * Ci : nullptr;
    }
    const __nv_bfloat16* wt = w + (size_t)tap * Ci * Co;

    for (int c0 = 0; c0 < Ci; c0 += BK) {
      const int ci = c0 + ac;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (src[r] != nullptr && ci < Ci) {
          v = *reinterpret_cast<const uint4*>(src[r] + ci);
          if (HAS_PRO) {
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
            const float4 a0 = *reinterpret_cast<const float4*>(pa + b * Ci + ci);
            const float4 a1 = *reinterpret_cast<const float4*>(pa + b * Ci + ci + 4);
            const float4 c0v = *reinterpret_cast<const float4*>(pc + b * Ci + ci);
            const float4 c1v = *reinterpret_cast<const float4*>(pc + b * Ci + ci + 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float cv[8] = {c0v.x, c0v.y, c0v.z, c0v.w,
                                 c1v.x, c1v.y, c1v.z, c1v.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float yv = __bfloat162float(e[i]) * av[i] + cv[i];
              e[i] = __float2bfloat16_rn(yv / (1.f + __expf(-yv)));
            }
          }
        }
        *reinterpret_cast<uint4*>(&As[(ar + r * 64) * LDS + ac]) = v;
      }
      {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        const int k = c0 + bk;
        if (bn_ok && k < Ci)
          v = *reinterpret_cast<const uint4*>(wt + (size_t)k * Co + n0 + bn);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[(bn + i) * LDS + bk] = e[i];
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int im = 0; im < 2; ++im) {
          const __nv_bfloat16* p = &As[(wm * 32 + im * 16 + g) * LDS + kk + 2 * t];
          af[im][0] = ld32(p);
          af[im][1] = ld32(p + 8 * LDS);
          af[im][2] = ld32(p + 8);
          af[im][3] = ld32(p + 8 * LDS + 8);
        }
#pragma unroll
        for (int in = 0; in < 4; ++in) {
          const __nv_bfloat16* p = &Bs[(wn * 32 + in * 8 + g) * LDS + kk + 2 * t];
          bf[in][0] = ld32(p);
          bf[in][1] = ld32(p + 8);
        }
#pragma unroll
        for (int im = 0; im < 2; ++im)
#pragma unroll
          for (int in = 0; in < 4; ++in) mma_bf16(acc[im][in], af[im], bf[in]);
      }
      __syncthreads();
    }
  }

  // Epilogue: bias, residual, bf16 store; moments of the stored value.
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int in = 0; in < 4; ++in) s1[in][0] = s1[in][1] = s2[in][0] = s2[in][1] = 0.f;
#pragma unroll
  for (int in = 0; in < 4; ++in) {
    const int col = n0 + wn * 32 + in * 8 + 2 * t;
    if (col >= Co) continue;  // Co % 8 == 0, so col + 1 < Co here
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int im = 0; im < 2; ++im) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + wm * 32 + im * 16 + g + h * 8;
        if (p >= HW) continue;
        const size_t o = ((size_t)b * HW + p) * Co + col;
        float v0 = acc[im][in][2 * h] + b0, v1 = acc[im][in][2 * h + 1] + b1;
        if (HAS_RES) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(res + o);
          v0 += __low2float(rv);
          v1 += __high2float(rv);
        }
        const __nv_bfloat162 ov = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(out + o) = ov;
        if (STATS) {
          const float f0 = __low2float(ov), f1 = __high2float(ov);
          s1[in][0] += f0;
          s1[in][1] += f1;
          s2[in][0] += f0 * f0;
          s2[in][1] += f1 * f1;
        }
      }
    }
  }
  if (STATS) {
#pragma unroll
    for (int in = 0; in < 4; ++in)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[in][j] += __shfl_xor_sync(0xffffffffu, s1[in][j], off);
          s2[in][j] += __shfl_xor_sync(0xffffffffu, s2[in][j], off);
        }
    if (g == 0) {
#pragma unroll
      for (int in = 0; in < 4; ++in)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          red[0][wm][wn * 32 + in * 8 + 2 * t + j] = s1[in][j];
          red[1][wm][wn * 32 + in * 8 + 2 * t + j] = s2[in][j];
        }
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int q = tid / BN, col = tid % BN;
      if (n0 + col < Co) {
        const float s = red[q][0][col] + red[q][1][col] + red[q][2][col] + red[q][3][col];
        part[(((size_t)b * gridDim.x + mt) * 2 + q) * Co + n0 + col] = s;
      }
    }
  }
}

template <bool UP, bool PRO, bool RES, bool ST>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* x, const void* w,
                   const void* bias, const void* pa, const void* pc,
                   const void* res, void* out, void* part, int H, int W,
                   int Ci, int Co) {
  conv3x3_kernel<UP, PRO, RES, ST><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(pa),
      static_cast<const float*>(pc), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), H, W, Ci, Co);
  return cudaGetLastError();
}

template <bool UP, bool PRO, bool RES>
cudaError_t launch_st(int st, dim3 grid, cudaStream_t s, const void* x,
                      const void* w, const void* bias, const void* pa,
                      const void* pc, const void* res, void* out, void* part,
                      int H, int W, int Ci, int Co) {
  return st ? launch<UP, PRO, RES, true>(grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co)
            : launch<UP, PRO, RES, false>(grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co);
}

template <bool UP, bool PRO>
cudaError_t launch_res(int has_res, int st, dim3 grid, cudaStream_t s,
                       const void* x, const void* w, const void* bias,
                       const void* pa, const void* pc, const void* res,
                       void* out, void* part, int H, int W, int Ci, int Co) {
  return has_res
             ? launch_st<UP, PRO, true>(st, grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co)
             : launch_st<UP, PRO, false>(st, grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co);
}

}  // namespace

// Number of M tiles per image; the moments scratch is (B, tiles, 2, Co).
extern "C" int conv3x3_slab_m_tiles(int H, int W) { return (H * W + BM - 1) / BM; }

// H, W: OUTPUT map size (with upsample != 0, x is (B, H/2, W/2, Ci)).
// pa/pc may be null (no prologue), res may be null, part may be null
// (no moments).  Ci and Co must be multiples of 8.  Returns a cudaError_t.
extern "C" int conv3x3_slab_launch(const void* x, const void* w, const void* bias,
                                   const void* pa, const void* pc, const void* res,
                                   void* out, void* part, int B, int H, int W,
                                   int Ci, int Co, int upsample, void* stream) {
  if (Ci % 8 || Co % 8 || B <= 0 || H <= 0 || W <= 0 || (upsample && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, (Co + BN - 1) / BN, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int st = part != nullptr, has_res = res != nullptr;
  cudaError_t err;
  if (upsample)
    err = pa ? launch_res<true, true>(has_res, st, grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co)
             : launch_res<true, false>(has_res, st, grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co);
  else
    err = pa ? launch_res<false, true>(has_res, st, grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co)
             : launch_res<false, false>(has_res, st, grid, s, x, w, bias, pa, pc, res, out, part, H, W, Ci, Co);
  return (int)err;
}

// Kernel E: bf16(sum of the nine taps' products in f32), no bias.  x is
// (B, H, W, Ci), w (3, 3, Ci, Co), out (B, H, W, Co), all bf16; Ci and Co
// multiples of 8.  Returns a cudaError_t.
extern "C" int conv3x3_gemm_launch(const void* x, const void* w, void* out, int B, int H,
                                   int W, int Ci, int Co, void* stream) {
  if (Ci % 8 || Co % 8 || B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, (Co + BN - 1) / BN, B);
  return (int)launch<false, false, false, false>(grid, static_cast<cudaStream_t>(stream), x,
                                                 w, nullptr, nullptr, nullptr, nullptr, out,
                                                 nullptr, H, W, Ci, Co);
}

// W8A8 3x3 same-pad stride-1 convolution as an implicit GEMM, with the
// fused GroupNorm(+temb)+SiLU prologue quantizing each input channel to an
// int8 affine code in registers, an int32 accumulator, and the per-output-
// channel rescale, bias, residual and optional moments in the epilogue.
//
// Replaces the TPU kernel sdtpu/kernels/conv2d.py:conv3x3_gemm_slab ->
// _slab_kernel with quant=True (an int8 kernel), reached through
// gn_silu_conv3x3_slab from every quantized resnet of the UNet and the VAE
// decoder (sdtpu/utils/quant.py).
//
// What it computes, per output pixel p = (b, y, x) and output channel co:
//   yv = silu(x(b, u, v, ci) * a[b, ci] + c[b, ci])        (f32, never rounded to bf16)
//   q  = clamp(rint(yv * s[ci]) + z[ci], -128, 127)          (s = 1/act_scale; half to even)
//   q  = z[ci] where (u, v) is outside the map               (the pad is the real value 0)
//   acc = sum_{dy, dx, ci} q(b, y+dy-1, x+dx-1, ci) * w[dy, dx, ci, co]   (int32, exact)
//   out = bf16(float(acc) * ws[co] + bias[co] + res(b, y, x, co))
//   STATS: part[b, m_tile, 0/1, co] = sum over the tile's pixels of out, out^2
//          (of the bf16-rounded value); the wrapper sums the tiles.
// bias is the caller's conv bias minus the zero-point correction
// (sdtpu_torch/utils/quant.py:conv_bias_deq).  Every float step is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn), so nvcc
// contracts nothing into an FMA and a code lands where the plain PyTorch
// version puts it; the sigmoid uses the accurate expf, not __expf.
//
// What bounds it on the H100 at the main path's shapes: by bytes and int8
// operations (1979 TOPS) the tensor cores, but in this first version the
// prologue on the CUDA cores.  It is a plain tiled GEMM: a 128x64 output
// tile per 256-thread block, a 32-channel K step staged through shared
// memory with synchronous loads, mma.sync m16n8k32 s8 with int32
// accumulators (each warp owns a 32x32 sub-tile).  The K loop runs channel
// chunks outside and the 9 taps inside, so each thread keeps its 8
// channels' prologue and quantization constants in registers for a whole
// chunk.  The prologue (an expf and a division per element) is redone for
// each of the 9 taps and each 64-wide N tile; staging a haloed slab of codes
// once per chunk, cp.async/TMA and wgmma are the known gaps to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per K step (one m16n8k32 depth)
constexpr int NT = 256;      // 8 warps: 4 along M x 2 along N
constexpr int LDS = BK + 16; // shared row stride in bytes (conflict-free frags)

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The prologue and the quantizer for one element.
__device__ __forceinline__ int8_t quantize(float xv, float a, float c, float s,
                                           float z) {
  const float y = __fadd_rn(__fmul_rn(xv, a), c);
  const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y)));
  const float q = __fadd_rn(rintf(__fmul_rn(__fmul_rn(y, sig), s)), z);
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(q, -128.f), 127.f)));
}

__device__ __forceinline__ void load8(float v[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

template <bool HAS_RES, bool STATS>
__global__ void __launch_bounds__(NT) conv3x3_int8_kernel(
    const __nv_bfloat16* __restrict__ x,    // (B, H, W, Ci)
    const int8_t* __restrict__ w,           // (3, 3, Ci, Co)
    const float* __restrict__ bias,         // (Co) conv bias - zp_corr
    const float* __restrict__ pa,           // (B, Ci) prologue scale
    const float* __restrict__ pc,           // (B, Ci) prologue offset
    const float* __restrict__ qs,           // (Ci) 1 / act_scale
    const float* __restrict__ qz,           // (Ci) act zero point
    const float* __restrict__ ws,           // (Co) weight scale
    const __nv_bfloat16* __restrict__ res,  // (B, H, W, Co)
    __nv_bfloat16* __restrict__ out,        // (B, H, W, Co)
    float* __restrict__ part,               // (B, n_mtiles, 2, Co)
    int H, int W, int Ci, int Co) {
  __shared__ __align__(16) int8_t As[BM * LDS];  // [pixel][ci]
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // [co][ci]
  __shared__ float red[2][4][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int HW = H * W;
  const int mt = blockIdx.x, b = blockIdx.z;
  const int m0 = mt * BM, n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + (size_t)b * HW * Ci;

  // A loader: rows ar and ar + 64 of the tile, channels ac..ac+7 of a chunk.
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

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int c0 = 0; c0 < Ci; c0 += BK) {
    const int ci = c0 + ac;
    float av[8], cv[8], sv[8], zv[8];
    load8(av, pa + (size_t)b * Ci + ci);
    load8(cv, pc + (size_t)b * Ci + ci);
    load8(sv, qs + ci);
    load8(zv, qz + ci);
    alignas(8) int8_t zcode[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) zcode[i] = static_cast<int8_t>(__float2int_rn(zv[i]));

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint2 v = make_uint2(0u, 0u);
        if (pv[r]) {
          const int iy = py[r] + dy, ix = px[r] + dx;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(xb + ((size_t)iy * W + ix) * Ci + ci);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
            alignas(8) int8_t qv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              qv[i] = quantize(__bfloat162float(e[i]), av[i], cv[i], sv[i], zv[i]);
            v = *reinterpret_cast<const uint2*>(qv);
          } else {
            v = *reinterpret_cast<const uint2*>(zcode);
          }
        }
        *reinterpret_cast<uint2*>(&As[(ar + r * 64) * LDS + ac]) = v;
      }
      {
        uint2 v = make_uint2(0u, 0u);
        if (bn_ok)
          v = *reinterpret_cast<const uint2*>(w + ((size_t)tap * Ci + c0 + bk) * Co + n0 + bn);
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[(bn + i) * LDS + bk] = e[i];
      }
      __syncthreads();

      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int im = 0; im < 2; ++im) {
        const int8_t* p = &As[(wm * 32 + im * 16 + g) * LDS + 4 * t];
        af[im][0] = ld32(p);
        af[im][1] = ld32(p + 8 * LDS);
        af[im][2] = ld32(p + 16);
        af[im][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int in = 0; in < 4; ++in) {
        const int8_t* p = &Bs[(wn * 32 + in * 8 + g) * LDS + 4 * t];
        bf[in][0] = ld32(p);
        bf[in][1] = ld32(p + 16);
      }
#pragma unroll
      for (int im = 0; im < 2; ++im)
#pragma unroll
        for (int in = 0; in < 4; ++in) mma_s8(acc[im][in], af[im], bf[in]);
      __syncthreads();
    }
  }

  // Epilogue: per-co rescale, bias, residual, bf16 store; moments of the
  // stored value.
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int in = 0; in < 4; ++in) s1[in][0] = s1[in][1] = s2[in][0] = s2[in][1] = 0.f;
#pragma unroll
  for (int in = 0; in < 4; ++in) {
    const int col = n0 + wn * 32 + in * 8 + 2 * t;
    if (col >= Co) continue;  // Co % 8 == 0, so col + 1 < Co here
    const float b0 = bias[col], b1 = bias[col + 1];
    const float w0 = ws[col], w1 = ws[col + 1];
#pragma unroll
    for (int im = 0; im < 2; ++im) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + wm * 32 + im * 16 + g + h * 8;
        if (p >= HW) continue;
        const size_t o = ((size_t)b * HW + p) * Co + col;
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[im][in][2 * h]), w0), b0);
        float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[im][in][2 * h + 1]), w1), b1);
        if (HAS_RES) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(res + o);
          v0 = __fadd_rn(v0, __low2float(rv));
          v1 = __fadd_rn(v1, __high2float(rv));
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

template <bool RES, bool ST>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* x, const void* w,
                   const void* bias, const void* pa, const void* pc, const void* qs,
                   const void* qz, const void* ws, const void* res, void* out,
                   void* part, int H, int W, int Ci, int Co) {
  conv3x3_int8_kernel<RES, ST><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(pa),
      static_cast<const float*>(pc), static_cast<const float*>(qs),
      static_cast<const float*>(qz), static_cast<const float*>(ws),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), H, W, Ci, Co);
  return cudaGetLastError();
}

}  // namespace

// Number of M tiles per image; the moments scratch is (B, tiles, 2, Co).
extern "C" int conv3x3_slab_int8_m_tiles(int H, int W) { return (H * W + BM - 1) / BM; }

// Every pointer but res and part must be given; res may be null (no
// residual), part may be null (no moments).  Ci must be a multiple of 32
// and Co of 8.  Returns a cudaError_t.
extern "C" int conv3x3_slab_int8_launch(const void* x, const void* w, const void* bias,
                                        const void* pa, const void* pc, const void* qs,
                                        const void* qz, const void* ws, const void* res,
                                        void* out, void* part, int B, int H, int W,
                                        int Ci, int Co, void* stream) {
  if (Ci % BK || Co % 8 || B <= 0 || H <= 0 || W <= 0 || !pa || !pc || !qs || !qz || !ws)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, (Co + BN - 1) / BN, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (res)
    err = part ? launch<true, true>(grid, s, x, w, bias, pa, pc, qs, qz, ws, res, out, part, H, W, Ci, Co)
               : launch<true, false>(grid, s, x, w, bias, pa, pc, qs, qz, ws, res, out, part, H, W, Ci, Co);
  else
    err = part ? launch<false, true>(grid, s, x, w, bias, pa, pc, qs, qz, ws, res, out, part, H, W, Ci, Co)
               : launch<false, false>(grid, s, x, w, bias, pa, pc, qs, qz, ws, res, out, part, H, W, Ci, Co);
  return (int)err;
}

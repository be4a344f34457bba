// W8A8 3x3 same-pad stride-1 convolution as an implicit GEMM: the
// GroupNorm(+temb)+SiLU prologue and the per-channel int8 quantizer as an
// elementwise pre-pass into a zero-point-padded code map, an int8 x int8 ->
// int32 GEMM on a cp.async ring, and the per-output-channel rescale, bias,
// residual and optional moments in its epilogue, or, where the grid is
// short, in a split-K reduction of int32 partial sums.
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
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __frcp_rn), so nvcc
// contracts nothing into an FMA and a code lands where the plain PyTorch
// version puts it; the sigmoid uses the accurate expf, not __expf.
//
// The three kernels, each launched by its own C entry point:
//   conv3x3_int8_prologue_launch  codes(b, u+1, v+1, ci) = q over the map and
//                            z[ci] on its one-pixel ring, 8 channels a
//                            thread: the expf and the reciprocal run once
//                            per input element.
//   conv3x3_slab_int8_launch  the GEMM on the codes: S = 1 writes out (and
//                            the moments); S > 1 writes slice s's int32
//                            partial sums to ws[s] (slices of the flattened
//                            K loop).
//   conv3x3_int8_splitk_reduce_launch  acc = sum_s ws[s] (exact in any
//                            order), then the epilogue above: the same
//                            rounding as S = 1, so a split call is bitwise
//                            equal to the unsplit one.
// The GEMM reads the weights K-major, (3, 3, Co, Ci): the wrapper keeps that
// copy beside each int8 weight tensor, made once.
//
// What bounds it on the H100 at the main path's shapes: the tensor cores
// (K = 9*Ci is 2880..23040; 1979 TOP/s int8 dense).  What this design does
// about the gaps of the first version (the prologue and quantizer redone
// per tap and per 64-wide N tile in the loader, synchronous loads with two
// barriers a 32-byte K step, the weights transposed byte by byte, 40
// blocks on the 16x16 maps):
//   * the pre-pass quantizes each element once (one extra read of the bf16
//     map and one write of the int8 codes); its zero-point ring makes every
//     tap of the GEMM a plain copy: a cp.async zero-fill would write 0,
//     not z, at the border, and bias - zp_corr assumes z at every tap;
//   * a 4-stage cp.async.cg ring over one flattened K loop of 9 taps x
//     ceil(Ci/64) chunks, 64 int8 channels (64 bytes) a step; zero-fill
//     only for a ragged M tile, a ragged Ci chunk (both operands) and a
//     ragged Co;
//   * both operands K-major in shared memory, so ldmatrix.x4 (non-trans)
//     reads the fragments of mma.sync m16n8k32 s8 -> s32 (rows padded by 16
//     bytes: conflict-free);
//   * 128x128 block tiles, 64x32 per warp: 6 ldmatrix per 16 mma.sync;
//   * split-K where the grid is short (plan_conv3x3_int8_split in the
//     wrapper) with int32 partials.
// What is left: wgmma (the full int8 tensor-core rate needs it) and a
// halo tile that would fold the pre-pass back into the load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 128;      // output channels per block
constexpr int BK = 64;       // input channels (bytes) per K step: two m16n8k32 depths
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int NT = 256;      // 8 warps: 2 along M x 4 along N, 64x32 each
constexpr int LDS = BK + 16; // shared row stride in bytes (80: ldmatrix conflict-free)
constexpr int A_STAGE = BM * LDS;
constexpr int B_STAGE = BN * LDS;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);  // 81920
constexpr int RN = 64;       // output channels per block of the split-K reduction
constexpr int QV = 8;        // channels per thread of the pre-pass

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices, i.e. four 8-row x 16-byte int8 tiles.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The prologue and the quantizer for one element.  __frcp_rn is the
// correctly rounded 1/d, the same value as __fdiv_rn(1, d) in fewer
// instructions.
__device__ __forceinline__ int8_t quantize(float xv, float a, float c, float s, float z) {
  const float y = __fadd_rn(__fmul_rn(xv, a), c);
  const float sig = __frcp_rn(__fadd_rn(1.f, expf(-y)));
  const float q = __fadd_rn(rintf(__fmul_rn(__fmul_rn(y, sig), s)), z);
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(q, -128.f), 127.f)));
}

__device__ __forceinline__ void load8(float v[QV], const float* p) {
#pragma unroll
  for (int j = 0; j < QV; j += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + j);
    v[j] = f.x;
    v[j + 1] = f.y;
    v[j + 2] = f.z;
    v[j + 3] = f.w;
  }
}

// codes (B, H+2, W+2, Ci) int8: quantize(x) inside, the zero point on the
// one-pixel ring; 8 channels a thread (16 held the per-channel constants of
// a thread in ~95 registers, and the kernel ran at a quarter occupancy).
__global__ void __launch_bounds__(256) quantize_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ pa,
    const float* __restrict__ pc, const float* __restrict__ qs, const float* __restrict__ qz,
    int8_t* __restrict__ codes, int B, int H, int W, int Ci) {
  const int cv = Ci / QV, Hp = H + 2, Wp = W + 2;
  const long long n = (long long)B * Hp * Wp * cv;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * QV;
    const long long pix = i / cv;
    const int px = (int)(pix % Wp);
    const long long t = pix / Wp;
    const int py = (int)(t % Hp), b = (int)(t / Hp);
    float zv[QV];
    load8(zv, qz + c);
    alignas(8) int8_t q[QV];
    if (py == 0 || py == Hp - 1 || px == 0 || px == Wp - 1) {
#pragma unroll
      for (int j = 0; j < QV; ++j) q[j] = static_cast<int8_t>(__float2int_rn(zv[j]));
    } else {
      float av[QV], cw[QV], sv[QV];
      load8(av, pa + (size_t)b * Ci + c);
      load8(cw, pc + (size_t)b * Ci + c);
      load8(sv, qs + c);
      const uint4 r = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + py - 1) * W + px - 1) * Ci + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int j = 0; j < QV; ++j) q[j] = quantize(__bfloat162float(e[j]), av[j], cw[j], sv[j], zv[j]);
    }
    reinterpret_cast<uint2*>(codes)[i] = *reinterpret_cast<const uint2*>(q);
  }
}

// The GEMM.  grid = (M tiles per image, N tiles, B * S); blockIdx.z = s * B + b.
template <bool SPLIT, bool HAS_RES, bool STATS>
__global__ void __launch_bounds__(NT, 2) conv3x3_int8_kernel(
    const int8_t* __restrict__ codes,       // (B, H+2, W+2, Ci), ring = z
    const int8_t* __restrict__ wk,          // (3, 3, Co, Ci), K-major
    const float* __restrict__ bias,         // (Co) conv bias - zp_corr
    const float* __restrict__ wsc,          // (Co) weight scale
    const __nv_bfloat16* __restrict__ res,  // (B, H, W, Co)
    __nv_bfloat16* __restrict__ out,        // (B, H, W, Co)
    float* __restrict__ part,               // (B, n_mtiles, 2, Co)
    int* __restrict__ ws,                   // (S, B, H, W, Co) int32 partial sums
    int B, int H, int W, int Ci, int Co, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [stage][pixel][ci]
  int8_t* Bs = As + STAGES * A_STAGE;            // [stage][co][ci]
  __shared__ float red[2][2][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int HW = H * W, Wp = W + 2;
  const int mt = blockIdx.x, n0 = blockIdx.y * BN;
  const int b = SPLIT ? (int)blockIdx.z % B : (int)blockIdx.z;
  const int s = SPLIT ? (int)blockIdx.z / B : 0;
  const int m0 = mt * BM;
  const int8_t* cb = codes + (size_t)b * (H + 2) * Wp * Ci;

  const int nch = (Ci + BK - 1) / BK, KT = 9 * nch;
  const int kb = SPLIT ? (int)((long long)s * KT / S) : 0;
  const int ke = SPLIT ? (int)((long long)(s + 1) * KT / S) : KT;
  const int nk = ke - kb;

  // loaders: A tile rows (pixels) and B tile rows (output channels) lr and
  // lr + 64, 16 bytes at lc of the K step
  const int lr = tid >> 2, lc = (tid & 3) * 16;
  size_t a_pix[2];
  bool pv[2], cv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = m0 + lr + r * 64;
    pv[r] = p < HW;
    const int y = pv[r] ? p / W : 0, x = pv[r] ? p - y * W : 0;
    a_pix[r] = ((size_t)y * Wp + x) * Ci;  // the tap (0, 0) of the padded map
    cv[r] = n0 + lr + r * 64 < Co;
  }
  int ld_tap = kb / nch, ld_c0 = (kb % nch) * BK;

  auto load_stage = [&](int slot) {
    const int dy = ld_tap / 3, dx = ld_tap % 3;
    const int ci = ld_c0 + lc;
    const bool cok = ci < Ci;
    const size_t tap_off = ((size_t)dy * Wp + dx) * Ci + ci;
    const uint32_t as = smem_u32(As + slot * A_STAGE);
    const uint32_t bs = smem_u32(Bs + slot * B_STAGE);
    const int8_t* wt = wk + (size_t)ld_tap * Co * Ci;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = pv[r] && cok;
      cp_async16(as + (lr + r * 64) * LDS + lc, ok ? cb + a_pix[r] + tap_off : codes, ok ? 16 : 0);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = cv[r] && cok;
      const int8_t* src = ok ? wt + (size_t)(n0 + lr + r * 64) * Ci + ci : wk;
      cp_async16(bs + (lr + r * 64) * LDS + lc, src, ok ? 16 : 0);
    }
    ld_c0 += BK;
    if (ld_c0 >= Ci) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st);
    cp_async_commit();
  }

  // ldmatrix lane addresses.  A (16 pixels x 32 bytes): rows lane & 15,
  // byte half lane >> 4 -> a0..a3 of m16n8k32.  B (16 channels x 32 bytes,
  // two n8 tiles): rows (lane & 7) + 8 (lane >> 4), byte half (lane >> 3) & 1
  // -> b0, b1 of the first n8 tile, then of the second.
  const int a_off = (wm * 64 + (lane & 15)) * LDS + (lane >> 4) * 16;
  const int b_off = (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 16;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i's stage is in; every warp is done with step i-1's
    if (i + STAGES - 1 < nk) load_stage((i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int slot = i % STAGES;
    const uint32_t a_base = smem_u32(As + slot * A_STAGE) + a_off;
    const uint32_t b_base = smem_u32(Bs + slot * B_STAGE) + b_off;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int im = 0; im < 4; ++im) ldsm_x4(af[im], a_base + im * 16 * LDS + kk);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        uint32_t r[4];
        ldsm_x4(r, b_base + jn * 16 * LDS + kk);
        bfr[2 * jn][0] = r[0];
        bfr[2 * jn][1] = r[1];
        bfr[2 * jn + 1][0] = r[2];
        bfr[2 * jn + 1][1] = r[3];
      }
#pragma unroll
      for (int im = 0; im < 4; ++im)
#pragma unroll
        for (int in = 0; in < 4; ++in) mma_s8(acc[im][in], af[im], bfr[in]);
    }
  }
  cp_async_wait<0>();

  if (SPLIT) {  // int32 partial sums of this slice
    int* wsb = ws + ((size_t)s * B + b) * HW * Co;
#pragma unroll
    for (int in = 0; in < 4; ++in) {
      const int col = n0 + wn * 32 + in * 8 + 2 * t;
      if (col >= Co) continue;  // Co % 8 == 0, so col + 1 < Co here
#pragma unroll
      for (int im = 0; im < 4; ++im)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m0 + wm * 64 + im * 16 + g + h * 8;
          if (p < HW)
            *reinterpret_cast<int2*>(wsb + (size_t)p * Co + col) =
                make_int2(acc[im][in][2 * h], acc[im][in][2 * h + 1]);
        }
    }
    return;
  }

  // Epilogue: per-co rescale, bias, residual, bf16 store; moments of the
  // stored value.
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int in = 0; in < 4; ++in) s1[in][0] = s1[in][1] = s2[in][0] = s2[in][1] = 0.f;
#pragma unroll
  for (int in = 0; in < 4; ++in) {
    const int col = n0 + wn * 32 + in * 8 + 2 * t;
    if (col >= Co) continue;
    const float b0 = bias[col], b1 = bias[col + 1];
    const float w0 = wsc[col], w1 = wsc[col + 1];
#pragma unroll
    for (int im = 0; im < 4; ++im) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + wm * 64 + im * 16 + g + h * 8;
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
    {  // NT == 2 * BN: one (moment, column) per thread
      const int q = tid / BN, col = tid % BN;
      if (n0 + col < Co)
        part[(((size_t)b * gridDim.x + mt) * 2 + q) * Co + n0 + col] =
            red[q][0][col] + red[q][1][col];
    }
  }
}

// acc = sum_{s < S} ws[s] (int32, exact), then out = bf16(float(acc) * ws[co]
// + bias + res) as the unsplit epilogue; moments of the rounded value per
// BM-pixel tile.  grid = (M tiles, ceil(Co/RN), B).
template <bool HAS_RES, bool STATS>
__global__ void __launch_bounds__(256) int8_splitk_reduce_kernel(
    const int* __restrict__ ws, const float* __restrict__ bias, const float* __restrict__ wsc,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int B, int HW, int Co, int S) {
  __shared__ float red[2][8][RN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = tid & 7, rl = tid >> 3;  // 8 chunks of 8 channels x 32 row lanes
  const int mt = blockIdx.x, b = blockIdx.z;
  const int col = blockIdx.y * RN + chunk * 8;
  const bool cok = col < Co;  // Co % 8 == 0: a chunk is all in or all out
  float bv[8], wv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bv[j] = cok ? bias[col + j] : 0.f;
    wv[j] = cok ? wsc[col + j] : 0.f;
  }
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  const size_t slice = (size_t)B * HW * Co;
  for (int r = rl; r < BM; r += 32) {
    const int p = mt * BM + r;
    if (p >= HW || !cok) continue;
    const size_t o = ((size_t)b * HW + p) * Co + col;
    int a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = 0;
    for (int sl = 0; sl < S; ++sl) {
      const int4* src = reinterpret_cast<const int4*>(ws + sl * slice + o);
      const int4 lo = src[0], hi = src[1];
      a[0] += lo.x; a[1] += lo.y; a[2] += lo.z; a[3] += lo.w;
      a[4] += hi.x; a[5] += hi.y; a[6] += hi.z; a[7] += hi.w;
    }
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(__fmul_rn(__int2float_rn(a[j]), wv[j]), bv[j]);
    if (HAS_RES) {
      const uint4 rv = *reinterpret_cast<const uint4*>(res + o);
      const __nv_bfloat16* re = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], __bfloat162float(re[j]));
    }
    uint4 ov;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oe[j] = __float2bfloat16_rn(v[j]);
      const float f = __bfloat162float(oe[j]);
      s1[j] += f;
      s2[j] += f * f;
    }
    *reinterpret_cast<uint4*>(out + o) = ov;
  }
  if (!STATS) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
    }
  if (lane < 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[0][warp][chunk * 8 + j] = s1[j];
      red[1][warp][chunk * 8 + j] = s2[j];
    }
  }
  __syncthreads();
  if (tid < 2 * RN) {
    const int q = tid / RN, c = tid % RN, co = blockIdx.y * RN + c;
    if (co < Co) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += red[q][k][c];
      part[(((size_t)b * gridDim.x + mt) * 2 + q) * Co + co] = sum;
    }
  }
}

template <bool SPLIT, bool RES, bool ST>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* codes, const void* wk,
                   const void* bias, const void* wsc, const void* res, void* out, void* part,
                   void* ws, int B, int H, int W, int Ci, int Co, int S) {
  static bool attr_set = false;  // one per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(conv3x3_int8_kernel<SPLIT, RES, ST>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  conv3x3_int8_kernel<SPLIT, RES, ST><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(wk),
      static_cast<const float*>(bias), static_cast<const float*>(wsc),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(ws), B, H, W, Ci, Co, S);
  return cudaGetLastError();
}

}  // namespace

// The tile sizes the GEMM runs with: which = 0 BM (output pixels per
// block), 1 BN (output channels per block), 2 BK (input channels per K
// step), 3 the ring's stages; -1 for another value.  The wrapper's split
// plan checks them against its own.
extern "C" int conv3x3_slab_int8_tile(int which) {
  const int v[4] = {BM, BN, BK, STAGES};
  return which >= 0 && which < 4 ? v[which] : -1;
}

// Number of M tiles per image; the moments scratch is (B, tiles, 2, Co).
extern "C" int conv3x3_slab_int8_m_tiles(int H, int W) { return (H * W + BM - 1) / BM; }

// codes (B, H+2, W+2, Ci) int8 = the quantized prologue of x (B, H, W, Ci)
// bf16 inside, int8(z) on the ring; pa, pc (B, Ci) f32, qs = 1 / act_scale
// and qz (Ci) f32; Ci a multiple of 8.  Returns a cudaError_t.
extern "C" int conv3x3_int8_prologue_launch(const void* x, const void* pa, const void* pc,
                                            const void* qs, const void* qz, void* codes, int B,
                                            int H, int W, int Ci, void* stream) {
  if (Ci % QV || B <= 0 || H <= 0 || W <= 0 || !x || !pa || !pc || !qs || !qz || !codes)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * (H + 2) * (W + 2) * (Ci / QV);
  const long long blocks = (n + 255) / 256;
  quantize_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(pa),
      static_cast<const float*>(pc), static_cast<const float*>(qs),
      static_cast<const float*>(qz), static_cast<int8_t*>(codes), B, H, W, Ci);
  return (int)cudaGetLastError();
}

// The GEMM on codes (B, H+2, W+2, Ci) and wk (3, 3, Co, Ci) int8.
// splits == 1: writes out (B, H, W, Co) bf16 = bf16(acc * wsc + bias + res)
// and, with part, the moments' partial sums; res and part may be null.
// splits > 1 (at most the 9 * ceil(Ci/64) K steps): writes only ws (splits,
// B, H, W, Co) int32, and bias, wsc, res, out and part must be null (the
// reduction takes them).  Ci a multiple of 16 and Co of 8.  Returns a
// cudaError_t.
extern "C" int conv3x3_slab_int8_launch(const void* codes, const void* wk, const void* bias,
                                        const void* wsc, const void* res, void* out, void* part,
                                        void* ws, int B, int H, int W, int Ci, int Co,
                                        int splits, void* stream) {
  if (Ci % 16 || Co % 8 || B <= 0 || H <= 0 || W <= 0 || !codes || !wk)
    return (int)cudaErrorInvalidValue;
  const int k_steps = 9 * ((Ci + BK - 1) / BK);
  if (splits < 1 || splits > k_steps || (splits > 1) != (ws != nullptr) ||
      (splits > 1 && (bias || wsc || res || out || part)) ||
      (splits == 1 && (!out || !bias || !wsc)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, (Co + BN - 1) / BN, B * splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (splits > 1)
    err = launch<true, false, false>(grid, s, codes, wk, nullptr, nullptr, nullptr, nullptr, nullptr, ws, B, H, W, Ci, Co, splits);
  else if (res)
    err = part ? launch<false, true, true>(grid, s, codes, wk, bias, wsc, res, out, part, nullptr, B, H, W, Ci, Co, 1)
               : launch<false, true, false>(grid, s, codes, wk, bias, wsc, res, out, part, nullptr, B, H, W, Ci, Co, 1);
  else
    err = part ? launch<false, false, true>(grid, s, codes, wk, bias, wsc, res, out, part, nullptr, B, H, W, Ci, Co, 1)
               : launch<false, false, false>(grid, s, codes, wk, bias, wsc, res, out, part, nullptr, B, H, W, Ci, Co, 1);
  return (int)err;
}

// out = bf16(float(sum over the splits of ws) * wsc + bias + res); ws
// (splits, B, H, W, Co) int32; bias and wsc (Co) f32; res (B, H, W, Co) bf16
// and part (B, m_tiles, 2, Co) f32 may be null.  Co a multiple of 8.
// Returns a cudaError_t.
extern "C" int conv3x3_int8_splitk_reduce_launch(const void* ws, const void* bias,
                                                 const void* wsc, const void* res, void* out,
                                                 void* part, int B, int H, int W, int Co,
                                                 int splits, void* stream) {
  if (Co % 8 || B <= 0 || H <= 0 || W <= 0 || splits < 1 || !ws || !bias || !wsc || !out)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, (Co + RN - 1) / RN, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wi = static_cast<const int*>(ws);
  const float* bf = static_cast<const float*>(bias);
  const float* sf = static_cast<const float*>(wsc);
  const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(res);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  float* pf = static_cast<float*>(part);
  const int HW = H * W;
  if (res && part)
    int8_splitk_reduce_kernel<true, true><<<grid, 256, 0, s>>>(wi, bf, sf, rb, ob, pf, B, HW, Co, splits);
  else if (res)
    int8_splitk_reduce_kernel<true, false><<<grid, 256, 0, s>>>(wi, bf, sf, rb, ob, pf, B, HW, Co, splits);
  else if (part)
    int8_splitk_reduce_kernel<false, true><<<grid, 256, 0, s>>>(wi, bf, sf, rb, ob, pf, B, HW, Co, splits);
  else
    int8_splitk_reduce_kernel<false, false><<<grid, 256, 0, s>>>(wi, bf, sf, rb, ob, pf, B, HW, Co, splits);
  return (int)cudaGetLastError();
}

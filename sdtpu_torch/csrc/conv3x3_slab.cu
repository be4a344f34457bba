// 3x3 same-pad stride-1 convolution as an implicit GEMM, with the
// GroupNorm(+temb)+SiLU prologue as an elementwise pre-pass, the bias +
// residual epilogue, optional per-channel output moments, (compile-time
// UPSAMPLE) a nearest-2x upsample folded into the input load, and split-K
// with a fixed-order reduction for the grids that do not fill the card.
//
// Replaces the TPU kernel sdtpu/kernels/conv2d.py:conv3x3_gemm_slab ->
// _slab_kernel (reached through gn_silu_conv3x3_slab for the resnets, kernel
// A, and through ops/conv.py:nearest_up_conv2d for the up-blocks, kernel B).
// Kernel E, the whole-map TPU kernel sdtpu/kernels/conv2d.py:conv3x3_gemm ->
// _kernel (pallas_call at :606), is this GEMM with a null bias, no residual
// and no moments: the f32 accumulator rounded once to bf16, its bias added
// afterwards in bf16 by the caller, as the TPU kernel leaves it to XLA.
//
// What it computes, per output pixel p = (b, y, x) and output channel co:
//   in(b, u, v, ci) = x(b, u, v, ci)                       (UPSAMPLE: x(b, u/2, v/2, ci))
//   yv = bf16(silu(in * a[b, ci] + c[b, ci]))              (prologue; else in)
//   yv = 0 where (u, v) is outside the H x W output map    (pad AFTER the prologue)
//   acc = sum_{dy, dx, ci} yv(b, y+dy-1, x+dx-1, ci) * w[dy, dx, ci, co]   (f32)
//   out = bf16(acc + bias[co] + res(b, y, x, co))
//   STATS: part[b, m_tile, 0/1, co] = sum over the tile's pixels of out, out^2
//          (of the bf16-rounded value); the wrapper sums the tiles and
//          divides by H*W.  No atomics, so the moments are deterministic.
//
// The three kernels, each launched by its own C entry point:
//   conv3x3_prologue_launch  yv = bf16(silu(x * a + c)) over the (small) input
//                            map, 16-byte vectors: the exp and the divide run
//                            once per input element.
//   conv3x3_slab_launch      the GEMM on yv: S = 1 writes out (and the
//                            moments); S > 1 writes slice s's f32 partial sums
//                            to ws[s] (slices of the flattened K loop).
//   conv3x3_splitk_reduce_launch  out = bf16(sum_{s=0..S-1} ws[s] + bias +
//                            res) in that order, one rounding, and the
//                            moments' partial sums.
//
// What bounds it on the H100 at the main path's shapes: the tensor cores.
// K = 9*Ci is 2880..23040 and every map is at least 16x16x2 pixels, so the
// GEMM does 30..900 operations per byte it must move, above the card's
// ~295 op/byte ridge.  What this design does about the gaps of the first
// version (whose loader ran the prologue once per tap and per 64-channel
// output tile, with synchronous loads, a scalar weight transpose and 80
// blocks on the 16x16 maps):
//   * the prologue is a pre-pass (one extra read and write of the input
//     map), so the GEMM's loader is a plain copy: one 16-byte cp.async.cg
//     per chunk, zero-filled (src-size 0) on the pad ring, the map's edge, a
//     ragged M tile, a ragged Ci chunk and a ragged Co;
//   * a 4-stage cp.async ring over one flattened K loop of 9 taps x
//     ceil(Ci/32) chunks: the copies of steps k+1..k+3 run under the MMAs
//     of step k;
//   * the weights stay in their HWIO [ci][co] layout in shared memory;
//     ldmatrix.x4 reads the A fragments and ldmatrix.x4.trans the B ones
//     (rows padded by 16 bytes: conflict-free);
//   * 128x128 block tiles, 64x32 per warp: 6 ldmatrix per 16 mma.sync
//     m16n8k16 (bf16 -> f32);
//   * split-K where the grid is short (plan_conv3x3_split in the wrapper),
//     with a deterministic reduction.
// What is left: TMA and wgmma (the full Hopper tensor-core rate needs
// wgmma), persistent blocks that overlap one tile's epilogue with the
// next one's loads, and the halo tile that would fold the pre-pass back
// into the load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 128;      // output channels per block
constexpr int BK = 32;       // input channels per K step
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int NT = 256;      // 8 warps: 2 along M x 4 along N, 64x32 each
constexpr int LDA = BK + 8;  // A row stride in bf16 (80 B: ldmatrix conflict-free)
constexpr int LDB = BN + 8;  // B row stride in bf16 (272 B)
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;  // 75776
constexpr int RN = 64;       // output channels per block of the split-K reduction

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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// y = bf16(silu(x * a[b, ci] + c[b, ci])) over (B, HWin, Ci), 8 channels a thread.
__global__ void __launch_bounds__(256) prologue_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ pa,
    const float* __restrict__ pc, __nv_bfloat16* __restrict__ y, long long nvec,
    long long vec_per_image, int Ci) {
  const int cv = Ci / 8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / vec_per_image);
    const int c = (int)(i % cv) * 8;
    uint4 v = reinterpret_cast<const uint4*>(x)[i];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
    const float4 a0 = *reinterpret_cast<const float4*>(pa + (size_t)b * Ci + c);
    const float4 a1 = *reinterpret_cast<const float4*>(pa + (size_t)b * Ci + c + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(pc + (size_t)b * Ci + c);
    const float4 c1 = *reinterpret_cast<const float4*>(pc + (size_t)b * Ci + c + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float cw[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = __bfloat162float(e[j]) * av[j] + cw[j];
      e[j] = __float2bfloat16_rn(t / (1.f + __expf(-t)));
    }
    reinterpret_cast<uint4*>(y)[i] = v;
  }
}

// The GEMM.  grid = (M tiles per image, N tiles, B * S); blockIdx.z = s * B + b.
template <bool UPSAMPLE, bool SPLIT, bool HAS_RES, bool STATS>
__global__ void __launch_bounds__(NT, 2) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ x,    // (B, Hin, Win, Ci), prologue applied
    const __nv_bfloat16* __restrict__ w,    // (3, 3, Ci, Co)
    const float* __restrict__ bias,         // (Co), or null
    const __nv_bfloat16* __restrict__ res,  // (B, H, W, Co)
    __nv_bfloat16* __restrict__ out,        // (B, H, W, Co)
    float* __restrict__ part,               // (B, n_mtiles, 2, Co)
    float* __restrict__ ws,                 // (S, B, H, W, Co) f32 partial sums
    int B, int H, int W, int Ci, int Co, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][pixel][ci]
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;                   // [stage][ci][co]
  __shared__ float red[2][2][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int HW = H * W;
  const int mt = blockIdx.x, n0 = blockIdx.y * BN;
  const int b = SPLIT ? (int)blockIdx.z % B : (int)blockIdx.z;
  const int s = SPLIT ? (int)blockIdx.z / B : 0;
  const int m0 = mt * BM;
  const int Hin = UPSAMPLE ? H / 2 : H, Win = UPSAMPLE ? W / 2 : W;
  const __nv_bfloat16* xb = x + (size_t)b * Hin * Win * Ci;

  const int nch = (Ci + BK - 1) / BK, KT = 9 * nch;
  const int kb = SPLIT ? (int)((long long)s * KT / S) : 0;
  const int ke = SPLIT ? (int)((long long)(s + 1) * KT / S) : KT;
  const int nk = ke - kb;

  // A loader: tile rows ar and ar + 64, channels ac..ac+7.
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
  // B loader: weight rows bkr and bkr + 16 of the K step, channels n0+bc..+7.
  const int bkr = tid >> 4, bc = (tid & 15) * 8;
  const bool bc_ok = n0 + bc < Co;
  int ld_tap = kb / nch, ld_c0 = (kb % nch) * BK;

  auto load_stage = [&](int slot) {
    const int dy = ld_tap / 3 - 1, dx = ld_tap % 3 - 1;
    const int ci = ld_c0 + ac;
    __nv_bfloat16* as = As + slot * A_STAGE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int iy = py[r] + dy, ix = px[r] + dx;
      const bool ok = pv[r] && ci < Ci && iy >= 0 && iy < H && ix >= 0 && ix < W;
      if (UPSAMPLE) {
        iy >>= 1;
        ix >>= 1;
      }
      const __nv_bfloat16* src = ok ? xb + ((size_t)iy * Win + ix) * Ci + ci : x;
      cp_async16(smem_u32(as + (ar + r * 64) * LDA + ac), src, ok ? 16 : 0);
    }
    const __nv_bfloat16* wt = w + (size_t)ld_tap * Ci * Co;
    __nv_bfloat16* bs = Bs + slot * B_STAGE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = ld_c0 + bkr + r * 16;
      const bool ok = bc_ok && k < Ci;
      const __nv_bfloat16* src = ok ? wt + (size_t)k * Co + n0 + bc : w;
      cp_async16(smem_u32(bs + (bkr + r * 16) * LDB + bc), src, ok ? 16 : 0);
    }
    ld_c0 += BK;
    if (ld_c0 >= Ci) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st);
    cp_async_commit();
  }

  // ldmatrix lane addresses: A rows (lane & 15), column half (lane >> 4);
  // B (trans) k rows (lane & 15), n half (lane >> 4).
  const int a_off = ((wm * 64 + (lane & 15)) * LDA + (lane >> 4) * 8) * 2;
  const int b_off = ((lane & 15) * LDB + wn * 32 + (lane >> 4) * 8) * 2;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i's stage is in; every warp is done with step i-1's
    if (i + STAGES - 1 < nk) load_stage((i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int slot = i % STAGES;
    const uint32_t a_base = smem_u32(As + slot * A_STAGE) + a_off;
    const uint32_t b_base = smem_u32(Bs + slot * B_STAGE) + b_off;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int im = 0; im < 4; ++im) ldsm_x4(af[im], a_base + (im * 16 * LDA + kk) * 2);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        uint32_t r[4];
        ldsm_x4_trans(r, b_base + (kk * LDB + jn * 16) * 2);
        bfr[2 * jn][0] = r[0];
        bfr[2 * jn][1] = r[1];
        bfr[2 * jn + 1][0] = r[2];
        bfr[2 * jn + 1][1] = r[3];
      }
#pragma unroll
      for (int im = 0; im < 4; ++im)
#pragma unroll
        for (int in = 0; in < 4; ++in) mma_bf16(acc[im][in], af[im], bfr[in]);
    }
  }
  cp_async_wait<0>();

  if (SPLIT) {  // f32 partial sums of this slice
    float* wsb = ws + ((size_t)s * B + b) * HW * Co;
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
            *reinterpret_cast<float2*>(wsb + (size_t)p * Co + col) =
                make_float2(acc[im][in][2 * h], acc[im][in][2 * h + 1]);
        }
    }
    return;
  }

  // Epilogue: bias, residual, bf16 store; moments of the stored value.
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int in = 0; in < 4; ++in) s1[in][0] = s1[in][1] = s2[in][0] = s2[in][1] = 0.f;
#pragma unroll
  for (int in = 0; in < 4; ++in) {
    const int col = n0 + wn * 32 + in * 8 + 2 * t;
    if (col >= Co) continue;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int im = 0; im < 4; ++im) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + wm * 64 + im * 16 + g + h * 8;
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
    {  // NT == 2 * BN: one (moment, column) per thread
      const int q = tid / BN, col = tid % BN;
      if (n0 + col < Co)
        part[(((size_t)b * gridDim.x + mt) * 2 + q) * Co + n0 + col] =
            red[q][0][col] + red[q][1][col];
    }
  }
}

// out = bf16(sum_{s < S} ws[s] + bias + res), the slices summed in order;
// moments of the rounded value per BM-pixel tile.  grid = (M tiles, ceil(Co/RN), B).
template <bool HAS_RES, bool STATS>
__global__ void __launch_bounds__(256) splitk_reduce_kernel(
    const float* __restrict__ ws, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int B, int HW, int Co, int S) {
  __shared__ float red[2][8][RN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = tid & 7, rl = tid >> 3;  // 8 chunks of 8 channels x 32 row lanes
  const int mt = blockIdx.x, b = blockIdx.z;
  const int col = blockIdx.y * RN + chunk * 8;
  const bool cok = col < Co;  // Co % 8 == 0: a chunk is all in or all out
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = (bias && cok) ? bias[col + j] : 0.f;
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  const size_t slice = (size_t)B * HW * Co;
  for (int r = rl; r < BM; r += 32) {
    const int p = mt * BM + r;
    if (p >= HW || !cok) continue;
    const size_t o = ((size_t)b * HW + p) * Co + col;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    for (int sl = 0; sl < S; ++sl) {
      const float4* src = reinterpret_cast<const float4*>(ws + sl * slice + o);
      const float4 lo = src[0], hi = src[1];
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += bv[j];
    if (HAS_RES) {
      const uint4 rv = *reinterpret_cast<const uint4*>(res + o);
      const __nv_bfloat16* re = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(re[j]);
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

template <bool UP, bool SPLIT, bool RES, bool ST>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* x, const void* w,
                   const void* bias, const void* res, void* out, void* part, void* ws,
                   int B, int H, int W, int Ci, int Co, int S) {
  static bool attr_set = false;  // one per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<UP, SPLIT, RES, ST>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  conv3x3_kernel<UP, SPLIT, RES, ST><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), static_cast<float*>(ws), B,
      H, W, Ci, Co, S);
  return cudaGetLastError();
}

template <bool UP>
cudaError_t launch_fused(int has_res, int st, dim3 grid, cudaStream_t s, const void* x,
                         const void* w, const void* bias, const void* res, void* out,
                         void* part, int B, int H, int W, int Ci, int Co) {
  if (has_res)
    return st ? launch<UP, false, true, true>(grid, s, x, w, bias, res, out, part, nullptr, B, H, W, Ci, Co, 1)
              : launch<UP, false, true, false>(grid, s, x, w, bias, res, out, part, nullptr, B, H, W, Ci, Co, 1);
  return st ? launch<UP, false, false, true>(grid, s, x, w, bias, res, out, part, nullptr, B, H, W, Ci, Co, 1)
            : launch<UP, false, false, false>(grid, s, x, w, bias, res, out, part, nullptr, B, H, W, Ci, Co, 1);
}

}  // namespace

// The tile sizes the GEMM runs with: which = 0 BM (output pixels per
// block), 1 BN (output channels per block), 2 BK (input channels per K
// step), 3 the ring's stages; -1 for another value.  The wrapper's split
// plan checks them against its own.
extern "C" int conv3x3_slab_tile(int which) {
  const int v[4] = {BM, BN, BK, STAGES};
  return which >= 0 && which < 4 ? v[which] : -1;
}

// Number of M tiles per image; the moments scratch is (B, tiles, 2, Co).
extern "C" int conv3x3_slab_m_tiles(int H, int W) { return (H * W + BM - 1) / BM; }

// y = bf16(silu(x * pa[b, ci] + pc[b, ci])); x and y (B, Hin, Win, Ci)
// bf16, pa and pc (B, Ci) f32; Ci a multiple of 8.  Returns a cudaError_t.
extern "C" int conv3x3_prologue_launch(const void* x, const void* pa, const void* pc, void* y,
                                       int B, int Hin, int Win, int Ci, void* stream) {
  if (Ci % 8 || B <= 0 || Hin <= 0 || Win <= 0) return (int)cudaErrorInvalidValue;
  const long long per_image = (long long)Hin * Win * (Ci / 8);
  const long long nvec = per_image * B;
  const long long blocks = (nvec + 255) / 256;
  prologue_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(pa),
      static_cast<const float*>(pc), static_cast<__nv_bfloat16*>(y), nvec, per_image, Ci);
  return (int)cudaGetLastError();
}

// The GEMM.  H, W: OUTPUT map size (with upsample != 0, x is (B, H/2, W/2,
// Ci)).  splits == 1: writes out = bf16(acc + bias + res) and, with part,
// the moments' partial sums; bias, res and part may be null.  splits > 1
// (at most the 9 * ceil(Ci/32) K steps): writes only ws, (splits, B, H, W,
// Co) f32, and bias, res, out and part must be null (the reduction takes
// them).  Ci and Co must be multiples of 8.  Returns a cudaError_t.
extern "C" int conv3x3_slab_launch(const void* x, const void* w, const void* bias,
                                   const void* res, void* out, void* part, void* ws, int B,
                                   int H, int W, int Ci, int Co, int upsample, int splits,
                                   void* stream) {
  if (Ci % 8 || Co % 8 || B <= 0 || H <= 0 || W <= 0 || (upsample && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  const int k_steps = 9 * ((Ci + BK - 1) / BK);
  if (splits < 1 || splits > k_steps || (splits > 1) != (ws != nullptr) ||
      (splits > 1 && (bias || res || out || part)) || (splits == 1 && !out))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, (Co + BN - 1) / BN, B * splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1)
    return (int)(upsample
                     ? launch<true, true, false, false>(grid, s, x, w, nullptr, nullptr, nullptr, nullptr, ws, B, H, W, Ci, Co, splits)
                     : launch<false, true, false, false>(grid, s, x, w, nullptr, nullptr, nullptr, nullptr, ws, B, H, W, Ci, Co, splits));
  const int st = part != nullptr, has_res = res != nullptr;
  return (int)(upsample ? launch_fused<true>(has_res, st, grid, s, x, w, bias, res, out, part, B, H, W, Ci, Co)
                        : launch_fused<false>(has_res, st, grid, s, x, w, bias, res, out, part, B, H, W, Ci, Co));
}

// out = bf16(sum over the splits of ws + bias + res), the slices in order;
// ws (splits, B, H, W, Co) f32; bias (Co) f32, res (B, H, W, Co) bf16 and
// part (B, m_tiles, 2, Co) f32 may be null.  Co a multiple of 8.  Returns a
// cudaError_t.
extern "C" int conv3x3_splitk_reduce_launch(const void* ws, const void* bias, const void* res,
                                            void* out, void* part, int B, int H, int W, int Co,
                                            int splits, void* stream) {
  if (Co % 8 || B <= 0 || H <= 0 || W <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, (Co + RN - 1) / RN, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(res);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  float* pf = static_cast<float*>(part);
  const int HW = H * W;
  if (res && part)
    splitk_reduce_kernel<true, true><<<grid, 256, 0, s>>>(wsf, bf, rb, ob, pf, B, HW, Co, splits);
  else if (res)
    splitk_reduce_kernel<true, false><<<grid, 256, 0, s>>>(wsf, bf, rb, ob, pf, B, HW, Co, splits);
  else if (part)
    splitk_reduce_kernel<false, true><<<grid, 256, 0, s>>>(wsf, bf, rb, ob, pf, B, HW, Co, splits);
  else
    splitk_reduce_kernel<false, false><<<grid, 256, 0, s>>>(wsf, bf, rb, ob, pf, B, HW, Co, splits);
  return (int)cudaGetLastError();
}

// Kernel G: the attention out-projection with the residual add, read
// straight from the head-major attention output:
//
//   out[b, l, c] = bf16( (sum_h sum_j o[b, h, l, j] * w[h, j, c] + bias[c])
//                        + residual[b, l, c] )
//
// accumulated in f32 and rounded once, to the residual's dtype (bf16).
//
// Replaces the TPU kernel sdtpu/kernels/flash_attention.py: out_proj_packed
// -> _out_proj_kernel (pallas_call at :464), which the flash route of the
// self-attention (ops/attention.py) takes with SDTPU_PACKED_OUT_PROJ=1
// wherever it has a residual: each UNet attn1 and the VAE mid-block
// attention.  There the heads are a sequential grid axis summed into an f32
// scratch; here they are part of one block's K loop.
//
// What bounds it on the H100: device memory.  K = C against o, residual and
// out of B*L*C bf16 each gives about C/3 operations per byte, under the ~295
// op/byte bf16 ridge.  Per call at the packed route's shapes (CFG batch 2):
//
//   o (B, H, L, D)     C     bytes    bound by bytes   ops       by ops
//   (2, 8, 4096, 40)   320   15.9 MB  4.76 us          1.68 GF   1.70 us
//   (2, 8, 1024, 80)   640    8.7 MB  2.60 us          1.68 GF   1.70 us
//   (2, 8, 256, 160)   1280   7.2 MB  2.15 us          1.68 GF   1.70 us
//   (1, 1, 4096, 512)  512   13.1 MB  3.9 us           2.15 GF   2.17 us
//
// so a call is a few microseconds and the grid has to fill the 132 SMs in one
// wave.  The design is kernel J's TMA + wgmma core (csrc/dot.cu):
//   * a 128 x BN output tile of one batch (BN 128 or 192) and a split of the
//     K loop over `splits` blocks, both from kernels/flash_attention.py:
//     plan_out_proj: one wave at each of the shapes above, split only where
//     the unsplit grid leaves most SMs idle (grid = (L tiles, C tiles, B *
//     splits); a tile never straddles a batch);
//   * 3 warpgroups: one thread of the first keeps a 4-stage ring of K steps
//     in flight by TMA (128-byte swizzle, mbarrier expect-tx); the other two
//     each run wgmma.mma_async m64n64k16 on 64 rows, o K-major and w N-major
//     (imm-trans-b: w is read as it lies, no transpose);
//   * o's map is 3-D (D, L, B*H) and w's (C, D, H), so each K step is one
//     64-wide box of one head: the TMA zero fill past D pads every head to
//     whole k16 steps on both operands and the contraction stays exact, as
//     the JAX kernel's zero-row-padded w is (at D = 40 a box is 37.5% zeros:
//     tensor work, not bytes; skipping those k16 steps ran no faster);
//   * unsplit, the producer also loads the block's residual tile by TMA at
//     the start; the epilogue adds bias and residual in f32, rounds once into
//     that tile in shared memory, and one thread stores it by TMA: the
//     residual and the output move as whole 128-byte rows;
//   * split, each block writes its f32 partial sums to ws[s], and
//     out_proj_packed_splitk_launch adds them in split order 0..S-1, then the
//     bias, then the residual, and rounds once: two calls are bitwise equal.
// What is left: on the card the K loop's loads alone take most of a call
// (each block re-reads its w slab; o is re-read once per column tile), and a
// single wave of blocks stores its outputs after all of them have loaded.
// A persistent grid that overlaps one tile's epilogue with the next one's
// loads, and w multicast to a cluster of blocks, are the next steps (a first
// 2-block cluster ran slower).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;    // output rows per block: two consumer warpgroups of 64
constexpr int BK = 64;     // K values per step: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;  // TMA ring depth
constexpr int NT = 384;    // warpgroup 0: the TMA producer; 1 and 2: consumers
constexpr int BN_A = 128;  // the two output-column tiles of the plan
constexpr int BN_B = 192;
constexpr int BOX = 64;                   // columns of one w, residual or out box
constexpr int A_BYTES = BM * BK * 2;      // 16 KB: o's 64 x 128 box
constexpr int B_BOX_BYTES = BOX * BK * 2; // 8 KB: w's 64 x 64 box
constexpr int R_BOX_BYTES = BOX * BM * 2; // 16 KB: a 64 x 128 box of residual / out

template <int BN>
struct Tile {
  static constexpr int NB = BN / BOX;                       // 2 or 3 boxes of 64 columns
  static constexpr int STAGE = A_BYTES + NB * B_BOX_BYTES;  // a multiple of 1024
  static constexpr int R = NB * R_BOX_BYTES;                // the residual / out tile
  static constexpr int SMEM = STAGES * STAGE + R + 1024 + (2 * STAGES + 1) * 8;
  static constexpr int NACC = BN / 2;  // f32 accumulators per consumer thread (64 rows x BN)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One 3-D TMA box global -> shared, completing on `bar`; c0 is the inner
// (contiguous) coordinate.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// One 3-D TMA box shared -> global; elements outside the tensor are not
// written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned atoms of 8 rows x 128 bytes), as in csrc/dot.cu.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[O .. O + 32) = A (64 x 16, K-major) . B (16 x 64, N-major: imm-trans-b 1)
// + (acc ? d : 0), both read through 128-byte-swizzled shared-memory
// descriptors.
template <int O, int R>
__device__ __forceinline__ void wgmma_n64(float (&d)[R], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "l"(da), "l"(db), "r"(acc));
}

// grid = (ceil(L / BM), ceil(C / BN), B * splits), blockIdx.z = b * splits
// + s.  The K loop is KT = H * ceil(D / BK) steps, step t = (head t / per,
// depth (t % per) * BK); split s takes [s * KT / splits, (s + 1) * KT /
// splits).  SPLIT: writes ws[s] (B, L, C) f32; else out (B, L, C) bf16 =
// (acc + bias) + residual.  to maps o (D, L, B*H) in 64 x 128 x 1 boxes, tw
// maps w (C, D, H) in 64 x 64 x 1, tr and tout residual and out (C, L, B) in
// 64 x 128 x 1, all 128-byte swizzled.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(NT, 1) out_proj_kernel(
    const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap tout,
    const float* __restrict__ bias, float* __restrict__ ws, int B, int H, int L, int D, int C,
    int splits) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // swizzle atoms on 1024 bytes
  const uint32_t rbuf = base + STAGES * T::STAGE;
  const uint32_t full = rbuf + T::R;  // full[st] at full + 8 st, then empty[st], then rbar
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t rbar = empty + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int l0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / splits, s = blockIdx.z - b * splits;
  const int per = (D + BK - 1) / BK;
  const int KT = H * per;
  const int kb = (int)((long long)s * KT / splits);
  const int nk = (int)((long long)(s + 1) * KT / splits) - kb;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread keeps up to STAGES steps in flight
    if (tid == 0) {
      if (!SPLIT) {  // the residual tile, read once, under the K loop
        mbar_expect_tx(rbar, T::R);
#pragma unroll
        for (int j = 0; j < T::NB; ++j)
          tma_load(rbuf + j * R_BOX_BYTES, &tr, n0 + BOX * j, l0, b, rbar);
      }
      for (int i = 0; i < nk; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
        const uint32_t a = base + st * T::STAGE, bar = full + 8 * st;
        const int h = (kb + i) / per, j0 = (kb + i - h * per) * BK;
        mbar_expect_tx(bar, T::STAGE);
        tma_load(a, &to, j0, l0, b * H + h, bar);
#pragma unroll
        for (int j = 0; j < T::NB; ++j)
          tma_load(a + A_BYTES + j * B_BOX_BYTES, &tw, n0 + BOX * j, j0, h, bar);
      }
    }
    return;
  }

  // the consumers: warpgroup c = wg - 1 owns rows 64 c .. 64 c + 63
  const int c = wg - 1;
  // no zeros written: the first product overwrites (scale-d 0), so that no
  // other instruction defines the accumulators inside the wgmma pipeline
  float acc[T::NACC];
  for (int i = 0; i < nk; ++i) {
    const int st = i % STAGES;
    mbar_wait(full + 8 * st, (i / STAGES) & 1);
    const uint32_t a = base + st * T::STAGE + c * 64 * 128, bb = base + st * T::STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 more K columns are 32 bytes along the swizzled row; B: 16 more
      // K rows are two 1024-byte atoms
      const uint64_t da = desc_sw128(a + kk * 32);
      const int add = i > 0 || kk > 0;
      wgmma_n64<0>(acc, da, desc_sw128(bb + kk * 2048), add);
      wgmma_n64<32>(acc, da, desc_sw128(bb + B_BOX_BYTES + kk * 2048), add);
      if constexpr (T::NB == 3)
        wgmma_n64<64>(acc, da, desc_sw128(bb + 2 * B_BOX_BYTES + kk * 2048), add);
    }
    wgmma_commit();
    wgmma_wait<1>();  // step i - 1's products are done: release its stage
    if (i > 0 && (tid & 31) == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
  }
  wgmma_wait<0>();
  // the accumulators are read after the wait, not moved above it
#pragma unroll
  for (int j = 0; j < T::NACC; ++j) asm volatile("" : "+f"(acc[j])::"memory");

  // accumulator layout of m64nN: warp w of the group holds rows 16 w + g and
  // + 8; n8 chunk j of the tile is acc[4 j .. 4 j + 3] at columns 8 j + 2 t, + 1
  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  if (SPLIT) {
    float* wsb = ws + ((size_t)s * B + b) * L * C;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= C) continue;  // C % 8 == 0, so col + 1 < C here
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = l0 + 64 * c + 16 * w + g + 8 * hh;
        if (row < L)
          *reinterpret_cast<float2*>(wsb + (size_t)row * C + col) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }
    return;
  }

  mbar_wait(rbar, 0);
  // residual element (r, 64 q + e) of the tile sits in box q at byte r * 128
  // + ((e / 8) ^ (r % 8)) * 16 + (e % 8) * 2 (the 128-byte swizzle); here
  // r % 8 == g and e / 8 == j % 8, so a warp's 32 accesses hit 32 banks
  unsigned char* rs = smem + (rbuf - smem_u32(smem));
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    float2 bv = make_float2(0.f, 0.f);
    if (bias != nullptr && col < C) bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 64 * c + 16 * w + g + 8 * hh;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
          rs + (j / 8) * R_BOX_BYTES + r * 128 + (((j % 8) ^ g) * 16) + 4 * t);
      const float2 rv = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn((acc[4 * j + 2 * hh] + bv.x) + rv.x,
                                 (acc[4 * j + 2 * hh + 1] + bv.y) + rv.y);
    }
  }
  // the generic-proxy writes are made visible to the TMA store, then one
  // thread stores the tile once both consumer warpgroups are done
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (tid == 128) {
#pragma unroll
    for (int j = 0; j < T::NB; ++j) tma_store(&tout, rbuf + j * R_BOX_BYTES, n0 + BOX * j, l0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// out = bf16(((ws[0] + ws[1] + ... + ws[S-1]) + bias) + residual) in that
// order, in f32, 8 values a thread (C % 8 == 0: the 8 share one row).
__global__ void __launch_bounds__(256) splitk_reduce_kernel(const float* __restrict__ ws,
                                                            const float* __restrict__ bias,
                                                            const __nv_bfloat16* __restrict__ res,
                                                            __nv_bfloat16* __restrict__ out,
                                                            long long n8, int C, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const long long slice = n8 * 8;
  float v[8];
  {
    const float4* src = reinterpret_cast<const float4*>(ws + i * 8);
    const float4 lo = src[0], hi = src[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
  for (int sl = 1; sl < S; ++sl) {
    const float4* src = reinterpret_cast<const float4*>(ws + sl * slice + i * 8);
    const float4 lo = src[0], hi = src[1];
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
  }
  if (bias != nullptr) {
    const float4* bsrc = reinterpret_cast<const float4*>(bias + (i * 8) % C);
    const float4 lo = bsrc[0], hi = bsrc[1];
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
  }
  const uint4 rv = reinterpret_cast<const uint4*>(res)[i];
  const __nv_bfloat162* re = reinterpret_cast<const __nv_bfloat162*>(&rv);
  uint4 o;
  __nv_bfloat162* oe = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 r2 = __bfloat1622float2(re[j]);
    oe[j] = __floats2bfloat162_rn(v[2 * j] + r2.x, v[2 * j + 1] + r2.y);
  }
  reinterpret_cast<uint4*>(out)[i] = o;
}

// cuTensorMapEncodeTiled from libcuda, fetched once through the runtime's
// entry-point query, so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 map of a contiguous (n2, n1, n0) tensor in (BOX, rows, 1)
// boxes, 128-byte swizzled, zeros outside the tensor.
cudaError_t encode(CUtensorMap* map, const void* ptr, int n0, int n1, int n2, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 2, (cuuint64_t)n0 * n1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool SPLIT>
cudaError_t launch(const void* o, const void* w, const float* bias, const void* res, void* out,
                   float* ws, int B, int H, int L, int D, int C, int splits, cudaStream_t s) {
  static bool attr_set = false;  // one per instance
  auto kern = out_proj_kernel<BN, SPLIT>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Tile<BN>::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap to, tw, tr, tout;
  cudaError_t e = encode(&to, o, D, L, B * H, BM);
  if (e == cudaSuccess) e = encode(&tw, w, C, D, H, BK);
  if (e != cudaSuccess) return e;
  if (!SPLIT) {  // the split form reads no residual and writes no out
    e = encode(&tr, res, C, L, B, BM);
    if (e == cudaSuccess) e = encode(&tout, out, C, L, B, BM);
    if (e != cudaSuccess) return e;
  } else {
    tr = tout = to;  // unused
  }
  const dim3 grid((L + BM - 1) / BM, (C + BN - 1) / BN, B * splits);
  kern<<<grid, NT, Tile<BN>::SMEM, s>>>(to, tw, tr, tout, bias, ws, B, H, L, D, C, splits);
  return cudaGetLastError();
}

template <int BN>
cudaError_t by_split(const void* o, const void* w, const float* bias, const void* res, void* out,
                     float* ws, int B, int H, int L, int D, int C, int splits, cudaStream_t s) {
  if (splits > 1) return launch<BN, true>(o, w, bias, res, out, ws, B, H, L, D, C, splits, s);
  return launch<BN, false>(o, w, bias, res, out, ws, B, H, L, D, C, 1, s);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) & 15; }

}  // namespace

// The tiles the kernel runs with, which kernels/flash_attention.py:
// plan_out_proj must assume: 0 BM, 1 BK, 2 the ring's stages, 3 and 4 the
// two BN; -1 for another value.
extern "C" int out_proj_packed_tile(int which) {
  const int v[5] = {BM, BK, STAGES, BN_A, BN_B};
  return which >= 0 && which < 5 ? v[which] : -1;
}

// o: (B, H, L, D), w: (H, D, C), residual and out: (B, L, C), all bf16,
// contiguous and 16-byte aligned; bias: (C,) f32 or null.  D and C
// multiples of 8; bn (128 or 192) and splits (1 .. H * ceil(D / 64)) from
// the plan.  splits == 1 writes out and ws must be null; splits > 1 writes
// only ws (splits, B, L, C) f32, and residual and out must be null
// (out_proj_packed_splitk_launch finishes the call).  Returns a cudaError_t.
extern "C" int out_proj_packed_launch(const void* o, const void* w, const void* bias,
                                      const void* residual, void* out, void* ws, int B, int H,
                                      int L, int D, int C, int bn, int splits, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D <= 0 || C <= 0 || D % 8 || C % 8 || splits < 1 ||
      (long long)splits > (long long)H * ((D + BK - 1) / BK) || (long long)B * splits > 65535 ||
      (splits > 1) != (ws != nullptr) || (splits > 1) == (out != nullptr) ||
      (splits > 1) == (residual != nullptr))
    return (int)cudaErrorInvalidValue;
  if (misaligned(o) || misaligned(w) || misaligned(bias) || misaligned(residual) ||
      misaligned(out) || misaligned(ws))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  float* wp = static_cast<float*>(ws);
  if (bn == BN_A) return (int)by_split<BN_A>(o, w, bp, residual, out, wp, B, H, L, D, C, splits, s);
  if (bn == BN_B) return (int)by_split<BN_B>(o, w, bp, residual, out, wp, B, H, L, D, C, splits, s);
  return (int)cudaErrorInvalidValue;
}

// out (M, C) bf16 = bf16(((sum over the splits of ws (splits, M, C) f32, in
// order) + bias) + residual (M, C) bf16); bias (C,) f32 or null; C a
// multiple of 8, every pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int out_proj_packed_splitk_launch(const void* ws, const void* bias,
                                             const void* residual, void* out, int M, int C,
                                             int splits, void* stream) {
  if (M <= 0 || C <= 0 || C % 8 || splits < 1 || misaligned(ws) || misaligned(bias) ||
      misaligned(residual) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  const long long n8 = (long long)M * C / 8;
  splitk_reduce_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual), static_cast<__nv_bfloat16*>(out), n8, C,
      splits);
  return (int)cudaGetLastError();
}

// Kernel J: out = x @ w, for bf16 inputs with an f32 accumulator rounded
// once to bf16, and for int8 inputs with an exact int32 accumulator
// returned as int32.
//
// Replaces tools/probe_int8_dot.py:make -> matmul_kernel (pallas_call at
// :39), the TPU probe that asked whether the int8 matrix unit gives twice
// the bf16 rate at the slab conv's GEMM shapes, (1024, 2560) @ (2560, 512)
// and (4096, 640) @ (640, 640).  The TPU version is one block holding all
// of x, w and out in VMEM; that is a VMEM artefact, and here the product is
// tiled like every other GEMM on the card.
//
// What bounds it on the H100: at those shapes 2*m*k*n operations against
// the bytes of x, w and out are 570 (bf16) to 680 (int8) per byte, above
// both ridges (~295 op/byte bf16, ~590 int8), so the tensor cores: 989
// TFLOP/s bf16, 1979 TOP/s int8, of which only wgmma reaches the full bf16
// rate.  At these sizes (2.7 and 3.4 GFLOP) a call is a few microseconds at
// that rate, so filling the 132 SMs in one wave matters as much as the rate
// of each SM.
//
// The bf16 form (dot_bf16_launch), the repository's first TMA + wgmma GEMM:
//   * a 128 x BN output tile per block, BN 128 or 160, and a split of the K
//     loop over `splits` blocks, both chosen on the host by
//     tools/probe_int8_dot.py:plan_dot so that the grid is one full wave
//     (128 x 128 tiles x 4 splits = 128 blocks at (1024, 2560, 512), 128 x
//     160 tiles = 128 blocks at (4096, 640, 640));
//   * 3 warpgroups: one thread of the first issues the TMA copies of a
//     4-stage ring of 64-wide K steps (x as a 64 x 128 box, w as 64-column
//     boxes of its row-major (K, N) layout; 128-byte swizzle, zeros outside
//     the tensors, so ragged M, N and K need no masks), with mbarrier
//     arrive/expect-tx; the other two each run wgmma.mma_async m64nNk16 on
//     64 rows: x K-major, w N-major (imm-trans-b: no transpose anywhere),
//     f32 accumulators in registers, one step's products in flight while
//     the next issues;
//   * the two tensor maps are built on the host for every call (the
//     pointers change) with cuTensorMapEncodeTiled, taken from the driver
//     through cudaGetDriverEntryPointByVersion (no -lcuda);
//   * with splits > 1 each block writes its f32 partial sums to ws[s], and
//     dot_bf16_splitk_launch sums the splits in order 0..S-1 in f32 and
//     rounds once to bf16: deterministic run to run.
// What is left: a persistent grid that overlaps one tile's epilogue with
// the next one's loads, and a TMA store of the output.
//
// The int8 form (dot_int8_launch) keeps the first design: a 128 x 64
// output tile per 256-thread block (8 warps, each 32 x 32), a 64-byte K
// step staged through shared memory with synchronous 16-byte loads, w
// transposed byte by byte into m16n8k32's k-major B layout (ldmatrix.trans
// moves 16-bit elements only), mma.sync m16n8k32 s8 -> s32.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- bf16 form --

constexpr int BM = 128;     // output rows per block: two consumer warpgroups of 64
constexpr int BK = 64;      // K values per step: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;   // TMA ring depth
constexpr int NT = 384;     // warpgroup 0: the TMA producer; 1 and 2: consumers
constexpr int BN_A = 128;   // the two output-column tiles of the plan
constexpr int BN_B = 160;
constexpr int BOX = 64;     // w's TMA box: 64 columns (128 bytes) x BK rows
constexpr int A_BYTES = BM * BK * 2;    // 16 KB: x's 128 x 64 box
constexpr int B_BOX_BYTES = BOX * BK * 2;  // 8 KB

template <int BN>
struct Tile {
  static constexpr int NB = (BN + BOX - 1) / BOX;  // w boxes a stage: 2, or 3 (half of one used)
  static constexpr int STAGE = A_BYTES + NB * B_BOX_BYTES;  // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;  // + alignment + barriers
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

// One 2-D TMA box global -> shared, completing on `bar`; c0 is the inner
// (contiguous) coordinate.  Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned atoms of 8 rows x 128 bytes): start address, leading
// and stride byte offsets (both 1024: the step between 8-row atoms; each
// instruction here spans one atom along its contiguous dimension, so the
// leading offset is not read), layout type 1 = 128-byte swizzle.
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

// d[O .. O + 16) = A (64 x 16, K-major) . B (16 x 32, N-major: imm-trans-b 1)
// + (acc ? d : 0), both read through 128-byte-swizzled shared-memory
// descriptors.
template <int O, int R>
__device__ __forceinline__ void wgmma_n32(float (&d)[R], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15])
      : "l"(da), "l"(db), "r"(acc));
}

// grid = (ceil(M / BM), ceil(N / BN), splits).  Split s takes the K steps
// [s * KT / splits, (s + 1) * KT / splits) of KT = ceil(K / BK).  SPLIT:
// writes ws[s] (M, N) f32; else out (M, N) bf16.  tx maps x (K inner, M
// outer) in 64 x 128 boxes, tw maps w (N inner, K outer) in 64 x 64 boxes,
// both 128-byte swizzled.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(NT, 1) gemm_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                                                          const __grid_constant__ CUtensorMap tw,
                                                          __nv_bfloat16* __restrict__ out,
                                                          float* __restrict__ ws, int M, int K,
                                                          int N) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // swizzle atoms on 1024 bytes
  const uint32_t full = base + STAGES * T::STAGE;  // full[st] at full + 8 st, then empty[st]
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int splits = gridDim.z, s = blockIdx.z;
  const int KT = (K + BK - 1) / BK;
  const int kb = (int)((long long)s * KT / splits);
  const int nk = (int)((long long)(s + 1) * KT / splits) - kb;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread keeps up to STAGES steps in flight
    if (tid == 0) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
        const uint32_t a = base + st * T::STAGE, bar = full + 8 * st;
        const int k0 = (kb + i) * BK;
        mbar_expect_tx(bar, T::STAGE);
        tma_load(a, &tx, k0, m0, bar);
#pragma unroll
        for (int j = 0; j < T::NB; ++j)
          tma_load(a + A_BYTES + j * B_BOX_BYTES, &tw, n0 + BOX * j, k0, bar);
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
    const uint32_t a = base + st * T::STAGE + c * 64 * 128, b = base + st * T::STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 more K columns are 32 bytes along the swizzled row; B: 16 more
      // K rows are two 1024-byte atoms
      const uint64_t da = desc_sw128(a + kk * 32);
      const int add = i > 0 || kk > 0;
      wgmma_n64<0>(acc, da, desc_sw128(b + kk * 2048), add);
      wgmma_n64<32>(acc, da, desc_sw128(b + B_BOX_BYTES + kk * 2048), add);
      if constexpr (BN == 160)
        wgmma_n32<64>(acc, da, desc_sw128(b + 2 * B_BOX_BYTES + kk * 2048), add);
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
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= N) continue;  // N % 8 == 0, so col + 1 < N here
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * c + 16 * w + g + 8 * h;
      if (row >= M) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (SPLIT)
        *reinterpret_cast<float2*>(ws + ((size_t)s * M + row) * N + col) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
}

// out = bf16(ws[0] + ws[1] + ... + ws[S-1]) in that order, 8 values a thread.
__global__ void __launch_bounds__(256) splitk_reduce_kernel(const float* __restrict__ ws,
                                                            __nv_bfloat16* __restrict__ out,
                                                            long long n8, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const long long slice = n8 * 8;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  for (int sl = 0; sl < S; ++sl) {
    const float4* src = reinterpret_cast<const float4*>(ws + sl * slice + i * 8);
    const float4 lo = src[0], hi = src[1];
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
  }
  uint4 o;
  __nv_bfloat162* oe = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) oe[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  reinterpret_cast<uint4*>(out)[i] = o;
}

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime,
// so that the library needs no -lcuda.
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

// A 2-D bf16 map of a row-major (rows, cols) tensor in (box_cols, box_rows)
// boxes, 128-byte swizzled, zeros outside the tensor.
cudaError_t encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols,
                   int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// x's map (64 x 128 boxes) and w's (64 x 64): built on the host for every
// call, since the pointers change.
cudaError_t encode_maps(CUtensorMap* tx, CUtensorMap* tw, const void* x, const void* w, int M,
                        int K, int N) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15)
    return cudaErrorInvalidValue;
  const cudaError_t e = encode(tx, x, M, K, BK, BM);
  return e != cudaSuccess ? e : encode(tw, w, K, N, BOX, BK);
}

template <int BN, bool SPLIT>
cudaError_t launch_gemm(const void* x, const void* w, void* out, void* ws, int M, int K, int N,
                        int splits, cudaStream_t s) {
  static bool attr_set = false;  // one per instance
  auto kern = gemm_bf16_kernel<BN, SPLIT>;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Tile<BN>::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tx, tw;
  const cudaError_t e = encode_maps(&tx, &tw, x, w, M, K, N);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kern<<<grid, NT, Tile<BN>::SMEM, s>>>(tx, tw, static_cast<__nv_bfloat16*>(out),
                                        static_cast<float*>(ws), M, K, N);
  return cudaGetLastError();
}

template <int BN>
cudaError_t by_split(const void* x, const void* w, void* out, void* ws, int M, int K, int N,
                     int splits, cudaStream_t s) {
  if (splits > 1) return launch_gemm<BN, true>(x, w, out, ws, M, K, N, splits, s);
  return launch_gemm<BN, false>(x, w, out, ws, M, K, N, 1, s);
}

// -------------------------------------------------------------- int8 form --

namespace i8 {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int NT = 256;  // 8 warps: 4 along M x 2 along N

template <typename T>
struct Traits;

template <>
struct Traits<int8_t> {
  using Acc = int;
  static constexpr int KSTEP = 32;  // m16n8k32
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(int* p, int v0, int v1) {
  *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}

template <typename T, typename O>
__global__ void __launch_bounds__(NT) dot_kernel(const T* __restrict__ x,
                                                 const T* __restrict__ w,
                                                 O* __restrict__ out, int M, int K, int N) {
  using Acc = typename Traits<T>::Acc;
  constexpr int KSTEP = Traits<T>::KSTEP;
  constexpr int VE = 16 / sizeof(T);   // values per 16-byte vector
  constexpr int BK = 64 / sizeof(T);   // K values per step (64 bytes)
  constexpr int LDS = BK + VE;         // shared row stride (conflict-free frags)
  constexpr int TE = 4 / sizeof(T);    // values per 32-bit fragment register
  __shared__ __align__(16) T As[BM * LDS];  // [row][k]
  __shared__ __align__(16) T Bs[BN * LDS];  // [col][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // A loader: rows ar and ar + 64, one 16-byte vector each (4 per row).
  const int ar = tid >> 2, ac = (tid & 3) * VE;
  // B loader: one 16-byte vector of w's row bk per thread.
  constexpr int BVR = BN / VE;  // vectors per w row of the tile
  const int bk = tid / BVR, bn = (tid % BVR) * VE;
  const bool bn_ok = n0 + bn < N;

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + ar + r * 64;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) v = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k0 + ac);
      *reinterpret_cast<uint4*>(&As[(ar + r * 64) * LDS + ac]) = v;
    }
    {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (bn_ok) v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + bk) * N + n0 + bn);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < VE; ++i) Bs[(bn + i) * LDS + bk] = e[i];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += KSTEP) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int im = 0; im < 2; ++im) {
        const T* p = &As[(wm * 32 + im * 16 + g) * LDS + kk + TE * t];
        af[im][0] = ld32(p);
        af[im][1] = ld32(p + 8 * LDS);
        af[im][2] = ld32(p + KSTEP / 2);
        af[im][3] = ld32(p + 8 * LDS + KSTEP / 2);
      }
#pragma unroll
      for (int in = 0; in < 4; ++in) {
        const T* p = &Bs[(wn * 32 + in * 8 + g) * LDS + kk + TE * t];
        bf[in][0] = ld32(p);
        bf[in][1] = ld32(p + KSTEP / 2);
      }
#pragma unroll
      for (int im = 0; im < 2; ++im)
#pragma unroll
        for (int in = 0; in < 4; ++in) mma(acc[im][in], af[im], bf[in]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int in = 0; in < 4; ++in) {
    const int col = n0 + wn * 32 + in * 8 + 2 * t;
    if (col >= N) continue;  // N % VE == 0, so col + 1 < N here
#pragma unroll
    for (int im = 0; im < 2; ++im)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + im * 16 + g + h * 8;
        if (row < M) store2(out + (size_t)row * N + col, acc[im][in][2 * h], acc[im][in][2 * h + 1]);
      }
  }
}

template <typename T, typename O>
int launch(const void* x, const void* w, void* out, int M, int K, int N, void* stream) {
  constexpr int VE = 16 / sizeof(T), BK = 64 / sizeof(T);
  if (M <= 0 || K <= 0 || N <= 0 || K % BK || N % VE) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  dot_kernel<T, O><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<O*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace i8

}  // namespace

// The tiles the bf16 kernel runs with, which tools/probe_int8_dot.py:plan_dot
// must assume: 0 BM, 1 BK, 2 the ring's stages, 3 and 4 the two BN; -1 for
// another value.
extern "C" int dot_bf16_tile(int which) {
  const int v[5] = {BM, BK, STAGES, BN_A, BN_B};
  return which >= 0 && which < 5 ? v[which] : -1;
}

// bf16: x (M, K), w (K, N) bf16, row-major, contiguous and 16-byte
// aligned; K a multiple of 32, N of 8; bn (128 or 160) and splits (1 ..
// ceil(K/64)) from the plan.  splits == 1 writes out (M, N) bf16 and ws
// must be null; splits > 1 writes only ws (splits, M, N) f32 and out must be
// null (dot_bf16_splitk_launch rounds it).  Returns a cudaError_t.
extern "C" int dot_bf16_launch(const void* x, const void* w, void* out, void* ws, int M, int K,
                               int N, int bn, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 32 || N % 8 || splits < 1 ||
      splits > (K + BK - 1) / BK || (splits > 1) != (ws != nullptr) ||
      (splits > 1) == (out != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == BN_A) return (int)by_split<BN_A>(x, w, out, ws, M, K, N, splits, s);
  if (bn == BN_B) return (int)by_split<BN_B>(x, w, out, ws, M, K, N, splits, s);
  return (int)cudaErrorInvalidValue;
}

// Builds the two tensor maps of a bf16 call as dot_bf16_launch does, and
// launches nothing: the host's cost of the maps, timed alone.
extern "C" int dot_bf16_tensor_maps(const void* x, const void* w, int M, int K, int N) {
  CUtensorMap tx, tw;
  return (int)encode_maps(&tx, &tw, x, w, M, K, N);
}

// out (M, N) bf16 = bf16(sum over the splits of ws (splits, M, N) f32), the
// splits in order; M * N a multiple of 8.  Returns a cudaError_t.
extern "C" int dot_bf16_splitk_launch(const void* ws, void* out, int M, int N, int splits,
                                      void* stream) {
  const long long n = (long long)M * N;
  if (M <= 0 || N <= 0 || n % 8 || splits < 1) return (int)cudaErrorInvalidValue;
  const long long n8 = n / 8;
  splitk_reduce_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), n8, splits);
  return (int)cudaGetLastError();
}

// int8 -> int32: x (M, K), w (K, N) int8, out (M, N) int32, row-major and
// contiguous; K a multiple of 64, N of 16.  Returns a cudaError_t.
extern "C" int dot_int8_launch(const void* x, const void* w, void* out, int M, int K, int N,
                               void* stream) {
  return i8::launch<int8_t, int>(x, w, out, M, K, N, stream);
}

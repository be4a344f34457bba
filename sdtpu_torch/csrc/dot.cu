// Kernel J: one tiled GEMM, out = x @ w, for bf16 inputs with an f32
// accumulator rounded once to bf16, and for int8 inputs with an exact int32
// accumulator returned as int32.
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
// TFLOP/s bf16, 1979 TOP/s int8.  This first version is kernel A's GEMM
// without the conv: a 128 x 64 output tile per 256-thread block (8 warps,
// each a 32 x 32 sub-tile), a 64-byte K step (32 bf16 or 64 int8 values)
// staged through shared memory with synchronous 16-byte loads, w
// transposed on its way into shared memory so that both operands are
// k-contiguous, and mma.sync m16n8k16 bf16 -> f32 or m16n8k32 s8 -> s32
// (the int8 B operand k-major, the fragment layout of kernel D).  No
// cp.async/TMA ring and no wgmma: those are the known gaps to the bound, and
// the int8 path's byte-wise transposed store costs it more than bf16's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int NT = 256;  // 8 warps: 4 along M x 2 along N

template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int KSTEP = 16;  // m16n8k16
};

template <>
struct Traits<int8_t> {
  using Acc = int;
  static constexpr int KSTEP = 32;  // m16n8k32
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
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

}  // namespace

// x (M, K), w (K, N), out (M, N), row-major and contiguous.  bf16 -> bf16:
// K a multiple of 32, N of 8.  int8 -> int32: K a multiple of 64, N of 16.
// Returns a cudaError_t.
extern "C" int dot_bf16_launch(const void* x, const void* w, void* out, int M, int K, int N,
                               void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, M, K, N, stream);
}

extern "C" int dot_int8_launch(const void* x, const void* w, void* out, int M, int K, int N,
                               void* stream) {
  return launch<int8_t, int>(x, w, out, M, K, N, stream);
}

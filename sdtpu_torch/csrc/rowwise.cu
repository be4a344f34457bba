// The transformer block's two float32 row chains, each as one pass over the
// activations (kernels/rowwise.py):
//
//   layer_norm_rows:  out[r, :] = T(((x - mean) * rsqrt(var + eps)) * scale + bias)
//                     x (N, C) bf16 or f32, mean and the centred variance of
//                     row r in f32, scale and bias (C,) f32 or bf16;
//   geglu_rows:       out[r, j] = T(value * T(GELU_erf(gate))), value = T(h[r, j] +
//                     T(bias[j])), gate = T(h[r, F + j] + T(bias[F + j])), h (N, 2F)
//                     the feed-forward's projection before its bias, bias (2F,) or null.
//
// These replace no TPU kernel: the JAX program (sdtpu/ops/norm.py:layer_norm,
// sdtpu/ops/activations.py:geglu) leaves both chains to XLA, which fuses each
// into one loop over the activations.  In eager PyTorch the same chains are
// 14 and 9 kernels with float32 intermediates the size of the activations
// (about 68 and 280 bytes an element of x moved, against 4 and 24 here).
//
// Each pass repeats the eager code's roundings (kernels/rowwise.py's plain
// versions), with every multiply and add rounded on its own (__fmul_rn,
// __fadd_rn: nvcc would otherwise contract them into FMAs): the affine as a
// multiply then an add, the bias rounded to x's type and the sum rounded,
// GELU in f32 on the rounded gate then rounded, the product rounded.  The one
// difference is the order of the row sums behind the LayerNorm statistics.
//
// What bounds them on the H100: device memory.  At tiny-sd's 16-row steps
// (bf16, per call, 3.35 TB/s):
//
//   layer_norm_rows (65536, 320)      83.9 MB   25.0 us
//                   (16384, 640)      41.9 MB   12.5 us
//                   (4096, 1280)      21.0 MB    6.3 us
//   geglu_rows      (65536, 2560)    503.3 MB  150.2 us
//                   (16384, 5120)    251.7 MB   75.1 us
//                   (4096, 10240)    125.8 MB   37.6 us
//
// Design: 16-byte loads and stores, neighbouring lanes on neighbouring
// vectors.  LayerNorm keeps its row in registers between the two reductions
// (a butterfly over the row's lanes each, no shared memory).  The lanes a row
// (TPR: 8, 16 or 32) and the vectors a lane (NV) follow from C at the launch:
// the fewest lanes that keep 5 vectors each, so that every lane loads its
// 80 bytes at once (bf16: C = 320 takes 8 lanes, 640 16, 768-1536 32 lanes
// and 3-6 vectors).  One kernel serves every width; 256 threads a block hold
// 8-32 rows, and the 65536 rows of tiny-sd's 64x64 level are 2048 blocks.
// GeGLU is elementwise: one thread a 16-byte output vector over the whole
// (N, F) output, so that a call of a few rows still fills the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 2048;   // widest LayerNorm row (the refiner's 1536): NV <= 8 (bf16)
constexpr int NV_TARGET = 5;  // 16-byte vectors a thread keeps, where C allows
constexpr float INV_SQRT2 = 0.70710678118654752f;  // PyTorch's x * (1 / float(sqrt(2)))

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T and back, as a .to(T) between two eager ops
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// N consecutive values of type E at p (N * sizeof(E) is 8, 16 or 32 bytes and
// p aligned to it, up to 16) as floats
template <typename E, int N>
__device__ __forceinline__ void load_vals(const E* __restrict__ p, float* v) {
  constexpr int BYTES = N * (int)sizeof(E);
  static_assert(BYTES == 8 || BYTES == 16 || BYTES == 32, "8, 16 or 32 bytes");
  if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f(e[j]);
  } else {
    constexpr int PER = 16 / (int)sizeof(E);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) v[c * PER + j] = to_f(e[j]);
    }
  }
}

// 16 bytes of T from N = 16 / sizeof(T) floats, each rounded to nearest even
template <typename T> __device__ __forceinline__ void store_vec(T* p, const float* v);
template <> __device__ __forceinline__ void store_vec<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store_vec<__nv_bfloat16>(__nv_bfloat16* p,
                                                                     const float* v) {
  uint4 raw;
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// the sum over an aligned group of G lanes, in every lane of the group
template <int G>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// TPR lanes a row, NV vectors a lane: the row in registers, the mean, the
// centred variance, then ((x - mean) * rstd) * scale + bias, each step
// rounded as the eager ops round.  Every lane runs the shuffles (a row past
// the end loads and stores nothing).
template <typename T, typename P, int TPR, int NV>
__global__ void __launch_bounds__(THREADS) layer_norm_rows_kernel(
    const T* __restrict__ x, const P* __restrict__ scale, const P* __restrict__ bias,
    T* __restrict__ out, int rows, int C, float eps) {
  constexpr int N = 16 / (int)sizeof(T);
  const int sub = threadIdx.x % TPR;
  const long long row = (long long)blockIdx.x * (THREADS / TPR) + threadIdx.x / TPR;
  const int nvec = row < rows ? C / N : 0;
  const T* xr = x + row * C;
  float v[NV][N];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = sub + TPR * i;
    if (c < nvec) {
      load_vals<T, N>(xr + c * N, v[i]);
#pragma unroll
      for (int j = 0; j < N; ++j) s += v[i][j];
    }
  }
  const float inv_c = 1.0f / (float)C;
  const float mean = __fmul_rn(group_sum<TPR>(s), inv_c);
  s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (sub + TPR * i < nvec) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[i][j] = __fsub_rn(v[i][j], mean);
        s = __fadd_rn(s, __fmul_rn(v[i][j], v[i][j]));
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(group_sum<TPR>(s), inv_c), eps));
  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = sub + TPR * i;
    if (c < nvec) {
      float g[N], b[N], o[N];
      load_vals<P, N>(scale + c * N, g);
      load_vals<P, N>(bias + c * N, b);
#pragma unroll
      for (int j = 0; j < N; ++j)
        o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), g[j]), b[j]);
      store_vec<T>(orow + c * N, o);
    }
  }
}

// One thread a 16-byte vector of the output: its value and gate vectors F
// apart in h's row, the bias (where given) rounded to T and added, GELU_erf
// of the gate in f32 as x * 0.5 * (1 + erf(x * (1 / sqrt 2))), rounded, times
// the value, rounded.
template <typename T, typename P>
__global__ void __launch_bounds__(THREADS) geglu_rows_kernel(
    const T* __restrict__ h, const P* __restrict__ bias, T* __restrict__ out, unsigned n,
    unsigned fv) {
  constexpr int N = 16 / (int)sizeof(T);
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned r = i / fv;
  const int c = (int)(i - r * fv) * N;  // column of the vector's first value
  const long long F = (long long)fv * N;
  const T* hr = h + (long long)r * 2 * F;
  float val[N], gate[N], o[N];
  load_vals<T, N>(hr + c, val);
  load_vals<T, N>(hr + F + c, gate);
  if (bias != nullptr) {
    float bv[N], bg[N];
    load_vals<P, N>(bias + c, bv);
    load_vals<P, N>(bias + F + c, bg);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      val[j] = round_to<T>(__fadd_rn(val[j], round_to<T>(bv[j])));
      gate[j] = round_to<T>(__fadd_rn(gate[j], round_to<T>(bg[j])));
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float e = erff(__fmul_rn(gate[j], INV_SQRT2));
    const float gl = round_to<T>(__fmul_rn(__fmul_rn(gate[j], 0.5f), __fadd_rn(1.0f, e)));
    o[j] = __fmul_rn(val[j], gl);
  }
  store_vec<T>(out + (long long)r * F + c, o);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

// lanes a row: the fewest of 8, 16, 32 that keep NV_TARGET vectors a lane
int lanes_for(int nvec) {
  return nvec <= 8 * NV_TARGET ? 8 : nvec <= 16 * NV_TARGET ? 16 : 32;
}

template <typename T, typename P, int TPR, int NV>
cudaError_t layer_norm_nv(const void* x, const void* scale, const void* bias, void* out,
                          int rows, int C, float eps, cudaStream_t s, int nv) {
  if constexpr (NV > 1) {
    if (nv < NV)
      return layer_norm_nv<T, P, TPR, NV - 1>(x, scale, bias, out, rows, C, eps, s, nv);
  }
  constexpr int ROWS = THREADS / TPR;
  layer_norm_rows_kernel<T, P, TPR, NV><<<(unsigned)((rows + ROWS - 1) / ROWS), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const P*>(scale), static_cast<const P*>(bias),
      static_cast<T*>(out), rows, C, eps);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t layer_norm_typed(const void* x, const void* scale, const void* bias, void* out,
                             int rows, int C, float eps, cudaStream_t s) {
  constexpr int N = 16 / (int)sizeof(T);
  constexpr int MAX_NV = (MAX_C / N + 31) / 32;
  const int nvec = C / N;
  const int tpr = lanes_for(nvec);
  const int nv = (nvec + tpr - 1) / tpr;
  if (tpr == 8) return layer_norm_nv<T, P, 8, NV_TARGET>(x, scale, bias, out, rows, C, eps, s, nv);
  if (tpr == 16)
    return layer_norm_nv<T, P, 16, NV_TARGET>(x, scale, bias, out, rows, C, eps, s, nv);
  return layer_norm_nv<T, P, 32, MAX_NV>(x, scale, bias, out, rows, C, eps, s, nv);
}

template <typename T>
cudaError_t layer_norm_by_param(const void* x, const void* scale, const void* bias, void* out,
                                int rows, int C, float eps, int p_dtype, cudaStream_t s) {
  if (p_dtype == 0) return layer_norm_typed<T, float>(x, scale, bias, out, rows, C, eps, s);
  if (p_dtype == 1)
    return layer_norm_typed<T, __nv_bfloat16>(x, scale, bias, out, rows, C, eps, s);
  return cudaErrorInvalidValue;
}

template <typename T, typename P>
cudaError_t geglu_typed(const void* h, const void* bias, void* out, int rows, int F,
                        cudaStream_t s) {
  constexpr int N = 16 / (int)sizeof(T);
  const unsigned fv = (unsigned)(F / N);
  const unsigned n = (unsigned)rows * fv;
  geglu_rows_kernel<T, P><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const T*>(h), static_cast<const P*>(bias), static_cast<T*>(out), n, fv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t geglu_by_param(const void* h, const void* bias, void* out, int rows, int F,
                           int p_dtype, cudaStream_t s) {
  if (p_dtype == 0) return geglu_typed<T, float>(h, bias, out, rows, F, s);
  if (p_dtype == 1) return geglu_typed<T, __nv_bfloat16>(h, bias, out, rows, F, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The widest LayerNorm row the kernel takes (kernels/rowwise.py checks C
// against it).
extern "C" int rowwise_max_c() { return MAX_C; }

// x and out: (rows, C), contiguous, x_dtype 0 f32 or 1 bf16; scale and bias:
// (C,), p_dtype 0 f32 or 1 bf16; C a multiple of 8, at most MAX_C; every
// pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int layer_norm_rows_launch(const void* x, const void* scale, const void* bias,
                                      void* out, int rows, int C, float eps, int x_dtype,
                                      int p_dtype, void* stream) {
  if (rows <= 0 || C <= 0 || C % 8 || C > MAX_C || misaligned(x) || misaligned(scale) ||
      misaligned(bias) || misaligned(out) || scale == nullptr || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)layer_norm_by_param<float>(x, scale, bias, out, rows, C, eps, p_dtype, s);
  if (x_dtype == 1)
    return (int)layer_norm_by_param<__nv_bfloat16>(x, scale, bias, out, rows, C, eps, p_dtype,
                                                   s);
  return (int)cudaErrorInvalidValue;
}

// h: (rows, 2F), out: (rows, F), contiguous, h_dtype 0 f32 or 1 bf16; bias:
// (2F,) of p_dtype (0 f32, 1 bf16) or null; F a multiple of 8, rows * F
// under 2^31; every pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int geglu_rows_launch(const void* h, const void* bias, void* out, int rows, int F,
                                 int h_dtype, int p_dtype, void* stream) {
  if (rows <= 0 || F <= 0 || F % 8 || (long long)rows * F >= (1LL << 31) || misaligned(h) ||
      misaligned(bias) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_dtype == 0) return (int)geglu_by_param<float>(h, bias, out, rows, F, p_dtype, s);
  if (h_dtype == 1)
    return (int)geglu_by_param<__nv_bfloat16>(h, bias, out, rows, F, p_dtype, s);
  return (int)cudaErrorInvalidValue;
}

// Non-causal flash attention over head-major (B*H, L, D) bf16 tensors with
// an f32 online softmax: three compile-time modes of the kernel template in
// flash_attention.cuh (what each computes is written there).
//
// * C (MODE_C) replaces sdtpu/kernels/flash_attention.py:
//   flash_attention_packed -> _flash_attention_packed_impl -> _kernel, used
//   by the UNet's self-attention (ops/attention.py) and the VAE mid-block's
//   single-head attention (models/vae.py).
// * F (MODE_STATS) replaces sdtpu/kernels/flash_attention.py:
//   flash_attention_stats -> _kernel(emit_stats=True), the per-KV-block
//   primitive of ring attention (parallel/ring_attention.py): the same
//   output, normalised over this KV block only, plus each row's running max
//   m of the scaled scores and running sum l = sum exp(s_j - m), both f32,
//   from which the ring merges its blocks exactly.  Both plans write them:
//   one row's l is spread over the four lanes of an mma.sync quad (each
//   lane sums its own key columns), so the quad reduces it before lane 0
//   writes m and l once.
// * H (MODE_LEGACY) replaces tools/probe_flash_vpu.py:legacy_flash ->
//   _legacy_kernel, the TPU round-2 body kept as a probe: natural exp, the
//   scale after the MMA, and the key mask on every tile.  It runs with C's
//   tiles, so that the A/B against C isolates the exponential and the mask.
//
// What bounds it on the H100 at the main path's shapes: the tensor cores
// and, at small head dims, the exponential units.  At L = 4096 keys the two
// products do 4*L*D operations per query row against 4*D bytes of q and
// out, and K/V are re-read from L2, not device memory, so every shape is
// above the ~295 op/byte ridge; one exponential per score at 16 per clock
// per SM (CUDA C++ Programming Guide, compute capability 9.0) costs more
// than the 4*D tensor operations per score at D = 40.  The design is the
// FlashAttention-2 register scheme with mma.sync m16n8k16: one block per
// (batch*head, tile of 16*NW query rows), each warp owns 16 rows.  Loads
// are synchronous 16-byte loads (no cp.async/TMA ring, no wgmma): those are
// the known gaps to the bound.  F at the ring's shard shapes (a quarter of
// the rows against a quarter of the keys, n = 4) has a sixteenth of a C
// call's work on a quarter of its grid (16 blocks at D = 160), so there it
// is bound by too few blocks and by the host-side launch loop.
//
// D <= 160 keeps the output accumulator in registers (64-row query tiles,
// 64-key tiles).  The VAE's D = 512 takes the shared-memory accumulator
// plan (kernel C and F only).

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, void* o, float* m, float* l,
             int BH, int Lq, int Lk, int D, void* stream) {
  const int dmax = MODE == MODE_LEGACY ? 160 : 512;
  if (D % 8 || D <= 0 || D > dmax || Lq <= 0 || Lk <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const float sc = (MODE == MODE_LEGACY ? 1.f : 1.4426950408889634f) / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch<32, 4, 1, 64, false, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  if (D <= 48) return (int)launch<48, 4, 1, 64, false, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  if (D <= 64) return (int)launch<64, 4, 1, 64, false, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  if (D <= 80) return (int)launch<80, 4, 1, 64, false, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  if (D <= 96) return (int)launch<96, 4, 1, 64, false, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  if (D <= 128) return (int)launch<128, 4, 1, 64, false, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  if (D <= 160) return (int)launch<160, 4, 1, 64, false, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
  if constexpr (MODE == MODE_LEGACY) return (int)cudaErrorInvalidValue;  // not reached
  else return (int)launch<512, 2, 1, 32, true, MODE>(q, k, v, o, m, l, BH, Lq, Lk, D, sc, s);
}

}  // namespace

// Kernel C.  q: (BH, Lq, D), k/v: (BH, Lk, D), o: (BH, Lq, D), all bf16 and
// contiguous.  D must be a multiple of 8 and at most 512.  Returns a
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int BH, int Lq, int Lk, int D,
                                      void* stream) {
  return dispatch<MODE_C>(q, k, v, o, nullptr, nullptr, BH, Lq, Lk, D, stream);
}

// Kernel F: as C, plus m and l, each (BH, Lq) f32 and contiguous.
extern "C" int flash_attention_stats_launch(const void* q, const void* k, const void* v,
                                            void* o, void* m, void* l, int BH, int Lq,
                                            int Lk, int D, void* stream) {
  return dispatch<MODE_STATS>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
                              BH, Lq, Lk, D, stream);
}

// Kernel H: as C's arguments; D a multiple of 8 and at most 160.
extern "C" int flash_attention_legacy_launch(const void* q, const void* k, const void* v,
                                             void* o, int BH, int Lq, int Lk, int D,
                                             void* stream) {
  return dispatch<MODE_LEGACY>(q, k, v, o, nullptr, nullptr, BH, Lq, Lk, D, stream);
}

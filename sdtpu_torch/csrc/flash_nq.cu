// Kernel I: flash attention with NQ independent online-softmax chains per
// block over the same K/V tiles (MODE_NQ of the kernel template in
// flash_attention.cuh, where what it computes is written).
//
// Replaces tools/probe_flash_2stream.py:flash_2q -> _kernel_nq (pallas_call
// at :124), the TPU probe that splits one q tile of nq*bq rows into nq
// chains, each with its own m, l and accumulator, sharing every K/V tile:
// natural exp, the scale after the MMA, P rounded to bf16, and the key mask
// only where Lk is not a multiple of the key tile.
//
// The TPU question was whether independent chains in one kernel body let
// the scheduler overlap one chain's exponentials with another's matrix
// work.  Here a chain is one warpgroup (4 warps); BQ, its rows, is 64 or
// 128, so each warp owns BQ/64 16-row tiles, each an independent softmax
// with its own m, l and accumulator in registers.  A block holds NQ chains
// (4*NQ warps) and stages each K/V tile once in shared memory for all of
// them.  Within a warp the S = Q K^T MMAs of all its row tiles issue before
// their softmax, so BQ = 128 lets one tile's exponentials issue under the
// other's MMAs; across warpgroups the SM's warp schedulers interleave the
// chains' exponentials and MMAs on their own.  Variants taken:
// NQ in {1, 2, 3, 4}, BQ in {64, 128}, NQ*BQ <= 256 query rows per block.
// NQ = 1, BQ = 64 is kernel C's schedule with I's exponential.  The JAX bq
// (256..1024 rows) sized a VMEM tile and has no counterpart here.
//
// What bounds it on the H100: as kernel C (flash_attention.cu), the tensor
// cores and, at small head dims, the exponential units (16 per clock per
// SM).  Register pressure grows with BQ: 2 x (16 rows x DP) f32 of output
// accumulator and 2 x 16 x 64 f32 of scores per warp at BQ = 128.

#include "flash_attention.cuh"

namespace {

using namespace flash;

template <int DP, int NQ, int MT>
cudaError_t variant(const void* q, const void* k, const void* v, void* o, int BH, int Lq,
                    int Lk, int D, float sc, cudaStream_t s) {
  return launch<DP, 4 * NQ, MT, 64, false, MODE_NQ>(q, k, v, o, nullptr, nullptr, BH, Lq, Lk,
                                                     D, sc, s);
}

template <int DP>
int by_variant(const void* q, const void* k, const void* v, void* o, int BH, int Lq, int Lk,
               int D, int nq, int bq, float sc, cudaStream_t s) {
  if (bq == 64) {
    switch (nq) {
      case 1: return (int)variant<DP, 1, 1>(q, k, v, o, BH, Lq, Lk, D, sc, s);
      case 2: return (int)variant<DP, 2, 1>(q, k, v, o, BH, Lq, Lk, D, sc, s);
      case 3: return (int)variant<DP, 3, 1>(q, k, v, o, BH, Lq, Lk, D, sc, s);
      case 4: return (int)variant<DP, 4, 1>(q, k, v, o, BH, Lq, Lk, D, sc, s);
    }
  } else if (bq == 128) {
    switch (nq) {
      case 1: return (int)variant<DP, 1, 2>(q, k, v, o, BH, Lq, Lk, D, sc, s);
      case 2: return (int)variant<DP, 2, 2>(q, k, v, o, BH, Lq, Lk, D, sc, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel I.  q: (BH, Lq, D), k/v: (BH, Lk, D), o: (BH, Lq, D), all bf16 and
// contiguous.  D a multiple of 8 and at most 160; (nq, bq) one of the
// variants above.  Returns a cudaError_t.
extern "C" int flash_attention_nq_launch(const void* q, const void* k, const void* v,
                                         void* o, int BH, int Lq, int Lk, int D, int nq,
                                         int bq, void* stream) {
  if (D % 8 || D <= 0 || D > 160 || Lq <= 0 || Lk <= 0 || BH <= 0)
    return (int)cudaErrorInvalidValue;
  const float sc = 1.f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 48) return by_variant<48>(q, k, v, o, BH, Lq, Lk, D, nq, bq, sc, s);
  if (D <= 64) return by_variant<64>(q, k, v, o, BH, Lq, Lk, D, nq, bq, sc, s);
  if (D <= 80) return by_variant<80>(q, k, v, o, BH, Lq, Lk, D, nq, bq, sc, s);
  if (D <= 128) return by_variant<128>(q, k, v, o, BH, Lq, Lk, D, nq, bq, sc, s);
  return by_variant<160>(q, k, v, o, BH, Lq, Lk, D, nq, bq, sc, s);
}

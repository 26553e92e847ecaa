// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), the counter-based generator behind the band kernels' and the
// fused attention kernels' dropout.
//
// The plain PyTorch version, which the CPU path runs and the tests hold this
// one to, is focused_attention_vit_tpu_torch/ops/philox.py; both must give
// the same bits for the same (counter, key).
//
// The band keys one draw on (seed, b*h row, window slot, query) and on
// nothing about how the kernel is tiled:
//   counter = (query i, slot / 4, row low 32 bits, row high 32 bits)
//   key     = (seed low 32 bits, seed high 32 bits)
//   bits    = word (slot % 4) of the output
// A slot is kept iff bits >= threshold, threshold = min(rate * 2^32, 2^32-1)
// (the JAX kernel's rule, focused_attention_vit_tpu/ops/mhla_band_roll.py
// :107-108). The forward and the backward kernel draw the same bits, so the
// backward regenerates the forward's mask without saving it.
//
// The fused short-S attention (fused_mha_fwd.cu, fused_mha_bwd.cu) keys one
// draw on (seed, b*h row, query i, key j), again on nothing about the tiling,
// the dtype or the direction of the pass. One Philox call yields four words,
// and they go to the four keys that one lane of an mma.m16n8k16 accumulator
// owns in a row of a 16-key chunk (columns 2t, 2t+1, 2t+8, 2t+9), so that the
// tensor-core kernels spend one call per lane, row and chunk:
//   counter = (query i, 4 * (j / 16) + (j % 8) / 2, row low, row high)
//   key     = (seed low 32 bits, seed high 32 bits)
//   bits    = word (j % 2) + 2 * ((j % 16) / 8) of the output
// A weight is kept iff bits >= threshold, the band's rule.

#pragma once

#include <cstdint>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x);
    const uint32_t lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z);
    const uint32_t lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words that decide window slots 4*grp .. 4*grp+3 of query i in
// row `row`: the band's one definition of the stream, which the kernels'
// masks and the generator's test entry point both draw through.
__device__ __forceinline__ uint4 band_words(uint64_t seed, int64_t row, int i,
                                            int grp) {
  const uint64_t urow = static_cast<uint64_t>(row);
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(grp),
                 static_cast<uint32_t>(urow),
                 static_cast<uint32_t>(urow >> 32)),
      make_uint2(static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(seed >> 32)));
}

// Bit o of the result is set iff window slot o (< w <= 16) of query i in
// row `row` is kept.
__device__ __forceinline__ uint32_t band_keep_mask(uint64_t seed, int64_t row,
                                                   int i, int w,
                                                   uint32_t threshold) {
  uint32_t keep = 0;
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
    if (4 * grp < w) {
      const uint4 r = band_words(seed, row, i, grp);
      const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (words[b] >= threshold) keep |= 1u << (4 * grp + b);
      }
    }
  }
  return keep;
}

// The four words of query i and key group `grp` in row `row` of the fused
// attention's stream: for grp = 4 * c + t they decide keys 16c + 2t,
// 16c + 2t + 1, 16c + 2t + 8 and 16c + 2t + 9, in that order. The stream's
// one definition: the kernels and the test entry point draw through it.
__device__ __forceinline__ uint4 mha_words(uint64_t seed, int64_t row, int i,
                                           int grp) {
  return band_words(seed, row, i, grp);
}

__device__ __forceinline__ int mha_group(int j) {
  return 4 * (j >> 4) + ((j & 7) >> 1);
}

// The word that decides key j of query i (scalar kernels: one call a key).
__device__ __forceinline__ uint32_t mha_word(uint64_t seed, int64_t row, int i,
                                             int j) {
  const uint4 r = mha_words(seed, row, i, mha_group(j));
  const bool odd = j & 1;
  return (j & 8) ? (odd ? r.w : r.z) : (odd ? r.y : r.x);
}

}  // namespace philox

// The block of the dense flash forward (flash_attention_fwd.cu), shared with
// the fused short-S forward for rows longer than one block holds
// (fused_mha_fwd.cu), which adds its Philox mask on the numerator through
// the Mask parameter. The design, and what bounds it, is described in
// flash_attention_fwd.cu: two consumer warpgroups of 64 queries and a
// producer warp; Q once and K/V tiles in a 3-stage TMA ring; S = Q K^T and
// O += P V by wgmma with the online softmax on the accumulators.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flash_fwd {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

constexpr int kConsumers = 256;            // two warpgroups of 64 queries
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBM = 128;                   // queries a block

// D is the tile width: the head dim, or the width it is padded to
// (flash_attention_fwd.cu); 192 and 256 take flash_block256.cuh.
template <int D>
struct Fwd {
  static_assert(D <= 128, "tile width");
  // 128-key tiles keep the logits in 64 registers a thread; at D = 128
  // the output accumulator takes 64 registers, so the tiles are 64 keys.
  static constexpr int kBN = D <= 80 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  // Q, the K/V ring, and 1 KB to align the tiles to the swizzle's period.
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
};

// No mask: the dense flash forward.
struct NoMask {
  static constexpr float inv_keep = 1.f;
  template <int N>
  __device__ __forceinline__ void apply(float (&)[N], int64_t, int,
                                        int) const {}
};

// The block's work: a kernel of kThreads threads calls it with its own
// __grid_constant__ tensor maps; `d` is the head dim, the row stride of
// `out` (D, or less when the tiles are padded: the columns past d are
// zeros in Q, K and V, and are not written). `mask.apply(sc, row, i,
// key0)` may zero weights of a key tile after they entered the sum l (rows
// i and i + 8 of this thread, keys from key0, the accumulator layout of
// hopper_common.cuh); the output is scaled by mask.inv_keep / l.
template <int D, bool kLse, class Mask>
__device__ __forceinline__ void block(const CUtensorMap& tq,
                                      const CUtensorMap& tk,
                                      const CUtensorMap& tv,
                                      bf16* __restrict__ out,
                                      float* __restrict__ lse, int s,
                                      int tiles_per_row, float scale_log2,
                                      const Mask& mask, int d = D) {
  using C = Fwd<D>;
  constexpr int BN = C::kBN;
  constexpr int ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[ST], bar_v[ST], bar_free[ST];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  // Stage st: the K tile at ring + 2 st BN D, the V tile after it.
  bf16* ring = reinterpret_cast<bf16*>(smem + C::kQBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kBM;
  const int n = (s + BN - 1) / BN;

  if (tid == 0) {
    hp::mbar_init(&bar_q, 1);
    for (int st = 0; st < ST; ++st) {
      hp::mbar_init(&bar_k[st], 1);
      hp::mbar_init(&bar_v[st], 1);
      hp::mbar_init(&bar_free[st], kConsumers / 32);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one lane issues every copy.
    if (lane == 0) {
      hp::prefetch_tensor_map(&tq);
      hp::prefetch_tensor_map(&tk);
      hp::prefetch_tensor_map(&tv);
      hp::mbar_arrive_expect_tx(&bar_q, C::kQBytes);
      hp::load_tile<D, kBM>(qs, &tq, &bar_q, row, q0);
      for (int j = 0; j < n; ++j) {
        const int st = j % ST;
        // Tile j - ST, which used this stage, must have been consumed.
        if (j >= ST) hp::mbar_wait(&bar_free[st], ((j / ST) & 1) ^ 1);
        bf16* ks = ring + st * 2 * BN * D;
        hp::mbar_arrive_expect_tx(&bar_k[st], C::kTileBytes);
        hp::load_tile<D, BN>(ks, &tk, &bar_k[st], row, j * BN);
        hp::mbar_arrive_expect_tx(&bar_v[st], C::kTileBytes);
        hp::load_tile<D, BN>(ks + BN * D, &tv, &bar_v[st], row, j * BN);
      }
    }
  } else {
    // Consumer warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64); this
    // thread holds rows r and r + 8 of them, columns 8j + 2wq (+1).
    const int wg = warp >> 2;
    const int wq = lane & 3;
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[BN / 2];         // logits, then weights, of one key tile
    uint32_t pa[BN / 16][4];  // the weights as P V's A operand
    // m in log2 units of the scaled logit; l this lane's share of the sum.
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    auto qk = [&](int st) {
      const bf16* ks = ring + st * 2 * BN * D;
      hp::fence_regs(sc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hp::Wgmma<BN>::ss(sc, hp::desc_k<D, kBM>(qs, wg * 64, kk),
                                      hp::desc_k<D, BN>(ks, 0, kk),
                                      kk > 0 ? 1 : 0);
      }
      hp::wgmma_commit();
      hp::fence_regs(sc);
    };
    auto pv = [&](int st) {
      const bf16* vs = ring + st * 2 * BN * D + BN * D;
      hp::fence_regs(o);
      hp::fence_regs(pa);
      hp::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        hp::rs_cols<D, BN>(o, pa[kc], vs, kc);
      }
      hp::wgmma_commit();
      hp::fence_regs(o);
      hp::fence_regs(pa);
    };
    // The online softmax of key tile j on sc, in place: updates m and l and
    // returns the factor that rescales o.
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int key0 = j * BN;
      if (key0 + BN > s) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          if (key0 + (i >> 2) * 8 + 2 * wq + (i & 1) >= s) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // The tile's first key is real, so m_new is finite and neither
        // difference is (-inf) - (-inf).
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        const float p = exp2f(fmaf(sc[i], scale_log2, -m[h]));
        sc[i] = p;
        l[h] += p;
      }
    };
    // The weights, rounded to bf16, into the A operand of P V. Only called
    // when no product is in flight: ptxas serializes every wgmma of a
    // pipeline stage in which other instructions write their registers.
    auto to_pa = [&]() {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) hp::pack_a(pa[kc], sc, kc);
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    };

    // Step j issues Q K_j^T and then P_{j-1} V_{j-1}, and runs the softmax
    // of tile j while P V is in flight. The two warpgroups take turns at
    // issuing (named barriers 1 and 2, warpgroup 0 first), so that one's
    // softmax runs while the other's products keep the tensor cores busy.
    // Each warpgroup takes n + 1 turns and arrives once for each of the
    // other's.
    float alpha[2];
    const int my_bar = 1 + wg, other_bar = 2 - wg;
    if (wg == 1) hp::named_arrive(1, kConsumers);
    hp::mbar_wait(&bar_q, 0);
    hp::mbar_wait(&bar_k[0], 0);
    hp::named_sync(my_bar, kConsumers);
    qk(0);
    hp::named_arrive(other_bar, kConsumers);
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    softmax(0, alpha);
    mask.apply(sc, row, q0 + r, 0);
    to_pa();
    for (int j = 1; j < n; ++j) {
      const int st = j % ST;
      const int pst = (j - 1) % ST;
      hp::mbar_wait(&bar_k[st], (j / ST) & 1);
      hp::mbar_wait(&bar_v[pst], ((j - 1) / ST) & 1);
      hp::named_sync(my_bar, kConsumers);
      qk(st);
      rescale(alpha);  // o is idle until P V is issued
      pv(pst);
      hp::named_arrive(other_bar, kConsumers);
      hp::wgmma_wait<1>();  // Q K_j^T is done; P_{j-1} V_{j-1} may not be
      hp::fence_regs(sc);
      softmax(j, alpha);
      mask.apply(sc, row, q0 + r, j * BN);
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
      hp::fence_regs(pa);
      if (lane == 0) hp::mbar_arrive(&bar_free[pst]);
      to_pa();
    }
    rescale(alpha);
    const int lst = (n - 1) % ST;
    hp::mbar_wait(&bar_v[lst], ((n - 1) / ST) & 1);
    hp::named_sync(my_bar, kConsumers);
    pv(lst);
    if (wg == 0) hp::named_arrive(other_bar, kConsumers);
    hp::wgmma_wait<0>();
    hp::fence_regs(o);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int i = q0 + r + 8 * h;
      if (i >= s) continue;
      const float inv = mask.inv_keep / l[h];
      bf16* orow = out + (static_cast<int64_t>(row) * s + i) * d;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (8 * j >= d) break;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * wq) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
      }
      if (kLse && wq == 0) {
        lse[static_cast<int64_t>(row) * s + i] =
            (m[h] + log2f(l[h])) * flash::kLn2;
      }
    }
  }
}

}  // namespace flash_fwd

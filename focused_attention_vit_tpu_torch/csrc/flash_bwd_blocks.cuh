// The blocks of the dense flash backward's dkv and dq kernels
// (flash_attention_bwd.cu), shared with the fused short-S backward for rows
// longer than one block holds (fused_mha_bwd.cu), which adds its Philox mask
// through the Mask parameter. The design, and what bounds it, is described
// in flash_attention_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flash_bwd {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

constexpr int kConsumers = 256;               // two warpgroups of 64 rows
constexpr int kMmaThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kOwn = 128;                      // rows a block owns
constexpr int kStages = 3;
// Registers a thread after the split: the block is launched with 168 (65536
// over 384 threads); the producer warpgroup, of which one warp issues the
// copies, gives all but 24 back, and the consumers take 240.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// This thread's rows r, r + 8 of its warpgroup's 64 (accumulator layout).
__device__ __forceinline__ int acc_row(int tid) {
  return ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
}

// Rows r and r + 8 of a 64 x D accumulator, rounded, to a [s, d] matrix
// (d <= D: the columns past d, of a padded tile, are not written).
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2],
                                          int r0, int s, int wq, int d = D) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    if (i >= s) continue;
    bf16* row = dst + static_cast<int64_t>(i) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= d) break;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * wq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// No mask: the dense flash backward's elementwise steps.
struct NoMask {
  // S^T and dP^T of a query tile (rows: this thread's keys; columns: the
  // tile's queries, whose lse in log2 units and delta are lse_c, delta_c)
  // into p^T and dS^T.
  template <int N>
  __device__ __forceinline__ void dkv(float (&st)[N], float (&dp)[N],
                                      const float* lse_c,
                                      const float* delta_c, float scale,
                                      float scale_log2, int64_t, int,
                                      int) const {
    const int wq = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = (i >> 2) * 8 + 2 * wq + (i & 1);  // the query
      const float p = exp2f(fmaf(st[i], scale_log2, -lse_c[c]));
      st[i] = p;
      dp[i] = p * (dp[i] - delta_c[c]) * scale;
    }
  }
  // S and dP of the key tile from key0 (rows: this thread's queries, whose
  // lse and delta are lse2, dl) into dS; keys past S get p = 0.
  template <int N>
  __device__ __forceinline__ void dq(const float (&sc)[N], float (&dp)[N],
                                     const float (&lse2)[2],
                                     const float (&dl)[2], float scale,
                                     float scale_log2, int s, int64_t, int,
                                     int key0) const {
    const int wq = threadIdx.x & 3;
    const bool ragged = key0 + 2 * N > s;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(fmaf(sc[i], scale_log2, -lse2[h]));
      if (ragged && key0 + (i >> 2) * 8 + 2 * wq + (i & 1) >= s) p = 0.f;
      dp[i] = p * (dp[i] - dl[h]) * scale;
    }
  }
};

// D is the tile width: the head dim, or the width it is padded to
// (flash_attention_bwd.cu).
template <int D>
struct Dkv {
  static constexpr int kBQ = D <= 64 ? 64 : 32;  // queries a staged tile
  static constexpr int kOwnBytes = kOwn * D * 2;  // the K or the V tile
  static constexpr int kTileBytes = kBQ * D * 2;  // one Q or g tile
  static constexpr int kSmem = 2 * kOwnBytes + 2 * kStages * kTileBytes + 1024;
};

// Which of dk and dv a dkv block sums: both, or (past D = 128, where two
// 64 x D f32 accumulators leave no registers for the tiles) one of them, in
// a launch of its own.
enum Part { kBoth = 0, kDkOnly = 1, kDvOnly = 2 };

// The dkv kernel's block (a kernel of kMmaThreads threads calls it with its
// own __grid_constant__ tensor maps). `mask.dkv` turns a query tile's S^T
// and dP^T into p^T (or z^T, the dropped weights) and dS^T in place. `d` is
// the head dim, the row stride of dk and dv (D, or less for padded tiles).
template <int D, class Mask, int kPart = kBoth>
__device__ __forceinline__ void dkv_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tg, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int s, int tiles_per_row, float scale,
    float scale_log2, const Mask& mask, int d = D) {
  constexpr bool kDk = kPart != kDvOnly;
  constexpr bool kDv = kPart != kDkOnly;
  using C = Dkv<D>;
  constexpr int BQ = C::kBQ;
  constexpr int ST = kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_full[ST], bar_free[ST];
  __shared__ float lse_s[ST][BQ];  // in log2 units; +inf past S
  __shared__ float delta_s[ST][BQ];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kOwn * D;
  // Stage st: the Q tile at ring + 2 st BQ D, the g tile after it.
  bf16* ring = vs + kOwn * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x / tiles_per_row;
  const int key0 = (blockIdx.x % tiles_per_row) * kOwn;
  const int64_t vec = static_cast<int64_t>(row) * s;
  const int n = (s + BQ - 1) / BQ;

  if (tid == 0) {
    hp::mbar_init(&bar_kv, 1);
    for (int st = 0; st < ST; ++st) {
      hp::mbar_init(&bar_full[st], 32);  // every producer lane arrives
      hp::mbar_init(&bar_free[st], kConsumers / 32);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumers / 32) return;
    if (lane == 0) {
      hp::prefetch_tensor_map(&tq);
      hp::prefetch_tensor_map(&tk);
      hp::prefetch_tensor_map(&tv);
      hp::prefetch_tensor_map(&tg);
      hp::mbar_arrive_expect_tx(&bar_kv, 2 * C::kOwnBytes);
      hp::load_tile<D, kOwn>(ks, &tk, &bar_kv, row, key0);
      hp::load_tile<D, kOwn>(vs, &tv, &bar_kv, row, key0);
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % ST;
      if (i >= ST) hp::mbar_wait(&bar_free[st], ((i / ST) & 1) ^ 1);
      for (int c = lane; c < BQ; c += 32) {
        const int qi = i * BQ + c;
        lse_s[st][c] = qi < s ? lse[vec + qi] * flash::kLog2e : INFINITY;
        delta_s[st][c] = qi < s ? delta[vec + qi] : 0.f;
      }
      if (lane == 0) {
        bf16* qt = ring + st * 2 * BQ * D;
        hp::mbar_arrive_expect_tx(&bar_full[st], 2 * C::kTileBytes);
        hp::load_tile<D, BQ>(qt, &tq, &bar_full[st], row, i * BQ);
        hp::load_tile<D, BQ>(qt + BQ * D, &tg, &bar_full[st], row, i * BQ);
      } else {
        hp::mbar_arrive(&bar_full[st]);
      }
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // Consumer warpgroup wg owns keys [key0 + 64 wg, key0 + 64 wg + 64).
    const int wg = warp >> 2;
    const int wq = lane & 3;

    // A part that sums one of them keeps 8 idle registers for the other.
    float dk_acc[kDk ? D / 2 : 8], dv_acc[kDv ? D / 2 : 8];
#pragma unroll
    for (int i = 0; i < (kDk ? D / 2 : 8); ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kDv ? D / 2 : 8); ++i) dv_acc[i] = 0.f;
    float st_acc[BQ / 2], dp_acc[BQ / 2];  // S^T and dP^T of one query tile
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // p^T, ds^T as A operands

    // S^T = K Q^T and dP^T = V g^T of the query tile in stage st.
    auto issue = [&](int st) {
      const bf16* qt = ring + st * 2 * BQ * D;
      hp::fence_regs(st_acc);
      hp::fence_regs(dp_acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hp::Wgmma<BQ>::ss(st_acc,
                                      hp::desc_k<D, kOwn>(ks, wg * 64, kk),
                                      hp::desc_k<D, BQ>(qt, 0, kk),
                                      kk > 0 ? 1 : 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hp::Wgmma<BQ>::ss(dp_acc,
                                      hp::desc_k<D, kOwn>(vs, wg * 64, kk),
                                      hp::desc_k<D, BQ>(qt + BQ * D, 0, kk),
                                      kk > 0 ? 1 : 0);
      }
      hp::wgmma_commit();
      hp::fence_regs(st_acc);
      hp::fence_regs(dp_acc);
    };
    // dv += P^T g and dk += dS^T Q.
    auto accumulate = [&](int st) {
      const bf16* qt = ring + st * 2 * BQ * D;
      hp::fence_regs(dk_acc);
      hp::fence_regs(dv_acc);
      hp::fence_regs(pa);
      hp::fence_regs(da);
      hp::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        if constexpr (kDv) {
          hp::rs_cols<D, BQ>(dv_acc, pa[kc], qt + BQ * D, kc);
        }
        if constexpr (kDk) {
          hp::rs_cols<D, BQ>(dk_acc, da[kc], qt, kc);
        }
      }
      hp::wgmma_commit();
      hp::fence_regs(dk_acc);
      hp::fence_regs(dv_acc);
      hp::fence_regs(pa);
      hp::fence_regs(da);
    };
    // p^T and ds^T of query tile i (in stage st), rounded into pa and da.
    auto grads = [&](int st, int i) {
      mask.dkv(st_acc, dp_acc, lse_s[st], delta_s[st], scale, scale_log2, row,
               key0 + wg * 64 + (warp & 3) * 16, i * BQ);
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        hp::pack_a(pa[kc], st_acc, kc);
        hp::pack_a(da[kc], dp_acc, kc);
      }
    };

    // The two warpgroups run this loop without turns: taking turns at the
    // tensor cores, as the dq kernel does, measured slower here (PERF.md).
    hp::mbar_wait(&bar_kv, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % ST;
      hp::mbar_wait(&bar_full[st], (i / ST) & 1);
      issue(st);
      hp::wgmma_wait<0>();
      hp::fence_regs(st_acc);
      hp::fence_regs(dp_acc);
      grads(st, i);
      accumulate(st);
      hp::wgmma_wait<0>();
      hp::fence_regs(dk_acc);
      hp::fence_regs(dv_acc);
      hp::fence_regs(pa);
      hp::fence_regs(da);
      if (lane == 0) hp::mbar_arrive(&bar_free[st]);
    }

    const int r0 = key0 + wg * 64 + acc_row(tid);
    if constexpr (kDk) store_acc<D>(dk + vec * d, dk_acc, r0, s, wq, d);
    if constexpr (kDv) store_acc<D>(dv + vec * d, dv_acc, r0, s, wq, d);
  }
}

template <int D>
struct Dq {
  // Keys a staged tile: 32 past D = 128, where the ring of 64 would not
  // fit shared memory beside the Q and g tiles.
  static constexpr int kBN = D <= 128 ? 64 : 32;
  static constexpr int kOwnBytes = kOwn * D * 2;  // the Q or the g tile
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kSmem = 2 * kOwnBytes + 2 * kStages * kTileBytes + 1024;
};

// The dq kernel's block. `mask.dq` turns a key tile's S and dP into dS in
// place (keys past S get p = 0). `d` is the head dim, dq's row stride.
template <int D, class Mask>
__device__ __forceinline__ void dq_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tg, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int s,
    int tiles_per_row, float scale, float scale_log2, const Mask& mask,
    int d = D) {
  using C = Dq<D>;
  constexpr int BN = C::kBN;
  constexpr int ST = kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qg, bar_full[ST], bar_free[ST];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + kOwn * D;
  // Stage st: the K tile at ring + 2 st BN D, the V tile after it.
  bf16* ring = gs + kOwn * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kOwn;
  const int64_t vec = static_cast<int64_t>(row) * s;
  const int n = (s + BN - 1) / BN;

  if (tid == 0) {
    hp::mbar_init(&bar_qg, 1);
    for (int st = 0; st < ST; ++st) {
      hp::mbar_init(&bar_full[st], 1);
      hp::mbar_init(&bar_free[st], kConsumers / 32);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kConsumers / 32) return;
    if (lane == 0) {
      hp::prefetch_tensor_map(&tq);
      hp::prefetch_tensor_map(&tk);
      hp::prefetch_tensor_map(&tv);
      hp::prefetch_tensor_map(&tg);
      hp::mbar_arrive_expect_tx(&bar_qg, 2 * C::kOwnBytes);
      hp::load_tile<D, kOwn>(qs, &tq, &bar_qg, row, q0);
      hp::load_tile<D, kOwn>(gs, &tg, &bar_qg, row, q0);
      for (int j = 0; j < n; ++j) {
        const int st = j % ST;
        if (j >= ST) hp::mbar_wait(&bar_free[st], ((j / ST) & 1) ^ 1);
        bf16* kt = ring + st * 2 * BN * D;
        hp::mbar_arrive_expect_tx(&bar_full[st], 2 * C::kTileBytes);
        hp::load_tile<D, BN>(kt, &tk, &bar_full[st], row, j * BN);
        hp::load_tile<D, BN>(kt + BN * D, &tv, &bar_full[st], row, j * BN);
      }
    }
  } else {
    hp::reg_alloc<kConsumerRegs>();
    // Consumer warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64).
    const int wg = warp >> 2;
    const int wq = lane & 3;
    const int r0 = q0 + wg * 64 + acc_row(tid);
    float lse2[2], dl[2];  // rows r0 and r0 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + 8 * h;
      lse2[h] = i < s ? lse[vec + i] * flash::kLog2e : INFINITY;
      dl[h] = i < s ? delta[vec + i] : 0.f;
    }

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float s_acc[BN / 2], dp_acc[BN / 2];  // S and dP of one key tile
    uint32_t da[BN / 16][4];              // ds as the A operand

    // S = Q K^T and dP = g V^T of the key tile in stage st.
    auto issue = [&](int st) {
      const bf16* kt = ring + st * 2 * BN * D;
      hp::fence_regs(s_acc);
      hp::fence_regs(dp_acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hp::Wgmma<BN>::ss(s_acc,
                                      hp::desc_k<D, kOwn>(qs, wg * 64, kk),
                                      hp::desc_k<D, BN>(kt, 0, kk),
                                      kk > 0 ? 1 : 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hp::Wgmma<BN>::ss(dp_acc,
                                      hp::desc_k<D, kOwn>(gs, wg * 64, kk),
                                      hp::desc_k<D, BN>(kt + BN * D, 0, kk),
                                      kk > 0 ? 1 : 0);
      }
      hp::wgmma_commit();
      hp::fence_regs(s_acc);
      hp::fence_regs(dp_acc);
    };
    // dq += dS K.
    auto accumulate = [&](int st) {
      const bf16* kt = ring + st * 2 * BN * D;
      hp::fence_regs(dq_acc);
      hp::fence_regs(da);
      hp::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        hp::rs_cols<D, BN>(dq_acc, da[kc], kt, kc);
      }
      hp::wgmma_commit();
      hp::fence_regs(dq_acc);
      hp::fence_regs(da);
    };
    // ds of key tile j, rounded into da; keys past S get p = 0.
    auto grads = [&](int j) {
      mask.dq(s_acc, dp_acc, lse2, dl, scale, scale_log2, s, row, r0, j * BN);
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) hp::pack_a(da[kc], dp_acc, kc);
    };

    // Turn t (0..n) of this warpgroup at the tensor cores issues dq's
    // product for key tile t - 1 and S, dP of tile t; between turns it
    // waits for them and computes tile t's ds. The warpgroups alternate
    // (named barriers 1 and 2, warpgroup 0 first), so that one's
    // exponentials run while the other's products do.
    const int my_bar = 1 + wg, other_bar = 2 - wg;
    if (wg == 1) hp::named_arrive(1, kConsumers);
    hp::mbar_wait(&bar_qg, 0);
    hp::mbar_wait(&bar_full[0], 0);
    hp::named_sync(my_bar, kConsumers);
    issue(0);
    hp::named_arrive(other_bar, kConsumers);
    hp::wgmma_wait<0>();
    hp::fence_regs(s_acc);
    hp::fence_regs(dp_acc);
    grads(0);
    for (int j = 0; j + 1 < n; ++j) {
      const int st = j % ST;
      const int nst = (j + 1) % ST;
      hp::mbar_wait(&bar_full[nst], ((j + 1) / ST) & 1);
      hp::named_sync(my_bar, kConsumers);
      accumulate(st);
      issue(nst);
      hp::named_arrive(other_bar, kConsumers);
      hp::wgmma_wait<0>();
      hp::fence_regs(dq_acc);
      hp::fence_regs(da);
      hp::fence_regs(s_acc);
      hp::fence_regs(dp_acc);
      if (lane == 0) hp::mbar_arrive(&bar_free[st]);
      grads(j + 1);
    }
    hp::named_sync(my_bar, kConsumers);
    accumulate((n - 1) % ST);
    if (wg == 0) hp::named_arrive(other_bar, kConsumers);
    hp::wgmma_wait<0>();
    hp::fence_regs(dq_acc);
    hp::fence_regs(da);
    store_acc<D>(dq + vec * d, dq_acc, r0, s, wq, d);
  }
}

}  // namespace flash_bwd

// Dense (non-causal) flash attention, backward, for Hopper (sm_90a).
//
// Replaces: the custom-VJP backward of JAX's bundled Pallas flash kernel
// (its dkv and dq kernels), reached through
// focused_attention_vit_tpu/ops/flash_attention_pallas.py::flash_attention_tpu
// (:28, call at :73). Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/flash_attention.py.
//
// What it computes, from q, k, v, the forward's out and lse (f32 [B*h, S])
// and the cotangent g of out, all contiguous [B*h, S, d]:
//   p_ij  = exp(q_i . k_j * scale - lse_i)         (the softmax, recomputed)
//   delta_i = sum_c g_ic out_ic
//   dv_j  = sum_i p_ij g_i
//   dp_ij = g_i . v_j,  ds_ij = p_ij (dp_ij - delta_i) scale
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// with f32 sums, rounded once to the input dtype. Nothing of size S x S is
// stored; only q, k, v, out and lse were saved.
//
// Three kernels, launched in order on one stream:
//   1. delta: a thread per query row (flash_common.cuh);
//   2. dkv: a block owns a tile of keys and loops over the query tiles;
//   3. dq: a block owns a tile of queries and loops over the key tiles.
// The TPU kernels carry the dk/dv (and dq) sums in scratch memory across a
// sequential grid. Blocks on this card run in parallel in no order, so the
// sum over the other axis is a loop inside the block, and each of dq, dk,
// dv is written by exactly one thread: no atomics, and the result is the
// same from run to run. The price is that the logits and dp are computed
// twice (7 matrix products instead of 5) and so are the exponentials.
//
// What bounds it on this card: operations. The function needs
// 10*B*h*S^2*d flops (2.4 TFLOP at B*h=384, S=3137, d=64: 2.4 ms at the
// 989 TFLOP/s bf16 peak) against 1.4 GB of q, k, v, out, g, dq, dk, dv
// (0.4 ms at 3.35 TB/s); the deterministic design does 7/5 of those
// products (3.4 ms) and 2 B*h*S^2 exponentials. So the bf16 kernels run
// every product as an asynchronous warpgroup product (wgmma, f32
// accumulators). Each block is two consumer warpgroups of 64 rows and a
// producer warpgroup, one warp of which brings tiles by TMA (3-D maps over
// [B*h, S, d]: a tile past S is zero-filled and never reads the next head)
// into a ring of 3 stages with "full" and "free" mbarriers; the
// producer keeps 24 registers a thread and the consumers take 240
// (setmaxnreg), which holds the d = 64 kernels free of spills:
//   - dkv: a block keeps 128 keys (K and V tiles, loaded once) and streams
//     Q and g tiles of 64 queries (32 at d = 128) with their lse and delta,
//     which the producer warp writes beside them. S^T = K Q^T and dP^T = V g^T are wgmmas with both
//     operands in shared memory; p^T and ds^T stay in registers, rounded to
//     bf16, as the register A operands of dv += P^T g and dk += dS^T Q,
//     whose B operands are read through the transpose bit. A query past S
//     arrives as zeros with lse = +inf, so its p and ds are 0. Each
//     warpgroup runs products, then exponentials, then products; the two
//     warpgroups overlap each other freely;
//   - dq: a block keeps 128 queries (Q and g tiles, loaded once) and streams
//     K and V tiles of 64 keys; S = Q K^T and dP = g V^T from shared memory,
//     ds in registers as the A operand of dq += dS K. Keys past S are masked
//     on the last tile. The two warpgroups take turns at the tensor cores:
//     a turn issues one tile's dq product and the next tile's S and dP, so
//     that one warpgroup's exponentials run under the other's products.
// Every wgmma's registers are written only while no product is in flight
// (ptxas serializes the products of a pipeline stage otherwise).
// p and ds are rounded to bf16 for the second products; the plain version
// keeps them in f32.
//
// The f32 instantiations are scalar-FMA kernels (a thread per key, or per
// query, with the other side's tile broadcast from shared memory): full f32
// products, for parity runs at small shapes, not for speed. They keep up to
// 4*d floats a thread and spill beyond d = 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

constexpr int kThreads = 128;  // the f32 kernels: 128 scalar rows a block

constexpr int kConsumers = 256;               // two warpgroups of 64 rows
constexpr int kMmaThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kOwn = 128;                      // rows a block owns
constexpr int kStages = 3;
// Registers a thread after the split: the block is launched with 168 (65536
// over 384 threads); the producer warpgroup, of which one warp issues the
// copies, gives all but 24 back, and the consumers take 240.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

using flash::load_row;
using flash::store_row;

// This thread's rows r, r + 8 of its warpgroup's 64 (accumulator layout).
__device__ __forceinline__ int acc_row(int tid) {
  return ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
}

// Rows r and r + 8 of a 64 x D accumulator, rounded, to a [s, D] matrix.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2],
                                          int r0, int s, int wq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    if (i >= s) continue;
    bf16* row = dst + static_cast<int64_t>(i) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * wq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
struct Dkv {
  static constexpr int kBQ = D <= 64 ? 64 : 32;  // queries a staged tile
  static constexpr int kOwnBytes = kOwn * D * 2;  // the K or the V tile
  static constexpr int kTileBytes = kBQ * D * 2;  // one Q or g tile
  static constexpr int kSmem = 2 * kOwnBytes + 2 * kStages * kTileBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tg,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int s, int tiles_per_row,
                        float scale, float scale_log2) {
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

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
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
        hp::Wgmma<D>::rs(dv_acc, pa[kc],
                                     hp::desc_mn<D, BQ>(qt + BQ * D, kc), 1);
        hp::Wgmma<D>::rs(dk_acc, da[kc],
                                     hp::desc_mn<D, BQ>(qt, kc), 1);
      }
      hp::wgmma_commit();
      hp::fence_regs(dk_acc);
      hp::fence_regs(dv_acc);
      hp::fence_regs(pa);
      hp::fence_regs(da);
    };
    // p^T and ds^T of the query tile in stage st, rounded into pa and da.
    auto grads = [&](int st) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = (i >> 2) * 8 + 2 * wq + (i & 1);  // the query
        const float p = exp2f(fmaf(st_acc[i], scale_log2, -lse_s[st][c]));
        st_acc[i] = p;
        dp_acc[i] = p * (dp_acc[i] - delta_s[st][c]) * scale;
      }
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
      grads(st);
      accumulate(st);
      hp::wgmma_wait<0>();
      hp::fence_regs(dk_acc);
      hp::fence_regs(dv_acc);
      hp::fence_regs(pa);
      hp::fence_regs(da);
      if (lane == 0) hp::mbar_arrive(&bar_free[st]);
    }

    const int r0 = key0 + wg * 64 + acc_row(tid);
    store_acc<D>(dk + vec * D, dk_acc, r0, s, wq);
    store_acc<D>(dv + vec * D, dv_acc, r0, s, wq);
  }
}

template <int D>
struct Dq {
  static constexpr int kBN = 64;                  // keys a staged tile
  static constexpr int kOwnBytes = kOwn * D * 2;  // the Q or the g tile
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kSmem = 2 * kOwnBytes + 2 * kStages * kTileBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tg,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int s, int tiles_per_row, float scale,
                       float scale_log2) {
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
        hp::Wgmma<D>::rs(dq_acc, da[kc],
                                     hp::desc_mn<D, BN>(kt, kc), 1);
      }
      hp::wgmma_commit();
      hp::fence_regs(dq_acc);
      hp::fence_regs(da);
    };
    // ds of key tile j, rounded into da; keys past S get p = 0.
    auto grads = [&](int j) {
      const int key0 = j * BN;
      const bool ragged = key0 + BN > s;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = exp2f(fmaf(s_acc[i], scale_log2, -lse2[h]));
        if (ragged && key0 + (i >> 2) * 8 + 2 * wq + (i & 1) >= s) p = 0.f;
        dp_acc[i] = p * (dp_acc[i] - dl[h]) * scale;
      }
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
    store_acc<D>(dq + vec * D, dq_acc, r0, s, wq);
  }
}

// --- f32: scalar FMA, a thread per row of the owned tile -------------------

constexpr int kF32Tile = 32;  // rows of the staged tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int s, int tiles_per_row,
                      float scale) {
  __shared__ __align__(16) float qs[kF32Tile * D];
  __shared__ __align__(16) float gs[kF32Tile * D];
  __shared__ float lse_s[kF32Tile];
  __shared__ float delta_s[kF32Tile];

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int j = (blockIdx.x % tiles_per_row) * kThreads + tid;  // the key
  const bool real = j < s;
  const int64_t base = row * static_cast<int64_t>(s) * D;
  const int64_t vec = row * static_cast<int64_t>(s);

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
  load_row<D>(kr, k + base + static_cast<int64_t>(j) * D, real);
  load_row<D>(vr, v + base + static_cast<int64_t>(j) * D, real);
#pragma unroll
  for (int c = 0; c < D; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int q0 = 0; q0 < s; q0 += kF32Tile) {
    flash::load_tile_f32<kF32Tile, D, kThreads>(qs, q + base, q0, s, tid);
    flash::load_tile_f32<kF32Tile, D, kThreads>(gs, g + base, q0, s, tid);
    if (tid < kF32Tile && q0 + tid < s) {
      lse_s[tid] = lse[vec + q0 + tid];
      delta_s[tid] = delta[vec + q0 + tid];
    }
    __syncthreads();
    const int nq = min(kF32Tile, s - q0);
    for (int ii = 0; ii < nq; ++ii) {
      const float* qr = qs + ii * D;
      const float* gr = gs + ii * D;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dot += qr[c] * kr[c];
        dp += gr[c] * vr[c];
      }
      const float p = expf(dot * scale - lse_s[ii]);
      const float ds = p * (dp - delta_s[ii]) * scale;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dv_acc[c] += p * gr[c];
        dk_acc[c] += ds * qr[c];
      }
    }
    __syncthreads();
  }
  if (!real) return;
  store_row<D>(dk + base + static_cast<int64_t>(j) * D, dk_acc);
  store_row<D>(dv + base + static_cast<int64_t>(j) * D, dv_acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int s, int tiles_per_row, float scale) {
  __shared__ __align__(16) float ks[kF32Tile * D];
  __shared__ __align__(16) float vs[kF32Tile * D];

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int i = (blockIdx.x % tiles_per_row) * kThreads + tid;  // the query
  const bool real = i < s;
  const int64_t base = row * static_cast<int64_t>(s) * D;
  const int64_t vec = row * static_cast<int64_t>(s);

  float qr[D], gr[D], dq_acc[D];
  load_row<D>(qr, q + base + static_cast<int64_t>(i) * D, real);
  load_row<D>(gr, g + base + static_cast<int64_t>(i) * D, real);
#pragma unroll
  for (int c = 0; c < D; ++c) dq_acc[c] = 0.f;
  const float lse_i = real ? lse[vec + i] : 0.f;
  const float delta_i = real ? delta[vec + i] : 0.f;

  for (int key0 = 0; key0 < s; key0 += kF32Tile) {
    flash::load_tile_f32<kF32Tile, D, kThreads>(ks, k + base, key0, s, tid);
    flash::load_tile_f32<kF32Tile, D, kThreads>(vs, v + base, key0, s, tid);
    __syncthreads();
    const int nk = min(kF32Tile, s - key0);
    for (int jj = 0; jj < nk; ++jj) {
      const float* kr = ks + jj * D;
      const float* vr = vs + jj * D;
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dot += qr[c] * kr[c];
        dp += gr[c] * vr[c];
      }
      const float p = expf(dot * scale - lse_i);
      const float ds = p * (dp - delta_i) * scale;
#pragma unroll
      for (int c = 0; c < D; ++c) dq_acc[c] += ds * kr[c];
    }
    __syncthreads();
  }
  if (!real) return;
  store_row<D>(dq + base + static_cast<int64_t>(i) * D, dq_acc);
}

struct Args {
  const void *q, *k, *v, *out, *lse, *g;
  void *dq, *dk, *dv, *delta;
  int64_t rows;
  int s;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  const int tiles = (a.s + kOwn - 1) / kOwn;
  const int64_t blocks = a.rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  // Boxes of kOwn rows for the tiles a block keeps, of the staged tile's
  // rows for the ones it streams.
  CUtensorMap q_own, g_own, k_own, v_own, q_str, g_str, k_str, v_str;
  cudaError_t err = cudaSuccess;
  const struct {
    CUtensorMap* map;
    const void* base;
    int box;
  } maps[8] = {{&q_own, a.q, kOwn},         {&g_own, a.g, kOwn},
               {&k_own, a.k, kOwn},         {&v_own, a.v, kOwn},
               {&q_str, a.q, Dkv<D>::kBQ},  {&g_str, a.g, Dkv<D>::kBQ},
               {&k_str, a.k, Dq<D>::kBN},   {&v_str, a.v, Dq<D>::kBN}};
  for (const auto& m : maps) {
    if (err == cudaSuccess) {
      err = hp::tensor_map_3d(m.map, m.base, a.rows, a.s, D, m.box);
    }
  }
  if (err != cudaSuccess) return err;
  err = flash::launch_delta<bf16, D, flash::for_flash_bwd>(
      a.out, a.g, a.delta, a.rows * a.s, a.stream);
  if (err != cudaSuccess) return err;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const float scale_log2 = a.scale * flash::kLog2e;
  const dim3 grid(static_cast<unsigned>(blocks));

  auto dkv = flash_bwd_dkv_wgmma<D>;
  err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv<D>::kSmem);
  if (err != cudaSuccess) return err;
  dkv<<<grid, kMmaThreads, Dkv<D>::kSmem, a.stream>>>(
      q_str, k_own, v_own, g_str, lse, delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.s, tiles, a.scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dq = flash_bwd_dq_wgmma<D>;
  err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<D>::kSmem);
  if (err != cudaSuccess) return err;
  dq<<<grid, kMmaThreads, Dq<D>::kSmem, a.stream>>>(
      q_own, k_str, v_str, g_own, lse, delta, static_cast<bf16*>(a.dq), a.s,
      tiles, a.scale, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, bool is_bf16) {
  if (is_bf16) return launch_wgmma<D>(a);
  const int tiles = (a.s + kThreads - 1) / kThreads;  // rows a block owns
  const int64_t blocks = a.rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err = flash::launch_delta<float, D, flash::for_flash_bwd>(
      a.out, a.g, a.delta, a.rows * a.s, a.stream);
  if (err != cudaSuccess) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* g = static_cast<const float*>(a.g);
  flash_bwd_dkv_f32<D><<<grid, kThreads, 0, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.s, tiles, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<D><<<grid, kThreads, 0, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<float*>(a.dq), a.s, tiles,
      a.scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// first launch that failed (0 on success). q, k, v, out, g and dq, dk, dv
// are device pointers to contiguous [rows, s, d] tensors of one dtype
// (is_bf16 = 1 for bf16, 0 for f32), 16-byte aligned; `lse` is the
// forward's f32 [rows, s]; `delta` is f32 [rows, s] scratch that the first
// kernel fills. `stream` is the caller's cudaStream_t. The kernels allocate
// nothing and do not synchronise.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* lse, const void* g, void* dq,
                                   void* dk, void* dv, void* delta,
                                   long long rows, int s, int d, int is_bf16,
                                   float scale, int device, void* stream) {
  if (rows <= 0 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,  k,  v,     out,  lse, g,     dq,
               dk, dv, delta, rows, s,   scale, static_cast<cudaStream_t>(stream)};
  const bool bf = is_bf16 != 0;
  switch (d) {
    case 16:
      err = launch_d<16>(a, bf);
      break;
    case 32:
      err = launch_d<32>(a, bf);
      break;
    case 64:
      err = launch_d<64>(a, bf);
      break;
    case 128:
      err = launch_d<128>(a, bf);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory, in bytes, that the bf16 dkv (kernel = 0) or dq
// (kernel = 1) kernel at head dim d is launched with (0 for a head dim it
// does not take).
extern "C" int flash_attention_bwd_smem(int d, int kernel) {
  switch (d) {
    case 16:
      return kernel == 0 ? Dkv<16>::kSmem : Dq<16>::kSmem;
    case 32:
      return kernel == 0 ? Dkv<32>::kSmem : Dq<32>::kSmem;
    case 64:
      return kernel == 0 ? Dkv<64>::kSmem : Dq<64>::kSmem;
    case 128:
      return kernel == 0 ? Dkv<128>::kSmem : Dq<128>::kSmem;
    default:
      return 0;
  }
}

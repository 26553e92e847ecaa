// The dense attention blocks at the tile widths 192 and 256 (head dims 136
// to 256, flash::tile_width): the forward of flash_attention_fwd.cu and of
// fused_mha_fwd.cu (rows past the whole-row kernel's 64 keys), the dkv and
// dq kernels of flash_attention_bwd.cu and fused_mha_bwd.cu. The fused op
// passes its Philox mask through the Mask parameter; the dense op passes
// NoMask below.
//
// Replaces, at these widths, what the narrower blocks replace:
// focused_attention_vit_tpu/ops/flash_attention_pallas.py::flash_attention_tpu
// (:28, JAX's bundled flash kernel at :73, forward and backward) and
// focused_attention_vit_tpu/ops/mha_kernel.py::_fwd_kernel (:59, pallas_call
// :146) and ::_bwd_kernel (:83, :172) past one block's row.
//
// Why blocks of their own: a 64 x D f32 accumulator of the output (or of
// dk, dv) is 96 or 128 registers a thread here. The blocks up to 128
// (flash_fwd_block.cuh, flash_bwd_blocks.cuh) run a producer warp or
// warpgroup beside two consumer warpgroups, and ptxas holds every thread of
// such a launch to 168 registers, setmaxnreg or not (the d = 128 dkv
// kernel spills 80 bytes at a 24/240 split; PERF.md). These blocks are two
// warpgroups and nothing else, 256 threads, so ptxas may give a thread 255
// registers; one thread of warpgroup 1 (kLoader) issues every TMA copy.
//
// What bounds them: operations. The forward does 4 S^2 d (Q K^T, P V), the
// backward 14 S^2 d (dkv 8, dq 6) against the function's 10 S^2 d, and
// S^2 exponentials each (at B*h = 128, S = 1370, d = 256: 0.25 and 0.87
// ms at 989 TFLOP/s). Every product is a wgmma with f32 accumulators:
//   - forward: a block owns 128 queries (64 a warpgroup, Q loaded once) and
//     streams K and V tiles of 80 keys (96 at D = 192; 64 at 256 under the
//     fused op's dropout draw) through two rings of their own, 2 stages
//     each (225 and 193 KB of shared memory).
//     The warpgroups take turns at issuing (named barriers 1 and 2): a turn
//     issues Q K_j^T and P_{j-1} V_{j-1}, then the online softmax of tile
//     j runs under the other warpgroup's products. Warpgroup 0's turn on a
//     tile always comes first, so its warps arrive on the tile's "free"
//     barrier and the loader, in warpgroup 1, refills the stage once its
//     own products on the tile have completed: K_j right after Q K_j^T,
//     V_{j-1} after P_{j-1} V_{j-1};
//   - dkv: a block owns 64 keys (K and V loaded once) and streams 64-query
//     Q and g tiles. Warpgroup 0 forms S^T = K Q^T, the weights p^T (one
//     exponential each) and dv += P^T g; warpgroup 1 forms dP^T = V g^T,
//     reads p^T from shared memory (a 16 KB f32 tile, the sign bit set
//     where the mask dropped the weight) and adds dk += dS^T Q. Each
//     product is formed once: 8 S^2 d and S^2 exponentials;
//   - dq: Q and g loaded once, 64-key K and V tiles streamed. At D = 192
//     a block owns 128 queries, 64 a warpgroup, and each warpgroup forms
//     S = Q K^T, dP = g V^T, p and dS of its rows and adds dq += dS K over
//     all columns. At 256 (S, dP and 128 registers of dq do not fit one
//     thread) a block owns 64 queries: warpgroup 0 forms S and p,
//     warpgroup 1 dP; they swap the two tiles through shared memory, both
//     form dS, and each adds dq += dS K over its share of the columns
//     (D - 128 and 128: warpgroup 0 also takes the exponentials). 6 S^2 d.
//     (Q and g held in registers as the A operand, and the next tile's S
//     and dP issued ahead of this tile's dq product, each measured no
//     faster: PERF.md.)
// No atomics: each of dq, dk, dv is written by one thread once, so a run
// gives the same bits as the last. A product's registers are written only
// while it is not in flight (ptxas serializes every wgmma of a pipeline
// stage otherwise); every product group completes before a loop's back
// edge. Tiles past S arrive as zeros (TMA), keys past S get p = 0 (forward:
// a logit of -inf), queries past S an lse of +inf; rows past S and columns
// past d are not stored. The masks act on a warp's 16 rows of the wgmma
// accumulator layout (hopper_common.cuh), as in the narrower blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flash256 {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

constexpr int kThreads = 256;   // two warpgroups, nothing else
constexpr int kLoader = 128;    // warpgroup 1's first thread issues the copies
constexpr int kTile = 64;       // rows of a streamed or owned tile
constexpr int kXElems = 64 * 64;  // one warpgroup's f32 tile to swap
constexpr int kXFull = 1;       // dkv: p^T written (named barriers)
constexpr int kXFree = 2;       // dkv: p^T read
constexpr int kXchg = 1;        // dq: both warpgroups' tiles

// kDraws: the mask draws dropout words in the softmax (the fused op's).
template <int D, bool kDraws = false>
struct Fwd {
  static_assert(D == 192 || D == 256, "tile width");
  static constexpr int kBM = 128;  // queries a block, 64 a warpgroup
  // Keys a K or V tile: the widest that leaves two stages of each ring
  // beside Q (a wider N eases the shared-memory reads of Q K^T, whose A
  // and B both come from there) and the logits' 40 or 48 registers beside
  // the accumulator; 64-key tiles measured 9% (D = 256) and 16% (192)
  // slower, ring depths of 3 and 2, or 2 and 3, alike. At 256 a mask that
  // draws takes 64 (with 80 the draw's registers spilled 24 bytes).
  static constexpr int kBN = D == 192 ? 96 : kDraws ? 64 : 80;
  static constexpr int kKStages = 2;
  static constexpr int kVStages = 2;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  // Q, the two rings, and 1 KB to align the tiles to the swizzle's period.
  static constexpr int kSmem =
      kQBytes + (kKStages + kVStages) * kTileBytes + 1024;
};

template <int D>
struct Bwd {
  static_assert(D == 192 || D == 256, "tile width");
  static constexpr int kTileBytes = kTile * D * 2;  // one 64-row tile
  // Stages of the streamed tiles (two 64-row tiles a stage). dkv: K and
  // V, the ring of Q and g, p^T. dq: Q and g, the ring of K and V (and at
  // 256 both warpgroups' swapped tiles).
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kDkvSmem =
      2 * kTileBytes + 2 * kStages * kTileBytes + kXElems * 4 + 1024;
  // dq's queries a block: at 192 each warpgroup owns 64 (S, dP and 96
  // registers of dq fit one thread), and Q and g of 128 rows leave room
  // for 2 stages; at 256 the warpgroups share 64 and swap S and dP.
  static constexpr bool kDqRows = D == 192;
  static constexpr int kDqQueries = kDqRows ? 2 * kTile : kTile;
  static constexpr int kDqStages = kDqRows ? 2 : kStages;
  static constexpr int kDqSmem =
      kDqRows ? 4 * kTileBytes + 2 * kDqStages * kTileBytes + 1024
              : 2 * kTileBytes + 2 * kStages * kTileBytes + 2 * kXElems * 4 +
                    1024;
};

// The column index (0..15) of accumulator element e among this lane's: its
// columns are 8 (e / 4) + 2 q + e % 2 of the 64 (hopper_common.cuh).
__device__ __forceinline__ constexpr int col_of(int e) {
  return 2 * (e >> 2) + (e & 1);
}

// No mask: the dense flash attention's elementwise steps. A mask keeps the
// weight p as it is and marks a dropped one by its sign bit in the tile
// that crosses to the other warpgroup (p >= 0, so the bit is free).
struct NoMask {
  static constexpr bool kDraws = false;
  static constexpr float inv_keep = 1.f;
  // Forward: the weights of a key tile after they entered the sum.
  template <int N>
  __device__ __forceinline__ void apply(float (&)[N], int64_t, int,
                                        int) const {}
  // dkv, warpgroup 0: S^T (rows this lane's keys kb + g and kb + g + 8,
  // columns the queries q0 + 8 (e / 4) + 2 q + e % 2, whose lse in log2
  // units is lse_c[col_of(e)]) into the weights dv takes, in place, and p
  // to the exchange x (element e at x[128 e]).
  template <int N>
  __device__ __forceinline__ void dkv_p(float (&st)[N], float* x,
                                        const float (&lse_c)[N / 2],
                                        float scale_log2, int64_t, int,
                                        int) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float p = exp2f(fmaf(st[e], scale_log2, -lse_c[col_of(e)]));
      st[e] = p;
      x[128 * e] = p;
    }
  }
  // dkv, warpgroup 1: dP^T into dS^T, in place, from the exchange's p.
  template <int N>
  __device__ __forceinline__ void dkv_ds(float (&dp)[N], const float* x,
                                         const float (&dl)[N / 2],
                                         float scale) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      dp[e] = x[128 * e] * (dp[e] - dl[col_of(e)]) * scale;
    }
  }
  // dq (warpgroup 0 at 256): S of the key tile from key0 (rows this
  // lane's queries, whose lse in log2 units is lse2) into p, in place;
  // keys past S get 0.
  template <int N>
  __device__ __forceinline__ void dq_p(float (&sc)[N], const float (&lse2)[2],
                                       float scale_log2, int s, int64_t,
                                       int, int key0) const {
    const int wq = threadIdx.x & 3;
    const bool ragged = key0 + 2 * N > s;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float p = exp2f(fmaf(sc[e], scale_log2, -lse2[(e >> 1) & 1]));
      if (ragged && key0 + (e >> 2) * 8 + 2 * wq + (e & 1) >= s) p = 0.f;
      sc[e] = p;
    }
  }
  // dq, every warpgroup: dS from p (x) and dP; ds may be either of them.
  template <int N>
  __device__ __forceinline__ void dq_ds(const float (&x)[N],
                                        const float (&dp)[N], float (&ds)[N],
                                        const float (&dl)[2],
                                        float scale) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      ds[e] = x[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;
    }
  }
};

// dS from an exchanged weight x (p, its sign bit set where the mask dropped
// it), dP, the row's delta, the scale and the kept weights' factor: the
// fused op's p (dp keep - delta) scale.
__device__ __forceinline__ float masked_ds(float x, float dp, float delta,
                                           float scale, float inv_keep) {
  const float keep = (__float_as_uint(x) >> 31) ? 0.f : inv_keep;
  return fabsf(x) * (dp * keep - delta) * scale;
}

// Rows r0 and r0 + 8 of a 64 x NC accumulator, rounded, to columns
// [n0, n0 + NC) of a [s, d] matrix (columns past d, of a padded tile, are
// not written).
template <int NC>
__device__ __forceinline__ void store_cols(bf16* dst,
                                           const float (&acc)[NC / 2], int r0,
                                           int s, int wq, int n0, int d) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    if (i >= s) continue;
    bf16* row = dst + static_cast<int64_t>(i) * d + n0;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      if (n0 + 8 * j >= d) break;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * wq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// --- forward ----------------------------------------------------------------

// The forward's block (a kernel of kThreads threads calls it with its own
// __grid_constant__ maps: Q's box kBM rows, K's and V's kBN). `d` is the
// head dim, out's row stride. `mask.apply(sc, row, i, key0)` may zero
// weights of a key tile after they entered the sum; the output is scaled
// by mask.inv_keep / l.
template <int D, bool kLse, class Mask>
__device__ __forceinline__ void fwd_block(const CUtensorMap& tq,
                                          const CUtensorMap& tk,
                                          const CUtensorMap& tv,
                                          bf16* __restrict__ out,
                                          float* __restrict__ lse, int s,
                                          int tiles_per_row, float scale_log2,
                                          const Mask& mask, int d) {
  using C = Fwd<D, Mask::kDraws>;
  constexpr int BM = C::kBM;
  constexpr int BN = C::kBN;
  constexpr int KS = C::kKStages;
  constexpr int VS = C::kVStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, kfull[KS], kfree[KS], vfull[VS],
      vfree[VS];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kring = qs + BM * D;
  bf16* vring = kring + KS * BN * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * BM;
  const int n = (s + BN - 1) / BN;
  const bool loader = tid == kLoader;

  if (tid == 0) {
    hp::mbar_init(&bar_q, 1);
    for (int st = 0; st < KS; ++st) {
      hp::mbar_init(&kfull[st], 1);
      hp::mbar_init(&kfree[st], 4);  // warpgroup 0's warps
    }
    for (int st = 0; st < VS; ++st) {
      hp::mbar_init(&vfull[st], 1);
      hp::mbar_init(&vfree[st], 4);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  auto load_k = [&](int j) {
    const int st = j % KS;
    hp::mbar_arrive_expect_tx(&kfull[st], C::kTileBytes);
    hp::load_tile<D, BN>(kring + st * BN * D, &tk, &kfull[st], row, j * BN);
  };
  auto load_v = [&](int j) {
    const int st = j % VS;
    hp::mbar_arrive_expect_tx(&vfull[st], C::kTileBytes);
    hp::load_tile<D, BN>(vring + st * BN * D, &tv, &vfull[st], row, j * BN);
  };
  if (loader) {
    hp::prefetch_tensor_map(&tq);
    hp::prefetch_tensor_map(&tk);
    hp::prefetch_tensor_map(&tv);
    hp::mbar_arrive_expect_tx(&bar_q, C::kQBytes);
    hp::load_tile<D, BM>(qs, &tq, &bar_q, row, q0);
    for (int j = 0; j < KS && j < n; ++j) load_k(j);
    for (int j = 0; j < VS && j < n; ++j) load_v(j);
  }
  // Tile j's K (V) has been read by this warpgroup's products: warpgroup 0
  // reports it, and the loader, whose warpgroup reads the tile last, waits
  // for that report and refills the stage with tile j + KS (j + VS).
  auto free_k = [&](int j) {
    if (wg == 0) {
      if (lane == 0) hp::mbar_arrive(&kfree[j % KS]);
    } else if (loader && j + KS < n) {
      hp::mbar_wait(&kfree[j % KS], (j / KS) & 1);
      load_k(j + KS);
    }
  };
  auto free_v = [&](int j) {
    if (wg == 0) {
      if (lane == 0) hp::mbar_arrive(&vfree[j % VS]);
    } else if (loader && j + VS < n) {
      hp::mbar_wait(&vfree[j % VS], (j / VS) & 1);
      load_v(j + VS);
    }
  };

  // Warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64); this thread
  // holds rows r and r + 8 of them, columns 8j + 2wq (+1).
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

  auto qk = [&](int j) {
    const bf16* ks = kring + (j % KS) * BN * D;
    hp::fence_regs(sc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hp::Wgmma<BN>::ss(sc, hp::desc_k<D, BM>(qs, wg * 64, kk),
                        hp::desc_k<D, BN>(ks, 0, kk), kk > 0 ? 1 : 0);
    }
    hp::wgmma_commit();
    hp::fence_regs(sc);
  };
  auto pv = [&](int j) {
    const bf16* vs = vring + (j % VS) * BN * D;
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
  auto to_pa = [&]() {
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) hp::pack_a(pa[kc], sc, kc);
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  };

  // Turn j of a warpgroup issues Q K_j^T and then P_{j-1} V_{j-1}, and
  // runs the softmax of tile j while P V is in flight; warpgroup 0 takes
  // each turn first. Each warpgroup takes n + 1 turns and arrives once for
  // each of the other's.
  float alpha[2];
  const int my_bar = 1 + wg, other_bar = 2 - wg;
  if (wg == 1) hp::named_arrive(1, kThreads);
  hp::mbar_wait(&bar_q, 0);
  hp::mbar_wait(&kfull[0], 0);
  hp::named_sync(my_bar, kThreads);
  qk(0);
  hp::named_arrive(other_bar, kThreads);
  hp::wgmma_wait<0>();
  hp::fence_regs(sc);
  free_k(0);
  softmax(0, alpha);
  mask.apply(sc, row, q0 + r, 0);
  to_pa();
  for (int j = 1; j < n; ++j) {
    hp::mbar_wait(&kfull[j % KS], (j / KS) & 1);
    hp::mbar_wait(&vfull[(j - 1) % VS], ((j - 1) / VS) & 1);
    hp::named_sync(my_bar, kThreads);
    qk(j);
    rescale(alpha);  // o is idle until P V is issued
    pv(j - 1);
    hp::named_arrive(other_bar, kThreads);
    hp::wgmma_wait<1>();  // Q K_j^T is done; P_{j-1} V_{j-1} may not be
    hp::fence_regs(sc);
    free_k(j);
    softmax(j, alpha);
    mask.apply(sc, row, q0 + r, j * BN);
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    hp::fence_regs(pa);
    free_v(j - 1);
    to_pa();
  }
  rescale(alpha);
  hp::mbar_wait(&vfull[(n - 1) % VS], ((n - 1) / VS) & 1);
  hp::named_sync(my_bar, kThreads);
  pv(n - 1);
  if (wg == 0) hp::named_arrive(other_bar, kThreads);
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

// --- backward ---------------------------------------------------------------

// The dkv kernel's block (a kernel of kThreads threads calls it with its
// own __grid_constant__ maps, boxes of kTile rows). `mask.dkv_p` turns S^T
// into the weights dv takes and writes p to the exchange, `mask.dkv_ds`
// turns dP^T into dS^T from it. `d` is the head dim, dk's and dv's row
// stride.
template <int D, class Mask>
__device__ __forceinline__ void dkv_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tg, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int s, int tiles_per_row, float scale,
    float scale_log2, const Mask& mask, int d) {
  using C = Bwd<D>;
  constexpr int ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[ST], freed[ST];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * D;
  // Stage st: the Q tile at ring + 2 st 64 D, the g tile after it.
  bf16* ring = vs + kTile * D;
  float* xbuf = reinterpret_cast<float*>(ring + 2 * ST * kTile * D);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int t = tid & 127;
  const int wq = lane & 3;
  const int row = blockIdx.x / tiles_per_row;
  const int key0 = (blockIdx.x % tiles_per_row) * kTile;
  const int64_t vec = static_cast<int64_t>(row) * s;
  const int n = (s + kTile - 1) / kTile;
  const bool loader = tid == kLoader;

  if (tid == 0) {
    hp::mbar_init(&bar_kv, 1);
    for (int st = 0; st < ST; ++st) {
      hp::mbar_init(&full[st], 1);
      hp::mbar_init(&freed[st], 4);  // warpgroup 0's warps
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  auto load = [&](int i) {
    const int st = i % ST;
    bf16* qt = ring + st * 2 * kTile * D;
    hp::mbar_arrive_expect_tx(&full[st], 2 * C::kTileBytes);
    hp::load_tile<D, kTile>(qt, &tq, &full[st], row, i * kTile);
    hp::load_tile<D, kTile>(qt + kTile * D, &tg, &full[st], row, i * kTile);
  };
  if (loader) {
    hp::prefetch_tensor_map(&tq);
    hp::prefetch_tensor_map(&tk);
    hp::prefetch_tensor_map(&tv);
    hp::prefetch_tensor_map(&tg);
    hp::mbar_arrive_expect_tx(&bar_kv, 2 * C::kTileBytes);
    hp::load_tile<D, kTile>(ks, &tk, &bar_kv, row, key0);
    hp::load_tile<D, kTile>(vs, &tv, &bar_kv, row, key0);
    for (int i = 0; i < ST && i < n; ++i) load(i);
  }

  // This thread's keys: rows kr and kr + 8 of the block's 64 (both
  // warpgroups hold the same keys and queries in the same layout).
  const int kb = key0 + (warp & 3) * 16;
  float acc[D / 2];  // dv (warpgroup 0) or dk (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sa[kTile / 2];        // S^T or dP^T of one query tile
  uint32_t pa[kTile / 16][4];  // the weights, or dS^T, as the A operand
  float col[kTile / 4];        // lse (log2 units) or delta of the columns

  // The query tile's lse (+inf past S) or delta (0 past S) of this
  // lane's columns, read while the tile's product runs.
  auto columns = [&](int i, const float* src, float factor, float past) {
#pragma unroll
    for (int e = 0; e < kTile / 4; ++e) {
      const int qi = i * kTile + 8 * (e >> 1) + 2 * wq + (e & 1);
      col[e] = qi < s ? src[vec + qi] * factor : past;
    }
  };
  // sa = A B^T over d, A the kept K or V, B the stage's Q or g.
  auto logits = [&](const bf16* a, const bf16* b) {
    hp::fence_regs(sa);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hp::Wgmma<kTile>::ss(sa, hp::desc_k<D, kTile>(a, 0, kk),
                           hp::desc_k<D, kTile>(b, 0, kk), kk > 0 ? 1 : 0);
    }
    hp::wgmma_commit();
  };
  // acc += pa B, B the stage's g (dv) or Q (dk) read through the
  // transpose bit.
  auto accumulate = [&](const bf16* b) {
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) hp::pack_a(pa[kc], sa, kc);
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    hp::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      hp::rs_cols<D, kTile>(acc, pa[kc], b, kc);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    hp::fence_regs(pa);
  };

  if (wg == 1) hp::named_arrive(kXFree, kThreads);  // the exchange is free
  hp::mbar_wait(&bar_kv, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % ST;
    const bf16* qt = ring + st * 2 * kTile * D;
    const bf16* gt = qt + kTile * D;
    hp::mbar_wait(&full[st], (i / ST) & 1);
    if (wg == 0) {
      // S^T = K Q^T; p^T to the exchange; dv += P^T g.
      logits(ks, qt);
      columns(i, lse, flash::kLog2e, INFINITY);
      hp::wgmma_wait<0>();
      hp::fence_regs(sa);
      hp::named_sync(kXFree, kThreads);
      mask.dkv_p(sa, xbuf + t, col, scale_log2, row, kb, i * kTile);
      __threadfence_block();
      hp::named_arrive(kXFull, kThreads);
      accumulate(gt);
      if (lane == 0) hp::mbar_arrive(&freed[st]);
    } else {
      // dP^T = V g^T; dS^T from the exchange's p^T; dk += dS^T Q.
      logits(vs, gt);
      columns(i, delta, 1.f, 0.f);
      hp::wgmma_wait<0>();
      hp::fence_regs(sa);
      hp::named_sync(kXFull, kThreads);
      mask.dkv_ds(sa, xbuf + t, col, scale);
      if (i + 1 < n) hp::named_arrive(kXFree, kThreads);
      accumulate(qt);
      if (loader && i + ST < n) {
        hp::mbar_wait(&freed[st], (i / ST) & 1);
        load(i + ST);
      }
    }
  }
  store_cols<D>((wg == 0 ? dv : dk) + vec * d, acc,
                kb + (lane >> 2), s, wq, 0, d);
}

// One warpgroup of the dq kernel's block: W = 0 forms S = Q K^T and p, W =
// 1 dP = g V^T (A the block's own Q or g tile, `own`); both form dS from
// the swapped tiles and add dq += dS K over columns [N0, N0 + NC).
template <int D, int W, int N0, int NC, class Mask>
__device__ __forceinline__ void dq_warpgroup(
    const bf16* own, const bf16* ring, float* xbuf, uint64_t* full,
    uint64_t* freed, const CUtensorMap& tk, const CUtensorMap& tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int row, int q0, int s, float scale,
    float scale_log2, const Mask& mask, int d) {
  constexpr int ST = Bwd<D>::kStages;
  const int tid = threadIdx.x;
  const int t = tid & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wq = lane & 3;
  const int r0 = q0 + (warp & 3) * 16 + (lane >> 2);
  const int64_t vec = static_cast<int64_t>(row) * s;
  const int n = (s + kTile - 1) / kTile;
  const bool loader = tid == kLoader;

  float lse2[2], dl[2];  // rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    lse2[h] = i < s ? lse[vec + i] * flash::kLog2e : INFINITY;
    dl[h] = i < s ? delta[vec + i] : 0.f;
  }
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  float a[kTile / 2], other[kTile / 2];
  uint32_t pa[kTile / 16][4];  // dS as the A operand

  for (int j = 0; j < n; ++j) {
    const int st = j % ST;
    const bf16* kt = ring + st * 2 * kTile * D;
    const bf16* vt = kt + kTile * D;
    hp::mbar_wait(&full[st], (j / ST) & 1);
    hp::fence_regs(a);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hp::Wgmma<kTile>::ss(a, hp::desc_k<D, kTile>(own, 0, kk),
                           hp::desc_k<D, kTile>(W == 0 ? kt : vt, 0, kk),
                           kk > 0 ? 1 : 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(a);
    if constexpr (W == 0) {
      mask.dq_p(a, lse2, scale_log2, s, row, r0, j * kTile);
    }
    // The first barrier frees the tile the other warpgroup read last
    // step, the second publishes this step's.
    hp::named_sync(kXchg, kThreads);
#pragma unroll
    for (int e = 0; e < kTile / 2; ++e) xbuf[W * kXElems + e * 128 + t] = a[e];
    hp::named_sync(kXchg, kThreads);
#pragma unroll
    for (int e = 0; e < kTile / 2; ++e) {
      other[e] = xbuf[(1 - W) * kXElems + e * 128 + t];
    }
    if constexpr (W == 0) {
      mask.dq_ds(a, other, a, dl, scale);
    } else {
      mask.dq_ds(other, a, a, dl, scale);
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) hp::pack_a(pa[kc], a, kc);
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    hp::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      hp::Wgmma<NC>::rs(acc, pa[kc], hp::desc_mn<D, kTile>(kt, kc, N0), 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    if constexpr (W == 0) {
      if (lane == 0) hp::mbar_arrive(&freed[st]);
    } else if (loader && j + ST < n) {
      hp::mbar_wait(&freed[st], (j / ST) & 1);
      bf16* next = const_cast<bf16*>(kt);
      hp::mbar_arrive_expect_tx(&full[st], 2 * Bwd<D>::kTileBytes);
      hp::load_tile<D, kTile>(next, &tk, &full[st], row, (j + ST) * kTile);
      hp::load_tile<D, kTile>(next + kTile * D, &tv, &full[st], row,
                              (j + ST) * kTile);
    }
  }
  store_cols<NC>(dq + vec * d, acc, r0, s, wq, N0, d);
}

// The dq kernel's block at D = 192 (Bwd<D>::kDqRows): 128 queries, each
// warpgroup 64 of them, Q and g loaded once; both read every K and V tile
// of the ring. A warpgroup forms S = Q K^T and dP = g V^T of its rows, p
// and dS, and adds dq += dS K over all D columns: no exchange, so one
// warpgroup's elementwise steps run under the other's products.
template <int D, class Mask>
__device__ __forceinline__ void dq_rows_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tg, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int s,
    int tiles_per_row, float scale, float scale_log2, const Mask& mask,
    int d) {
  using C = Bwd<D>;
  constexpr int ST = C::kDqStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qg, full[ST], freed[ST];
  uint8_t* smem = hp::align1024(smem_raw);
  // Warpgroup w's Q tile at w 64 D, its g tile at (2 + w) 64 D.
  bf16* qs = reinterpret_cast<bf16*>(smem);
  // Stage st: the K tile at ring + 2 st 64 D, the V tile after it.
  bf16* ring = qs + 4 * kTile * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int wq = lane & 3;
  const int row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * C::kDqQueries;
  const int r0 = q0 + wg * kTile + (warp & 3) * 16 + (lane >> 2);
  const int64_t vec = static_cast<int64_t>(row) * s;
  const int n = (s + kTile - 1) / kTile;
  const bool loader = tid == kLoader;

  if (tid == 0) {
    hp::mbar_init(&bar_qg, 1);
    for (int st = 0; st < ST; ++st) {
      hp::mbar_init(&full[st], 1);
      hp::mbar_init(&freed[st], 8);  // every warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  auto load = [&](int j) {
    bf16* kt = ring + (j % ST) * 2 * kTile * D;
    hp::mbar_arrive_expect_tx(&full[j % ST], 2 * C::kTileBytes);
    hp::load_tile<D, kTile>(kt, &tk, &full[j % ST], row, j * kTile);
    hp::load_tile<D, kTile>(kt + kTile * D, &tv, &full[j % ST], row,
                            j * kTile);
  };
  if (loader) {
    hp::prefetch_tensor_map(&tq);
    hp::prefetch_tensor_map(&tk);
    hp::prefetch_tensor_map(&tv);
    hp::prefetch_tensor_map(&tg);
    // A second half that lies wholly past S is not loaded: its rows are
    // never stored, and nothing crosses between the warpgroups.
    const int halves = q0 + kTile < s ? 2 : 1;
    hp::mbar_arrive_expect_tx(&bar_qg, 2 * halves * C::kTileBytes);
    for (int w = 0; w < halves; ++w) {
      hp::load_tile<D, kTile>(qs + w * kTile * D, &tq, &bar_qg, row,
                              q0 + w * kTile);
      hp::load_tile<D, kTile>(qs + (2 + w) * kTile * D, &tg, &bar_qg, row,
                              q0 + w * kTile);
    }
    for (int j = 0; j < ST && j < n; ++j) load(j);
  }

  const bf16* own_q = qs + wg * kTile * D;
  const bf16* own_g = qs + (2 + wg) * kTile * D;
  float lse2[2], dl[2];  // rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    lse2[h] = i < s ? lse[vec + i] * flash::kLog2e : INFINITY;
    dl[h] = i < s ? delta[vec + i] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[kTile / 2], dp[kTile / 2];
  uint32_t pa[kTile / 16][4];  // dS as the A operand

  hp::mbar_wait(&bar_qg, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % ST;
    const bf16* kt = ring + st * 2 * kTile * D;
    const bf16* vt = kt + kTile * D;
    hp::mbar_wait(&full[st], (j / ST) & 1);
    hp::fence_regs(sc);
    hp::fence_regs(dp);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hp::Wgmma<kTile>::ss(sc, hp::desc_k<D, kTile>(own_q, 0, kk),
                           hp::desc_k<D, kTile>(kt, 0, kk), kk > 0 ? 1 : 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hp::Wgmma<kTile>::ss(dp, hp::desc_k<D, kTile>(own_g, 0, kk),
                           hp::desc_k<D, kTile>(vt, 0, kk), kk > 0 ? 1 : 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);
    mask.dq_p(sc, lse2, scale_log2, s, row, r0, j * kTile);
    mask.dq_ds(sc, dp, sc, dl, scale);
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) hp::pack_a(pa[kc], sc, kc);
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    hp::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      hp::rs_cols<D, kTile>(acc, pa[kc], kt, kc);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    if (lane == 0) hp::mbar_arrive(&freed[st]);
    if (loader && j + ST < n) {
      hp::mbar_wait(&freed[st], (j / ST) & 1);
      load(j + ST);
    }
  }
  store_cols<D>(dq + vec * d, acc, r0, s, wq, 0, d);
}

// The dq kernel's block at D = 256: 64 queries, S in warpgroup 0 and dP
// in warpgroup 1, swapped through shared memory.
template <int D, class Mask>
__device__ __forceinline__ void dq_swap_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tg, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int s,
    int tiles_per_row, float scale, float scale_log2, const Mask& mask,
    int d) {
  using C = Bwd<D>;
  constexpr int ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qg, full[ST], freed[ST];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + kTile * D;
  // Stage st: the K tile at ring + 2 st 64 D, the V tile after it.
  bf16* ring = gs + kTile * D;
  float* xbuf = reinterpret_cast<float*>(ring + 2 * ST * kTile * D);

  const int tid = threadIdx.x;
  const int row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kTile;
  const int n = (s + kTile - 1) / kTile;

  if (tid == 0) {
    hp::mbar_init(&bar_qg, 1);
    for (int st = 0; st < ST; ++st) {
      hp::mbar_init(&full[st], 1);
      hp::mbar_init(&freed[st], 4);  // warpgroup 0's warps
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (tid == kLoader) {
    hp::prefetch_tensor_map(&tq);
    hp::prefetch_tensor_map(&tk);
    hp::prefetch_tensor_map(&tv);
    hp::prefetch_tensor_map(&tg);
    hp::mbar_arrive_expect_tx(&bar_qg, 2 * C::kTileBytes);
    hp::load_tile<D, kTile>(qs, &tq, &bar_qg, row, q0);
    hp::load_tile<D, kTile>(gs, &tg, &bar_qg, row, q0);
    for (int j = 0; j < ST && j < n; ++j) {
      bf16* kt = ring + j * 2 * kTile * D;
      hp::mbar_arrive_expect_tx(&full[j], 2 * C::kTileBytes);
      hp::load_tile<D, kTile>(kt, &tk, &full[j], row, j * kTile);
      hp::load_tile<D, kTile>(kt + kTile * D, &tv, &full[j], row, j * kTile);
    }
  }
  hp::mbar_wait(&bar_qg, 0);
  // Warpgroup 0 takes the exponentials and D - 128 columns of dq,
  // warpgroup 1 the last 128.
  if (tid < kLoader) {
    dq_warpgroup<D, 0, 0, D - 128>(qs, ring, xbuf, full, freed, tk, tv, lse,
                                   delta, dq, row, q0, s, scale, scale_log2,
                                   mask, d);
  } else {
    dq_warpgroup<D, 1, D - 128, 128>(gs, ring, xbuf, full, freed, tk, tv,
                                     lse, delta, dq, row, q0, s, scale,
                                     scale_log2, mask, d);
  }
}

// The dq kernel's block (a kernel of kThreads threads calls it with its own
// __grid_constant__ maps, boxes of kTile rows, Bwd<D>::kDqQueries queries
// a block). `mask.dq_p` turns a key tile's S into p, marking dropped
// weights, `mask.dq_ds` forms dS. `d` is the head dim, dq's row stride.
template <int D, class Mask>
__device__ __forceinline__ void dq_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tg, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int s,
    int tiles_per_row, float scale, float scale_log2, const Mask& mask,
    int d) {
  if constexpr (Bwd<D>::kDqRows) {
    dq_rows_block<D>(tq, tk, tv, tg, lse, delta, dq, s, tiles_per_row, scale,
                     scale_log2, mask, d);
  } else {
    dq_swap_block<D>(tq, tk, tv, tg, lse, delta, dq, s, tiles_per_row, scale,
                     scale_log2, mask, d);
  }
}

// --- host -------------------------------------------------------------------

// The backward's dkv and dq launches at these widths in this library since
// the last read: launch_bwd adds one to each where it launches the kernel,
// and the library's *_block256_launches entry point reads and zeroes them.
inline std::atomic<long long> dkv_launches{0}, dq_launches{0};

// The forward at tile width D over contiguous [rows, s, d] bf16 q, k, v:
// `kernel` is a __global__ of kThreads threads taking (tq, tk, tv, out,
// lse, s, tiles_per_row, scale_log2, mask, d) that calls fwd_block.
template <int D, class Kernel, class Mask>
inline cudaError_t launch_fwd(Kernel kernel, const void* q, const void* k,
                              const void* v, void* out, float* lse,
                              int64_t rows, int s, int d, float scale_log2,
                              const Mask& mask, cudaStream_t stream) {
  using C = Fwd<D, Mask::kDraws>;
  const int tiles = (s + C::kBM - 1) / C::kBM;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hp::tensor_map_3d(&tq, q, rows, s, d, C::kBM, 64);
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tk, k, rows, s, d, C::kBN, 64);
  }
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tv, v, rows, s, d, C::kBN, 64);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, s, tiles, scale_log2, mask,
      d);
  return cudaGetLastError();
}

// The backward's dkv and dq launches at tile width D (after the caller's
// delta kernel): each a __global__ of kThreads threads taking (tq, tk, tv,
// tg, lse, delta, then dk and dv or dq, s, tiles_per_row, scale,
// scale_log2, mask, d) that calls dkv_block or dq_block.
template <int D, class DkvKernel, class DqKernel, class Mask>
inline cudaError_t launch_bwd(DkvKernel dkv, DqKernel dqk, const void* q,
                              const void* k, const void* v, const void* g,
                              const float* lse, const float* delta,
                              void* dq, void* dk, void* dv, int64_t rows,
                              int s, int d, float scale, const Mask& mask,
                              cudaStream_t stream) {
  using C = Bwd<D>;
  const int tiles = (s + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap m[4];
  const void* src[4] = {q, k, v, g};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = hp::tensor_map_3d(&m[i], src[i], rows, s, d, kTile, 64);
  }
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * flash::kLog2e;
  err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkvSmem);
  if (err != cudaSuccess) return err;
  dkv<<<static_cast<unsigned>(blocks), kThreads, C::kDkvSmem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, tiles, scale, scale_log2, mask, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++dkv_launches;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err != cudaSuccess) return err;
  const int dq_tiles = (s + C::kDqQueries - 1) / C::kDqQueries;
  dqk<<<static_cast<unsigned>(rows * dq_tiles), kThreads, C::kDqSmem,
        stream>>>(m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dq),
                  s, dq_tiles, scale, scale_log2, mask, d);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++dq_launches;
  return err;
}

}  // namespace flash256

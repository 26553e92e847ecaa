// Fused short-sequence attention with dropout on the attention weights,
// backward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/mha_kernel.py::_bwd_kernel (:83,
// pallas_call at :172). Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/mha_kernel.py.
//
// What it computes, from q, k, v, the cotangent g of out, the forward's out
// and lse (f32 [B*h, S]) and the dropout seed, all contiguous [B*h, S, d]:
//   p_ij  = exp(q_i . k_j * scale - lse_i)           (the softmax, recomputed)
//   m_ij  = keep_ij / (1 - rate)                     (the mask, regenerated)
//   z_ij  = p_ij m_ij                                (the dropped weights)
//   dv_j  = sum_i z_ij g_i
//   dz_ij = g_i . v_j,  dp_ij = dz_ij m_ij
//   ds_ij = p_ij (dp_ij - sum_j dp_ij p_ij) scale
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// which is the TPU kernel's function. Two things differ in how it gets
// there, neither in what comes out:
//   - the TPU kernel saves only q, k, v and the seed and recomputes the row
//     maximum and sum from the whole [Sp, Sp] tile in VMEM. Here the forward
//     saves lse (4 bytes a query), so no pass over the keys is needed to
//     rebuild the softmax;
//   - sum_j dp_ij p_ij = sum_j dz_ij m_ij p_ij = sum_j dz_ij z_ij
//     = g_i . sum_j z_ij v_j = g_i . out_i =: delta_i, with the dropped
//     weights z on both sides, so the row sum is taken from the saved out
//     (a thread per query) instead of a second pass over the keys. The
//     identity holds at any rate; the tests hold it at rate > 0.
// keep_ij comes from Philox keyed on (seed, row, i, j) (philox.cuh): the same
// words as the forward drew, whatever the tiling.
//
// What bounds it on this card: bytes, on paper. At B*h = 1536, S = 197,
// d = 64 in bf16 the function moves 271 MB (q, k, v, g in; dq, dk, dv out:
// 0.081 ms at 3.35 TB/s) against 38 GFLOP (0.039 ms at the bf16 peak).
// This design reads 40 MB more than that, the saved out and lse, which the
// bound does not count. In training the Philox draw and the exponentials
// are again a large share of the work, so each is done once.
//
// The whole-row kernel (fused_bwd_row_wgmma; S <= 256 at d <= 32, S <= 208
// at d = 64, S <= 128 at d = 128): one launch, in which a block of two
// warpgroups owns one head-row at a time and computes every logit,
// exponential and Philox word of it exactly once:
//   - the block is persistent (one an SM, an equal share of the rows
//     each). Its first thread brings a row's Q, g and V, then its K, by
//     TMA (3-D maps that zero-fill past S inside the head) on two
//     mbarriers; the block computes delta_i = g_i . out_i and stages lse
//     (+inf past S, so that p = 0 there). The next row's Q, g and V are
//     loaded, and its delta staged, once this row's key-major pass is done;
//     its K once the dq pass is;
//   - key-major: a warpgroup owns a 64-key chunk and walks the row's
//     queries in slices of 96 (32 at d = 128): S^T = K Q^T and
//     dP^T = V g^T are wgmmas from shared memory; p^T, the mask, z^T and
//     dS^T stay in registers, rounded to bf16 as the A operands of
//     dv += Z^T g and dk += dS^T Q (g and Q through the transpose bit);
//     the next slice's S^T and dP^T are issued right behind them;
//   - one Philox call gives the words of two keys for one query in this
//     layout (rows g and g + 8 of the accumulator), and the other two words
//     are those of the neighbouring lane's keys; two lanes draw for their
//     pair of queries and swap halves with a shuffle, so a call still
//     serves four weights;
//   - dS^T goes once to shared memory as bf16, in the 128-byte-swizzled
//     layout TMA would write (keys x queries, 87 KB at S = 197); after a
//     barrier, dq = dS K is a wgmma with both operands in shared memory,
//     dS^T and K read through the two transpose bits.
// Each of dq, dk, dv is written by exactly one thread: no atomics, and two
// runs give the same bits. No product's registers are touched while it is
// in flight. What limits it (PERF.md): at S = 197 a row takes about 58,000
// cycles of an SM, 40,000 of them in the key-major pass, where the tensor
// work is about 7,000 and the rest is exponentials, Philox and their
// latency at 8 warps an SM; 10,000 more wait for the next row's loads,
// which all SMs issue at once. Taking turns at the tensor cores, as the
// flash kernels do, measured slower.
//
// Longer rows (up to the op's S = 1024) take the tiled kernels, launched in
// order on one stream: delta (flash_common.cuh), then the dense flash
// backward's dkv and dq blocks (flash_bwd_blocks.cuh: wgmma products, TMA
// rings, a producer warpgroup; at the tile widths 192 and 256
// flash_block256.cuh's, two warpgroups and no producer) with this op's
// Philox mask in their elementwise steps: the dkv block draws key-major as
// above (a lane pair shares each call), the dq block one call per lane,
// row and 16-key chunk. They compute the logits and dP twice, as the flash
// backward does. In flash_block256.cuh's dkv (and its dq at 256) one
// warpgroup draws and forms p, and the other reads each dropped weight's
// mark from the sign bit of the p it is handed; its dq at 192 draws each
// warpgroup's own rows. Each word is drawn once a kernel.
//
// f32 tensors, at every head dim, take flash_f32.cuh's scalar kernels for
// parity runs, one Philox call a (query, key) pair, after the same delta.
//
// Head dims: every multiple of 8. Up to 256, at the tile width D of
// flash::tile_width (16, 32, 64, 80, 128, 192, 256), zeros past d in the
// staged tiles, the columns past d not stored. The whole-row kernel is built
// for d = D in 16, 32, 64 and 128; every other head dim takes the tiled
// kernels at every S (the flash blocks up to 128, flash_block256.cuh's at
// 192 and 256). Past 256, the dense backward's wide
// blocks (flash_wide.cuh: dkv in slices of up to 256 columns of dk and dv,
// dq in slices of up to 512, the slices over the grid's y) with the Philox
// mask, after the delta kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_block256.cuh"
#include "flash_bwd_blocks.cuh"
#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

struct Dropout {
  uint64_t seed;
  uint32_t threshold;  // keep iff word >= threshold
  float inv_keep;      // 1 / (1 - rate)
};

// --- bf16, a whole row a block -----------------------------------------------

// The keys of a row that one block holds: the row's Q, K, V and g tiles and
// its bf16 dS (keys x queries) must fit the 227 KB of shared memory. The
// whole-row kernel is built for the head dims 16, 32, 64 and 128 (0 keys at
// the other tile widths: every row takes the tiled kernels there).
template <int D>
constexpr int kRowMaxKeys = D <= 32    ? 256
                            : D == 64  ? 208
                            : D == 128 ? 128
                                       : 0;

constexpr int kRowThreads = 256;  // two warpgroups

// Dynamic shared memory of the whole-row kernel at kc 16-key chunks: Q and
// g of 16 kc rows, K and V of whole 64-key chunks (the M of K Q^T), dS^T of
// 16 kc keys by whole 64-query column blocks, and 1 KB to align them.
constexpr int row_bwd_smem(int d, int kc) {
  return 2 * ((16 * kc * d * 2 + 1023) / 1024 * 1024) +
         2 * (64 * ((kc + 3) / 4) * d * 2) +
         16 * kc * 128 * ((kc + 3) / 4) + 1024;
}

template <int D, int KC>
struct RowBwd {
  static constexpr int kKeys = 16 * KC;              // keys and queries, padded
  static constexpr int kKRows = 64 * ((KC + 3) / 4);  // K, V rows staged
  static constexpr int kQN = D <= 64 ? 96 : 32;  // queries a slice of S^T
  static constexpr int kQBytes = (kKeys * D * 2 + 1023) / 1024 * 1024;
  static constexpr int kKBytes = kKRows * D * 2;
  static constexpr int kDsBytes = kKeys * 128 * ((KC + 3) / 4);
  static constexpr int kSmem = 2 * kQBytes + 2 * kKBytes + kDsBytes + 1024;
  static_assert(kSmem == row_bwd_smem(D, KC), "one formula");
  static_assert(kKeys <= kRowMaxKeys<D>, "row too long for one block");
  // With the static lse and delta rows and the barriers.
  static_assert(kSmem + 2 * 4 * kKeys + 64 <= 232448, "shared memory");
};

template <int D, int KC>
__global__ void __launch_bounds__(kRowThreads, 1)
    fused_bwd_row_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tg,
                        const bf16* __restrict__ out,
                        const bf16* __restrict__ g,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int64_t rows, int s, float scale, float scale_log2,
                        Dropout drop, int drop_on) {
  using C = RowBwd<D, KC>;
  constexpr int NK = C::kKeys;
  constexpr int KR = C::kKRows;
  constexpr int QN = C::kQN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qgv, bar_k;
  __shared__ float lse_s[NK];  // in log2 units; +inf past S
  __shared__ float delta_s[NK];
  uint8_t* smem = hp::align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = reinterpret_cast<bf16*>(smem + C::kQBytes);
  bf16* ks = reinterpret_cast<bf16*>(smem + 2 * C::kQBytes);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * C::kQBytes + C::kKBytes);
  uint8_t* dst = smem + 2 * C::kQBytes + 2 * C::kKBytes;  // dS^T, bf16

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int wq = lane & 3;
  const int gr = lane >> 2;

  // Q, g and V of a row (free once phase 1 is done), and K (free once
  // phase 2 is done).
  auto load_qgv = [&](int64_t row) {
    hp::mbar_arrive_expect_tx(&bar_qgv, (2 * NK + KR) * D * 2);
    hp::load_tile<D, NK>(qs, &tq, &bar_qgv, row, 0);
    hp::load_tile<D, NK>(gs, &tg, &bar_qgv, row, 0);
    hp::load_tile<D, KR>(vs, &tv, &bar_qgv, row, 0);
  };
  auto load_k = [&](int64_t row) {
    hp::mbar_arrive_expect_tx(&bar_k, KR * D * 2);
    hp::load_tile<D, KR>(ks, &tk, &bar_k, row, 0);
  };
  // delta_i = g_i . out_i and lse of every query of a row. D / 8 lanes
  // read a row's out and g, 16 bytes each, so that a warp reads whole rows
  // of both; every load is issued before the first sum. A query past S
  // gets p = exp2(-inf) = 0, so ds = 0.
  auto stage_rows = [&](int64_t row) {
    constexpr int kLanes = D / 8;                    // lanes a row
    constexpr int kRowsAPass = kRowThreads / kLanes;
    constexpr int kPasses = (NK + kRowsAPass - 1) / kRowsAPass;
    const int64_t base = row * s * D;
    const int sub = tid % kLanes;
    uint4 ov[kPasses], gv[kPasses];
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int i = tid / kLanes + pass * kRowsAPass;
      ov[pass] = gv[pass] = make_uint4(0u, 0u, 0u, 0u);
      if (i < s) {
        const int64_t at = base + static_cast<int64_t>(i) * D + sub * 8;
        ov[pass] = *reinterpret_cast<const uint4*>(out + at);
        gv[pass] = *reinterpret_cast<const uint4*>(g + at);
      }
    }
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int i = tid / kLanes + pass * kRowsAPass;
      const bf16* oe = reinterpret_cast<const bf16*>(&ov[pass]);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv[pass]);
      float dl = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dl += __bfloat162float(oe[e]) * __bfloat162float(ge[e]);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o /= 2) {
        dl += __shfl_xor_sync(0xffffffffu, dl, o);
      }
      if (sub == 0 && i < NK) {
        lse_s[i] = i < s ? lse[row * s + i] * flash::kLog2e : INFINITY;
        delta_s[i] = dl;
      }
    }
  };

  if (tid == 0) {
    hp::mbar_init(&bar_qgv, 1);
    hp::mbar_init(&bar_k, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_qgv(blockIdx.x);
    load_k(blockIdx.x);
  }
  stage_rows(blockIdx.x);
  __syncthreads();

  // A persistent block walks rows blockIdx.x, blockIdx.x + gridDim.x, ...;
  // the next row's Q, g and V are loaded, and its delta and lse staged,
  // after this row's phase 1, its K after phase 2.
  for (int n = 0;; ++n) {
    const int64_t row = blockIdx.x + n * static_cast<int64_t>(gridDim.x);
    if (row >= rows) break;
    const int64_t next = row + gridDim.x;
    const int64_t base = row * s * D;
    hp::mbar_wait(&bar_qgv, n & 1);
    hp::mbar_wait(&bar_k, n & 1);

    // Phase 1, key-major: warpgroup wg takes 64-key chunks wg, wg + 2, ...;
    // this thread holds keys kb + gr and kb + gr + 8 of them. For each slice
    // of QN queries: S^T = K Q^T and dP^T = V g^T, then p^T, the mask, z^T
    // and dS^T in registers, dv += Z^T g and dk += dS^T Q with the register
    // A operands, and dS^T to shared memory for phase 2. The next slice's
    // S^T and dP^T are issued right behind this slice's dv and dk products,
    // so that the two run back to back and are waited for once.
    constexpr int NF = NK / QN;  // full slices
    constexpr int NT = NK % QN;  // and the last one's width, if any
    const int chunks = (s + 63) / 64;
    for (int c = wg; c < chunks; c += 2) {
      const int kb = 64 * c + (warp & 3) * 16;
      // A warp whose 16 keys all lie past S (and so past NK) skips the
      // elementwise work and stores nothing.
      const bool live = kb < s;
      bool real[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) real[h] = kb + gr + 8 * h < s;
      // The Philox group of this lane's keys: kb is a multiple of 16.
      const int grp = 4 * (kb >> 4) + (gr >> 1);
      const int odd = gr & 1;

      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

      // S^T and dP^T of the N queries from n0 (one commit group).
      auto issue_sd = [&](int n0, auto& st, auto& dp) {
        constexpr int N = 2 * sizeof(st) / sizeof(float);
        hp::fence_regs(st);
        hp::fence_regs(dp);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hp::Wgmma<N>::ss(st, hp::desc_k<D, KR>(ks, 64 * c, kk),
                           hp::desc_k<D, NK>(qs, n0, kk), kk > 0 ? 1 : 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hp::Wgmma<N>::ss(dp, hp::desc_k<D, KR>(vs, 64 * c, kk),
                           hp::desc_k<D, NK>(gs, n0, kk), kk > 0 ? 1 : 0);
        }
        hp::wgmma_commit();
        hp::fence_regs(st);
        hp::fence_regs(dp);
      };
      // p^T, the mask, z^T and dS^T of those queries; dS^T to shared memory;
      // z^T and dS^T rounded into the A operands za, da.
      auto grads = [&](int n0, auto& st, auto& dp, auto& za, auto& da) {
        constexpr int N = 2 * sizeof(st) / sizeof(float);
        if (live) {
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            // keep[h][e]: key kb + gr + 8h, query n0 + 8j + 2wq + e.
            float keep[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
            if (drop_on) {
              // One Philox call serves the two keys of this lane and the two
              // of its neighbour (gr ^ 1, lane ^ 4) for one query; the two
              // lanes draw for the pair's two queries and swap halves.
              const uint4 w = philox::mha_words(drop.seed, row,
                                                n0 + 8 * j + 2 * wq + odd, grp);
              const uint32_t mine0 = odd ? w.y : w.x, mine1 = odd ? w.w : w.z;
              const uint32_t give0 = odd ? w.x : w.y, give1 = odd ? w.z : w.w;
              const uint32_t got0 = __shfl_xor_sync(0xffffffffu, give0, 4);
              const uint32_t got1 = __shfl_xor_sync(0xffffffffu, give1, 4);
              const uint32_t words[2][2] = {
                  {odd ? got0 : mine0, odd ? mine0 : got0},
                  {odd ? got1 : mine1, odd ? mine1 : got1}};
#pragma unroll
              for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  keep[h][e] =
                      words[h][e] >= drop.threshold ? drop.inv_keep : 0.f;
                }
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * h + e;
                const int qi = n0 + 8 * j + 2 * wq + e;
                const float p = exp2f(fmaf(st[i], scale_log2, -lse_s[qi]));
                const float ds = p * (dp[i] * keep[h][e] - delta_s[qi]) * scale;
                st[i] = p * keep[h][e];
                dp[i] = real[h] ? ds : 0.f;  // K past S is zero, so is its ds
              }
              // dS^T[key][query], bf16, as a 128-byte-swizzled tile.
              *reinterpret_cast<__nv_bfloat162*>(
                  dst + hp::swizzle128_offset<NK>(kb + gr + 8 * h,
                                                  n0 + 8 * j + 2 * wq)) =
                  __floats2bfloat162_rn(dp[4 * j + 2 * h],
                                        dp[4 * j + 2 * h + 1]);
            }
          }
        }
#pragma unroll
        for (int kc = 0; kc < N / 16; ++kc) {
          hp::pack_a(za[kc], st, kc);
          hp::pack_a(da[kc], dp, kc);
        }
      };
      // dv += Z^T g and dk += dS^T Q over those queries (one commit group).
      auto issue_acc = [&](int n0, auto& za, auto& da) {
        constexpr int N = 16 * sizeof(za) / sizeof(za[0]);
        hp::fence_regs(dk_acc);
        hp::fence_regs(dv_acc);
        hp::fence_regs(za);
        hp::fence_regs(da);
        hp::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < N / 16; ++kc) {
          hp::Wgmma<D>::rs(dv_acc, za[kc],
                           hp::desc_mn<D, NK>(gs, n0 / 16 + kc), 1);
          hp::Wgmma<D>::rs(dk_acc, da[kc],
                           hp::desc_mn<D, NK>(qs, n0 / 16 + kc), 1);
        }
        hp::wgmma_commit();
        hp::fence_regs(dk_acc);
        hp::fence_regs(dv_acc);
        hp::fence_regs(za);
        hp::fence_regs(da);
      };
      auto wait_all = [&](auto&... regs) {
        hp::wgmma_wait<0>();
        (hp::fence_regs(regs), ...);
      };

      float stf[QN / 2], dpf[QN / 2];           // a full slice
      uint32_t zaf[QN / 16][4], daf[QN / 16][4];
      float stt[NT > 0 ? NT / 2 : 1], dpt[NT > 0 ? NT / 2 : 1];  // the last
      uint32_t zat[NT > 0 ? NT / 16 : 1][4], dat[NT > 0 ? NT / 16 : 1][4];
      if constexpr (NF > 0) {
        issue_sd(0, stf, dpf);
        wait_all(stf, dpf);
#pragma unroll 1
        for (int f = 0; f + 1 < NF; ++f) {
          grads(f * QN, stf, dpf, zaf, daf);
          issue_acc(f * QN, zaf, daf);
          issue_sd((f + 1) * QN, stf, dpf);
          wait_all(dk_acc, dv_acc, zaf, daf, stf, dpf);
        }
        grads((NF - 1) * QN, stf, dpf, zaf, daf);
        issue_acc((NF - 1) * QN, zaf, daf);
        if constexpr (NT > 0) issue_sd(NF * QN, stt, dpt);
        wait_all(dk_acc, dv_acc, zaf, daf, stt, dpt);
      } else {
        issue_sd(0, stt, dpt);
        wait_all(stt, dpt);
      }
      if constexpr (NT > 0) {
        grads(NF * QN, stt, dpt, zat, dat);
        issue_acc(NF * QN, zat, dat);
        wait_all(dk_acc, dv_acc, zat, dat);
      }
      if (live) {
        const int r = kb + gr;
        flash_bwd::store_acc<D>(dk + base, dk_acc, r, s, wq);
        flash_bwd::store_acc<D>(dv + base, dv_acc, r, s, wq);
      }
    }

    // dS^T is complete once both warpgroups have written theirs; Q, g, V,
    // delta and lse are free for the next row.
    hp::fence_proxy_async();
    __syncthreads();
    if (next < rows) {
      if (tid == 0) load_qgv(next);
      stage_rows(next);
    }

    // Phase 2: dq = dS K for 64-query blocks wg, wg + 2, ..., dS read from
    // dS^T and K through the transpose bits.
    const int qblocks = (s + 63) / 64;
    for (int b = wg; b < qblocks; b += 2) {
      // Column block b of dS^T: queries [64 b, 64 b + 64) as M.
      const bf16* dsb = reinterpret_cast<const bf16*>(dst) + b * NK * 64;
      float dq_acc[D / 2];
      hp::fence_regs(dq_acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        hp::Wgmma<D>::ss_t(dq_acc, hp::desc_mn<64, NK>(dsb, kk),
                           hp::desc_mn<D, KR>(ks, kk), kk > 0 ? 1 : 0);
      }
      hp::wgmma_commit();
      hp::fence_regs(dq_acc);
      hp::wgmma_wait<0>();
      hp::fence_regs(dq_acc);
      flash_bwd::store_acc<D>(dq + base, dq_acc, 64 * b + (warp & 3) * 16 + gr, s, wq);
    }
    // K is free once both warpgroups' dq products are done.
    __syncthreads();
    if (tid == 0 && next < rows) load_k(next);
  }
}

// --- bf16, tiled (longer rows) -----------------------------------------------

// The Philox mask for the dense flash backward's blocks
// (flash_bwd_blocks.cuh), with the elementwise steps of this op: z = p keep
// for dv, ds = p (dp keep - delta) scale.
struct PhiloxMask {
  uint64_t seed;
  uint32_t threshold;
  float inv_keep;  // 1 / (1 - rate)
  int on;

  // Key-major (the dkv block): rows kb + g and kb + g + 8 are this lane's
  // keys (kb a multiple of 16), columns the query tile's from q0. One
  // Philox call serves two keys of one query; a lane and its neighbour
  // (g ^ 1) draw for their pair of queries and swap halves.
  // The factors (inv_keep or 0; 1 without dropout) of this lane's keys
  // (rows h) and columns 8 j + 2 wq + e of the query tile from q0.
  __device__ __forceinline__ void keep_kv(float (&keep)[2][2], int j,
                                          int64_t row, int kb,
                                          int q0) const {
    keep[0][0] = keep[0][1] = keep[1][0] = keep[1][1] = 1.f;
    if (!on) return;
    const int lane = threadIdx.x & 31;
    const int wq = lane & 3;
    const int gr = lane >> 2;
    const int odd = gr & 1;
    const int grp = 4 * (kb >> 4) + (gr >> 1);
    const uint4 w =
        philox::mha_words(seed, row, q0 + 8 * j + 2 * wq + odd, grp);
    const uint32_t mine0 = odd ? w.y : w.x, mine1 = odd ? w.w : w.z;
    const uint32_t give0 = odd ? w.x : w.y, give1 = odd ? w.z : w.w;
    const uint32_t got0 = __shfl_xor_sync(0xffffffffu, give0, 4);
    const uint32_t got1 = __shfl_xor_sync(0xffffffffu, give1, 4);
    const uint32_t words[2][2] = {{odd ? got0 : mine0, odd ? mine0 : got0},
                                  {odd ? got1 : mine1, odd ? mine1 : got1}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        keep[h][e] = words[h][e] >= threshold ? inv_keep : 0.f;
      }
    }
  }

  template <int N>
  __device__ __forceinline__ void dkv(float (&st)[N], float (&dp)[N],
                                      const float* lse_c,
                                      const float* delta_c, float scale,
                                      float scale_log2, int64_t row, int kb,
                                      int q0) const {
    const int wq = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      float keep[2][2];
      keep_kv(keep, j, row, kb, q0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int c = 8 * j + 2 * wq + e;  // the query in the tile
          const float p = exp2f(fmaf(st[i], scale_log2, -lse_c[c]));
          st[i] = p * keep[h][e];
          dp[i] = p * (dp[i] * keep[h][e] - delta_c[c]) * scale;
        }
      }
    }
  }

  // Query-major (the dq block): rows i and i + 8 are this lane's queries,
  // keys from key0; one Philox call per lane, row and 16-key chunk.
  template <int N>
  __device__ __forceinline__ void dq(const float (&sc)[N], float (&dp)[N],
                                     const float (&lse2)[2],
                                     const float (&dl)[2], float scale,
                                     float scale_log2, int s, int64_t row,
                                     int i, int key0) const {
    const int wq = threadIdx.x & 3;
    const bool ragged = key0 + 2 * N > s;
#pragma unroll
    for (int kc = 0; kc < N / 8; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float keep[4];  // elements +0, +1, +4, +5
        keep_q(keep, row, i + 8 * h, key0, kc);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 8 * kc + 2 * h + (u & 1) + 4 * (u >> 1);
          float p = exp2f(fmaf(sc[e], scale_log2, -lse2[h]));
          if (ragged && key0 + (e >> 2) * 8 + 2 * wq + (e & 1) >= s) p = 0.f;
          dp[e] = p * (dp[e] * keep[u] - dl[h]) * scale;
        }
      }
    }
  }

  // The factors of query i and this lane's keys of 16-key chunk kc from
  // key0 (accumulator elements +0, +1, +4, +5): one call.
  __device__ __forceinline__ void keep_q(float (&keep)[4], int64_t row, int i,
                                         int key0, int kc) const {
    keep[0] = keep[1] = keep[2] = keep[3] = 1.f;
    if (!on) return;
    const uint4 w = philox::mha_words(seed, row, i,
                                      4 * (key0 / 16 + kc) + (threadIdx.x & 3));
    keep[0] = w.x >= threshold ? inv_keep : 0.f;
    keep[1] = w.y >= threshold ? inv_keep : 0.f;
    keep[2] = w.z >= threshold ? inv_keep : 0.f;
    keep[3] = w.w >= threshold ? inv_keep : 0.f;
  }

  // flash_block256.cuh's steps (its NoMask says what each takes). dkv,
  // warpgroup 0: S^T into z^T = p^T keep, and p^T, its sign bit set where
  // the weight is dropped, to the exchange.
  template <int N>
  __device__ __forceinline__ void dkv_p(float (&st)[N], float* x,
                                        const float (&lse_c)[N / 2],
                                        float scale_log2, int64_t row, int kb,
                                        int q0) const {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      float keep[2][2];
      keep_kv(keep, j, row, kb, q0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = exp2f(fmaf(st[i], scale_log2, -lse_c[2 * j + e]));
          st[i] = p * keep[h][e];
          x[128 * i] = keep[h][e] != 0.f ? p : -p;
        }
      }
    }
  }
  // dkv, warpgroup 1: dP^T into dS^T from the exchange.
  template <int N>
  __device__ __forceinline__ void dkv_ds(float (&dp)[N], const float* x,
                                         const float (&dl)[N / 2],
                                         float scale) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      dp[e] = flash256::masked_ds(x[128 * e], dp[e], dl[flash256::col_of(e)],
                                  scale, inv_keep);
    }
  }
  // dq (warpgroup 0 at 256): S into p, marked where dropped; keys past S
  // get 0.
  template <int N>
  __device__ __forceinline__ void dq_p(float (&sc)[N], const float (&lse2)[2],
                                       float scale_log2, int s, int64_t row,
                                       int i, int key0) const {
    const int wq = threadIdx.x & 3;
    const bool ragged = key0 + 2 * N > s;
#pragma unroll
    for (int kc = 0; kc < N / 8; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float keep[4];
        keep_q(keep, row, i + 8 * h, key0, kc);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 8 * kc + 2 * h + (u & 1) + 4 * (u >> 1);
          float p = exp2f(fmaf(sc[e], scale_log2, -lse2[h]));
          if (ragged && key0 + (e >> 2) * 8 + 2 * wq + (e & 1) >= s) p = 0.f;
          sc[e] = keep[u] != 0.f ? p : -p;
        }
      }
    }
  }
  // dq, every warpgroup: dS from the marked p (x) and dP.
  template <int N>
  __device__ __forceinline__ void dq_ds(const float (&x)[N],
                                        const float (&dp)[N], float (&ds)[N],
                                        const float (&dl)[2],
                                        float scale) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      ds[e] = flash256::masked_ds(x[e], dp[e], dl[(e >> 1) & 1], scale,
                                  inv_keep);
    }
  }
};

// D is the tile width, d the head dim (the row stride of dk, dv, dq).
template <int D>
__global__ void __launch_bounds__(flash_bwd::kMmaThreads, 1)
    fused_bwd_dkv_tiled_wgmma(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int s, int tiles_per_row, float scale,
                              float scale_log2, PhiloxMask mask, int d) {
  flash_bwd::dkv_block<D, PhiloxMask>(tq, tk, tv, tg, lse, delta, dk, dv, s,
                                      tiles_per_row, scale, scale_log2, mask,
                                      d);
}

// kExact: d == D, passed to the block as the constant D (with a run-time d
// this kernel measured 9.5% slower at D = 64, S = 577: PERF.md).
template <int D, bool kExact>
__global__ void __launch_bounds__(flash_bwd::kMmaThreads, 1)
    fused_bwd_dq_tiled_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tg,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int s, int tiles_per_row,
                             float scale, float scale_log2, PhiloxMask mask,
                             int d) {
  flash_bwd::dq_block<D>(tq, tk, tv, tg, lse, delta, dq, s, tiles_per_row,
                         scale, scale_log2, mask, kExact ? D : d);
}

// Tile widths 192 and 256: flash_block256.cuh's dkv and dq blocks with the
// Philox mask.
template <int D>
__global__ void __launch_bounds__(flash256::kThreads, 1)
    fused_bwd_dkv_block256(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                           int tiles_per_row, float scale, float scale_log2,
                           PhiloxMask mask, int d) {
  flash256::dkv_block<D>(tq, tk, tv, tg, lse, delta, dk, dv, s, tiles_per_row,
                         scale, scale_log2, mask, d);
}

template <int D>
__global__ void __launch_bounds__(flash256::kThreads, 1)
    fused_bwd_dq_block256(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int s, int tiles_per_row,
                          float scale, float scale_log2, PhiloxMask mask,
                          int d) {
  flash256::dq_block<D>(tq, tk, tv, tg, lse, delta, dq, s, tiles_per_row,
                        scale, scale_log2, mask, d);
}

// Past d = 256: flash_wide.cuh's dkv and dq blocks with the Philox mask, NT
// output tiles of 64 columns a warpgroup.
template <int NT>
__global__ void __launch_bounds__(flash_wide::kThreads, 1)
    fused_bwd_dkv_wide(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tg,
                       flash_wide::Geom g, flash_wide::Io io,
                       PhiloxMask mask) {
  const flash_wide::Maps m0{&tk, &tq, &tg}, m1{&tv, &tg, &tq};
  flash_wide::block<flash_wide::kDkv, NT, false>(m0, m1, g, io, mask);
}

template <int NT>
__global__ void __launch_bounds__(flash_wide::kThreads, 1)
    fused_bwd_dq_wide(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg,
                      flash_wide::Geom g, flash_wide::Io io,
                      PhiloxMask mask) {
  const flash_wide::Maps m0{&tq, &tk, &tk}, m1{&tg, &tv, &tk};
  flash_wide::block<flash_wide::kDq, NT, false>(m0, m1, g, io, mask);
}

template <int KIND>
auto wide_kernel(int tiles) {
  if constexpr (KIND == flash_wide::kDkv) {
    return tiles == 2   ? &fused_bwd_dkv_wide<2>
           : tiles == 3 ? &fused_bwd_dkv_wide<3>
                        : &fused_bwd_dkv_wide<4>;
  } else {
    return tiles == 2   ? &fused_bwd_dq_wide<2>
           : tiles == 3 ? &fused_bwd_dq_wide<3>
                        : &fused_bwd_dq_wide<4>;
  }
}

struct Args {
  const void *q, *k, *v, *out, *lse, *g;
  void *dq, *dk, *dv, *delta;
  int64_t rows;
  int s, d;
  float scale;
  Dropout drop;
  int device;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkv(const Args& a, const CUtensorMap& q_str,
                       const CUtensorMap& k_own, const CUtensorMap& v_own,
                       const CUtensorMap& g_str, dim3 grid, int tiles,
                       const PhiloxMask& mask) {
  using flash_bwd::Dkv;
  auto dkv = fused_bwd_dkv_tiled_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv<D>::kSmem);
  if (err != cudaSuccess) return err;
  dkv<<<grid, flash_bwd::kMmaThreads, Dkv<D>::kSmem, a.stream>>>(
      q_str, k_own, v_own, g_str, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.s, tiles, a.scale, a.scale * flash::kLog2e,
      mask, a.d);
  return cudaGetLastError();
}

// Three kernels in order on one stream: delta, then the flash backward's
// dkv and dq blocks with the Philox mask.
template <int D>
cudaError_t launch_tiled(const Args& a, bool drop_on) {
  using flash_bwd::Dkv;
  using flash_bwd::Dq;
  using flash_bwd::kOwn;
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
      err = hp::tensor_map_3d(m.map, m.base, a.rows, a.s, a.d, m.box,
                              hp::Span<D>::kCols);
    }
  }
  if (err != cudaSuccess) return err;
  err = flash::launch_delta<bf16, flash::for_fused_bwd>(
      a.out, a.g, a.delta, a.rows * a.s, a.d, a.stream);
  if (err != cudaSuccess) return err;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const float scale_log2 = a.scale * flash::kLog2e;
  const PhiloxMask mask{a.drop.seed, a.drop.threshold, a.drop.inv_keep,
                        drop_on ? 1 : 0};
  const dim3 grid(static_cast<unsigned>(blocks));

  err = launch_dkv<D>(a, q_str, k_own, v_own, g_str, grid, tiles, mask);
  if (err != cudaSuccess) return err;

  auto dq = a.d == D ? fused_bwd_dq_tiled_wgmma<D, true>
                     : fused_bwd_dq_tiled_wgmma<D, false>;
  err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<D>::kSmem);
  if (err != cudaSuccess) return err;
  dq<<<grid, flash_bwd::kMmaThreads, Dq<D>::kSmem, a.stream>>>(
      q_own, k_str, v_str, g_own, lse, delta, static_cast<bf16*>(a.dq), a.s,
      tiles, a.scale, scale_log2, mask, a.d);
  return cudaGetLastError();
}

// Tile widths 192 and 256: the delta kernel, then flash_block256.cuh's dkv
// and dq kernels with the Philox mask.
template <int D>
cudaError_t launch_block256(const Args& a, bool drop_on) {
  cudaError_t err = flash::launch_delta<bf16, flash::for_fused_bwd>(
      a.out, a.g, a.delta, a.rows * a.s, a.d, a.stream);
  if (err != cudaSuccess) return err;
  const PhiloxMask mask{a.drop.seed, a.drop.threshold, a.drop.inv_keep,
                        drop_on ? 1 : 0};
  return flash256::launch_bwd<D>(
      &fused_bwd_dkv_block256<D>, &fused_bwd_dq_block256<D>, a.q, a.k, a.v,
      a.g, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.dq, a.dk, a.dv, a.rows, a.s, a.d,
      a.scale, mask, a.stream);
}

// Past d = 256: the delta kernel, then the wide dkv and dq blocks with the
// Philox mask, at the plan's slices and tiles (ops/flash_attention.py
// wide_plan).
cudaError_t launch_wide(const Args& a, bool drop_on, const int (&plan)[4]) {
  namespace fw = flash_wide;
  if (!fw::plan_ok(fw::kDkv, a.d, plan[0], plan[1]) ||
      !fw::plan_ok(fw::kDq, a.d, plan[2], plan[3])) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = flash::launch_delta<bf16, flash::for_fused_bwd>(
      a.out, a.g, a.delta, a.rows * a.s, a.d, a.stream);
  if (err != cudaSuccess) return err;
  const PhiloxMask mask{a.drop.seed, a.drop.threshold, a.drop.inv_keep,
                        drop_on ? 1 : 0};
  float* lse = const_cast<float*>(static_cast<const float*>(a.lse));
  const float* delta = static_cast<const float*>(a.delta);
  const float scale_log2 = a.scale * flash::kLog2e;
  const fw::Io dkv{static_cast<bf16*>(a.dv), static_cast<bf16*>(a.dk), lse,
                   delta, a.scale, scale_log2};
  err = fw::launch(wide_kernel<fw::kDkv>(plan[1]), fw::kDkv, plan[1], a.q,
                   a.k, a.v, a.g, a.rows, a.s, a.d, plan[0], dkv, mask,
                   a.stream);
  if (err != cudaSuccess) return err;
  const fw::Io dq{static_cast<bf16*>(a.dq), nullptr, lse, delta, a.scale,
                  scale_log2};
  return fw::launch(wide_kernel<fw::kDq>(plan[3]), fw::kDq, plan[3], a.q,
                    a.k, a.v, a.g, a.rows, a.s, a.d, plan[2], dq, mask,
                    a.stream);
}

template <int D, int KC>
cudaError_t launch_row(const Args& a, bool drop_on) {
  using C = RowBwd<D, KC>;
  if (a.rows > INT32_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = hp::tensor_map_3d(&tq, a.q, a.rows, a.s, D, C::kKeys);
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tg, a.g, a.rows, a.s, D, C::kKeys);
  }
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tk, a.k, a.rows, a.s, D, C::kKRows);
  }
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tv, a.v, a.rows, a.s, D, C::kKRows);
  }
  if (err != cudaSuccess) return err;
  auto kernel = fused_bwd_row_wgmma<D, KC>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  // A persistent grid of equal shares: at most one block an SM.
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               a.device);
  if (err != cudaSuccess) return err;
  const int64_t per_block = (a.rows + sms - 1) / sms;
  const int64_t blocks = (a.rows + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), kRowThreads, C::kSmem, a.stream>>>(
      tq, tk, tv, tg, static_cast<const bf16*>(a.out),
      static_cast<const bf16*>(a.g), static_cast<const float*>(a.lse),
      static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.rows, a.s, a.scale,
      a.scale * flash::kLog2e, a.drop, drop_on ? 1 : 0);
  return cudaGetLastError();
}

// The whole-row instantiation for kc = ceil(S / 16) chunks, KC >= kc.
template <int D, int KC>
cudaError_t launch_row_chunks(const Args& a, bool drop_on, int kc) {
  if constexpr (KC > 1) {
    if (kc < KC) return launch_row_chunks<D, KC - 1>(a, drop_on, kc);
  }
  return launch_row<D, KC>(a, drop_on);
}

template <int D>
cudaError_t launch_d(const Args& a, bool drop_on) {
  // Dispatch by S: a row that one block holds takes the whole-row kernel
  // (one launch), a longer one the tiled kernels. Neither falls back to the
  // other.
  if constexpr (kRowMaxKeys<D> > 0) {
    if (a.d == D && a.s <= kRowMaxKeys<D>) {
      return launch_row_chunks<D, kRowMaxKeys<D> / 16>(a, drop_on,
                                                       (a.s + 15) / 16);
    }
  }
  if constexpr (D == 192 || D == 256) {
    return launch_block256<D>(a, drop_on);
  } else {
    return launch_tiled<D>(a, drop_on);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// first launch that failed (0 on success). q, k, v, out, g and dq, dk, dv
// are device pointers to contiguous [rows, s, d] tensors of one dtype
// (is_bf16 = 1 for bf16, 0 for f32; d a multiple of 8), 16-byte aligned;
// `lse` is the forward's f32 [rows, s]; `delta` is f32
// [rows, s] scratch that the first kernel fills. The dropout arguments are
// the forward's (fused_mha_fwd.cu).
// `stream` is the caller's cudaStream_t. The kernels allocate nothing and do
// not synchronise.
extern "C" int fused_mha_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* lse, const void* g,
                             void* dq, void* dk, void* dv, void* delta,
                             long long rows, int s, int d, int is_bf16,
                             float scale, int drop_on, unsigned seed_lo,
                             unsigned seed_hi, unsigned threshold,
                             float keep_prob, int device, void* stream,
                             int kv_slices, int kv_tiles, int q_slices,
                             int q_tiles) {
  if (rows <= 0 || s < 1 || d < 8 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (drop_on && !(keep_prob > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dropout drop{(static_cast<uint64_t>(seed_hi) << 32) | seed_lo,
                     threshold, drop_on ? 1.f / keep_prob : 1.f};
  const Args a{q,  k,     v,    out, lse, g,     dq,   dk,     dv,
               delta, rows, s, d,   scale, drop, device,
               static_cast<cudaStream_t>(stream)};
  const bool on = drop_on != 0;
  if (!is_bf16) {
    return static_cast<int>(flash_f32::launch_bwd<flash::for_fused_bwd>(
        q, k, v, out, g, lse, delta, dq, dk, dv, rows, s, d, scale,
        flash_f32::Drop{drop.seed, drop.threshold, drop.inv_keep, on ? 1 : 0},
        a.stream));
  }
  if (flash_wide::takes(d)) {
    const int plan[4] = {kv_slices, kv_tiles, q_slices, q_tiles};
    return static_cast<int>(launch_wide(a, on, plan));
  }
  switch (flash::tile_width(d)) {
    case 16:
      err = launch_d<16>(a, on);
      break;
    case 32:
      err = launch_d<32>(a, on);
      break;
    case 64:
      err = launch_d<64>(a, on);
      break;
    case 80:
      err = launch_d<80>(a, on);
      break;
    case 128:
      err = launch_d<128>(a, on);
      break;
    case 192:
      err = launch_d<192>(a, on);
      break;
    case 256:
      err = launch_d<256>(a, on);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory, in bytes, that the whole-row bf16 kernel is
// launched with at head dim d and key length s (0 where the tiled kernels
// run instead: every S at the head dims other than 16, 32, 64 and 128).
extern "C" int fused_mha_bwd_smem(int d, int s) {
  const int max_keys = d == 16   ? kRowMaxKeys<16>
                       : d == 32 ? kRowMaxKeys<32>
                       : d == 64 ? kRowMaxKeys<64>
                       : d == 128 ? kRowMaxKeys<128>
                                  : 0;
  return s >= 1 && s <= max_keys ? row_bwd_smem(d, (s + 15) / 16) : 0;
}

// The dkv and dq kernels of flash_block256.cuh that this library launched
// since the last call, into counts[0] and counts[1]; zeroes both counts.
extern "C" void fused_mha_bwd_block256_launches(long long* counts) {
  counts[0] = flash256::dkv_launches.exchange(0);
  counts[1] = flash256::dq_launches.exchange(0);
}

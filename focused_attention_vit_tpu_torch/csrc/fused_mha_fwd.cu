// Fused short-sequence attention with dropout on the attention weights,
// forward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/mha_kernel.py::_fwd_kernel (:59,
// pallas_call at :146). Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/mha_kernel.py.
//
// What it computes, for each (b*h) row of contiguous [B*h, S, d] q, k, v:
//   w_ij  = softmax_j(q_i . k_j * d^-1/2)            over the S real keys
//   z_ij  = w_ij * keep_ij / (1 - rate)               (inverted dropout)
//   out_i = sum_j z_ij v_j
// with f32 logits and softmax, the weights rounded to v's dtype for the
// second product, f32 accumulation and one rounding of out. keep_ij comes
// from Philox keyed on (seed, row, i, j) (philox.cuh), so the backward
// (fused_mha_bwd.cu) and the plain version draw the same mask. The training
// instantiation also writes lse_i = log sum_j exp(logit_ij) (f32 [B*h, S])
// for the backward; the eval instantiation writes none and draws nothing.
//
// The TPU kernel holds the whole [Sp, Sp] f32 score tile of one row in
// VMEM and runs the softmax in one pass over it. At S <= 256 and d <= 64 a
// row's Q, K and V take at most 96 KB, so the bf16 kernel here keeps that
// shape: one block owns one whole head-row.
//
// What bounds it on this card: bytes, on paper. At B*h = 1536, S = 197,
// d = 64 in bf16 a call moves 155 MB of q, k, v and out (0.046 ms at
// 3.35 TB/s) and does 15.3 GFLOP (0.015 ms at the bf16 peak). In training
// the Philox draw (one call of 10 rounds per four weights) and the
// exponentials are the largest share of the work. The whole-row kernel
// (fused_fwd_row_wgmma, S <= 256 at d <= 64, S <= 128 at d = 128):
//   - a block is two warpgroups and owns one head-row at a time; it is
//     persistent (one block an SM, an equal share of the rows each) and
//     holds two rows, so that the next row's Q, K and V arrive by TMA
//     (3-D maps over [B*h, S, d], which zero-fill past S inside the head;
//     two mbarriers a row: Q and K, then V) while this one is computed;
//     the warpgroups take the row's 64-query tiles in turns;
//   - keys are padded to a multiple of 16 only (208 at S = 197), and that
//     width is a template parameter: S = Q K^T for 64 queries over the
//     whole row is one chain of wgmma products (64 keys each, and one of
//     16, 32 or 48 for the rest) with the logits in registers;
//   - the softmax is one pass over the row: maximum, exponentials, the sum
//     over every key (dropped or not), then the mask on the numerator; in
//     the accumulator layout a lane owns columns 2t, 2t+1, 2t+8, 2t+9 of
//     each 16, the four keys of one Philox call, so a call serves four
//     weights. Warps whose 16 queries all lie past S skip it;
//   - P, rounded to bf16 in registers, is the A operand of O = P V, with V
//     read through the transpose bit; the output is divided by the sum and
//     by (1 - rate) and rounded once. Rounding the weights before they are
//     normalised keeps the largest of each row exact (1.0); rounding the
//     normalised weights, as the plain version does, measured 1.3 to 1.4
//     bf16 ulps of error on average against 1.0 to 1.1 (PERF.md);
//   - a row at S = 197 is 4 tiles of 64 queries, the last with 5 real
//     ones. Every product is waited for before its registers are touched,
//     so ptxas serializes nothing.
// Eval and training are one code path (the lse store and the draw are
// flags), so their outputs agree bit for bit.
//
// Longer rows (up to the op's S = 1024) take the tiled kernel
// (fused_fwd_tiled_wgmma): the dense flash forward's block
// (flash_fwd_block.cuh: 128 queries, K/V tiles of 128 keys, 64 at d = 128,
// in a TMA ring, wgmma products, the online-softmax recurrence, the two
// consumer warpgroups taking turns) with the same Philox mask applied to
// each key tile's weights after they entered the sum.
//
// f32 tensors, at every head dim, take flash_f32.cuh's scalar kernels (full
// f32 products, one Philox call a key; for parity runs, not for speed).
//
// Head dims: every multiple of 8 (JAX's rule is d % 8 == 0). Up to 256 they
// run at the narrowest tile width D of 16, 32, 64, 80, 128, 192 and 256
// that holds it (flash::tile_width, as the dense flash kernels). The TMA
// maps cover the real d columns and zero-fill the rest of the tile, the
// softmax scale is the real d's, and the columns past d are not stored.
// The whole-row kernel holds S <= kRowMaxKeys<D> keys (256, 192, 128 and 64
// as D grows); longer rows take the flash blocks with the mask. Past 256
// every S takes the dense forward's wide block (flash_wide.cuh) with the
// mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_fwd_block.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

struct Dropout {
  uint64_t seed;
  uint32_t threshold;  // keep iff word >= threshold
  float inv_keep;      // 1 / (1 - rate); 1 without dropout
};

// --- bf16, a whole row a block (S <= kRowMaxKeys) ----------------------------

// The keys of a row that one block holds, by tile width D: S <= 256 at
// D <= 64, 192 at D = 80, 128 at D = 128 (where the output accumulator
// takes 64 registers more and two rows' tiles must still fit), 64 at
// D = 192 and 256 (96 and 128 registers of accumulator; two stages of a
// 64-key row take 145 and 193 KB).
template <int D>
constexpr int kRowMaxKeys = D <= 64    ? 256
                            : D == 80  ? 192
                            : D == 128 ? 128
                                       : 64;

constexpr int kRowThreads = 256;  // two warpgroups
constexpr int kRowStages = 2;     // rows in flight a block

// Dynamic shared memory of the whole-row kernel: two stages of Q, K and V
// of a row, and 1 KB to align them (RowFwd below).
constexpr int row_fwd_smem(int d, int kc) {
  return kRowStages * (64 * ((kc + 3) / 4) * d * 2 +
                       2 * ((16 * kc * d * 2 + 1023) / 1024 * 1024)) +
         1024;
}

// One instantiation per count KC of 16-key chunks: the row's keys padded to
// 16 KC are the N of one chain of products, fixed at compile time so that
// the logits stay in registers.
template <int D, int KC>
struct RowFwd {
  static constexpr int kKeys = 16 * KC;
  // Whole 64-query tiles: the M of a warpgroup's product.
  static constexpr int kQRows = 64 * ((KC + 3) / 4);
  static constexpr int kQBytes = kQRows * D * 2;
  static constexpr int kKVBytes = (kKeys * D * 2 + 1023) / 1024 * 1024;
  static constexpr int kStageBytes = kQBytes + 2 * kKVBytes;
  static constexpr int kSmem = kRowStages * kStageBytes + 1024;
  static_assert(kSmem == row_fwd_smem(D, KC), "one formula");
  static_assert(kKeys <= kRowMaxKeys<D>, "row too long for one block");
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

// A persistent block walks rows blockIdx.x, blockIdx.x + gridDim.x, ...;
// row n of its walk sits in stage n % 2, and the next row's loads run
// while this one is computed. Both warpgroups work on each row, taking its
// 64-query tiles in turns (the first turn alternating from row to row, so
// that a short last tile does not always fall to the same one); the one
// that finishes a row second refills its stage with the row after next.
// O (+)= P V for 16-key chunk kc of the row: one product where wgmma has
// an N of D (the first chunk overwrites), else rs_cols' column slices (64
// + 16 at D = 80, 128 + 64 at 192, 128 + 128 at 256), which accumulate, on
// an O the caller zeroed.
template <int D, int NK>
__device__ __forceinline__ void pv_chunk(float (&o)[D / 2],
                                         const uint32_t (&pa)[4],
                                         const bf16* vs, int kc) {
  if constexpr (D == 16 || D == 32 || D == 64 || D == 128) {
    hp::Wgmma<D>::rs(o, pa, hp::desc_mn<D, NK>(vs, kc), kc > 0 ? 1 : 0);
  } else {
    hp::rs_cols<D, NK>(o, pa, vs, kc);
  }
}

// D is the tile width; d (<= D, a multiple of 8) the head dim, the row
// stride of `out`: Q, K and V arrive with zeros past d (TMA fills them),
// and the columns past d are not stored.
template <int D, int KC>
__global__ void __launch_bounds__(kRowThreads, 1)
    fused_fwd_row_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        int64_t rows, int s, float scale_log2, Dropout drop,
                        int drop_on, int d) {
  using C = RowFwd<D, KC>;
  constexpr int NK = C::kKeys;
  constexpr int NFULL = NK / 64;  // 64-key products of the chain
  constexpr int NTAIL = NK % 64;  // and the last one's width, if any
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_qk[kRowStages], bar_v[kRowStages];
  __shared__ int released[kRowStages];  // warpgroups done with the stage
  uint8_t* smem = hp::align1024(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // in the warpgroup
  const int lane = tid & 31;
  const int wq = lane & 3;
  // This thread's rows r and r + 8 of each 64-query tile, columns
  // 8j + 2wq (+1) of the accumulators.
  const int r = warp * 16 + (lane >> 2);

  auto load = [&](int st, int64_t row) {
    uint8_t* base = smem + st * C::kStageBytes;
    bf16* qs = reinterpret_cast<bf16*>(base);
    bf16* ks = reinterpret_cast<bf16*>(base + C::kQBytes);
    bf16* vs = reinterpret_cast<bf16*>(base + C::kQBytes + C::kKVBytes);
    hp::mbar_arrive_expect_tx(&bar_qk[st], (C::kQRows + NK) * D * 2);
    hp::load_tile<D, C::kQRows>(qs, &tq, &bar_qk[st], row, 0);
    hp::load_tile<D, NK>(ks, &tk, &bar_qk[st], row, 0);
    hp::mbar_arrive_expect_tx(&bar_v[st], NK * D * 2);
    hp::load_tile<D, NK>(vs, &tv, &bar_v[st], row, 0);
  };

  if (tid == 0) {
    for (int st = 0; st < kRowStages; ++st) {
      hp::mbar_init(&bar_qk[st], 1);
      hp::mbar_init(&bar_v[st], 1);
      released[st] = 0;
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int st = 0; st < kRowStages; ++st) {
      const int64_t row = blockIdx.x + st * static_cast<int64_t>(gridDim.x);
      if (row < rows) load(st, row);
    }
  }

  float sc[NK / 2];    // logits, then weights, of two query rows
  uint32_t pa[KC][4];  // the weights as P V's A operand
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  const int tiles = (s + 63) / 64;
  for (int n = 0;; ++n) {
    const int64_t row = blockIdx.x + n * static_cast<int64_t>(gridDim.x);
    if (row >= rows) break;
    const int st = n % kRowStages;
    const uint32_t parity = (n / kRowStages) & 1;
    uint8_t* base = smem + st * C::kStageBytes;
    const bf16* qs = reinterpret_cast<const bf16*>(base);
    const bf16* ks = reinterpret_cast<const bf16*>(base + C::kQBytes);
    const bf16* vs =
        reinterpret_cast<const bf16*>(base + C::kQBytes + C::kKVBytes);
    hp::mbar_wait(&bar_qk[st], parity);

    for (int t = (wg + n) & 1; t < tiles; t += 2) {
      // S = Q K^T over the whole row: NFULL products of 64 keys and a
      // narrower last one, with Q's tile as A.
      hp::fence_regs(sc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = hp::desc_k<D, C::kQRows>(qs, 64 * t, kk);
#pragma unroll
        for (int c = 0; c < NFULL; ++c) {
          hp::Wgmma<64>::ss(hp::slice<32>(sc, 32 * c), da,
                            hp::desc_k<D, NK>(ks, 64 * c, kk),
                            kk > 0 ? 1 : 0);
        }
        if constexpr (NTAIL > 0) {
          hp::Wgmma<NTAIL>::ss(hp::slice<NTAIL / 2>(sc, 32 * NFULL), da,
                               hp::desc_k<D, NK>(ks, 64 * NFULL, kk),
                               kk > 0 ? 1 : 0);
        }
      }
      hp::wgmma_commit();
      hp::fence_regs(sc);
      hp::wgmma_wait<0>();
      hp::fence_regs(sc);

      // The softmax in one pass over the row: maximum, exponentials and
      // the sum over every key, dropped or not; then the mask on the
      // numerator. A warp whose 16 queries all lie past S skips it: its
      // rows are never written and the rows of a product do not mix.
      const int i0 = 64 * t + r;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      const bool live = 64 * t + warp * 16 < s;
      if (live) {
#pragma unroll
        for (int i = 8 * (KC - 1); i < NK / 2; ++i) {  // the last chunk
          if ((i >> 2) * 8 + 2 * wq + (i & 1) >= s) sc[i] = -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) {
          m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], sc[i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
          m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
          m[h] *= scale_log2;  // key 0 is real, so m is finite
        }
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) {
          const int h = (i >> 1) & 1;
          const float p = exp2f(fmaf(sc[i], scale_log2, -m[h]));
          sc[i] = p;
          l[h] += p;
        }
        if (drop_on) {
          // One Philox call gives the words of this lane's four keys of
          // one row in one 16-key chunk: columns 2wq, 2wq+1, 2wq+8, 2wq+9.
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 w = philox::mha_words(drop.seed, row, i0 + 8 * h,
                                                4 * kc + wq);
              const int e = 8 * kc + 2 * h;
              if (w.x < drop.threshold) sc[e] = 0.f;
              if (w.y < drop.threshold) sc[e + 1] = 0.f;
              if (w.z < drop.threshold) sc[e + 4] = 0.f;
              if (w.w < drop.threshold) sc[e + 5] = 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) hp::pack_a(pa[kc], sc, kc);

      // O = P V, V read through the transpose bit.
      hp::mbar_wait(&bar_v[st], parity);
      if constexpr (!(D == 16 || D == 32 || D == 64 || D == 128)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      }
      hp::fence_regs(o);
      hp::fence_regs(pa);
      hp::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) pv_chunk<D, NK>(o, pa[kc], vs, kc);
      hp::wgmma_commit();
      hp::fence_regs(o);
      hp::fence_regs(pa);
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
      hp::fence_regs(pa);

      if (live) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          const int i = i0 + 8 * h;
          if (i >= s) continue;
          const float inv = drop.inv_keep / l[h];
          bf16* orow = out + (row * s + i) * d;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            if (8 * j >= d) break;
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * wq) =
                __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                      o[4 * j + 2 * h + 1] * inv);
          }
          if (lse != nullptr && wq == 0) {
            lse[row * s + i] = (m[h] + log2f(l[h])) * flash::kLn2;
          }
        }
      }
    }

    // This warpgroup is done with the stage (its products were waited
    // for); the second to get here refills it with the row after next.
    hp::named_sync(1 + wg, 128);
    if ((tid & 127) == 0) {
      __threadfence_block();
      if (atomicAdd(&released[st], 1) == 1) {
        released[st] = 0;
        const int64_t next = row + kRowStages * static_cast<int64_t>(gridDim.x);
        if (next < rows) load(st, next);
      }
    }
  }
}

// --- bf16, tiled (longer rows) -----------------------------------------------

// The Philox mask on the numerator, for the flash forward's block
// (flash_fwd_block.cuh): zero the weights of this thread's rows i and i + 8
// whose word is below the threshold, keys from key0 in the accumulator
// layout, one call per lane, row and 16-key chunk.
struct PhiloxMask {
  uint64_t seed;
  uint32_t threshold;
  float inv_keep;  // 1 / (1 - rate); 1 without dropout
  int on;

  template <int N>
  __device__ __forceinline__ void apply(float (&sc)[N], int64_t row, int i,
                                        int key0) const {
    if (!on) return;
    const int wq = threadIdx.x & 3;
#pragma unroll
    for (int kc = 0; kc < N / 8; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 w =
            philox::mha_words(seed, row, i + 8 * h, 4 * (key0 / 16 + kc) + wq);
        const int e = 8 * kc + 2 * h;
        if (w.x < threshold) sc[e] = 0.f;
        if (w.y < threshold) sc[e + 1] = 0.f;
        if (w.z < threshold) sc[e + 4] = 0.f;
        if (w.w < threshold) sc[e + 5] = 0.f;
      }
    }
  }
};

template <int D, bool kLse>
__global__ void __launch_bounds__(flash_fwd::kThreads, 1)
    fused_fwd_tiled_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int s, int tiles_per_row, float scale_log2,
                          PhiloxMask mask, int d) {
  flash_fwd::block<D, kLse>(tq, tk, tv, out, lse, s, tiles_per_row,
                            scale_log2, mask, d);
}

// Past d = 256: flash_wide.cuh's forward block with the Philox mask, NT
// output tiles of 64 columns a warpgroup (the fourth map is unused).
template <int NT, bool kLse>
__global__ void __launch_bounds__(flash_wide::kThreads, 1)
    fused_fwd_wide(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap, flash_wide::Geom g,
                   flash_wide::Io io, PhiloxMask mask) {
  const flash_wide::Maps m{&tq, &tk, &tv};
  flash_wide::block<flash_wide::kFwd, NT, kLse>(m, m, g, io, mask);
}

template <bool kLse>
auto wide_kernel(int tiles) {
  return tiles == 2   ? &fused_fwd_wide<2, kLse>
         : tiles == 3 ? &fused_fwd_wide<3, kLse>
                      : &fused_fwd_wide<4, kLse>;
}

constexpr int kThreads = 128;  // the dropout words' threads a block

// The dropout words as the kernels draw them, for holding the device
// generator to the plain one: out[row][i][j] for every query i and key j.
__global__ void __launch_bounds__(kThreads)
    fused_keep_bits(uint32_t* __restrict__ out, int64_t rows, int s,
                    int groups, uint64_t seed) {
  const int64_t idx =
      blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (idx >= rows * s * groups) return;
  const int grp = static_cast<int>(idx % groups);
  const int i = static_cast<int>((idx / groups) % s);
  const int64_t row = idx / (static_cast<int64_t>(groups) * s);
  const uint4 w = philox::mha_words(seed, row, i, grp);
  const int j = 16 * (grp >> 2) + 2 * (grp & 3);
  uint32_t* orow = out + (row * s + i) * s;
  if (j < s) orow[j] = w.x;
  if (j + 1 < s) orow[j + 1] = w.y;
  if (j + 8 < s) orow[j + 8] = w.z;
  if (j + 9 < s) orow[j + 9] = w.w;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int64_t rows;
  int s, d;
  float scale;
  bool drop_on;
  Dropout drop;
  int device;
  cudaStream_t stream;
};

template <int D, bool kLse>
cudaError_t launch_tiled(const Args& a) {
  using C = flash_fwd::Fwd<D>;
  const int tiles = (a.s + flash_fwd::kBM - 1) / flash_fwd::kBM;
  const int64_t blocks = a.rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  constexpr int kCols = hp::Span<D>::kCols;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      hp::tensor_map_3d(&tq, a.q, a.rows, a.s, a.d, flash_fwd::kBM, kCols);
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tk, a.k, a.rows, a.s, a.d, C::kBN, kCols);
  }
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tv, a.v, a.rows, a.s, a.d, C::kBN, kCols);
  }
  if (err != cudaSuccess) return err;
  auto kernel = fused_fwd_tiled_wgmma<D, kLse>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const PhiloxMask mask{a.drop.seed, a.drop.threshold, a.drop.inv_keep,
                        a.drop_on ? 1 : 0};
  kernel<<<static_cast<unsigned>(blocks), flash_fwd::kThreads, C::kSmem,
           a.stream>>>(tq, tk, tv, static_cast<bf16*>(a.out), a.lse, a.s,
                       tiles, a.scale * flash::kLog2e, mask, a.d);
  return cudaGetLastError();
}

// Past d = 256: the wide block with the Philox mask, at the plan's
// `slices` slices of `tiles` 64-column tiles a warpgroup
// (ops/flash_attention.py wide_plan).
cudaError_t launch_wide(const Args& a, int slices, int tiles) {
  const flash_wide::Io io{static_cast<bf16*>(a.out), nullptr, a.lse, nullptr,
                          a.scale, a.scale * flash::kLog2e};
  const PhiloxMask mask{a.drop.seed, a.drop.threshold, a.drop.inv_keep,
                        a.drop_on ? 1 : 0};
  return flash_wide::launch(
      a.lse != nullptr ? wide_kernel<true>(tiles) : wide_kernel<false>(tiles),
      flash_wide::kFwd, tiles, a.q, a.k, a.v, a.v, a.rows, a.s, a.d, slices,
      io, mask, a.stream);
}

template <int D, int KC>
cudaError_t launch_row(const Args& a) {
  using C = RowFwd<D, KC>;
  if (a.rows > INT32_MAX) return cudaErrorInvalidConfiguration;
  constexpr int kCols = hp::Span<D>::kCols;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      hp::tensor_map_3d(&tq, a.q, a.rows, a.s, a.d, C::kQRows, kCols);
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tk, a.k, a.rows, a.s, a.d, C::kKeys, kCols);
  }
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tv, a.v, a.rows, a.s, a.d, C::kKeys, kCols);
  }
  if (err != cudaSuccess) return err;
  auto kernel = fused_fwd_row_wgmma<D, KC>;
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
      tq, tk, tv, static_cast<bf16*>(a.out), a.lse, a.rows, a.s,
      a.scale * flash::kLog2e, a.drop, a.drop_on ? 1 : 0, a.d);
  return cudaGetLastError();
}

// The whole-row instantiation for kc = ceil(S / 16) chunks, KC >= kc.
template <int D, int KC>
cudaError_t launch_row_chunks(const Args& a, int kc) {
  if constexpr (KC > 1) {
    if (kc < KC) return launch_row_chunks<D, KC - 1>(a, kc);
  }
  return launch_row<D, KC>(a);
}

template <int D>
cudaError_t launch_d(const Args& a) {
  // Dispatch by S: a row that one block holds takes the whole-row kernel, a
  // longer one the tiled kernel. Neither falls back to the other.
  if (a.s <= kRowMaxKeys<D>) {
    return launch_row_chunks<D, kRowMaxKeys<D> / 16>(a, (a.s + 15) / 16);
  }
  return a.lse != nullptr ? launch_tiled<D, true>(a)
                          : launch_tiled<D, false>(a);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). q, k, v and out are device pointers to contiguous
// [rows, s, d] tensors of one dtype (is_bf16 = 1 for bf16, 0 for f32),
// 16-byte aligned; `lse` is a contiguous f32 [rows, s] tensor to receive the
// log-sum-exp of each query's scaled logits, or null; d is a multiple of 8.
// With drop_on != 0 the
// weights are dropped: keep iff the Philox word of (seed, row, query, key)
// is at least `threshold`, and scale the kept by 1 / keep_prob. `stream` is
// the caller's cudaStream_t. The kernel allocates nothing and does not
// synchronise.
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, long long rows, int s,
                             int d, int is_bf16, float scale, int drop_on,
                             unsigned seed_lo, unsigned seed_hi,
                             unsigned threshold, float keep_prob, int device,
                             void* stream, int slices, int tiles) {
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
  const Args a{q,     k,           v,    out,
               static_cast<float*>(lse), rows, s, d, scale,
               drop_on != 0, drop, device, static_cast<cudaStream_t>(stream)};
  if (!is_bf16) {
    return static_cast<int>(flash_f32::launch_fwd(
        q, k, v, out, a.lse, rows, s, d, scale,
        flash_f32::Drop{drop.seed, drop.threshold, drop.inv_keep,
                        drop_on != 0 ? 1 : 0},
        a.stream));
  }
  if (flash_wide::takes(d)) {
    return static_cast<int>(launch_wide(a, slices, tiles));
  }
  switch (flash::tile_width(d)) {
    case 16:
      err = launch_d<16>(a);
      break;
    case 32:
      err = launch_d<32>(a);
      break;
    case 64:
      err = launch_d<64>(a);
      break;
    case 80:
      err = launch_d<80>(a);
      break;
    case 128:
      err = launch_d<128>(a);
      break;
    case 192:
      err = launch_d<192>(a);
      break;
    case 256:
      err = launch_d<256>(a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Writes the dropout words of every (row, query, key) into `out`, a
// contiguous uint32 [rows, s, s] device tensor.
extern "C" int fused_mha_keep_bits(void* out, long long rows, int s,
                                   unsigned seed_lo, unsigned seed_hi,
                                   int device, void* stream) {
  if (rows <= 0 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = 4 * ((s + 15) / 16);
  const int64_t n = static_cast<int64_t>(rows) * s * groups;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_keep_bits<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), rows, s, groups,
      (static_cast<uint64_t>(seed_hi) << 32) | seed_lo);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory, in bytes, that the whole-row bf16 kernel is
// launched with at head dim d and key length s, at d's padded tile width
// (0 where the tiled kernel runs instead, or for a d it does not take).
extern "C" int fused_mha_fwd_smem(int d, int s) {
  const int w = flash::tile_width(d);
  const int max_keys = w == 0     ? 0
                       : w <= 64  ? kRowMaxKeys<64>
                       : w == 80  ? kRowMaxKeys<80>
                       : w == 128 ? kRowMaxKeys<128>
                                  : kRowMaxKeys<256>;
  return s >= 1 && s <= max_keys ? row_fwd_smem(w, (s + 15) / 16) : 0;
}

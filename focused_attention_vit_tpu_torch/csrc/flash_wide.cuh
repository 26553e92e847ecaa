// The dense attention kernels' blocks for head dims past 256 (d a multiple
// of 8 above 256): the forward of flash_attention_fwd.cu and
// fused_mha_fwd.cu, the dkv and dq kernels of flash_attention_bwd.cu and
// fused_mha_bwd.cu. The fused op passes its Philox mask through the same
// Mask parameter as flash_fwd_block.cuh and flash_bwd_blocks.cuh; the
// dense op passes their NoMask.
//
// Replaces, past d = 256, what the narrower blocks replace:
// focused_attention_vit_tpu/ops/flash_attention_pallas.py::flash_attention_tpu
// (:28, JAX's bundled flash kernel, forward and backward) and
// focused_attention_vit_tpu/ops/mha_kernel.py::_fwd_kernel (:59) and
// ::_bwd_kernel (:83), which take any head dim that is a multiple of 8.
//
// Why another block: the wgmma blocks hold a 64 x D accumulator of the
// output (or of dk, dv, dq) in registers and stage whole rows of d columns
// by TMA, whose box holds at most 256 elements a side; at D = 256 the
// accumulator already spills (PERF.md). Past 256 no row fits. So here:
//   - the output columns are split over the grid's y dimension, in slices
//     of kFwdSlice (forward) and kBwdSlice (backward) columns; each block
//     keeps only its slice's accumulator;
//   - each block forms the logits (and, in the backward, dP) over the whole
//     head dim, in chunks of kCh columns staged by 16-byte cp.async copies
//     (zero-filled past S and past d, never reading the next head) into a
//     two-stage ring of padded rows; the next chunk's copies run under this
//     chunk's products. So every slice recomputes the logits: the forward
//     does (n_slices + 1) / 2 times the 4 S^2 d flops of attention, the
//     backward (8 n_slices + 6) / 10 times its 10 S^2 d (PERF.md writes the
//     factor beside the time);
//   - the products are warp-level bf16 tensor-core products
//     (mma.sync.m16n8k16, f32 accumulation; flash_common.cuh), four warps of
//     16 rows a block, operands read by ldmatrix: the accumulator layout of
//     a warp's 16 rows is that of the wgmma blocks (hopper_common.cuh), so
//     the masks' apply/dkv/dq act on it unchanged;
//   - in the backward the chunks of a tile are walked so that the block's
//     own slice comes last: its Q and g (dkv) or K (dq) columns are then
//     still staged for the slice's products.
// What bounds it: operations, times the recomputation factor; at d = 768 the
// chunks are read from L2 once per slice. (The f32 calls, at every head
// dim, take flash_f32.cuh's scalar kernels.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace flash_wide {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;     // four warps of 16 rows
constexpr int kRows = 64;         // rows (queries, or keys) a block owns
constexpr int kTile = 64;         // rows of a streamed tile
constexpr int kCh = 64;           // columns of a staged chunk of d
constexpr int kPitch = kCh + 8;   // a staged row, padded: ldmatrix reads
                                  // 8 rows at 8 different bank groups
constexpr int kChunkElems = kRows * kPitch;
constexpr int kFwdSlice = 128;    // output columns of a forward block
constexpr int kVPitch = kFwdSlice + 8;
constexpr int kBwdSlice = kCh;    // dk, dv or dq columns of a backward block

// The head dims these blocks take.
inline bool takes(int d) { return d > 256 && d % 8 == 0; }
inline int slices(int d, int width) { return (d + width - 1) / width; }

// Dynamic shared memory: the forward's two stages of Q and K chunks and
// its V slice; the backward's two stages of four chunks (K, V, Q, g).
constexpr int kFwdSmem = (4 * kChunkElems + kTile * kVPitch) * 2;
constexpr int kBwdSmem = 8 * kChunkElems * 2;

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool real) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(real ? 16 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [r0, r0 + 64) and columns [c0, c0 + COLS) of a contiguous [s, d]
// matrix into 64 rows of PITCH elements; rows at or past s and columns at
// or past d (d a multiple of 8) become zeros.
template <int COLS, int PITCH>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int r0,
                                      int c0, int s, int d) {
  constexpr int kVecs = COLS / 8;
  static_assert(kTile * kVecs % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int f0 = 0; f0 < kTile * kVecs; f0 += kThreads) {
    const int f = f0 + threadIdx.x;
    const int r = f / kVecs;
    const int c = (f % kVecs) * 8;
    const bool real = r0 + r < s && c0 + c < d;
    cp16(dst + r * PITCH + c,
         real ? src + static_cast<int64_t>(r0 + r) * d + c0 + c : src, real);
  }
}

// ldmatrix addresses of a lane in a 16-row block of padded rows:
// pattern A (an A operand; a B operand read transposed): matrix lane / 8
// holds rows 8 (lane / 8 & 1).. and columns 8 (lane / 16)..; pattern B (a
// B operand [n][k]): rows 8 (lane / 16).. and columns 8 (lane / 8 & 1)...
template <int PITCH>
__device__ __forceinline__ const bf16* at_a(const bf16* blk, int lane,
                                            int col) {
  return blk + (((lane >> 3) & 1) * 8 + (lane & 7)) * PITCH + col +
         (lane >> 4) * 8;
}
template <int PITCH>
__device__ __forceinline__ const bf16* at_b(const bf16* blk, int lane,
                                            int col) {
  return blk + ((lane >> 4) * 8 + (lane & 7)) * PITCH + col +
         ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[64 / 2] += A B^T over one staged chunk: A the warp's 16 rows of `a`,
// B the 64 rows of `b` (both kCh columns of padded rows); the accumulator
// holds the warp's 16 rows x 64 columns, 8 n-tiles of 4.
__device__ __forceinline__ void chunk_product(float (&acc)[32],
                                              const bf16* a, const bf16* b,
                                              int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < kCh / 16; ++kk) {
    uint32_t af[4];
    flash::ldsm_x4(af, at_a<kPitch>(a + warp * 16 * kPitch, lane, kk * 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      flash::ldsm_x4(bf, at_b<kPitch>(b + np * 16 * kPitch, lane, kk * 16));
      mma(acc + 8 * np, af, bf[0], bf[1]);
      mma(acc + 8 * np + 4, af, bf[2], bf[3]);
    }
  }
}

// acc[N / 2] += P B over 64 rows of B: P the warp's 16 x 64 weights in the
// accumulator layout (rounded to bf16 as A operands), B's rows [64][N]
// (padded to PITCH) read transposed.
template <int N, int PITCH>
__device__ __forceinline__ void weights_product(float (&acc)[N / 2],
                                                const float (&p)[32],
                                                const bf16* b, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t pa[4] = {flash::pack_bf16(p[8 * kc], p[8 * kc + 1]),
                            flash::pack_bf16(p[8 * kc + 2], p[8 * kc + 3]),
                            flash::pack_bf16(p[8 * kc + 4], p[8 * kc + 5]),
                            flash::pack_bf16(p[8 * kc + 6], p[8 * kc + 7])};
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      flash::ldsm_x4_trans(bf,
                           at_a<PITCH>(b + kc * 16 * PITCH, lane, np * 16));
      mma(acc + 8 * np, pa, bf[0], bf[1]);
      mma(acc + 8 * np + 4, pa, bf[2], bf[3]);
    }
  }
}

// Columns [c0, c0 + N) of rows r and r + 8 of a warp's accumulator, rounded,
// to a [s, d] matrix (rows past s and columns past d not written).
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[N / 2],
                                           int r, int c0, int s, int d,
                                           float inv0 = 1.f, float inv1 = 1.f) {
  const int wq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r + 8 * h;
    if (i >= s) continue;
    const float inv = h ? inv1 : inv0;
    bf16* row = dst + static_cast<int64_t>(i) * d + c0;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      if (c0 + 8 * nt >= d) break;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt + 2 * wq) =
          __floats2bfloat162_rn(acc[4 * nt + 2 * h] * inv,
                                acc[4 * nt + 2 * h + 1] * inv);
    }
  }
}

// --- forward --------------------------------------------------------------

// A block owns 64 queries of a row (blockIdx.x) and kFwdSlice output
// columns (blockIdx.y). Per key tile of 64: the logits over d chunk by
// chunk, the online softmax (m in log2 units, as flash_fwd_block.cuh), the
// mask, then O += P V over the slice. The ring walks (key tile, chunk)
// pairs; the key tile's V slice is staged with the tile's second chunk.
template <bool kLse, class Mask>
__device__ __forceinline__ void fwd_block(const bf16* __restrict__ q,
                                          const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          bf16* __restrict__ out,
                                          float* __restrict__ lse, int s,
                                          int d, int tiles_per_row,
                                          float scale_log2, const Mask& mask) {
  extern __shared__ uint8_t smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage b: Q, then K
  bf16* vs = ring + 4 * kChunkElems;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wq = lane & 3;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kRows;
  const int c_out = blockIdx.y * kFwdSlice;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const bf16* qh = q + base;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int nc = (d + kCh - 1) / kCh;
  const int nk = (s + kTile - 1) / kTile;
  const int total = nk * nc;
  const int r = warp * 16 + (lane >> 2);  // rows r, r + 8 of the block

  auto issue = [&](int t) {
    bf16* st = ring + (t & 1) * 2 * kChunkElems;
    const int c0 = (t % nc) * kCh;
    stage<kCh, kPitch>(st, qh, q0, c0, s, d);
    stage<kCh, kPitch>(st + kChunkElems, kh, (t / nc) * kTile, c0, s, d);
  };

  float o[kFwdSlice / 2];
#pragma unroll
  for (int i = 0; i < kFwdSlice / 2; ++i) o[i] = 0.f;
  float sc[32];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  issue(0);
  commit();
  for (int j = 0; j < nk; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int t = j * nc + c;
      wait_all();
      __syncthreads();  // chunk t landed; P V of tile j - 1 is done
      if (c == 0) stage<kFwdSlice, kVPitch>(vs, vh, j * kTile, c_out, s, d);
      if (t + 1 < total) issue(t + 1);
      commit();
      const bf16* st = ring + (t & 1) * 2 * kChunkElems;
      chunk_product(sc, st, st + kChunkElems, warp, lane);
    }
    // The online softmax of key tile j (keys past S get -inf; the tile's
    // first key is real, so m stays finite).
    const int key0 = j * kTile;
    if (key0 + kTile > s) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (key0 + (i >> 2) * 8 + 2 * wq + (i & 1) >= s) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = exp2f(fmaf(sc[i], scale_log2, -m[h]));
      sc[i] = p;
      l[h] += p;
    }
    mask.apply(sc, row, q0 + r, key0);
#pragma unroll
    for (int i = 0; i < kFwdSlice / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    wait_all();
    __syncthreads();  // tile j's V slice landed
    weights_product<kFwdSlice, kVPitch>(o, sc, vs, lane);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = mask.inv_keep / l[h];
    const int i = q0 + r + 8 * h;
    if (kLse && blockIdx.y == 0 && wq == 0 && i < s) {
      lse[row * s + i] = (m[h] + log2f(l[h])) * flash::kLn2;
    }
  }
  store_rows<kFwdSlice>(out + base, o, q0 + r, c_out, s, d, inv[0], inv[1]);
}

// --- backward ---------------------------------------------------------------

// The chunk of d that step n of a tile's walk stages: the walk starts after
// the block's slice and ends on it.
__device__ __forceinline__ int walk_chunk(int n, int slice, int nc) {
  return (slice + 1 + n) % nc;
}

// dkv: a block owns 64 keys of a row (blockIdx.x) and kBwdSlice columns of
// dk and dv (blockIdx.y). Per query tile of 64: S^T = K Q^T and dP^T = V g^T
// over d, chunk by chunk (K, V, Q and g chunks in each stage), mask.dkv,
// then dv += P^T g and dk += dS^T Q over the slice, whose Q and g columns
// the last chunk of the walk left staged.
template <class Mask>
__device__ __forceinline__ void dkv_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int d,
    int tiles_per_row, float scale, float scale_log2, const Mask& mask) {
  extern __shared__ uint8_t smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage b: K, V, Q, g
  __shared__ float lse_s[2][kTile];  // log2 units; +inf past S
  __shared__ float delta_s[2][kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int key0 = (blockIdx.x % tiles_per_row) * kRows;
  const int slice = blockIdx.y;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const int64_t vec = row * static_cast<int64_t>(s);
  const int nc = (d + kCh - 1) / kCh;
  const int nq = (s + kTile - 1) / kTile;
  const int total = nq * nc;

  auto issue = [&](int t) {
    bf16* st = ring + (t & 1) * 4 * kChunkElems;
    const int i = t / nc;
    const int c0 = walk_chunk(t % nc, slice, nc) * kCh;
    stage<kCh, kPitch>(st, k + base, key0, c0, s, d);
    stage<kCh, kPitch>(st + kChunkElems, v + base, key0, c0, s, d);
    stage<kCh, kPitch>(st + 2 * kChunkElems, q + base, i * kTile, c0, s, d);
    stage<kCh, kPitch>(st + 3 * kChunkElems, g + base, i * kTile, c0, s, d);
    if (t % nc == 0) {  // the tile's lse and delta, read after a barrier
      for (int c = tid; c < kTile; c += kThreads) {
        const int qi = i * kTile + c;
        lse_s[i & 1][c] = qi < s ? lse[vec + qi] * flash::kLog2e : INFINITY;
        delta_s[i & 1][c] = qi < s ? delta[vec + qi] : 0.f;
      }
    }
  };

  float dk_acc[kBwdSlice / 2], dv_acc[kBwdSlice / 2];
#pragma unroll
  for (int i = 0; i < kBwdSlice / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st_acc[32], dp_acc[32];

  issue(0);
  commit();
  for (int i = 0; i < nq; ++i) {
#pragma unroll
    for (int e = 0; e < 32; ++e) st_acc[e] = dp_acc[e] = 0.f;
    const bf16* last = nullptr;
    for (int c = 0; c < nc; ++c) {
      const int t = i * nc + c;
      wait_all();
      __syncthreads();  // chunk t landed; the products of tile i - 1 are done
      if (t + 1 < total) issue(t + 1);
      commit();
      const bf16* st = ring + (t & 1) * 4 * kChunkElems;
      chunk_product(st_acc, st, st + 2 * kChunkElems, warp, lane);
      chunk_product(dp_acc, st + kChunkElems, st + 3 * kChunkElems, warp,
                    lane);
      last = st;
    }
    mask.dkv(st_acc, dp_acc, lse_s[i & 1], delta_s[i & 1], scale, scale_log2,
             row, key0 + warp * 16, i * kTile);
    weights_product<kBwdSlice, kPitch>(dv_acc, st_acc,
                                       last + 3 * kChunkElems, lane);
    weights_product<kBwdSlice, kPitch>(dk_acc, dp_acc,
                                       last + 2 * kChunkElems, lane);
  }

  const int r0 = key0 + warp * 16 + (lane >> 2);
  store_rows<kBwdSlice>(dk + base, dk_acc, r0, slice * kBwdSlice, s, d);
  store_rows<kBwdSlice>(dv + base, dv_acc, r0, slice * kBwdSlice, s, d);
}

// dq: a block owns 64 queries of a row (blockIdx.x) and kBwdSlice columns
// of dq (blockIdx.y). Per key tile of 64: S = Q K^T and dP = g V^T over d,
// chunk by chunk (Q, g, K and V chunks in each stage), mask.dq, then
// dq += dS K over the slice, whose K columns the walk's last chunk left
// staged.
template <class Mask>
__device__ __forceinline__ void dq_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int s, int d, int tiles_per_row, float scale,
    float scale_log2, const Mask& mask) {
  extern __shared__ uint8_t smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage b: Q, g, K, V

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kRows;
  const int slice = blockIdx.y;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const int64_t vec = row * static_cast<int64_t>(s);
  const int nc = (d + kCh - 1) / kCh;
  const int nk = (s + kTile - 1) / kTile;
  const int total = nk * nc;
  const int r0 = q0 + warp * 16 + (lane >> 2);

  float lse2[2], dl[2];  // rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    lse2[h] = i < s ? lse[vec + i] * flash::kLog2e : INFINITY;
    dl[h] = i < s ? delta[vec + i] : 0.f;
  }

  auto issue = [&](int t) {
    bf16* st = ring + (t & 1) * 4 * kChunkElems;
    const int j = t / nc;
    const int c0 = walk_chunk(t % nc, slice, nc) * kCh;
    stage<kCh, kPitch>(st, q + base, q0, c0, s, d);
    stage<kCh, kPitch>(st + kChunkElems, g + base, q0, c0, s, d);
    stage<kCh, kPitch>(st + 2 * kChunkElems, k + base, j * kTile, c0, s, d);
    stage<kCh, kPitch>(st + 3 * kChunkElems, v + base, j * kTile, c0, s, d);
  };

  float dq_acc[kBwdSlice / 2];
#pragma unroll
  for (int i = 0; i < kBwdSlice / 2; ++i) dq_acc[i] = 0.f;
  float s_acc[32], dp_acc[32];

  issue(0);
  commit();
  for (int j = 0; j < nk; ++j) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s_acc[e] = dp_acc[e] = 0.f;
    const bf16* last = nullptr;
    for (int c = 0; c < nc; ++c) {
      const int t = j * nc + c;
      wait_all();
      __syncthreads();  // chunk t landed; the product of tile j - 1 is done
      if (t + 1 < total) issue(t + 1);
      commit();
      const bf16* st = ring + (t & 1) * 4 * kChunkElems;
      chunk_product(s_acc, st, st + 2 * kChunkElems, warp, lane);
      chunk_product(dp_acc, st + kChunkElems, st + 3 * kChunkElems, warp,
                    lane);
      last = st;
    }
    mask.dq(s_acc, dp_acc, lse2, dl, scale, scale_log2, s, row, r0,
            j * kTile);
    weights_product<kBwdSlice, kPitch>(dq_acc, dp_acc,
                                       last + 2 * kChunkElems, lane);
  }
  store_rows<kBwdSlice>(dq + base, dq_acc, r0, slice * kBwdSlice, s, d);
}

// The grid of the bf16 kernels: (rows x 64-row tiles, slices of `width`).
inline cudaError_t grid_of(dim3* grid, int* tiles, int64_t rows, int s,
                           int d, int width) {
  *tiles = (s + kRows - 1) / kRows;
  const int64_t blocks = rows * *tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(blocks), slices(d, width));
  return cudaSuccess;
}

}  // namespace flash_wide

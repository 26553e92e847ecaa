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
//   1. delta: a thread per query row;
//   2. dkv: a block owns a tile of keys and loops over the query tiles;
//   3. dq: a block owns a tile of queries and loops over the key tiles.
// The TPU kernels carry the dk/dv (and dq) sums in scratch memory across a
// sequential grid. Blocks on this card run in parallel in no order, so the
// sum over the other axis is a loop inside the block, and each of dq, dk,
// dv is written by exactly one thread: no atomics, and the result is the
// same from run to run. The price is that the logits and dp are computed
// twice (7 matrix products instead of 5).
//
// What bounds it on this card: operations. The function needs
// 10*B*h*S^2*d flops (2.4 TFLOP at B*h=384, S=3137, d=64: 2.4 ms at the
// 989 TFLOP/s bf16 peak) against 1.4 GB of q, k, v, out, g, dq, dk, dv
// (0.4 ms at 3.35 TB/s). So the bf16 kernels run every product on the
// tensor cores (mma.sync.m16n8k16, f32 accumulation): a warp owns 16 rows
// of its block's tile and keeps their K and V (dkv) or Q and G (dq)
// fragments in registers; the other side's tiles of 64 rows are staged in
// shared memory for all 4 warps; a 16 x 16 block of logits and of dp is
// produced at a time, turned into p and ds on the accumulator registers,
// rounded to bf16 and fed straight back as the A operand of the products
// that accumulate dv, dk or dq. In dkv the logits are computed transposed
// (K Q^T), so that p^T and ds^T come out in the layout the tensor cores
// take as A. No wgmma, no TMA, no pipelining: later work.
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

namespace {

using flash::kPad;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps of 16 rows, or 128 scalar rows
constexpr int kTile = 64;      // rows of the owned and of the staged tile

using flash::load_row;
using flash::store_row;
using flash::store_rows;
using flash::zero;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int s, int tiles_per_row,
                      float scale, float scale_log2) {
  constexpr int LD = D + kPad;
  __shared__ __align__(16) bf16 qs[kTile * LD];
  __shared__ __align__(16) bf16 gs[kTile * LD];
  __shared__ float lse_s[kTile];    // in log2 units; +inf past S
  __shared__ float delta_s[kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int key0 = (blockIdx.x % tiles_per_row) * kTile;
  const int64_t base = row * static_cast<int64_t>(s) * D;
  const int64_t vec = row * static_cast<int64_t>(s);

  // This block's K and V tile goes through shared memory into registers.
  flash::load_tile<kTile, D, kThreads>(qs, k + base, key0, s, tid);
  flash::load_tile<kTile, D, kThreads>(gs, v + base, key0, s, tid);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    flash::load_a<LD>(kf[kk], qs, warp * 16, kk * 16, lane);
    flash::load_a<LD>(vf[kk], gs, warp * 16, kk * 16, lane);
  }
  __syncthreads();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int q0 = 0; q0 < s; q0 += kTile) {
    flash::load_tile<kTile, D, kThreads>(qs, q + base, q0, s, tid);
    flash::load_tile<kTile, D, kThreads>(gs, g + base, q0, s, tid);
    if (tid < kTile) {
      const bool real = q0 + tid < s;
      // A query past S gets p = exp2(-inf) = 0 and so ds = 0.
      lse_s[tid] = real ? lse[vec + q0 + tid] * flash::kLog2e : INFINITY;
      delta_s[tid] = real ? delta[vec + q0 + tid] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int qc = 0; qc < kTile / 16; ++qc) {
      // 16 keys x 16 queries of logits^T and dp^T.
      float st[2][4], dp[2][4];
      zero(st);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        flash::load_b<LD>(b, qs, qc * 16, kk * 16, lane);
        flash::mma_bf16(st[0], kf[kk], b[0], b[1]);
        flash::mma_bf16(st[1], kf[kk], b[2], b[3]);
        flash::load_b<LD>(b, gs, qc * 16, kk * 16, lane);
        flash::mma_bf16(dp[0], vf[kk], b[0], b[1]);
        flash::mma_bf16(dp[1], vf[kk], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = qc * 16 + nt * 8 + 2 * t + (r & 1);  // the query
          const float p = exp2f(st[nt][r] * scale_log2 - lse_s[col]);
          st[nt][r] = p;
          dp[nt][r] = p * (dp[nt][r] - delta_s[col]) * scale;
        }
      }
      const uint32_t pa[4] = {flash::pack_bf16(st[0][0], st[0][1]),
                              flash::pack_bf16(st[0][2], st[0][3]),
                              flash::pack_bf16(st[1][0], st[1][1]),
                              flash::pack_bf16(st[1][2], st[1][3])};
      const uint32_t dsa[4] = {flash::pack_bf16(dp[0][0], dp[0][1]),
                               flash::pack_bf16(dp[0][2], dp[0][3]),
                               flash::pack_bf16(dp[1][0], dp[1][1]),
                               flash::pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        flash::load_b_trans<LD>(b, gs, qc * 16, np * 16, lane);
        flash::mma_bf16(dv_acc[2 * np], pa, b[0], b[1]);
        flash::mma_bf16(dv_acc[2 * np + 1], pa, b[2], b[3]);
        flash::load_b_trans<LD>(b, qs, qc * 16, np * 16, lane);
        flash::mma_bf16(dk_acc[2 * np], dsa, b[0], b[1]);
        flash::mma_bf16(dk_acc[2 * np + 1], dsa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  store_rows<D>(dk + base, dk_acc, key0 + warp * 16, s, lane);
  store_rows<D>(dv + base, dv_acc, key0 + warp * 16, s, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int s, int tiles_per_row, float scale,
                     float scale_log2) {
  constexpr int LD = D + kPad;
  __shared__ __align__(16) bf16 ks[kTile * LD];
  __shared__ __align__(16) bf16 vs[kTile * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kTile;
  const int64_t base = row * static_cast<int64_t>(s) * D;
  const int64_t vec = row * static_cast<int64_t>(s);

  flash::load_tile<kTile, D, kThreads>(ks, q + base, q0, s, tid);
  flash::load_tile<kTile, D, kThreads>(vs, g + base, q0, s, tid);
  __syncthreads();
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    flash::load_a<LD>(qf[kk], ks, warp * 16, kk * 16, lane);
    flash::load_a<LD>(gf[kk], vs, warp * 16, kk * 16, lane);
  }
  __syncthreads();

  float lse2[2], dl[2];  // rows gq and gq + 8 of the warp's 16 queries
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = q0 + warp * 16 + gq + 8 * h;
    lse2[h] = i < s ? lse[vec + i] * flash::kLog2e : INFINITY;
    dl[h] = i < s ? delta[vec + i] : 0.f;
  }

  float dq_acc[D / 8][4];
  zero(dq_acc);

  for (int key0 = 0; key0 < s; key0 += kTile) {
    flash::load_tile<kTile, D, kThreads>(ks, k + base, key0, s, tid);
    flash::load_tile<kTile, D, kThreads>(vs, v + base, key0, s, tid);
    __syncthreads();

#pragma unroll 1
    for (int kc = 0; kc < kTile / 16; ++kc) {
      // 16 queries x 16 keys of logits and dp.
      float st[2][4], dp[2][4];
      zero(st);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        flash::load_b<LD>(b, ks, kc * 16, kk * 16, lane);
        flash::mma_bf16(st[0], qf[kk], b[0], b[1]);
        flash::mma_bf16(st[1], qf[kk], b[2], b[3]);
        flash::load_b<LD>(b, vs, kc * 16, kk * 16, lane);
        flash::mma_bf16(dp[0], gf[kk], b[0], b[1]);
        flash::mma_bf16(dp[1], gf[kk], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = key0 + kc * 16 + nt * 8 + 2 * t + (r & 1);
          const int h = r >> 1;
          const float p =
              key < s ? exp2f(st[nt][r] * scale_log2 - lse2[h]) : 0.f;
          dp[nt][r] = p * (dp[nt][r] - dl[h]) * scale;
        }
      }
      const uint32_t dsa[4] = {flash::pack_bf16(dp[0][0], dp[0][1]),
                               flash::pack_bf16(dp[0][2], dp[0][3]),
                               flash::pack_bf16(dp[1][0], dp[1][1]),
                               flash::pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        flash::load_b_trans<LD>(b, ks, kc * 16, np * 16, lane);
        flash::mma_bf16(dq_acc[2 * np], dsa, b[0], b[1]);
        flash::mma_bf16(dq_acc[2 * np + 1], dsa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  store_rows<D>(dq + base, dq_acc, q0 + warp * 16, s, lane);
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
cudaError_t launch_d(const Args& a, bool is_bf16) {
  const int bm = is_bf16 ? kTile : kThreads;  // rows a block owns
  const int tiles = (a.s + bm - 1) / bm;
  const int64_t blocks = a.rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t err;
  if (is_bf16) {
    err = flash::launch_delta<bf16, D, flash::for_flash_bwd>(
        a.out, a.g, a.delta, a.rows * a.s, a.stream);
    if (err != cudaSuccess) return err;
    const bf16* q = static_cast<const bf16*>(a.q);
    const bf16* k = static_cast<const bf16*>(a.k);
    const bf16* v = static_cast<const bf16*>(a.v);
    const bf16* g = static_cast<const bf16*>(a.g);
    const float scale_log2 = a.scale * flash::kLog2e;
    flash_bwd_dkv_mma<D><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, g, lse, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.s, tiles, a.scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_mma<D><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, g, lse, delta, static_cast<bf16*>(a.dq), a.s, tiles, a.scale,
        scale_log2);
  } else {
    err = flash::launch_delta<float, D, flash::for_flash_bwd>(
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
  }
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

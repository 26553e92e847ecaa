// The f32 kernels of dense attention, at every head dim that is a multiple
// of 8: the forward of flash_attention_fwd.cu and fused_mha_fwd.cu, the dkv
// and dq kernels of flash_attention_bwd.cu and fused_mha_bwd.cu. The fused
// op passes its Philox dropout (Drop); the dense op passes it off.
//
// Replaces, for f32 tensors, what the bf16 blocks replace:
// focused_attention_vit_tpu/ops/flash_attention_pallas.py::flash_attention_tpu
// (:28, JAX's bundled flash kernel, forward and backward) and
// focused_attention_vit_tpu/ops/mha_kernel.py::_fwd_kernel (:59) and
// ::_bwd_kernel (:83).
//
// Scalar FMA, a thread per row: full f32 products, which TF32 tensor cores
// would not give, so they agree with the plain versions to 1e-5. They are
// meant for parity runs and small shapes, not for speed. The result columns
// are split over the grid's y dimension in slices of kSlice; each block forms
// the logits (and in the backward dP) over the whole head dim, kCh columns at
// a time, so a block's registers do not grow with d. The backward walks the
// chunks of a tile so that the block's own slice comes last: its Q and g
// (dkv) or K and V (dq) columns are then still staged for the slice's sums.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "philox.cuh"

namespace flash_f32 {

constexpr int kThreads = 128;  // rows a block
constexpr int kCh = 32;        // columns of a staged chunk of d
constexpr int kSlice = kCh;    // result columns of a block
constexpr int kKeys = 32;      // keys of the forward's staged tile
constexpr int kTile = 16;      // rows of the backward's staged tiles

// The fused op's dropout (keep iff the Philox word of (seed, row, query,
// key) is at least the threshold; kept weights scaled by inv_keep); off for
// the dense op.
struct Drop {
  uint64_t seed;
  uint32_t threshold;
  float inv_keep;  // 1 / (1 - rate); 1 without dropout
  int on;

  __device__ __forceinline__ bool dropped(int64_t row, int i, int j) const {
    return on && philox::mha_word(seed, row, i, j) < threshold;
  }
  // The factor on weight (i, j) in the backward: 0 or inv_keep.
  __device__ __forceinline__ float keep(int64_t row, int i, int j) const {
    return dropped(row, i, j) ? 0.f : inv_keep;
  }
};

// Rows [r0, r0 + ROWS) and columns [c0, c0 + kCh) of a contiguous [s, d]
// f32 matrix into a [ROWS][kCh] tile, zeros past s and d (d a multiple
// of 4).
template <int ROWS>
__device__ __forceinline__ void load_f32(float* tile, const float* src,
                                         int r0, int c0, int s, int d) {
  constexpr int kVecs = kCh / 4;
  static_assert(ROWS * kVecs % kThreads == 0, "whole rounds of loads");
#pragma unroll
  for (int f0 = 0; f0 < ROWS * kVecs; f0 += kThreads) {
    const int f = f0 + threadIdx.x;
    const int r = f / kVecs;
    const int c = (f % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < s && c0 + c < d) {
      val = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * d + c0 + c);
    }
    *reinterpret_cast<float4*>(tile + r * kCh + c) = val;
  }
}

// kCh columns of one row from c0 (zeros past d, or when !real).
__device__ __forceinline__ void load_cols(float (&x)[kCh], const float* row,
                                          int c0, int d, bool real) {
#pragma unroll
  for (int c = 0; c < kCh; c += 4) {
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (real && c0 + c < d) {
      val = *reinterpret_cast<const float4*>(row + c0 + c);
    }
    x[c] = val.x, x[c + 1] = val.y, x[c + 2] = val.z, x[c + 3] = val.w;
  }
}

__device__ __forceinline__ void store_cols(float* row, const float (&x)[kCh],
                                           int c0, int d, float scale = 1.f) {
#pragma unroll
  for (int c = 0; c < kCh; c += 4) {
    if (c0 + c >= d) break;
    *reinterpret_cast<float4*>(row + c0 + c) =
        make_float4(x[c] * scale, x[c + 1] * scale, x[c + 2] * scale,
                    x[c + 3] * scale);
  }
}

// The forward: a thread per query (blockIdx.x: 128 queries of a row),
// kSlice output columns (blockIdx.y); per tile of 32 keys, the logits
// over d chunk by chunk, the online softmax (natural units), the mask on
// the numerator after the sum, then the slice of O.
template <bool kLse>
__global__ void __launch_bounds__(kThreads)
    attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int s, int d, int tiles_per_row,
             float scale, Drop drop) {
  __shared__ __align__(16) float ks[kKeys * kCh];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int i = (blockIdx.x % tiles_per_row) * kThreads + tid;
  const bool valid = i < s;
  const int c_out = blockIdx.y * kSlice;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const float* qrow = q + base + static_cast<int64_t>(valid ? i : 0) * d;

  float acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int key0 = 0; key0 < s; key0 += kKeys) {
    float p[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) p[j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kCh) {
      __syncthreads();
      load_f32<kKeys>(ks, k + base, key0, c0, s, d);
      __syncthreads();
      float qc[kCh];
      load_cols(qc, qrow, c0, d, valid);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kCh; ++c) dot += qc[c] * ks[j * kCh + c];
        p[j] += dot;
      }
    }
    const int nk = min(kKeys, s - key0);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      p[j] = j < nk ? p[j] * scale : -INFINITY;
      mx = fmaxf(mx, p[j]);
    }
    const float m_new = fmaxf(m, mx);  // key0 is real: finite
    const float alpha = expf(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      p[j] = expf(p[j] - m_new);
      psum += p[j];  // dropout acts on the normalised weights
      if (drop.on && j < nk && drop.dropped(row, i, key0 + j)) p[j] = 0.f;
    }
    l = l * alpha + psum;
    __syncthreads();
    load_f32<kKeys>(ks, v + base, key0, c_out, s, d);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) a += p[j] * ks[j * kCh + c];
      acc[c] = a;
    }
  }
  if (!valid) return;
  store_cols(out + base + static_cast<int64_t>(i) * d, acc, c_out, d,
             drop.inv_keep / l);
  if (kLse && blockIdx.y == 0) lse[row * s + i] = m + logf(l);
}

// dkv: a thread per key (blockIdx.x: 128 keys of a row), kSlice columns
// of dk and dv (blockIdx.y); per tile of 16 queries, q . k and g . v over d
// chunk by chunk (the walk ending on the slice, whose Q and g columns stay
// staged), then the slice's sums.
__global__ void __launch_bounds__(kThreads)
    attn_dkv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int s, int d,
             int tiles_per_row, float scale, Drop drop) {
  __shared__ __align__(16) float qs[kTile * kCh];
  __shared__ __align__(16) float gs[kTile * kCh];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int j = (blockIdx.x % tiles_per_row) * kThreads + tid;  // the key
  const bool real = j < s;
  const int slice = blockIdx.y;
  const int nc = (d + kCh - 1) / kCh;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const int64_t vec = row * static_cast<int64_t>(s);
  const float* krow = k + base + static_cast<int64_t>(real ? j : 0) * d;
  const float* vrow = v + base + static_cast<int64_t>(real ? j : 0) * d;

  float dk_acc[kCh], dv_acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int q0 = 0; q0 < s; q0 += kTile) {
    float dot[kTile], dz[kTile];
#pragma unroll
    for (int e = 0; e < kTile; ++e) dot[e] = dz[e] = 0.f;
    for (int n = 0; n < nc; ++n) {
      const int c0 = ((slice + 1 + n) % nc) * kCh;
      __syncthreads();
      load_f32<kTile>(qs, q + base, q0, c0, s, d);
      load_f32<kTile>(gs, g + base, q0, c0, s, d);
      __syncthreads();
      float kc[kCh], vc[kCh];
      load_cols(kc, krow, c0, d, real);
      load_cols(vc, vrow, c0, d, real);
#pragma unroll
      for (int e = 0; e < kTile; ++e) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          a += qs[e * kCh + c] * kc[c];
          b += gs[e * kCh + c] * vc[c];
        }
        dot[e] += a;
        dz[e] += b;
      }
    }
    const int nq = min(kTile, s - q0);
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      if (e >= nq) break;
      const int qi = q0 + e;
      const float mask = real ? drop.keep(row, qi, j) : 0.f;
      const float p = expf(dot[e] * scale - lse[vec + qi]);
      const float z = p * mask;
      const float ds = p * (dz[e] * mask - delta[vec + qi]) * scale;
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        dv_acc[c] += z * gs[e * kCh + c];
        dk_acc[c] += ds * qs[e * kCh + c];
      }
    }
  }
  if (!real) return;
  store_cols(dk + base + static_cast<int64_t>(j) * d, dk_acc,
             slice * kSlice, d);
  store_cols(dv + base + static_cast<int64_t>(j) * d, dv_acc,
             slice * kSlice, d);
}

// dq: a thread per query, kSlice columns of dq (blockIdx.y); per tile of
// 16 keys, q . k and g . v over d (the walk ending on the slice, whose K
// columns stay staged), then the slice's sum.
__global__ void __launch_bounds__(kThreads)
    attn_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ g,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int s, int d, int tiles_per_row,
            float scale, Drop drop) {
  __shared__ __align__(16) float ks[kTile * kCh];
  __shared__ __align__(16) float vs[kTile * kCh];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int i = (blockIdx.x % tiles_per_row) * kThreads + tid;  // query
  const bool real = i < s;
  const int slice = blockIdx.y;
  const int nc = (d + kCh - 1) / kCh;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const int64_t vec = row * static_cast<int64_t>(s);
  const float* qrow = q + base + static_cast<int64_t>(real ? i : 0) * d;
  const float* grow = g + base + static_cast<int64_t>(real ? i : 0) * d;
  const float lse_i = real ? lse[vec + i] : 0.f;
  const float delta_i = real ? delta[vec + i] : 0.f;

  float dq_acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) dq_acc[c] = 0.f;

  for (int key0 = 0; key0 < s; key0 += kTile) {
    float dot[kTile], dz[kTile];
#pragma unroll
    for (int e = 0; e < kTile; ++e) dot[e] = dz[e] = 0.f;
    for (int n = 0; n < nc; ++n) {
      const int c0 = ((slice + 1 + n) % nc) * kCh;
      __syncthreads();
      load_f32<kTile>(ks, k + base, key0, c0, s, d);
      load_f32<kTile>(vs, v + base, key0, c0, s, d);
      __syncthreads();
      float qc[kCh], gc[kCh];
      load_cols(qc, qrow, c0, d, real);
      load_cols(gc, grow, c0, d, real);
#pragma unroll
      for (int e = 0; e < kTile; ++e) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          a += qc[c] * ks[e * kCh + c];
          b += gc[c] * vs[e * kCh + c];
        }
        dot[e] += a;
        dz[e] += b;
      }
    }
    const int nk = min(kTile, s - key0);
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      if (e >= nk) break;
      const float mask = real ? drop.keep(row, i, key0 + e) : 0.f;
      const float p = expf(dot[e] * scale - lse_i);
      const float ds = p * (dz[e] * mask - delta_i) * scale;
#pragma unroll
      for (int c = 0; c < kCh; ++c) dq_acc[c] += ds * ks[e * kCh + c];
    }
  }
  if (!real) return;
  store_cols(dq + base + static_cast<int64_t>(i) * d, dq_acc,
             slice * kSlice, d);
}

// --- launches ---------------------------------------------------------------

// The forward; lse (f32 [rows, s]) is written when not null.
inline cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, int64_t rows, int s,
                              int d, float scale, Drop drop,
                              cudaStream_t stream) {
  const int tiles = (s + kThreads - 1) / kThreads;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), (d + kSlice - 1) / kSlice);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  if (lse != nullptr) {
    attn_fwd<true><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, lse, s,
                                                  d, tiles, scale, drop);
  } else {
    attn_fwd<false><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, lse, s,
                                                   d, tiles, scale, drop);
  }
  return cudaGetLastError();
}

// The backward: the delta kernel (flash_common.cuh; `Caller` names it for a
// profile), then dkv and dq.
template <typename Caller>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* g, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, int64_t rows,
                       int s, int d, float scale, Drop drop,
                       cudaStream_t stream) {
  const int tiles = (s + kThreads - 1) / kThreads;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t err = flash::launch_delta<float, Caller>(out, g, delta,
                                                       rows * s, d, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), (d + kSlice - 1) / kSlice);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(g);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  attn_dkv<<<grid, kThreads, 0, stream>>>(qp, kp, vp, gp, lp, dp,
                                          static_cast<float*>(dk),
                                          static_cast<float*>(dv), s, d,
                                          tiles, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dq<<<grid, kThreads, 0, stream>>>(qp, kp, vp, gp, lp, dp,
                                         static_cast<float*>(dq), s, d, tiles,
                                         scale, drop);
  return cudaGetLastError();
}

}  // namespace flash_f32

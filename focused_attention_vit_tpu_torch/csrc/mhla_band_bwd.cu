// MHLA window band, backward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/mhla_band_roll.py::_bwd_kernel
// (:199, the Pallas lane-roll backward, reached through _roll_bwd :481),
// with the halo fold of _fold_ext (:330) as its spec. Wrapper and plain
// PyTorch version: focused_attention_vit_tpu_torch/ops/mhla_band_roll.py.
//
// What it computes, for each (b*h) row, from q, k, v, the output cotangent g
// (all [B*h, d, S] of one dtype), the forward's pre-dropout softmax weights
// w (f32 [B*h, W, S], written by mhla_band_fwd.cu) and, with dropout, the
// forward's mask regenerated from the seed (philox.cuh):
//   per query i and slot o (key j_o, the forward's edge rule):
//     u_o   = g_i . v_{j_o}
//     dw_o  = keep_o ? u_o / (1-rate) : 0     (u_o without dropout)
//     wd_o  = keep_o ? w_o / (1-rate) : 0     (w_o without dropout)
//     dlog_o = w_o * (dw_o - sum_p w_p dw_p)  (softmax backward)
//     dq_i  = sum_o dlog_o * k_{j_o} * scale
//   and for each key j, summed over every (query i, slot o) that read it:
//     dk_j  = sum dlog_o * scale * q_i,   dv_j = sum wd_o * g_i.
// All sums are in f32; dq, dk and dv are rounded once to the input dtype.
//
// The TPU kernel adds each query tile's dk/dv into a VMEM scratch that
// persists across the tiles of a row (a sequential grid), then folds the
// halo on the last tile. On this card blocks run in parallel and in no
// order, so the sum is turned around and made key-centred, in two passes
// with no atomics (float atomics would make the sum order, and so the
// result, change from run to run):
//   pass 1, one thread per query: u, the softmax backward and dq; it writes
//     the per-slot coefficients dlog_o * scale and wd_o (f32 [2, B*h, W, S]
//     scratch, allocated by the wrapper);
//   pass 2, one thread per key j: an interior key is read by exactly one
//     slot of each of the W queries i = j + W/2 - o, so dk/dv gather those W
//     terms. Only rows S-1 and 0 also collect the slots that wrapped past
//     the edges (queries i < W/2 for S-1, i >= S - (W-1-W/2) for 0): the
//     fold of _fold_ext, done by the two edge threads of the row.
//
// What bounds it on this card: bytes, as in the forward (about 8*W*d flops
// per query against ~7 d-vectors and 4W f32 words moved). Each of q, k, v,
// g, dq, dk and dv passes through device memory once; the W-fold shifted
// re-reads hit in L1/L2, and the coefficient scratch is 4W f32 words a
// query, written once and read once. Loops are channel-outer, slot-inner,
// so registers hold W coefficients and W indices, never a d-vector. Like
// the forward, this first design makes one scalar load per element and
// slot; shared-memory staging is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kMaxWindow = 16;  // the wrapper raises above this
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Dropout {
  uint64_t seed;
  uint32_t threshold;
  float one_minus_rate;
};

// Pass 1: one thread per query.
template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    band_bwd_query_kernel(const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ g,
                          const float* __restrict__ wts, T* __restrict__ dq,
                          float* __restrict__ coef_k,
                          float* __restrict__ coef_v, int s, int w,
                          int tiles_per_row, float scale, Dropout drop) {
  const int64_t row = blockIdx.x / tiles_per_row;
  const int i = (blockIdx.x % tiles_per_row) * kThreads + threadIdx.x;
  if (i >= s) return;
  const int64_t base = row * D * static_cast<int64_t>(s);
  const int64_t wbase = row * w * static_cast<int64_t>(s);
  const T* kr = k + base;
  const T* vr = v + base;
  const T* gr = g + base;

  const int hw = w / 2;
  int key[kMaxWindow];
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    const int j = i - hw + o;
    key[o] = j < 0 ? s - 1 : (j >= s ? 0 : j);
  }

  float u[kMaxWindow];
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) u[o] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const int64_t off = static_cast<int64_t>(c) * s;
    const float gc = to_f32(gr[off + i]);
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) u[o] += gc * to_f32(vr[off + key[o]]);
    }
  }

  float wt[kMaxWindow];
  float wd[kMaxWindow];  // the weights the forward used (after dropout)
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    wt[o] = o < w ? wts[wbase + static_cast<int64_t>(o) * s + i] : 0.f;
    wd[o] = wt[o];
  }
  if constexpr (kDrop) {
    const uint32_t keep =
        philox::band_keep_mask(drop.seed, row, i, w, drop.threshold);
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) {
        const bool kept = (keep >> o) & 1u;
        u[o] = kept ? u[o] / drop.one_minus_rate : 0.f;
        wd[o] = kept ? wt[o] / drop.one_minus_rate : 0.f;
      }
    }
  }
  float dot = 0.f;
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    if (o < w) dot += wt[o] * u[o];
  }
  float dlog[kMaxWindow];
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    dlog[o] = o < w ? wt[o] * (u[o] - dot) : 0.f;
    if (o < w) {
      coef_k[wbase + static_cast<int64_t>(o) * s + i] = dlog[o] * scale;
      coef_v[wbase + static_cast<int64_t>(o) * s + i] = wd[o];
    }
  }

  T* dqr = dq + base;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const int64_t off = static_cast<int64_t>(c) * s;
    float acc = 0.f;
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) acc += dlog[o] * to_f32(kr[off + key[o]]);
    }
    dqr[off + i] = from_f32<T>(acc * scale);
  }
}

// Pass 2: one thread per key.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    band_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ g,
                        const float* __restrict__ coef_k,
                        const float* __restrict__ coef_v, T* __restrict__ dk,
                        T* __restrict__ dv, int s, int w, int tiles_per_row) {
  const int64_t row = blockIdx.x / tiles_per_row;
  const int j = (blockIdx.x % tiles_per_row) * kThreads + threadIdx.x;
  if (j >= s) return;
  const int64_t base = row * D * static_cast<int64_t>(s);
  const int64_t wbase = row * w * static_cast<int64_t>(s);
  const T* qr = q + base;
  const T* gr = g + base;
  const float* ckr = coef_k + wbase;
  const float* cvr = coef_v + wbase;

  // Slot o of query i = j + hw - o reads key j without wrapping, for every
  // such i inside the row.
  const int hw = w / 2;
  int qi[kMaxWindow];
  float ck[kMaxWindow];
  float cv[kMaxWindow];
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    const int i = j + hw - o;
    const bool valid = o < w && i >= 0 && i < s;
    qi[o] = valid ? i : j;
    ck[o] = valid ? ckr[static_cast<int64_t>(o) * s + i] : 0.f;
    cv[o] = valid ? cvr[static_cast<int64_t>(o) * s + i] : 0.f;
  }
  // The edge fold: the wrapped slots of the first hw queries read row S-1,
  // those of the last w-1-hw queries read row 0.
  int edge_lo = 0, edge_hi = 0;  // queries [edge_lo, edge_hi) wrapped here
  if (j == s - 1) {
    edge_lo = 0;
    edge_hi = hw;
  } else if (j == 0) {
    edge_lo = s - (w - 1 - hw);
    edge_hi = s;
  }

#pragma unroll 2
  for (int c = 0; c < D; ++c) {
    const int64_t off = static_cast<int64_t>(c) * s;
    float acc_k = 0.f;
    float acc_v = 0.f;
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) {
        acc_k += ck[o] * to_f32(qr[off + qi[o]]);
        acc_v += cv[o] * to_f32(gr[off + qi[o]]);
      }
    }
    for (int i = edge_lo; i < edge_hi; ++i) {
      const float qv = to_f32(qr[off + i]);
      const float gv = to_f32(gr[off + i]);
      // Slots of query i that wrapped: below 0 (o < hw - i) for row S-1,
      // past S-1 (o >= s + hw - i) for row 0.
      const int o_lo = j == 0 ? s + hw - i : 0;
      const int o_hi = j == 0 ? w : hw - i;
      for (int o = o_lo; o < o_hi; ++o) {
        acc_k += ckr[static_cast<int64_t>(o) * s + i] * qv;
        acc_v += cvr[static_cast<int64_t>(o) * s + i] * gv;
      }
    }
    dk[base + off + j] = from_f32<T>(acc_k);
    dv[base + off + j] = from_f32<T>(acc_v);
  }
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* g,
                     const float* wts, T* dq, T* dk, T* dv, float* coef_k,
                     float* coef_v, int s, int w, dim3 grid, int tiles,
                     float scale, bool dropout, Dropout drop,
                     cudaStream_t stream) {
  if (dropout) {
    band_bwd_query_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
        k, v, g, wts, dq, coef_k, coef_v, s, w, tiles, scale, drop);
  } else {
    band_bwd_query_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
        k, v, g, wts, dq, coef_k, coef_v, s, w, tiles, scale, drop);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  band_bwd_key_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      q, g, coef_k, coef_v, dk, dv, s, w, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const float* wts, void* dq, void* dk,
                   void* dv, float* scratch, int64_t rows, int d, int s,
                   int w, float scale, bool dropout, Dropout drop,
                   cudaStream_t stream) {
  const int tiles = (s + kThreads - 1) / kThreads;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  float* coef_k = scratch;
  float* coef_v = scratch + rows * w * static_cast<int64_t>(s);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  switch (d) {
    case 16:
      return launch_d<T, 16>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                             coef_v, s, w, grid, tiles, scale, dropout, drop,
                             stream);
    case 32:
      return launch_d<T, 32>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                             coef_v, s, w, grid, tiles, scale, dropout, drop,
                             stream);
    case 64:
      return launch_d<T, 64>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                             coef_v, s, w, grid, tiles, scale, dropout, drop,
                             stream);
    case 128:
      return launch_d<T, 128>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                              coef_v, s, w, grid, tiles, scale, dropout, drop,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launches (0 on success). q, k, v, g, dq, dk and dv are device pointers to
// contiguous [rows, d, s] tensors of one dtype (is_bf16 = 1 for bf16, 0 for
// f32); wts is the forward's f32 [rows, w, s] weights; scratch is f32
// [2, rows, w, s], written and read here. With dropout != 0 the forward's
// mask is regenerated by philox.cuh's rule under (seed_lo, seed_hi,
// threshold). `stream` is the caller's cudaStream_t. Nothing is allocated
// and nothing synchronises.
extern "C" int mhla_band_bwd(const void* q, const void* k, const void* v,
                             const void* g, const void* wts, void* dq,
                             void* dk, void* dv, void* scratch,
                             long long rows, int d, int s, int w, int is_bf16,
                             float scale, int dropout, unsigned int seed_lo,
                             unsigned int seed_hi, unsigned int threshold,
                             float one_minus_rate, int device, void* stream) {
  if (rows <= 0 || w < 1 || w > kMaxWindow || s <= 2 * w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{(static_cast<uint64_t>(seed_hi) << 32) | seed_lo,
                     threshold, one_minus_rate};
  const float* wp = static_cast<const float*>(wts);
  float* sp = static_cast<float*>(scratch);
  err = is_bf16
            ? launch<__nv_bfloat16>(q, k, v, g, wp, dq, dk, dv, sp, rows, d,
                                    s, w, scale, dropout != 0, drop, st)
            : launch<float>(q, k, v, g, wp, dq, dk, dv, sp, rows, d, s, w,
                            scale, dropout != 0, drop, st);
  return static_cast<int>(err);
}

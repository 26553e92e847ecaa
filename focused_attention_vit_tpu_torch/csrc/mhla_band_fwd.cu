// MHLA window band, forward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/mhla_band_roll.py::_fwd_kernel
// (:158, the Pallas lane-roll kernel), on both of its paths:
//   - eval (primal) path: no saved softmax weights, dropout rate 0;
//   - custom-VJP forward: the pre-dropout softmax weights are written for
//     the backward (mhla_band_bwd.cu), and per-slot inverted dropout runs
//     with the mask drawn in the kernel (philox.cuh).
// Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/mhla_band_roll.py.
//
// What it computes, for each (b*h) row and each query i of S tokens:
//   slot o in [0, W) reads key j = i - W/2 + o, where j < 0 reads row S-1
//   and j >= S reads row 0 (the reference edge rule: a duplicated edge key
//   counts once per slot it fills; no mask, no deduplication);
//   logit_o = (q_i . k_j) * d^-1/2 in f32, softmax over the W slots in f32;
//   training: wts[o, i] = the softmax weight (f32), and with dropout the
//   weight of a dropped slot becomes 0 and a kept one w_o / (1 - rate);
//   out_i = sum_o w_o * v_j accumulated in f32 and rounded once to the
//   input dtype (f32 or bf16).
//
// Layout: q, k, v and out are contiguous S-minor [B*h, d, S], the layout the
// model's projections emit; wts is f32 [B*h, W, S]. One thread owns one
// query. For a channel c the 32 threads of a warp read q[c, i..i+31] and,
// for each slot, the keys k[c, i-W/2+o ..] -- neighbouring threads on
// neighbouring addresses, so every load is coalesced, and the W shifted
// reads of one warp overlap in L1.
//
// What bounds it on this card: bytes. Per query it reads d values each of
// q, k and v and writes d of out (plus W f32 weights in training), and does
// about 4*W*d flops -- far below the card's flop-to-byte ratio. So the design
// moves each of q, k, v and out through device memory once: key indices come
// straight from the edge rule, so no halo-extended copies of K and V are
// written before the kernel (the TPU version needed them because Mosaic
// cannot shift sublanes), and the W shifted re-reads of a key row hit in
// L1/L2 instead of device memory. The loops run channel-outer, slot-inner,
// so a thread keeps only W logits and W key indices in registers, never a
// d-vector of q or of the accumulator. The dropout mask is never stored:
// the backward regenerates it from the seed. The eval instantiation
// (kSave = kDrop = false) compiles neither the weights write nor the mask.
// This first design does not reach the byte bound: it makes one scalar
// load per element and slot, so bf16 runs no faster than f32 (about 1.35 ms
// for both at B=32, h=12, d=64, S=3137, W=7 on an H100 80GB HBM3 at 700 W,
// against ~0.18 ms for the bf16 bytes at 3.35 TB/s). Staging the K/V window
// in shared memory (TMA) and wider per-thread loads are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kMaxWindow = 16;  // the wrapper raises above this
constexpr int kThreads = 128;   // queries per block

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
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

struct Dropout {
  uint64_t seed;
  uint32_t threshold;    // keep iff bits >= threshold
  float one_minus_rate;  // kept weights are divided by this
};

// Slots are unrolled to kMaxWindow with an `o < w` guard so that the
// per-slot arrays stay in registers for any runtime W <= kMaxWindow.
template <typename T, int D, bool kSave, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    band_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ wts, int s, int w, int tiles_per_row,
                    float scale, Dropout drop) {
  const int64_t row = blockIdx.x / tiles_per_row;
  const int i = (blockIdx.x % tiles_per_row) * kThreads + threadIdx.x;
  if (i >= s) return;
  const int64_t base = row * D * static_cast<int64_t>(s);
  const T* qr = q + base;
  const T* kr = k + base;
  const T* vr = v + base;
  T* outr = out + base;

  const int hw = w / 2;
  int key[kMaxWindow];
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    const int j = i - hw + o;
    key[o] = j < 0 ? s - 1 : (j >= s ? 0 : j);
  }

  float logit[kMaxWindow];
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) logit[o] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const int64_t off = static_cast<int64_t>(c) * s;
    const float qc = to_f32(qr[off + i]);
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) logit[o] += qc * to_f32(kr[off + key[o]]);
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    if (o < w) {
      logit[o] *= scale;
      m = fmaxf(m, logit[o]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    if (o < w) {
      logit[o] = expf(logit[o] - m);
      sum += logit[o];
    }
  }
#pragma unroll
  for (int o = 0; o < kMaxWindow; ++o) {
    if (o < w) logit[o] = logit[o] / sum;  // now the softmax weights
  }

  if constexpr (kSave) {
    float* wr = wts + row * w * static_cast<int64_t>(s);
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) wr[static_cast<int64_t>(o) * s + i] = logit[o];
    }
  }
  if constexpr (kDrop) {
    const uint32_t keep =
        philox::band_keep_mask(drop.seed, row, i, w, drop.threshold);
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) {
        logit[o] = (keep >> o) & 1u ? logit[o] / drop.one_minus_rate : 0.f;
      }
    }
  }

#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const int64_t off = static_cast<int64_t>(c) * s;
    float acc = 0.f;
#pragma unroll
    for (int o = 0; o < kMaxWindow; ++o) {
      if (o < w) acc += logit[o] * to_f32(vr[off + key[o]]);
    }
    outr[off + i] = from_f32<T>(acc);
  }
}

template <typename T, bool kSave, bool kDrop>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* out, float* wts,
                     int d, int s, int w, dim3 grid, int tiles, float scale,
                     Dropout drop, cudaStream_t stream) {
  switch (d) {
    case 16:
      band_fwd_kernel<T, 16, kSave, kDrop><<<grid, kThreads, 0, stream>>>(
          q, k, v, out, wts, s, w, tiles, scale, drop);
      break;
    case 32:
      band_fwd_kernel<T, 32, kSave, kDrop><<<grid, kThreads, 0, stream>>>(
          q, k, v, out, wts, s, w, tiles, scale, drop);
      break;
    case 64:
      band_fwd_kernel<T, 64, kSave, kDrop><<<grid, kThreads, 0, stream>>>(
          q, k, v, out, wts, s, w, tiles, scale, drop);
      break;
    case 128:
      band_fwd_kernel<T, 128, kSave, kDrop><<<grid, kThreads, 0, stream>>>(
          q, k, v, out, wts, s, w, tiles, scale, drop);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* wts, int64_t rows, int d, int s, int w, float scale,
                   bool dropout, Dropout drop, cudaStream_t stream) {
  const int tiles = (s + kThreads - 1) / kThreads;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (wts == nullptr) {
    return dropout ? launch_d<T, false, true>(qp, kp, vp, op, wts, d, s, w,
                                              grid, tiles, scale, drop, stream)
                   : launch_d<T, false, false>(qp, kp, vp, op, wts, d, s, w,
                                               grid, tiles, scale, drop,
                                               stream);
  }
  return dropout ? launch_d<T, true, true>(qp, kp, vp, op, wts, d, s, w, grid,
                                           tiles, scale, drop, stream)
                 : launch_d<T, true, false>(qp, kp, vp, op, wts, d, s, w, grid,
                                            tiles, scale, drop, stream);
}

__global__ void keep_bits_kernel(uint32_t* __restrict__ out, int64_t rows,
                                 int s, int w, uint64_t seed) {
  const int64_t n = rows * s;
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= n) return;
  const int64_t row = idx / s;
  const int i = static_cast<int>(idx % s);
  for (int grp = 0; 4 * grp < w; ++grp) {
    const uint4 r = philox::band_words(seed, row, i, grp);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
    for (int b = 0; b < 4 && 4 * grp + b < w; ++b) {
      out[(row * w + 4 * grp + b) * static_cast<int64_t>(s) + i] = words[b];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous
// [rows, d, s] tensors of one dtype (is_bf16 = 1 for bf16, 0 for f32);
// `wts` is a contiguous f32 [rows, w, s] tensor to receive the pre-dropout
// softmax weights, or null for the eval kernel. With dropout != 0 the slots
// are dropped by philox.cuh's rule under (seed_lo, seed_hi, threshold).
// `stream` is the caller's cudaStream_t. The kernel allocates nothing and
// does not synchronise.
extern "C" int mhla_band_fwd(const void* q, const void* k, const void* v,
                             void* out, void* wts, long long rows, int d,
                             int s, int w, int is_bf16, float scale,
                             int dropout, unsigned int seed_lo,
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
  float* wp = static_cast<float*>(wts);
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, wp, rows, d, s, w,
                                        scale, dropout != 0, drop, st)
                : launch<float>(q, k, v, out, wp, rows, d, s, w, scale,
                                dropout != 0, drop, st);
  return static_cast<int>(err);
}

// The band's dropout bits as the kernels draw them: out[row, o, i] is the
// 32-bit word that decides slot o of query i (kept iff >= the threshold).
// Used to hold the generator to its plain version; not on the model's path.
extern "C" int mhla_band_keep_bits(void* out, long long rows, int s, int w,
                                   unsigned int seed_lo, unsigned int seed_hi,
                                   int device, void* stream) {
  if (rows <= 0 || s <= 0 || w < 1 || w > kMaxWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = rows * static_cast<int64_t>(s);
  const int64_t blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  keep_bits_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), rows, s, w,
      (static_cast<uint64_t>(seed_hi) << 32) | seed_lo);
  return static_cast<int>(cudaGetLastError());
}

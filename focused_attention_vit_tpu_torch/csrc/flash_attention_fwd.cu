// Dense (non-causal) flash attention, forward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/flash_attention_pallas.py
// ::flash_attention_tpu (:28, the wrapper; :73, the call into JAX's bundled
// Pallas flash kernel), forward. Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/flash_attention.py.
//
// What it computes, for each (b*h) row of contiguous [B*h, S, d] q, k, v:
//   out_i = sum_j softmax_j(q_i . k_j * d^-1/2) v_j  over the S real keys,
// by the online-softmax recurrence over key tiles: f32 logits, a running
// maximum m, a running sum l and an f32 accumulator per query, one rounding
// to the input dtype at the end. The training instantiation also writes
// lse_i = m_i + log l_i (f32 [B*h, S]) for the backward
// (flash_attention_bwd.cu); the eval instantiation writes none. The key
// length is an argument: keys at or past S in the last tile get a logit of
// -inf, so there are no padded copies of q, k, v and no segment ids (the TPU
// wrapper pads S to 512 and masks by segment id because Mosaic's blocks
// must divide the arrays). Query rows at or past S in the last query tile
// are computed on zeros and never written.
//
// What bounds it on this card: operations. A call does 4*B*h*S^2*d flops
// (0.97 TFLOP at B*h=384, S=3137, d=64: 0.98 ms at the 989 TFLOP/s bf16
// peak) and must move only q, k, v and out once (617 MB, 0.18 ms at
// 3.35 TB/s). So the bf16 kernel runs both products on the tensor cores:
//   - a block of 8 warps owns 128 queries, a warp 16 of them; its Q
//     fragments stay in registers for the whole key loop;
//   - K and V tiles of 64 keys are staged in shared memory (16-byte loads,
//     rows padded by 16 bytes so ldmatrix reads without bank conflicts) and
//     shared by the 8 warps, which cuts the re-reads of K and V from L2 to
//     one per 128 queries;
//   - S = Q K^T by mma.sync.m16n8k16 (bf16 in, f32 out), the softmax on the
//     accumulator registers (row statistics reduced over the 4 lanes that
//     share a row), P rounded to bf16 in registers and fed straight back as
//     the A operand of O += P V. Nothing of size S x S touches memory.
// P is rounded to bf16 for the second product (the tensor cores take bf16),
// while l sums the unrounded f32 weights; the plain version keeps P in f32.
// The difference is a sum of S independent roundings of relative size 2^-9,
// far below one bf16 ulp of a typical output.
// This first design issues its loads and its products from the same warps
// with one barrier pair per key tile: no wgmma, no TMA, no pipelining of
// the next tile behind the current products. Those are later work.
//
// The f32 instantiation is a scalar-FMA kernel (a thread per query, K and V
// tiles broadcast from shared memory): full f32 products, which TF32 tensor
// cores would not give, so it agrees with the plain version to 1e-5. It is
// meant for small shapes and parity runs, not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

using flash::kPad;
using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;  // 8 warps of 16 queries
constexpr int kMmaBM = 128;       // queries a block
constexpr int kMmaBN = 64;        // keys a tile

// At most 128 registers a thread for d <= 64, so that two blocks (16 warps)
// share an SM and one block's loads hide behind the other's products.
template <int D, bool kLse>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 2 : 1)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ lse, int s, int tiles_per_row,
                  float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int BN = kMmaBN;
  static_assert(kMmaBM == 2 * BN, "the Q tile is staged through K and V's");
  __shared__ __align__(16) bf16 smem[2 * BN * LD];
  bf16* ks = smem;
  bf16* vs = smem + BN * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kMmaBM;
  const int64_t base = row * static_cast<int64_t>(s) * D;

  // The Q tile goes through K's and V's shared memory into registers.
  flash::load_tile<kMmaBM, D, kMmaThreads>(smem, q + base, q0, s, tid);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    flash::load_a<LD>(qf[kk], smem, warp * 16, kk * 16, lane);
  }
  __syncthreads();

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nt][r] = 0.f;
  }
  // Rows g and g + 8 of the warp's 16; m in log2 units of the scaled logit.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  const int key_tiles = (s + BN - 1) / BN;
  for (int kt = 0; kt < key_tiles; ++kt) {
    const int key0 = kt * BN;
    flash::load_tile<BN, D, kMmaThreads>(ks, k + base, key0, s, tid);
    flash::load_tile<BN, D, kMmaThreads>(vs, v + base, key0, s, tid);
    __syncthreads();

    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        flash::load_b<LD>(b, ks, np * 16, kk * 16, lane);
        flash::mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
        flash::mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    const bool ragged = key0 + BN > s;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = sc[nt][r] * scale_log2;
        if (ragged && key0 + nt * 8 + 2 * t + (r & 1) >= s) x = -INFINITY;
        sc[nt][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // Key 0 is always real, so after the first tile m is finite and
      // neither difference below is (-inf) - (-inf).
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(sc[nt][r] - m[r >> 1]);
        sc[nt][r] = p;
        l[r >> 1] += p;
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) o[nt][r] *= alpha[r >> 1];
    }

#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t pa[4] = {
          flash::pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
          flash::pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
          flash::pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
          flash::pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        flash::load_b_trans<LD>(b, vs, kc * 16, np * 16, lane);
        flash::mma_bf16(o[2 * np], pa, b[0], b[1]);
        flash::mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int i = q0 + warp * 16 + g + 8 * h;
    if (i >= s) continue;
    const float inv = 1.f / l[h];
    bf16* orow = out + base + static_cast<int64_t>(i) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
    }
    if (kLse && t == 0) {
      lse[row * s + i] = (m[h] + log2f(l[h])) * flash::kLn2;
    }
  }
}

constexpr int kF32Threads = 128;  // queries a block, one a thread

template <int D, bool kLse>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int s, int tiles_per_row,
                  float scale) {
  constexpr int BN = D <= 64 ? 64 : 32;  // 32 KB of K and V tiles at most
  constexpr int kChunk = 8;              // keys per softmax update
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int i = (blockIdx.x % tiles_per_row) * kF32Threads + tid;
  const bool valid = i < s;
  const int64_t base = row * static_cast<int64_t>(s) * D;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      val = *reinterpret_cast<const float4*>(
          q + base + static_cast<int64_t>(i) * D + c);
    }
    qr[c] = val.x, qr[c + 1] = val.y, qr[c + 2] = val.z, qr[c + 3] = val.w;
    acc[c] = acc[c + 1] = acc[c + 2] = acc[c + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int key0 = 0; key0 < s; key0 += BN) {
    flash::load_tile_f32<BN, D, kF32Threads>(ks, k + base, key0, s, tid);
    flash::load_tile_f32<BN, D, kF32Threads>(vs, v + base, key0, s, tid);
    __syncthreads();
    const int nk = min(BN, s - key0);
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float p[kChunk];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (j0 + jj) * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot += qr[c] * kr[c];
        p[jj] = j0 + jj < nk ? dot * scale : -INFINITY;
        mx = fmaxf(mx, p[jj]);
      }
      // Key j0 is real, so m_new is finite.
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      m = m_new;
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        p[jj] = expf(p[jj] - m_new);
        psum += p[jj];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float a = acc[c] * alpha;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) a += p[jj] * vs[(j0 + jj) * D + c];
        acc[c] = a;
      }
    }
    __syncthreads();
  }

  if (!valid) return;
  const float inv = 1.f / l;
  float* orow = out + base + static_cast<int64_t>(i) * D;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    *reinterpret_cast<float4*>(orow + c) = make_float4(
        acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv, acc[c + 3] * inv);
  }
  if (kLse) lse[row * s + i] = m + logf(l);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int64_t rows, int s, bool is_bf16,
                     float scale, cudaStream_t stream) {
  const int bm = is_bf16 ? kMmaBM : kF32Threads;
  const int tiles = (s + bm - 1) / bm;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (is_bf16) {
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    bf16* op = static_cast<bf16*>(out);
    const float scale_log2 = scale * flash::kLog2e;
    if (lse != nullptr) {
      flash_fwd_mma<D, true><<<grid, kMmaThreads, 0, stream>>>(
          qp, kp, vp, op, lse, s, tiles, scale_log2);
    } else {
      flash_fwd_mma<D, false><<<grid, kMmaThreads, 0, stream>>>(
          qp, kp, vp, op, lse, s, tiles, scale_log2);
    }
  } else {
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    float* op = static_cast<float*>(out);
    if (lse != nullptr) {
      flash_fwd_f32<D, true><<<grid, kF32Threads, 0, stream>>>(
          qp, kp, vp, op, lse, s, tiles, scale);
    } else {
      flash_fwd_f32<D, false><<<grid, kF32Threads, 0, stream>>>(
          qp, kp, vp, op, lse, s, tiles, scale);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). q, k, v and out are device pointers to contiguous
// [rows, s, d] tensors of one dtype (is_bf16 = 1 for bf16, 0 for f32),
// 16-byte aligned; `lse` is a contiguous f32 [rows, s] tensor to receive
// the log-sum-exp of each query's scaled logits, or null for the eval
// kernel. `stream` is the caller's cudaStream_t. The kernel allocates
// nothing and does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   long long rows, int s, int d, int is_bf16,
                                   float scale, int device, void* stream) {
  if (rows <= 0 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  const bool bf = is_bf16 != 0;
  switch (d) {
    case 16:
      err = launch_d<16>(q, k, v, out, lp, rows, s, bf, scale, st);
      break;
    case 32:
      err = launch_d<32>(q, k, v, out, lp, rows, s, bf, scale, st);
      break;
    case 64:
      err = launch_d<64>(q, k, v, out, lp, rows, s, bf, scale, st);
      break;
    case 128:
      err = launch_d<128>(q, k, v, out, lp, rows, s, bf, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

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
// VMEM (4 MB at Sp = 1024). A block here has 227 KB of shared memory and a
// warp's registers hold 16 queries x 64 keys at a time, so the kernel walks
// the keys in tiles of 64 with the online-softmax recurrence instead: a
// running maximum m, a running sum l and an f32 accumulator per query.
// Dropout acts on the NORMALISED weights, so the recurrence masks only the
// numerator: l sums every exp, kept or not, the masked exps go into the
// product with V, and the result is divided by l and by (1 - rate) at the
// end. The key length is an argument: keys at or past S get a logit of -inf
// and query rows at or past S are never written, so nothing is padded to
// 128 in memory as the TPU wrapper pads it.
//
// What bounds it on this card: bytes, on paper. At B*h = 1536, S = 197,
// d = 64 in bf16 a call moves 155 MB of q, k, v and out (0.046 ms at
// 3.35 TB/s) and does 15.3 GFLOP (0.015 ms at the bf16 peak). This first
// design follows the flash forward (flash_attention_fwd.cu): a block of 4
// warps owns 64 queries of one row, a warp 16; K and V tiles of 64 keys are
// staged in shared memory with 16-byte loads; both products run on the
// tensor cores (mma.sync.m16n8k16) with the softmax, and the Philox draw, on
// the accumulator registers. One Philox call yields the four words of the
// four keys a lane owns in one row of a 16-key chunk. No wgmma, no TMA, no
// pipelining: later work.
//
// The f32 instantiation is a scalar-FMA kernel (a thread per query) with
// full f32 products, for parity runs (1e-5 against the plain version), not
// for speed. It spends one Philox call a key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using flash::kPad;
using bf16 = __nv_bfloat16;

struct Dropout {
  uint64_t seed;
  uint32_t threshold;  // keep iff word >= threshold
  float inv_keep;      // 1 / (1 - rate); 1 without dropout
};

constexpr int kThreads = 128;  // 4 warps of 16 queries, or 128 scalar queries
constexpr int kBM = 64;        // queries a tensor-core block
constexpr int kBN = 64;        // keys a tile

template <int D, bool kLse, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    fused_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ lse, int s, int tiles_per_row,
                  float scale_log2, Dropout drop) {
  constexpr int LD = D + kPad;
  constexpr int BN = kBN;
  static_assert(kBM == BN, "the Q tile is staged through K's");
  __shared__ __align__(16) bf16 ks[BN * LD];
  __shared__ __align__(16) bf16 vs[BN * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int q0 = (blockIdx.x % tiles_per_row) * kBM;
  const int64_t base = row * static_cast<int64_t>(s) * D;

  // The Q tile goes through K's shared memory into registers.
  flash::load_tile<kBM, D, kThreads>(ks, q + base, q0, s, tid);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    flash::load_a<LD>(qf[kk], ks, warp * 16, kk * 16, lane);
  }
  __syncthreads();

  float o[D / 8][4];
  flash::zero(o);
  // Rows g and g + 8 of the warp's 16; m in log2 units of the scaled logit.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums, unmasked

  for (int key0 = 0; key0 < s; key0 += BN) {
    flash::load_tile<BN, D, kThreads>(ks, k + base, key0, s, tid);
    flash::load_tile<BN, D, kThreads>(vs, v + base, key0, s, tid);
    __syncthreads();

    float sc[BN / 8][4];
    flash::zero(sc);
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
        l[r >> 1] += p;  // the softmax sum takes every key, dropped or not
      }
    }
    if (kDrop) {
      // Only the numerator is masked. One Philox call gives the words of
      // this lane's four keys of one row in one 16-key chunk.
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const int grp = 4 * ((key0 >> 4) + kc) + t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = q0 + warp * 16 + g + 8 * h;
          const uint4 w = philox::mha_words(drop.seed, row, i, grp);
          if (w.x < drop.threshold) sc[2 * kc][2 * h] = 0.f;
          if (w.y < drop.threshold) sc[2 * kc][2 * h + 1] = 0.f;
          if (w.z < drop.threshold) sc[2 * kc + 1][2 * h] = 0.f;
          if (w.w < drop.threshold) sc[2 * kc + 1][2 * h + 1] = 0.f;
        }
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
    const float inv = drop.inv_keep / l[h];
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

template <int D, bool kLse, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    fused_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int s, int tiles_per_row,
                  float scale, Dropout drop) {
  constexpr int BN = D <= 64 ? 64 : 32;  // 32 KB of K and V tiles at most
  constexpr int kChunk = 8;              // keys per softmax update
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles_per_row;
  const int i = (blockIdx.x % tiles_per_row) * kThreads + tid;
  const bool valid = i < s;
  const int64_t base = row * static_cast<int64_t>(s) * D;

  float qr[D], acc[D];
  flash::load_row<D>(qr, q + base + static_cast<int64_t>(i) * D, valid);
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int key0 = 0; key0 < s; key0 += BN) {
    flash::load_tile_f32<BN, D, kThreads>(ks, k + base, key0, s, tid);
    flash::load_tile_f32<BN, D, kThreads>(vs, v + base, key0, s, tid);
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
        psum += p[jj];  // unmasked: dropout acts on the normalised weights
        if (kDrop && philox::mha_word(drop.seed, row, i, key0 + j0 + jj) <
                         drop.threshold) {
          p[jj] = 0.f;
        }
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
  const float inv = drop.inv_keep / l;
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] *= inv;
  flash::store_row<D>(out + base + static_cast<int64_t>(i) * D, acc);
  if (kLse) lse[row * s + i] = m + logf(l);
}

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
  int s;
  float scale;
  bool drop_on;
  Dropout drop;
  cudaStream_t stream;
};

template <int D, bool kLse, bool kDrop>
cudaError_t launch_kernel(const Args& a, bool is_bf16) {
  const int bm = is_bf16 ? kBM : kThreads;
  const int tiles = (a.s + bm - 1) / bm;
  const int64_t blocks = a.rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (is_bf16) {
    fused_fwd_mma<D, kLse, kDrop><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.s,
        tiles, a.scale * flash::kLog2e, a.drop);
  } else {
    fused_fwd_f32<D, kLse, kDrop><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse,
        a.s, tiles, a.scale, a.drop);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, bool is_bf16) {
  if (a.lse != nullptr) {
    return a.drop_on ? launch_kernel<D, true, true>(a, is_bf16)
                     : launch_kernel<D, true, false>(a, is_bf16);
  }
  return a.drop_on ? launch_kernel<D, false, true>(a, is_bf16)
                   : launch_kernel<D, false, false>(a, is_bf16);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). q, k, v and out are device pointers to contiguous
// [rows, s, d] tensors of one dtype (is_bf16 = 1 for bf16, 0 for f32),
// 16-byte aligned; `lse` is a contiguous f32 [rows, s] tensor to receive the
// log-sum-exp of each query's scaled logits, or null. With drop_on != 0 the
// weights are dropped: keep iff the Philox word of (seed, row, query, key)
// is at least `threshold`, and scale the kept by 1 / keep_prob. `stream` is
// the caller's cudaStream_t. The kernel allocates nothing and does not
// synchronise.
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, long long rows, int s,
                             int d, int is_bf16, float scale, int drop_on,
                             unsigned seed_lo, unsigned seed_hi,
                             unsigned threshold, float keep_prob, int device,
                             void* stream) {
  if (rows <= 0 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (drop_on && !(keep_prob > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dropout drop{(static_cast<uint64_t>(seed_hi) << 32) | seed_lo,
                     threshold, drop_on ? 1.f / keep_prob : 1.f};
  const Args a{q,     k,           v,    out, static_cast<float*>(lse), rows, s,
               scale, drop_on != 0, drop, static_cast<cudaStream_t>(stream)};
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

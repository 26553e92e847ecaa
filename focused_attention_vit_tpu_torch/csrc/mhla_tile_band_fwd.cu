// MHLA tile band, forward, for Hopper (sm_90a): K6 and K8.
//
// Replaces: focused_attention_vit_tpu/ops/mhla_kernel_v4.py::_fwd_kernel
// (:66, K6; pallas_call at :212, reached through banded_attention_v4) and
// ::_fwd_kernel_b (:383, K8; pallas_call at :428 in banded_attention_v4b).
// Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/mhla_kernel_v4.py.
//
// What it computes, for each (b*h) row and query r of contiguous [B*h, S, d]
// q, k, v, with hw = W / 2 and c(x) = clamp(x, 0, S - 1):
//   out_r = sum_{o = -hw..hw} p_ro v_c(r+o),
//   p_ro  = softmax_o(q_r . k_c(r+o) * d^-1/2),
// the clamped band: a replicated edge key counts once per position, and an
// even W reads W + 1 keys. Logits and softmax in f32, p rounded to the input
// dtype before the product with V, f32 sums rounded once, as the TPU kernel.
// K8 reads the same keys from prebuilt window tiles [B*h, n_t, t + 32, d]
// (row c of tile i is position i*t + c - 16, clamped) beside query tiles
// [B*h, n_t, t, d], and writes output tiles of the query tiles' shape.
//
// What bounds it on this card: bytes. At B*h = 384, S = 3137, d = 64, W = 7
// a K6 call must read q, k, v and write out, 617 MB in bf16 (0.184 ms at
// 3.35 TB/s), against 2 W d multiply-adds a query (0.7 GFLOP). The TPU kernel
// forms a dense [T, T + 2 halo] logit tile per 256-query tile (41x the
// band's softmax work), because its DMA wants whole aligned slices. Here:
//   - a block owns 64 queries of one row, a warp 16 of them; the block's K
//     and V rows [q0 - 16, q0 + 80) are staged in shared memory with clamped
//     row indices, which is the edge-replicated pad (K8: window rows);
//   - a warp forms logits only for the three 16-key blocks that meet its
//     band (48 keys for 16 queries: 7x the band at W = 7) on the tensor cores
//     (mma.sync.m16n8k16, bf16 in, f32 out), masks |c - r| > hw to -inf and
//     runs the whole softmax in registers: the band never leaves the block,
//     so no online softmax is needed;
//   - p is rounded to bf16 in registers and fed back as the A operand of
//     out = P V.
// Each K/V row is staged by 1.5 blocks on average, the second time mostly
// from L2. No TMA, no pipelining of the next block's loads: later work.
//
// The f32 instantiations are scalar-FMA kernels, a thread per query reading
// its 2 hw + 1 keys from device memory: full f32 products, for parity runs,
// not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

using flash::kPad;
using bf16 = __nv_bfloat16;

constexpr int kHalo = 16;               // K/V rows staged each side; hw <= 16
constexpr int kBQ = 64;                 // queries a block
constexpr int kRows = kBQ + 2 * kHalo;  // K/V rows staged
constexpr int kThreads = 128;           // 4 warps of 16 queries
constexpr int kMaxBand = 2 * kHalo + 1;

// The rows one block reads and writes. K6 (kTiles false): block `blk` of a
// (b*h) row owns queries [64 blk, 64 blk + 64) of the [s, D] matrices, and
// staged key row j is position 64 blk - 16 + j, clamped. K8 (kTiles true):
// block `blk` is chunk blk % chunks of tile blk / chunks; it owns tile rows
// [64 c, 64 c + 64) below t, and staged key row j is window row 64 c + j,
// none past the window's t + 32 rows. Either way the band of the block's
// query j is staged key rows j + 16 - hw .. j + 16 + hw.
template <typename T, int D, bool kTiles>
struct Rows {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int nq;  // query rows of the block's matrix
  int nk;  // key rows
  int r0;  // the block's first query row
  int k0;  // the key row of staged row 0

  __device__ Rows(const T* q_, const T* k_, const T* v_, T* out_,
                  int64_t row, int blk, int s, int n_t, int t, int chunks) {
    if (kTiles) {
      const int64_t tile = row * n_t + blk / chunks;
      const int ext = t + 2 * kHalo;
      q = q_ + tile * t * D;
      out = out_ + tile * t * D;
      k = k_ + tile * ext * D;
      v = v_ + tile * ext * D;
      nq = t;
      nk = ext;
      r0 = (blk % chunks) * kBQ;
      k0 = r0;
    } else {
      const int64_t base = row * static_cast<int64_t>(s) * D;
      q = q_ + base;
      out = out_ + base;
      k = k_ + base;
      v = v_ + base;
      nq = nk = s;
      r0 = blk * kBQ;
      k0 = r0 - kHalo;
    }
  }

  // The key row behind staged row j, or -1 for none (zeros).
  __device__ int key_row(int j) const {
    const int x = k0 + j;
    if (kTiles) return x < nk ? x : -1;
    return min(max(x, 0), nk - 1);
  }

  // The query row behind staged row j, or -1 past the matrix.
  __device__ int query_row(int j) const { return r0 + j < nq ? r0 + j : -1; }
};

// Stage ROWS rows of D bf16 into a padded tile (LD = D + kPad), 16 bytes a
// thread and step: tile row j is src row row_of(j), or zeros for -1.
template <int ROWS, int D, int THREADS, typename RowOf>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src,
                                      RowOf row_of, int tid) {
  constexpr int kVecs = D / 8;
  constexpr int LD = D + kPad;
  for (int idx = tid; idx < ROWS * kVecs; idx += THREADS) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 8;
    const int sr = row_of(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (sr >= 0) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(sr) *
                                                      D + c);
    }
    *reinterpret_cast<uint4*>(tile + r * LD + c) = val;
  }
}

template <int D, bool kTiles>
__global__ void __launch_bounds__(kThreads)
    tile_band_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int s, int n_t, int t, int per_row, int chunks, int hw,
                      float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kRows * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const Rows<bf16, D, kTiles> rows(q, k, v, out, blockIdx.x / per_row,
                                   blockIdx.x % per_row, s, n_t, t, chunks);

  // The block's queries go through K's shared memory into registers.
  stage<kBQ, D, kThreads>(
      ks, rows.q, [&](int j) { return rows.query_row(j); }, tid);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    flash::load_a<LD>(qf[kk], ks, warp * 16, kk * 16, lane);
  }
  __syncthreads();
  stage<kRows, D, kThreads>(
      ks, rows.k, [&](int j) { return rows.key_row(j); }, tid);
  stage<kRows, D, kThreads>(
      vs, rows.v, [&](int j) { return rows.key_row(j); }, tid);
  __syncthreads();

  // Logits of the warp's 16 queries against staged keys [16 warp, +48).
  float sc[6][4];
  flash::zero(sc);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 3; ++np) {
      uint32_t b[4];
      flash::load_b<LD>(b, ks, warp * 16 + np * 16, kk * 16, lane);
      flash::mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
      flash::mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }

  // Column c is offset c - qi - 16 from query qi of the warp: the band is
  // |offset| <= hw, which always holds the query's own key.
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = nt * 8 + 2 * t4 + (r & 1) - (g + 8 * (r >> 1)) - kHalo;
      const float x = (off >= -hw && off <= hw) ? sc[nt][r] * scale
                                                : -INFINITY;
      sc[nt][r] = x;
      mx[r >> 1] = fmaxf(mx[r >> 1], x);
    }
  }
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(sc[nt][r] - mx[r >> 1]);
      sc[nt][r] = e;
      den[r >> 1] += e;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }

  float o[D / 8][4];
  flash::zero(o);
#pragma unroll
  for (int kc = 0; kc < 3; ++kc) {
    // p = e / den, rounded to bf16 as the A operand of P V.
    const uint32_t pa[4] = {
        flash::pack_bf16(sc[2 * kc][0] / den[0], sc[2 * kc][1] / den[0]),
        flash::pack_bf16(sc[2 * kc][2] / den[1], sc[2 * kc][3] / den[1]),
        flash::pack_bf16(sc[2 * kc + 1][0] / den[0],
                         sc[2 * kc + 1][1] / den[0]),
        flash::pack_bf16(sc[2 * kc + 1][2] / den[1],
                         sc[2 * kc + 1][3] / den[1])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      flash::load_b_trans<LD>(b, vs, warp * 16 + kc * 16, np * 16, lane);
      flash::mma_bf16(o[2 * np], pa, b[0], b[1]);
      flash::mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
    }
  }
  flash::store_rows<D>(rows.out, o, rows.r0 + warp * 16, rows.nq, lane);
}

// --- f32: scalar FMA, a thread per query ------------------------------------

template <int D, bool kTiles>
__global__ void __launch_bounds__(kBQ)
    tile_band_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int s, int n_t, int t, int per_row, int chunks, int hw,
                      float scale) {
  const Rows<float, D, kTiles> rows(q, k, v, out, blockIdx.x / per_row,
                                    blockIdx.x % per_row, s, n_t, t, chunks);
  const int j = threadIdx.x;
  const int r = rows.query_row(j);
  if (r < 0) return;
  float qr[D];
  flash::load_row<D>(qr, rows.q + static_cast<int64_t>(r) * D, true);
  const int n = 2 * hw + 1;
  float lg[kMaxBand];
  float mx = -INFINITY;
  for (int o = 0; o < n; ++o) {
    const float* kr =
        rows.k + static_cast<int64_t>(rows.key_row(j + kHalo + o - hw)) * D;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) dot += qr[c] * kr[c];
    lg[o] = dot * scale;
    mx = fmaxf(mx, lg[o]);
  }
  float den = 0.f;
  for (int o = 0; o < n; ++o) {
    lg[o] = expf(lg[o] - mx);
    den += lg[o];
  }
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int o = 0; o < n; ++o) {
    const float p = lg[o] / den;
    const float* vr =
        rows.v + static_cast<int64_t>(rows.key_row(j + kHalo + o - hw)) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] += p * vr[c];
  }
  flash::store_row<D>(rows.out + static_cast<int64_t>(r) * D, acc);
}

template <int D, bool kTiles>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int64_t rows, int per_row, int s, int n_t, int t,
                     int chunks, int hw, bool is_bf16, float scale,
                     cudaStream_t stream) {
  const int64_t blocks = rows * per_row;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (is_bf16) {
    constexpr int kSmem = 2 * kRows * (D + kPad) * sizeof(bf16);
    if (kSmem > 48 * 1024) {
      static const cudaError_t attr = cudaFuncSetAttribute(
          tile_band_fwd_mma<D, kTiles>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (attr != cudaSuccess) return attr;
    }
    tile_band_fwd_mma<D, kTiles><<<grid, kThreads, kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), s, n_t, t,
        per_row, chunks, hw, scale);
  } else {
    tile_band_fwd_f32<D, kTiles><<<grid, kBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, n_t, t,
        per_row, chunks, hw, scale);
  }
  return cudaGetLastError();
}

template <bool kTiles>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t rows, int per_row, int s, int n_t, int t,
                   int chunks, int d, int hw, bool is_bf16, float scale,
                   cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_d<16, kTiles>(q, k, v, out, rows, per_row, s, n_t, t,
                                  chunks, hw, is_bf16, scale, stream);
    case 32:
      return launch_d<32, kTiles>(q, k, v, out, rows, per_row, s, n_t, t,
                                  chunks, hw, is_bf16, scale, stream);
    case 64:
      return launch_d<64, kTiles>(q, k, v, out, rows, per_row, s, n_t, t,
                                  chunks, hw, is_bf16, scale, stream);
    case 128:
      return launch_d<128, kTiles>(q, k, v, out, rows, per_row, s, n_t, t,
                                   chunks, hw, is_bf16, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launch (0 on success); the kernels allocate nothing and do not
// synchronise. Tensors are device pointers to contiguous tensors of one
// dtype (is_bf16 = 1 for bf16, 0 for f32), 16-byte aligned; 0 <= hw <= 16;
// d is 16, 32, 64 or 128; `stream` is the caller's cudaStream_t.
//
// K6: q, k, v and out are [rows, s, d].
extern "C" int mhla_tile_band_fwd(const void* q, const void* k, const void* v,
                                  void* out, long long rows, int s, int d,
                                  int hw, int is_bf16, float scale, int device,
                                  void* stream) {
  if (rows <= 0 || s < 1 || hw < 0 || hw > kHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_row = (s + kBQ - 1) / kBQ;
  return static_cast<int>(launch<false>(
      q, k, v, out, rows, per_row, s, 0, 0, 1, d, hw, is_bf16 != 0, scale,
      static_cast<cudaStream_t>(stream)));
}

// K8: q and out are [rows, n_t, t, d] query tiles, k and v
// [rows, n_t, t + 32, d] window tiles.
extern "C" int mhla_tile_band_fwd_tiles(const void* q, const void* k,
                                        const void* v, void* out,
                                        long long rows, int n_t, int t, int d,
                                        int hw, int is_bf16, float scale,
                                        int device, void* stream) {
  if (rows <= 0 || n_t < 1 || t < 1 || hw < 0 || hw > kHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (t + kBQ - 1) / kBQ;
  if (static_cast<int64_t>(n_t) * chunks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return static_cast<int>(launch<true>(
      q, k, v, out, rows, n_t * chunks, 0, n_t, t, chunks, d, hw,
      is_bf16 != 0, scale, static_cast<cudaStream_t>(stream)));
}

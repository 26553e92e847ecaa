// MHLA tile band, backward, for Hopper (sm_90a): K7.
//
// Replaces: focused_attention_vit_tpu/ops/mhla_kernel_v4.py::_bwd_kernel
// (:104; pallas_call at :255 in the custom VJP's _bwd_rule). Wrapper and
// plain PyTorch versions: focused_attention_vit_tpu_torch/ops/
// mhla_kernel_v4.py, which also runs JAX's plain _edge_fold (:285) after
// this kernel.
//
// What it computes, for the clamped band of mhla_tile_band_fwd.cu (query r
// reads position r + o, o = -hw..hw, at key c(r + o) = clamp(r + o, 0, S-1)),
// from q, k, v and the cotangent g, all contiguous [B*h, S, d]:
//   p_ro  = softmax_o(q_r . k_c(r+o) * d^-1/2)      (recomputed)
//   dp_ro = g_r . v_c(r+o),  ds_ro = p_ro (dp_ro - sum_o' dp_ro' p_ro') scale
//   dq_r  = sum_o ds_ro k_c(r+o)
//   dk_j  = sum_{r + o = j} ds_ro q_r,   dv_j = sum_{r + o = j} p_ro g_r
// over in-range positions j only: the mass that the first and last hw
// queries put on clamped positions is added to rows 0 and S-1 by the plain
// edge fold, as in JAX. ds and p are rounded to the input dtype for the
// second products, as the TPU kernel rounds them; sums are f32.
//
// What bounds it on this card: bytes. At B*h = 384, S = 3137, d = 64, W = 7
// a call must read q, k, v, g and write dq, dk, dv, 1.08 GB in bf16 (0.322 ms
// at 3.35 TB/s), against 5 W d multiply-adds a query (1.7 GFLOP). The TPU
// kernel holds [T + 2 halo, T + 4 halo] f32 logits per 256-key tile, 368 KB,
// which a block's 227 KB of shared memory cannot. Here a block owns 64 rows
// [t0, t0 + 64) of one (b*h) row, as queries (dq) and as keys (dk, dv):
//   - it stages Q and G for the 96 query positions [t0 - 16, t0 + 80) that
//     can reach its keys (G zero outside [0, S)) and K and V for the 128
//     positions [t0 - 32, t0 + 96) that those queries read, clamped;
//   - six warps each take 16 of the staged queries and recompute logits and
//     dp for the three 16-key blocks that meet their band on the tensor
//     cores (mma.sync.m16n8k16), then p, the row sum and ds in registers;
//     the four warps of the block's own queries multiply ds by K for dq;
//   - each writes p and ds, rounded to bf16 and transposed, to shared
//     memory; after a barrier, four warps multiply ds^T by Q for dk and four
//     multiply p^T by G for dv, each for 16 of the block's keys, from the
//     three band warps whose keys reach them.
// Every output element is written by one thread: no atomics, the same bits
// from run to run. Staging reads 1.75x the block's own rows, the rest
// mostly from L2. No TMA, no pipelining: later work.
//
// The f32 instantiation is a scalar-FMA kernel (a thread per staged query,
// then a thread per key for dk and one for dv) reading q, k, v, g from
// device memory, with p and ds in shared memory: for parity runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

using flash::kPad;
using bf16 = __nv_bfloat16;

constexpr int kHalo = 16;                   // hw <= 16
constexpr int kBQ = 64;                     // rows a block owns
constexpr int kQRows = kBQ + 2 * kHalo;     // query positions staged
constexpr int kKRows = kBQ + 4 * kHalo;     // key positions staged
constexpr int kBandWarps = kQRows / 16;     // 6 warps of 16 staged queries
constexpr int kThreads = 256;               // 8 warps
constexpr int kBand = 48;                   // keys a band warp computes
constexpr int kLDT = 16 + kPad;             // [48 keys][16 queries] tiles
constexpr int kMaxBand = 2 * kHalo + 1;
constexpr int kF32Threads = 128;

__device__ __forceinline__ int clamp_row(int x, int s) {
  return min(max(x, 0), s - 1);
}

// Stage ROWS rows of D bf16 into a padded tile (LD = D + kPad): tile row j
// is src row row_of(j), or zeros for -1.
template <int ROWS, int D, typename RowOf>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src,
                                      RowOf row_of, int tid) {
  constexpr int kVecs = D / 8;
  constexpr int LD = D + kPad;
  for (int idx = tid; idx < ROWS * kVecs; idx += kThreads) {
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

template <int D>
constexpr int smem_bytes() {
  return (2 * kQRows + 2 * kKRows) * (D + kPad) * 2 +
         2 * kBandWarps * kBand * kLDT * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    tile_band_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      bf16* __restrict__ dq, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int s, int per_row, int hw,
                      float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // staged query positions
  bf16* gs = qs + kQRows * LD;
  bf16* ks = gs + kQRows * LD;                   // staged key positions
  bf16* vs = ks + kKRows * LD;
  bf16* pt = vs + kKRows * LD;                   // p^T of each band warp
  bf16* dst = pt + kBandWarps * kBand * kLDT;    // ds^T of each band warp

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int64_t row = blockIdx.x / per_row;
  const int t0 = (blockIdx.x % per_row) * kBQ;
  const int64_t base = row * static_cast<int64_t>(s) * D;

  // Staged query j is position t0 - 16 + j; staged key j is t0 - 32 + j.
  // Query j's band is staged keys j + 16 - hw .. j + 16 + hw.
  stage<kQRows, D>(
      qs, q + base, [&](int j) { return clamp_row(t0 - kHalo + j, s); }, tid);
  stage<kQRows, D>(
      gs, g + base,
      [&](int j) {
        const int p = t0 - kHalo + j;
        return p >= 0 && p < s ? p : -1;
      },
      tid);
  stage<kKRows, D>(
      ks, k + base, [&](int j) { return clamp_row(t0 - 2 * kHalo + j, s); },
      tid);
  stage<kKRows, D>(
      vs, v + base, [&](int j) { return clamp_row(t0 - 2 * kHalo + j, s); },
      tid);
  __syncthreads();

  if (warp < kBandWarps) {
    // Staged queries [16 warp, +16) against staged keys [16 warp, +48).
    uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      flash::load_a<LD>(qf[kk], qs, warp * 16, kk * 16, lane);
      flash::load_a<LD>(gf[kk], gs, warp * 16, kk * 16, lane);
    }
    float sc[6][4], dp[6][4];
    flash::zero(sc);
    flash::zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        uint32_t b[4];
        flash::load_b<LD>(b, ks, warp * 16 + np * 16, kk * 16, lane);
        flash::mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
        flash::mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
        flash::load_b<LD>(b, vs, warp * 16 + np * 16, kk * 16, lane);
        flash::mma_bf16(dp[2 * np], gf[kk], b[0], b[1]);
        flash::mma_bf16(dp[2 * np + 1], gf[kk], b[2], b[3]);
      }
    }

    // The softmax of each row over its band (column c is offset
    // c - qi - 16 from the warp's query qi), as the forward.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int off = nt * 8 + 2 * t4 + (r & 1) - (gq + 8 * (r >> 1)) - kHalo;
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
    float rs[2] = {0.f, 0.f};  // sum_o dp p of rows gq and gq + 8
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sc[nt][r] /= den[r >> 1];
        rs[r >> 1] += dp[nt][r] * sc[nt][r];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
    // ds in dp's registers; p and ds, rounded and transposed, to shared
    // memory for the dk and dv products.
    bf16* pw = pt + warp * kBand * kLDT;
    bf16* dw = dst + warp * kBand * kLDT;
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = nt * 8 + 2 * t4 + (r & 1);
        const int qi = gq + 8 * (r >> 1);
        const int off = c - qi - kHalo;
        const float ds = (off >= -hw && off <= hw)
                             ? (sc[nt][r] * (dp[nt][r] - rs[r >> 1])) * scale
                             : 0.f;
        dp[nt][r] = ds;
        pw[c * kLDT + qi] = __float2bfloat16(sc[nt][r]);
        dw[c * kLDT + qi] = __float2bfloat16(ds);
      }
    }
    // dq of the block's own queries: staged queries [16, 80), band warps
    // 1 to 4.
    if (warp >= 1 && warp <= 4) {
      float acc[D / 8][4];
      flash::zero(acc);
#pragma unroll
      for (int kc = 0; kc < 3; ++kc) {
        const uint32_t dsa[4] = {
            flash::pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
            flash::pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
            flash::pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
            flash::pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          flash::load_b_trans<LD>(b, ks, warp * 16 + kc * 16, np * 16, lane);
          flash::mma_bf16(acc[2 * np], dsa, b[0], b[1]);
          flash::mma_bf16(acc[2 * np + 1], dsa, b[2], b[3]);
        }
      }
      flash::store_rows<D>(dq + base, acc, t0 + (warp - 1) * 16, s, lane);
    }
  }
  __syncthreads();

  // The block's keys [t0 + 16 j, +16) are staged key block j + 2; band
  // warp u reaches staged key blocks u .. u + 2, so warps j .. j + 2 hold
  // every query of these keys. Warps 0-3 sum ds^T Q (dk), warps 4-7 p^T G
  // (dv).
  {
    const int j = warp & 3;
    const bool is_dv = warp >= 4;
    const bf16* weights = is_dv ? pt : dst;
    const bf16* rows = is_dv ? gs : qs;
    float acc[D / 8][4];
    flash::zero(acc);
#pragma unroll
    for (int u = j; u <= j + 2; ++u) {
      uint32_t a[4];
      flash::load_a<kLDT>(a, weights + u * kBand * kLDT, (j + 2 - u) * 16, 0,
                          lane);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        flash::load_b_trans<LD>(b, rows, u * 16, np * 16, lane);
        flash::mma_bf16(acc[2 * np], a, b[0], b[1]);
        flash::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    flash::store_rows<D>((is_dv ? dv : dk) + base, acc, t0 + j * 16, s,
                         lane);
  }
}

// --- f32: scalar FMA ---------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    tile_band_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      float* __restrict__ dq, float* __restrict__ dk,
                      float* __restrict__ dv, int s, int per_row, int hw,
                      float scale) {
  __shared__ float p_s[kQRows][kMaxBand];
  __shared__ float ds_s[kQRows][kMaxBand];

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / per_row;
  const int t0 = (blockIdx.x % per_row) * kBQ;
  const int64_t base = row * static_cast<int64_t>(s) * D;
  const int n = 2 * hw + 1;

  // A thread per staged query position t0 - 16 + tid: p and ds of its
  // band; a position outside [0, S) has g = 0 and so p g = ds = 0.
  if (tid < kQRows) {
    const int pos = t0 - kHalo + tid;
    if (pos >= 0 && pos < s) {
      float qr[D], gr[D], lg[kMaxBand], dpv[kMaxBand];
      flash::load_row<D>(qr, q + base + static_cast<int64_t>(pos) * D, true);
      flash::load_row<D>(gr, g + base + static_cast<int64_t>(pos) * D, true);
      float mx = -INFINITY;
      for (int o = 0; o < n; ++o) {
        const int64_t kr = clamp_row(pos + o - hw, s);
        const float* krow = k + base + kr * D;
        const float* vrow = v + base + kr * D;
        float dot = 0.f, dpo = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          dot += qr[c] * krow[c];
          dpo += gr[c] * vrow[c];
        }
        lg[o] = dot * scale;
        dpv[o] = dpo;
        mx = fmaxf(mx, lg[o]);
      }
      float den = 0.f;
      for (int o = 0; o < n; ++o) {
        lg[o] = expf(lg[o] - mx);
        den += lg[o];
      }
      float rs = 0.f;
      for (int o = 0; o < n; ++o) {
        lg[o] /= den;
        rs += dpv[o] * lg[o];
      }
      for (int o = 0; o < n; ++o) {
        p_s[tid][o] = lg[o];
        ds_s[tid][o] = (lg[o] * (dpv[o] - rs)) * scale;
      }
      if (tid >= kHalo && tid < kHalo + kBQ) {
        float acc[D];
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = 0.f;
        for (int o = 0; o < n; ++o) {
          const float* krow =
              k + base + static_cast<int64_t>(clamp_row(pos + o - hw, s)) * D;
#pragma unroll
          for (int c = 0; c < D; ++c) acc[c] += ds_s[tid][o] * krow[c];
        }
        flash::store_row<D>(dq + base + static_cast<int64_t>(pos) * D, acc);
      }
    } else {
      for (int o = 0; o < n; ++o) p_s[tid][o] = ds_s[tid][o] = 0.f;
    }
  }
  __syncthreads();

  // Key position t0 + j gets offset o - hw from the query at position
  // t0 + j + hw - o, staged query j + 16 + hw - o. Threads 0-63 sum dk,
  // 64-127 dv.
  const int j = tid & (kBQ - 1);
  const int pos = t0 + j;
  if (pos >= s) return;
  const bool is_dv = tid >= kBQ;
  const float* src = is_dv ? g : q;
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int o = 0; o < n; ++o) {
    const int i = j + kHalo + hw - o;
    const float w = is_dv ? p_s[i][o] : ds_s[i][o];
    const float* r =
        src + base + static_cast<int64_t>(clamp_row(pos + hw - o, s)) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] += w * r[c];
  }
  flash::store_row<D>((is_dv ? dv : dk) + base + static_cast<int64_t>(pos) * D,
                      acc);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv, int64_t rows,
                     int s, int hw, bool is_bf16, float scale,
                     cudaStream_t stream) {
  const int per_row = (s + kBQ - 1) / kBQ;
  const int64_t blocks = rows * per_row;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (is_bf16) {
    constexpr int kSmem = smem_bytes<D>();
    if (kSmem > 48 * 1024) {
      static const cudaError_t attr = cudaFuncSetAttribute(
          tile_band_bwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmem);
      if (attr != cudaSuccess) return attr;
    }
    tile_band_bwd_mma<D><<<grid, kThreads, kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g),
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        s, per_row, hw, scale);
  } else {
    tile_band_bwd_f32<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g),
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), s, per_row, hw, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). q, k, v, g and dq, dk, dv are device pointers to
// contiguous [rows, s, d] tensors of one dtype (is_bf16 = 1 for bf16, 0 for
// f32), 16-byte aligned; 0 <= hw <= 16; d is 16, 32, 64 or 128; `stream` is
// the caller's cudaStream_t. The kernel allocates nothing and does not
// synchronise.
extern "C" int mhla_tile_band_bwd(const void* q, const void* k, const void* v,
                                  const void* g, void* dq, void* dk, void* dv,
                                  long long rows, int s, int d, int hw,
                                  int is_bf16, float scale, int device,
                                  void* stream) {
  if (rows <= 0 || s < 1 || hw < 0 || hw > kHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  switch (d) {
    case 16:
      err = launch_d<16>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale, st);
      break;
    case 32:
      err = launch_d<32>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale, st);
      break;
    case 64:
      err = launch_d<64>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale, st);
      break;
    case 128:
      err = launch_d<128>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

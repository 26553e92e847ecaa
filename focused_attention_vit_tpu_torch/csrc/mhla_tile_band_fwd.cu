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
// even W reads W + 1 keys. Logits and softmax in f32, p = e / den rounded to
// the input dtype before the product with V, f32 sums rounded once, as the
// TPU kernel. K8 reads the same keys from prebuilt window tiles
// [B*h, n_t, t + 32, d] (row c of tile i is position i*t + c - 16, clamped)
// beside query tiles [B*h, n_t, t, d], and writes output tiles of the query
// tiles' shape.
//
// What bounds it on this card: bytes. At B*h = 384, S = 3137, d = 64, W = 7
// a K6 call must read q, k, v and write out, 617 MB in bf16 (0.184 ms at
// 3.35 TB/s), against 2 W d multiply-adds a query (0.7 GFLOP); K8 on that
// shape's 256-row tiles moves 695 MB, the window tiles' halo rows included
// (0.208 ms). The products run on mma.sync.m16n8k16 over 16-query by 48-key
// band tiles; wgmma would not pay: its 64-row M widens a band 2 hw + 1 <= 33
// keys wide to 64 + 2 hw columns of products, and the tensor cores sit far
// below their rate either way. So the design is about moving each byte
// once, with the next loads in flight:
//   - A block walks along a line (K6: a (b*h) row; K8: one window tile) in
//     steps of 64 queries. Step t owns the queries [t, t + 64) and reads
//     the keys [t - 16, t + 80).
//   - Rings in shared memory: 160 rows each of K and V, 128 of Q. A step
//     loads only its new rows, K and V at [t + 80, t + 144) and Q at
//     [t + 64, t + 128) for the step after it, issued right after the
//     step's barrier, so they land under this step's products: one step in
//     flight. Within a segment (a block's run of steps on one line) every
//     row is read from device memory once; a segment's first step loads
//     K and V at [t - 16, t + 80), and one that starts inside a line
//     re-reads the 32 rows around its start. A K8 segment never crosses a
//     window tile: a tile's window rows are its own data.
//   - Copies are 16-byte cp.async, not TMA: a copy's source row is chosen
//     per copy, so K6's K and V rows outside [0, S) are copied straight from
//     row 0 or S - 1 (nothing is written into a ring after a copy lands, so
//     no later write can race a copy of the same row), which a 3-D TMA map,
//     filling zeros there, cannot do. Q rows past the line's last query are
//     zeros stored by the issuing thread, and never stored out. K8's window
//     rows past t + 32 (which no stored query reads: a masked logit's zero
//     weight must not meet inf or NaN) are zeros stored the same way. Rows
//     are unpadded and their 16-byte chunks XOR-swizzled by the ring row
//     (tile_ring.cuh, shared with K7), so ldmatrix reads 8 rows of one
//     chunk from 8 bank groups.
//   - One warp a 16-query block: four warps take the step's 64 queries,
//     each forming its logits against the three 16-key blocks that meet its
//     band (48 keys), masking |c - r| > hw to -inf and running the whole
//     softmax in registers; p is rounded to bf16 in registers as the A
//     operand of out = P V. The band work is as long as the copies: with
//     the band work alone a call took about as long as with the copies
//     alone. So a warp skips the 8-key n-tiles and 8-query row halves that
//     miss the band (a test on hw, the same in every thread): at W = 7 it
//     forms 4 of the 6 logit n-tiles and takes exponentials and quotients
//     in half the slots, for the same bits. K7 splits each block over a
//     pair of warps because its band work (four products and an exchange)
//     bounded its step; the forward's two products fit one warp, and a
//     split would add an exchange through shared memory and pair barriers.
//   - Stores: a warp's Q rows are dead once its logits are formed, so it
//     stages its 16 result rows there with stmatrix and sends them out in
//     16-byte row chunks. No extra shared memory is spent on staging.
//   - One block barrier a step (after the wait for its rows) and one a
//     segment (before its first copies).
//   - Persistent blocks: the (line, step) units of all lines are split
//     into equal runs, one a block, over as many blocks as the card holds
//     at once (and no fewer than 8 units a block). At B*h = 384, S = 3137
//     (50 steps a row) on 132 SMs at 4 blocks each, K6's 19,200 units make
//     528 runs of 36 or 37 steps: 864 segments, 480 of them starting
//     inside a row, whose re-read of 32 K and 32 V rows (8 KB) comes to
//     3.9 MB, 0.85% of the 463 MB of reads; every block is resident from
//     the start, so there is no tail wave, and the runs differ by one
//     step. K8 at t = 256 (13 tiles of 4 steps a row): 19,968 units, 528
//     runs of 37 or 38 steps in 5,376 segments, 384 of them inside a tile.
// Every output element is written by one thread: no atomics, the same bits
// from run to run. Shared memory: (128 + 2 x 160) rows of d bf16, 57,344
// bytes at d = 64 (4 blocks an SM at 128 threads, at most 128 registers a
// thread, one step of 24 KB of copies in flight each), 114,688 at d = 128
// (2 blocks an SM).
//
// The f32 instantiations are scalar-FMA kernels, a thread per query reading
// its 2 hw + 1 keys from device memory: full f32 products, for parity runs,
// not for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#include "band_stage.cuh"
#include "flash_common.cuh"
#include "tile_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace tile_ring;

constexpr int kHalo = 16;          // hw <= 16
constexpr int kStep = 64;          // queries a step owns
constexpr int kKRing = 160;        // rows of the K and V rings
constexpr int kQRing = 128;        // rows of the Q ring
constexpr int kThreads = 128;      // 4 warps of 16 queries
constexpr int kMinUnits = 8;       // steps a block takes at least
constexpr int kBQ = 64;            // queries an f32 block
constexpr int kMaxBand = 2 * kHalo + 1;

template <int D>
constexpr int smem_bytes() {
  return (kQRing + 2 * kKRing) * D * 2;
}

// One line, the unit the kernels walk along: K6 (kTiles false) a (b*h) row
// of [n, D] q, k, v, out; K8 (kTiles true) one tile, query and output rows
// [0, n) of [n, D] tiles and the n + 32 rows of its [n + 32, D] window
// tiles. Key position p (query r reads positions r - hw..r + hw) is at
// k + p D for p in [lo, hi); outside it, K6's clamped band reads the
// nearest edge row, and K8's window has no row (no stored query reads one).
template <typename T, int D, bool kTiles>
struct Line {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int lo;
  int hi;

  __device__ Line(const T* q_, const T* k_, const T* v_, T* out_,
                  long long line, int n) {
    const int64_t base = line * static_cast<int64_t>(n) * D;
    q = q_ + base;
    out = out_ + base;
    if (kTiles) {
      const int64_t kbase = line * static_cast<int64_t>(n + 2 * kHalo) * D +
                            kHalo * D;  // window row 16 is position 0
      k = k_ + kbase;
      v = v_ + kbase;
      lo = -kHalo;
      hi = n + kHalo;
    } else {
      k = k_ + base;
      v = v_ + base;
      lo = 0;
      hi = n;
    }
  }
};

// Whether n-tile nt (8 keys) meets the band of row half h (8 queries) of a
// warp's 16: column c of query row i is offset c - i - 16, so the tile's
// offsets for the half span [8 (nt - h) - 23, 8 (nt - h) - 9]. Work on a
// dead slot is skipped: its logits would be -inf and its e and p 0, so the
// bits are the same. The test is the same in every thread.
__device__ __forceinline__ bool live(int nt, int h, int hw) {
  return 8 * (nt - h) - 23 <= hw && 8 * (nt - h) - 9 >= -hw;
}

// The 16 queries [qb, qb + 16) of a warp: logits against the 48 keys
// [qb - 16, qb + 32) that meet their band (at W = 7 only 32 do), the softmax
// in registers, p rounded to bf16 as the A operand of P V, and the rows in
// [0, n) out through the queries' own Q ring rows, dead once the logits are
// formed.
template <int D>
__device__ __forceinline__ void band_step(bf16* qs, bf16* ks, bf16* vs,
                                          bf16* out, int qb, int n, int hw,
                                          float scale, int lane) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const LaneAddr<D> la = pattern_a<D>(lane);
  const LaneAddr<D> lb = pattern_b<D>(lane);
  const int jq = ring_row<kQRing>(qb);
  int jk[3];
  bool used[6];  // n-tiles that meet either row half's band
#pragma unroll
  for (int kc = 0; kc < 3; ++kc) {
    jk[kc] = ring_row<kKRing>(qb - kHalo + 16 * kc);
  }
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    used[nt] = live(nt, 0, hw) || live(nt, 1, hw);
  }

  float sc[6][4];
  flash::zero(sc);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4];
    flash::ldsm_x4(qf, la.at(qs, jq, kk));
#pragma unroll
    for (int kc = 0; kc < 3; ++kc) {
      if (!used[2 * kc] && !used[2 * kc + 1]) continue;
      uint32_t b[4];
      flash::ldsm_x4(b, lb.at(ks, jk[kc], kk));
      if (used[2 * kc]) flash::mma_bf16(sc[2 * kc], qf, b[0], b[1]);
      if (used[2 * kc + 1]) flash::mma_bf16(sc[2 * kc + 1], qf, b[2], b[3]);
    }
  }

  // The band is |offset| <= hw, which always holds the query's own key.
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
      const float e =
          live(nt, r >> 1, hw) ? expf(sc[nt][r] - mx[r >> 1]) : 0.f;
      sc[nt][r] = e;
      den[r >> 1] += e;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
  // p = e / den in the live slots, rounded to bf16.
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (live(nt, r >> 1, hw)) sc[nt][r] /= den[r >> 1];
    }
  }

  float o[D / 8][4];
  flash::zero(o);
#pragma unroll
  for (int kc = 0; kc < 3; ++kc) {
    if (!used[2 * kc] && !used[2 * kc + 1]) continue;
    // p as the A operand of P V.
    const uint32_t pa[4] = {
        flash::pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
        flash::pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
        flash::pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
        flash::pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      flash::ldsm_x4_trans(b, la.at(vs, jk[kc], np));
      flash::mma_bf16(o[2 * np], pa, b[0], b[1]);
      flash::mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
    }
  }
  store_rows<D, 0, D / 8>(out, o, qs, jq, qb, n, lane);
}

// Positions [p0, p0 + N) of the line's K and V into their rings.
template <int D, int N, bool kTiles>
__device__ __forceinline__ void issue_kv(bf16* ks, bf16* vs,
                                         const Line<bf16, D, kTiles>& ln,
                                         int p0, int tid) {
  issue_rows<D, N, kThreads, kKRing>(ks, ln.k, p0, ln.lo, ln.hi, !kTiles,
                                     tid);
  issue_rows<D, N, kThreads, kKRing>(vs, ln.v, p0, ln.lo, ln.hi, !kTiles,
                                     tid);
}

// n: the queries of a line (K6: S; K8: t); steps = ceil(n / 64) a line.
template <int D, bool kTiles>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 2)
    tile_band_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int n, int steps, long long units, int hw,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kQRing * D;
  bf16* vs = ks + kKRing * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long blocks = gridDim.x;
  long long u = units * blockIdx.x / blocks;
  const long long u_end = units * (blockIdx.x + 1) / blocks;

  while (u < u_end) {
    // One segment: steps [i0, i1) of one line.
    const long long line = u / steps;
    const int i0 = static_cast<int>(u - line * steps);
    const int i1 = static_cast<int>(
        min(static_cast<long long>(steps), i0 + (u_end - u)));
    u += i1 - i0;
    const Line<bf16, D, kTiles> ln(q, k, v, out, line, n);

    __syncthreads();  // the previous segment's last step is done
    const int t0 = i0 * kStep;
    issue_kv<D, kStep + 2 * kHalo>(ks, vs, ln, t0 - kHalo, tid);
    issue_rows<D, kStep, kThreads, kQRing>(qs, ln.q, t0, 0, n, false, tid);
    band_stage::cp_async_commit();

    for (int i = i0; i < i1; ++i) {
      const int t = i * kStep;
      band_stage::cp_async_wait<0>();
      __syncthreads();
      // The next step's rows go to ring rows that only the step before
      // this one read: K and V [t + 80, t + 144) to those of
      // [t - 80, t - 16), Q [t + 64, t + 128) to those of [t - 64, t).
      if (i + 1 < i1) {
        issue_kv<D, kStep>(ks, vs, ln, t + kStep + kHalo, tid);
        issue_rows<D, kStep, kThreads, kQRing>(qs, ln.q, t + kStep, 0, n,
                                               false, tid);
        band_stage::cp_async_commit();
      }
      band_step<D>(qs, ks, vs, ln.out, t + 16 * warp, n, hw, scale, lane);
    }
  }
}

// --- f32: scalar FMA, a thread per query ------------------------------------

// Block b takes queries [64 (b % per_line), + 64) of line b / per_line.
template <int D, bool kTiles>
__global__ void __launch_bounds__(kBQ)
    tile_band_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int n, int per_line, int hw, float scale) {
  const int r = (blockIdx.x % per_line) * kBQ + threadIdx.x;
  if (r >= n) return;
  const Line<float, D, kTiles> ln(q, k, v, out, blockIdx.x / per_line, n);
  float qr[D];
  flash::load_row<D>(qr, ln.q + static_cast<int64_t>(r) * D, true);
  const int nb = 2 * hw + 1;
  const auto key = [&](int o) {
    return static_cast<int64_t>(min(max(r + o - hw, ln.lo), ln.hi - 1)) * D;
  };
  float lg[kMaxBand];
  float mx = -INFINITY;
  for (int o = 0; o < nb; ++o) {
    const float* kr = ln.k + key(o);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) dot += qr[c] * kr[c];
    lg[o] = dot * scale;
    mx = fmaxf(mx, lg[o]);
  }
  float den = 0.f;
  for (int o = 0; o < nb; ++o) {
    lg[o] = expf(lg[o] - mx);
    den += lg[o];
  }
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int o = 0; o < nb; ++o) {
    const float p = lg[o] / den;
    const float* vr = ln.v + key(o);
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] += p * vr[c];
  }
  flash::store_row<D>(ln.out + static_cast<int64_t>(r) * D, acc);
}

// `lines` lines of n queries: K6's (b*h) rows, K8's tiles.
template <int D, bool kTiles>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int64_t lines, int n, int hw, bool is_bf16, float scale,
                     int device, cudaStream_t stream) {
  if (!is_bf16) {
    const int per_line = (n + kBQ - 1) / kBQ;
    const int64_t blocks = lines * per_line;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    tile_band_fwd_f32<D, kTiles><<<static_cast<unsigned>(blocks), kBQ, 0,
                                   stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), n, per_line,
        hw, scale);
    return cudaGetLastError();
  }
  constexpr int kSmem = smem_bytes<D>();
  // Blocks an SM, found once: the attributes first (all the SM's shared
  // memory for shared memory), then the occupancy (0 if any step fails).
  static const int per_sm = [] {
    int b = 0;
    if (cudaFuncSetAttribute(tile_band_fwd_mma<D, kTiles>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess ||
        cudaFuncSetAttribute(tile_band_fwd_mma<D, kTiles>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, tile_band_fwd_mma<D, kTiles>, kThreads, kSmem) !=
            cudaSuccess) {
      return 0;
    }
    return b;
  }();
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int steps = (n + kStep - 1) / kStep;
  const int64_t units = lines * steps;
  const int64_t blocks = std::min<int64_t>(
      (units + kMinUnits - 1) / kMinUnits, static_cast<int64_t>(sms) * per_sm);
  tile_band_fwd_mma<D, kTiles><<<static_cast<unsigned>(blocks), kThreads,
                                 kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, steps, units,
      hw, scale);
  return cudaGetLastError();
}

template <bool kTiles>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t lines, int n, int d, int hw, int is_bf16, float scale,
           int device, void* stream) {
  if (lines <= 0 || n < 1 || hw < 0 || hw > kHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bf = is_bf16 != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      err = launch_d<16, kTiles>(q, k, v, out, lines, n, hw, bf, scale,
                                 device, st);
      break;
    case 32:
      err = launch_d<32, kTiles>(q, k, v, out, lines, n, hw, bf, scale,
                                 device, st);
      break;
    case 64:
      err = launch_d<64, kTiles>(q, k, v, out, lines, n, hw, bf, scale,
                                 device, st);
      break;
    case 128:
      err = launch_d<128, kTiles>(q, k, v, out, lines, n, hw, bf, scale,
                                  device, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
  return launch<false>(q, k, v, out, rows, s, d, hw, is_bf16, scale, device,
                       stream);
}

// K8: q and out are [rows, n_t, t, d] query tiles, k and v
// [rows, n_t, t + 32, d] window tiles.
extern "C" int mhla_tile_band_fwd_tiles(const void* q, const void* k,
                                        const void* v, void* out,
                                        long long rows, int n_t, int t, int d,
                                        int hw, int is_bf16, float scale,
                                        int device, void* stream) {
  if (n_t < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, k, v, out, rows * n_t, t, d, hw, is_bf16, scale,
                      device, stream);
}

// Dynamic shared memory of the bf16 kernels at head dim d (-1 for a d they
// do not take), for the build report.
extern "C" int mhla_tile_band_fwd_smem(int d) {
  switch (d) {
    case 16:
      return smem_bytes<16>();
    case 32:
      return smem_bytes<32>();
    case 64:
      return smem_bytes<64>();
    case 128:
      return smem_bytes<128>();
    default:
      return -1;
  }
}

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
// [B*h, n_t, t + 2 halo, d] (row c of tile i is position i*t + c - halo,
// clamped; halo = 16 up to W = 33, JAX's _halo past it)
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
// The f32 calls take one scalar-FMA kernel, a thread per query reading its
// 2 hw + 1 keys from device memory, in 32-column output slices at every hw
// and head dim: full f32 products, for parity runs, not for speed.
//
// Range. The design above (the ring kernel) takes hw <= 16 and the head
// dims 16, 32, 64 and 128, the MHLA-B/4, E5 and E6 paths'. The card takes
// JAX's v4 range beyond it, every W and every head dim that is a multiple
// of 8, at JAX's halo (hw rounded up to a multiple of 16, at least 16; K8's
// window tiles have t + 2 halo rows): up to hw = 64 (W = 129) and d = 256
// the wide kernel below (tile_band_fwd_wide: one 64-query step a block, its
// whole band staged at d's tile width, flash_common.cuh tile_width, zeros
// past d, walked in 48-key chunks in two passes); past either limit, and at
// d > 128 with W = 128 or 129, the wgmma kernel (tile_band_fwd_sm90: Q kept
// in shared memory where it fits, K and V by TMA through a deep ring, the
// products on wgmma, output slices of at most 256 columns after one
// statistics pass; tile_ring.cuh sm90_takes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#include "band_stage.cuh"
#include "flash_common.cuh"
#include "tile_band_sm90.cuh"
#include "tile_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace tile_ring;

constexpr int kHalo = 16;          // the ring kernel's halo: hw <= 16
constexpr int kStep = 64;          // queries a step owns
constexpr int kKRing = 160;        // rows of the K and V rings
constexpr int kQRing = 128;        // rows of the Q ring
constexpr int kThreads = 128;      // 4 warps of 16 queries
constexpr int kMinUnits = 8;       // steps a block takes at least
constexpr int kBQ = 64;            // queries an f32 block

template <int D>
constexpr int smem_bytes() {
  return (kQRing + 2 * kKRing) * D * 2;
}

// The wide kernel's: 64 Q rows and 64 + 2 halo rows of each of K and V.
constexpr int wide_smem_bytes(int d_tile, int halo) {
  return (kStep + 2 * (kStep + 2 * halo)) * d_tile * 2;
}

// One line, the unit the kernels walk along: K6 (kTiles false) a (b*h) row
// of [n, d] q, k, v, out; K8 (kTiles true) one tile, query and output rows
// [0, n) of [n, d] tiles and the n + 2 halo rows of its [n + 2 halo, d]
// window tiles. Key position p (query r reads positions r - hw..r + hw) is
// at k + p d for p in [lo, hi); outside it, K6's clamped band reads the
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
                  long long line, int n, int d = D, int halo = kHalo) {
    const int64_t base = line * static_cast<int64_t>(n) * d;
    q = q_ + base;
    out = out_ + base;
    if (kTiles) {
      // Window row `halo` is position 0.
      const int64_t kbase =
          line * static_cast<int64_t>(n + 2 * halo) * d + halo * d;
      k = k_ + kbase;
      v = v_ + kbase;
      lo = -halo;
      hi = n + halo;
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

// --- bf16, any halo and tile width: one 64-query step a block -------------
//
// The ring kernel above keeps a 16-row halo and the head dims 16, 32, 64
// and 128. Every other (hw, d) the card takes (hw <= 64, d a multiple of 8
// up to 256) runs here, at JAX's halo (16, 32, 48 or 64) and d's tile width
// D (16, 32, 64, 80, 128, 192, 256; zeros past d): a block stages one
// step's 64 Q rows and the 64 + 2 halo K and V rows its band reads (at
// D = 256 and halo 64 that is 224 KB, so there is no second step in flight,
// and a block does one step), then each warp walks its 16 queries' band,
// 16 + 2 halo keys, in chunks of 48 keys in two passes: the first forms the
// logits and keeps a running maximum and sum of exponentials, the second
// forms them again and takes p = e / sum, rounded to bf16, into P V. So p
// is the normalised weight rounded once, as in the ring kernel and the TPU
// kernel, and the registers hold one chunk's logits whatever the window.
// Each step re-reads 2 halo rows of K and V (three reads of each row at
// halo 64): simple, not the bound.

// The logits of chunk ch (keys [qb - halo + 48 ch, + 48)) of a warp's 16
// queries, -inf outside the band |offset| <= hw; blocks that meet no query's
// band are skipped (their slots are -inf either way).
template <int D>
__device__ __forceinline__ void wide_logits(const bf16* qs, const bf16* ks,
                                            int jq, int ch, int halo, int hw,
                                            float scale, int lane,
                                            float (&sc)[6][4]) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const LaneAddr<D> la = pattern_a<D>(lane);
  const LaneAddr<D> lb = pattern_b<D>(lane);
  bool used[3];
#pragma unroll
  for (int kc = 0; kc < 3; ++kc) {
    used[kc] = block_live(16 * (3 * ch + kc) - halo, hw);
  }
  flash::zero(sc);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4];
    flash::ldsm_x4(qf, la.at(const_cast<bf16*>(qs), jq, kk));
#pragma unroll
    for (int kc = 0; kc < 3; ++kc) {
      if (!used[kc]) continue;
      uint32_t b[4];
      flash::ldsm_x4(b, lb.at(const_cast<bf16*>(ks), jq + 48 * ch + 16 * kc,
                              kk));
      flash::mma_bf16(sc[2 * kc], qf, b[0], b[1]);
      flash::mma_bf16(sc[2 * kc + 1], qf, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = 48 * ch + nt * 8 + 2 * t4 + (r & 1) -
                      (g + 8 * (r >> 1)) - halo;
      sc[nt][r] = (off >= -hw && off <= hw) ? sc[nt][r] * scale : -INFINITY;
    }
  }
}

template <int D, bool kTiles>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
    tile_band_fwd_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int n, int steps, int d, int hw, int halo,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kStep * D;
  bf16* vs = ks + (kStep + 2 * halo) * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long line = blockIdx.x / steps;
  const int t = static_cast<int>(blockIdx.x % steps) * kStep;
  const Line<bf16, D, kTiles> ln(q, k, v, out, line, n, d, halo);
  // Q [t, t + 64) to rows 0..63; K and V [t - halo, t + 64 + halo) to rows
  // 0..63 + 2 halo.
  issue_rows_n<D>(qs, ln.q, t, kStep, 0, n, false, tid, kThreads, d);
  issue_rows_n<D>(ks, ln.k, t - halo, kStep + 2 * halo, ln.lo, ln.hi,
                  !kTiles, tid, kThreads, d);
  issue_rows_n<D>(vs, ln.v, t - halo, kStep + 2 * halo, ln.lo, ln.hi,
                  !kTiles, tid, kThreads, d);
  band_stage::cp_async_commit();
  band_stage::cp_async_wait<0>();
  __syncthreads();

  const int qb = t + 16 * warp;
  if (qb >= n) return;
  const int jq = 16 * warp;  // the warp's Q rows; its keys start there too
  const int nch = (16 + 2 * halo + 47) / 48;
  float sc[6][4];

  // Pass 1: the running maximum and sum of exponentials of rows g, g + 8
  // (every lane of a quad holds the same maximum, its own share of the sum).
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int ch = 0; ch < nch; ++ch) {
    if (!wide_chunk_live(ch, halo, hw)) continue;
    wide_logits<D>(qs, ks, jq, ch, halo, hw, scale, lane, sc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        mx = fmaxf(mx, fmaxf(sc[nt][2 * h], sc[nt][2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      if (m_new == -INFINITY) continue;  // no key of this row yet
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        sum += expf(sc[nt][2 * h] - m_new) + expf(sc[nt][2 * h + 1] - m_new);
      }
      l[h] = l[h] * expf(m[h] - m_new) + sum;
      m[h] = m_new;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // Pass 2: p = e / l, rounded to bf16, into out = P V.
  float o[D / 8][4];
  flash::zero(o);
  for (int ch = 0; ch < nch; ++ch) {
    if (!wide_chunk_live(ch, halo, hw)) continue;
    wide_logits<D>(qs, ks, jq, ch, halo, hw, scale, lane, sc);
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[nt][r];
        sc[nt][r] = x == -INFINITY ? 0.f : expf(x - m[r >> 1]) / l[r >> 1];
      }
    }
    const LaneAddr<D> la = pattern_a<D>(lane);
#pragma unroll
    for (int kc = 0; kc < 3; ++kc) {
      if (!block_live(16 * (3 * ch + kc) - halo, hw)) continue;
      const uint32_t pa[4] = {
          flash::pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
          flash::pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
          flash::pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
          flash::pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        flash::ldsm_x4_trans(bv, la.at(vs, jq + 48 * ch + 16 * kc, np));
        flash::mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        flash::mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }
  // The warp's Q rows are dead: stage its results there.
  store_rows<D, 0, D / 8>(ln.out, o, qs, jq, qb, n, lane, d);
}

// --- bf16 past the wide kernel's range: the wgmma band -------------------
//
// Past hw = 64 (W = 129) or d = 256, and at d > 128 with hw = 64
// (tile_ring.cuh sm90_takes), at JAX's halo. A block owns the 64 queries
// [t, t + 64) of a line and walks the keys [t - halo, t + 64 + halo) in
// chunks of 64 (tile_band_sm90.cuh):
//   - one thread of a producer warp loads the block's Q once by TMA
//     (ceil(d / 64) tiles of 64 x 64, kept for the whole block), then
//     streams K and V tiles (64 keys x 64 columns) by TMA through a ring of
//     up to 16 stages, each on its own mbarrier; K6's positions outside
//     [0, S) arrive as zeros, K8's come from its window tile. Where Q does
//     not fit beside the ring (d past 1472), its tile c streams through
//     the ring just before each K tile c instead (keep_q = 0);
//   - one consumer warpgroup forms a chunk's 64 x 64 logits on wgmma
//     (m64n64k16, Q and K from shared memory) over d's 16-column steps
//     only (d = 80: five steps), one committed group a tile, releasing each
//     K tile as soon as the product after it is issued;
//   - two passes, as the TPU kernel's softmax: the first keeps each query's
//     running maximum and sum of exponentials (in log2 units, the scale
//     folded in), the second forms the logits again and takes p = e / sum
//     (times the sum's reciprocal), rounded to bf16, from registers as the A
//     operand of out += P V (V tiles read MN-major), so p is the normalised
//     weight rounded once. A block owns every output column up to d = 256
//     (an accumulator of 64 x 256 f32 on one warpgroup); past that d runs
//     in equal slices of at most 256 columns, each forming the logits once
//     after the one statistics pass, the first slice keeping its bf16
//     weights in shared memory for the others (64 x (64 + 2 halo) a block,
//     where they fit), which then read V alone: the logits are formed twice
//     a query whatever d (7 times at d = 768 in the streamed kernel this
//     replaced). Only chunks that cross some row's band edge are masked;
//   - K6's clamped band: a block whose chunks leave the line keeps row 0
//     and row S - 1 of K and V; each query's logit against them (lo, hi)
//     takes the place of the zero rows' at positions outside [0, S), and
//     the weights there, rounded to bf16 and summed (wl, wh), add
//     wl v_0 + wh v_{S-1} to its output: the same sum as the clamped rows'
//     terms one by one, without a copy of a row.
// A 64-query tile over the keys [t - halo, t + 64 + halo) also forms the
// logits of keys outside every query's band (128 keys for a band of 15 at
// W = 7); at small windows and at d <= 128 the wide kernel above, which
// stages exactly the band at d's width, stays faster. What bounds this one
// (PERF.md section 6): the consumer's chain of waits, products and softmax a
// chunk and the tiles a block reads (K twice and V once, 64 + 2 halo rows,
// from L2 for the most part), at two blocks an SM up to slice width 128.

// Maps (tile_band_sm90.cuh): tq over the [lines, n, d] queries, tk and tv
// over the keys and values (K6: [lines, n, d], positions outside [0, n)
// arriving as zeros, and tk1, tv1 the same with one-row boxes for the edge
// rows; K8: the [lines, n + 2 halo, d] window tiles, whose row p + halo is
// position p); q itself for K6's logits against the edge rows. keep_q: Q
// kept in shared memory, else streamed through the ring.
template <int NO, bool kTiles>
__global__ void __launch_bounds__(tb90::kThreads, NO <= 128 ? 2 : 1)
    tile_band_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tk1,
                       const __grid_constant__ CUtensorMap tv1,
                       const bf16* __restrict__ q, bf16* __restrict__ out,
                       int n, int steps, int d, int hw, int halo, int ns,
                       int keep_q, int keep_p, float scale) {
  namespace hp = hopper;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * tb90::kMaxStages + 2];
  uint8_t* smem = hp::align1024(smem_raw);
  const int nd = tb90::col_tiles(d);
  const int nk = (kStep + 2 * halo + 63) / 64;
  const int nq = keep_q ? nd : 0;  // kept tiles of Q
  bf16* qs = reinterpret_cast<bf16*>(smem);
  // With keep_p, the first slice's weights (one 64 x 64 tile a chunk) stay
  // for the other slices, which then read V alone.
  bf16* ps = qs + nq * tb90::kTileElems;
  const tb90::Ring ring = tb90::make_ring(
      smem, (nq + (keep_p ? nk : 0)) * tb90::kTileBytes, bars, ns);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int line = static_cast<int>(blockIdx.x / steps);
  const int t = static_cast<int>(blockIdx.x % steps) * kStep;
  const int k0 = t - halo;
  const int n_sl = (d + NO - 1) / NO;
  // K6's chunks that leave the line: their positions outside [0, n) are
  // copies of row 0 or n - 1 (the clamped band), which the consumers add
  // from the edge rows.
  const bool clamped = !kTiles && (k0 < 0 || k0 + 64 * nk > n);
  const tb90::Edges ed = ring.edge_rows(d);

  if (warp == tb90::kConsumers / 32) {
    // The producer warp: Q (one thread, with keep_q), K6's edge rows where
    // its chunks leave the line, then pass 0's K tiles and each slice's K
    // (the first slice's only, with keep_p; each after its Q tile without
    // keep_q) and V.
    if (keep_q && lane == 0) {
      hp::mbar_arrive_expect_tx(ring.kept, nd * tb90::kTileBytes);
      for (int c = 0; c < nd; ++c) {
        hp::tma_load_3d(qs + c * tb90::kTileElems, &tq, ring.kept, 64 * c, t,
                        line);
      }
    }
    if (clamped) tb90::load_edges(ed, &tk1, &tv1, ring.edges, n, line, lane);
    int i = 0;
    auto load = [&](int x, int c, int kj) {
      if (x == 0 && !keep_q) {
        tb90::load_full(ring.tile(i), &tq, ring.acquire(i), 64 * c, t, line,
                        lane);
        ++i;
      }
      tb90::load_full(ring.tile(i), x ? &tv : &tk, ring.acquire(i), 64 * c,
                      kTiles ? kj + halo : kj, line, lane);
      ++i;
    };
    for (int pass = 0; pass <= n_sl; ++pass) {
      const int c0 = (pass - 1) * NO;
      const int nv = pass == 0 ? 0 : min(NO / 64, tb90::col_tiles(d - c0));
      for (int j = 0; j < nk; ++j) {
        const int kj = k0 + 64 * j;
        if (pass < 2 || !keep_p) {
          for (int c = 0; c < nd; ++c) load(0, c, kj);
        }
        for (int vb = 0; vb < nv; ++vb) load(1, c0 / 64 + vb, kj);
      }
    }
    return;
  }

  // The consumer warpgroup: this thread holds query rows r and r + 8,
  // columns 8 j + 2 wq (+1) of each 64-column accumulator.
  const int g8 = (lane >> 2) + 16 * warp;  // rows g8, g8 + 8 of the 64
  const int wq = lane & 3;
  const int r = t + g8;
  float sc[32];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  int i = 0;
  if (keep_q) hp::mbar_wait(ring.kept, 0);
  const float scale2 = scale * 1.4426950408889634f;
  // A clamped block's logits of rows r, r + 8 against row 0 (lo) and row
  // n - 1 (hi) of K, in log2 units: every position outside [0, n) in the
  // band takes one of them.
  float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};
  if (clamped) {
    hp::mbar_wait(ring.edges, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // A query past n has a zero row (its logits 0), as the tiles hold.
      const int qi = t + g8 + 8 * h;
      const bf16* qr = q + (static_cast<int64_t>(line) * n + qi) * d;
      for (int c = 2 * wq; c < d && qi < n; c += 8) {
        const float2 x = tb90::row_pair(qr, c);
        const float2 a = tb90::edge_pair(ed, 0, 0, c);
        const float2 b = tb90::edge_pair(ed, 0, 1, c);
        lo[h] += x.x * a.x + x.y * a.y;
        hi[h] += x.x * b.x + x.y * b.y;
      }
      lo[h] += __shfl_xor_sync(0xffffffffu, lo[h], 1);
      lo[h] += __shfl_xor_sync(0xffffffffu, lo[h], 2);
      hi[h] += __shfl_xor_sync(0xffffffffu, hi[h], 1);
      hi[h] += __shfl_xor_sync(0xffffffffu, hi[h], 2);
      lo[h] *= scale2;
      hi[h] *= scale2;
    }
  }

  // The logits of chunk j into sc, in log2 units (scaled by d^-1/2 log2 e),
  // -inf off the band |key - query| <= hw; a chunk inside every row's band
  // needs no mask. K6's positions outside [0, n) take lo and hi. Each
  // product reads `per` ring items (K, after its Q tile without keep_q),
  // released once the product after it has been issued.
  const int per = keep_q ? 1 : 2;
  auto logits = [&](int j) {
    hp::fence_regs(sc);
    for (int c = 0; c < nd; ++c, ++i) {
      const bf16* a = qs + c * tb90::kTileElems;
      if (!keep_q) {
        ring.wait(i);
        a = ring.tile(i++);
      }
      ring.wait(i);
      hp::wgmma_fence();
      tb90::tile_product<0, 0>(sc, a, ring.tile(i), tb90::steps_of(d, c),
                               c > 0);
      hp::wgmma_commit();
      if (c > 0) {
        hp::wgmma_wait<1>();
        ring.release_last(i - per, per, lane);
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    ring.release_last(i - 1, per, lane);
    const int kj = k0 + 64 * j;
    if (kj + 63 - t <= hw && t + 63 - kj <= hw) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale2;
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int off = kj + (e >> 2) * 8 + 2 * wq + (e & 1) -
                        (r + 8 * ((e >> 1) & 1));
        sc[e] = (off >= -hw && off <= hw) ? sc[e] * scale2 : -INFINITY;
      }
    }
    if (clamped && (kj < 0 || kj + 64 > n)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = kj + (e >> 2) * 8 + 2 * wq + (e & 1);
        const int h = (e >> 1) & 1;
        if (sc[e] != -INFINITY && (key < 0 || key >= n)) {
          sc[e] = key < 0 ? lo[h] : hi[h];
        }
      }
    }
  };

  // Pass 0: the running maximum and sum of exponentials of rows r, r + 8
  // (every lane of a quad holds the maximum, its own share of the sum).
  for (int j = 0; j < nk; ++j) {
    logits(j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int e = 2 * h; e < 32; e += 4) {
        mx = fmaxf(mx, fmaxf(sc[e], sc[e + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      if (m_new == -INFINITY) continue;  // no key of this row yet
      float sum = 0.f;
#pragma unroll
      for (int e = 2 * h; e < 32; e += 4) {
        sum += exp2f(sc[e] - m_new) + exp2f(sc[e + 1] - m_new);
      }
      l[h] = l[h] * exp2f(m[h] - m_new) + sum;
      m[h] = m_new;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / l[h];  // from here on the sum's reciprocal
  }

  // Each slice: p = e / sum, rounded to bf16, into out = P V. A clamped
  // block's weights at positions below 0 (wl) and past n - 1 (wh), each
  // rounded to bf16 and summed over them in the first slice, add
  // wl v_0 + wh v_{n-1} to every slice (the tiles hold zeros there).
  float wl[2] = {0.f, 0.f}, wh[2] = {0.f, 0.f};
  for (int sl = 0; sl < n_sl; ++sl) {
    const int c0 = sl * NO;
    const int nv = min(NO / 64, tb90::col_tiles(d - c0));
    // Only slice widths past 128 (d > 256) have more than one slice.
    bool kept = false;
    if constexpr (NO > 128) kept = keep_p && sl > 0;
    float o[NO / 2];
#pragma unroll
    for (int e = 0; e < NO / 2; ++e) o[e] = 0.f;
    if (kept && sl == 1) {
      // Slice 0's weights, written by every warp, before wgmma reads them.
      hp::fence_proxy_async();
      hp::named_sync(tb90::kConsumerBar, tb90::kConsumers);
    }
    for (int j = 0; j < nk; ++j) {
      const bf16* pt = ps + j * tb90::kTileElems;
      uint32_t pa[4][4];
      if (!kept) {
        logits(j);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          sc[e] = exp2f(sc[e] - m[(e >> 1) & 1]) * l[(e >> 1) & 1];
        }
        const int kj = k0 + 64 * j;
        if (clamped && sl == 0 && (kj < 0 || kj + 64 > n)) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int key = kj + (e >> 2) * 8 + 2 * wq + (e & 1);
            const float pr = __bfloat162float(__float2bfloat16(sc[e]));
            if (key < 0) wl[(e >> 1) & 1] += pr;
            if (key >= n) wh[(e >> 1) & 1] += pr;
          }
        }
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) hp::pack_a(pa[kc], sc, kc);
        if (NO > 128 && keep_p) {
          // The A operand's K-major tile (wgmma layout, 128-byte swizzle).
          uint8_t* pb = reinterpret_cast<uint8_t*>(ps + j * tb90::kTileElems);
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int col = 16 * kc + 8 * (x >> 1) + 2 * wq;
              *reinterpret_cast<uint32_t*>(
                  pb + hp::swizzle128_offset<64>(g8 + 8 * (x & 1), col)) =
                  pa[kc][x];
            }
          }
        }
      }
      hp::fence_regs(o);
      if (!kept) hp::fence_regs(pa);
#pragma unroll
      for (int vb = 0; vb < NO / 64; ++vb) {
        if (vb >= nv) break;
        ring.wait(i);
        hp::wgmma_fence();
        if (kept) {
          tb90::tile_product<0, 1>(hp::slice<32>(o, 32 * vb), pt,
                                   ring.tile(i), 4, true);
        } else {
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            hp::Wgmma<64>::rs(hp::slice<32>(o, 32 * vb), pa[kc],
                              tb90::desc_mn(ring.tile(i), kc), 1);
          }
        }
        hp::wgmma_commit();
        if (vb > 0) {
          hp::wgmma_wait<1>();
          ring.release(i - 1, lane);
        }
        ++i;
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
      if (!kept) hp::fence_regs(pa);
      ring.release(i - 1, lane);
    }
    if (clamped) {
      if (sl == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wl[h] += __shfl_xor_sync(0xffffffffu, wl[h], 1);
          wl[h] += __shfl_xor_sync(0xffffffffu, wl[h], 2);
          wh[h] += __shfl_xor_sync(0xffffffffu, wh[h], 1);
          wh[h] += __shfl_xor_sync(0xffffffffu, wh[h], 2);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NO / 8; ++jj) {
        const int col = c0 + 8 * jj + 2 * wq;
        if (col >= d) break;
        const float2 a = tb90::edge_pair(ed, 1, 0, col);
        const float2 b = tb90::edge_pair(ed, 1, 1, col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * jj + 2 * h] += wl[h] * a.x + wh[h] * b.x;
          o[4 * jj + 2 * h + 1] += wl[h] * a.y + wh[h] * b.y;
        }
      }
    }
    tb90::store_acc<NO>(out + static_cast<int64_t>(line) * n * d, o, t, c0, n,
                        d, tid);
  }
}

// --- f32: scalar FMA, a thread per query ------------------------------------

// Rows of d floats (d a multiple of 4).
__device__ __forceinline__ float row_dot(const float* a, const float* b,
                                         int d) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return acc;
}

// Block b takes queries [64 (b % per_line), + 64) of line b / per_line and
// the kF32Slice output columns of blockIdx.y, at any hw and head dim: for
// each of the 2 hw + 1 positions of its band the logit over all of d, in
// two passes: the maximum and the sum of exponentials first (running), then
// p = e / sum in f32, as the plain version's softmax, into the slice's sum
// in the band's order. The sums are f64, rounded once, as the
// plain version's: a running f32 sum over hundreds of band terms drifts
// about as far as the f32 rule allows. Every slice forms the logits
// again. Full f32 products, for parity runs, not for speed.
constexpr int kF32Slice = 32;  // f64 sums: 64 registers

template <bool kTiles>
__global__ void __launch_bounds__(kBQ)
    tile_band_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int n, int per_line, int d, int hw, int halo,
                      float scale) {
  const int r = (blockIdx.x % per_line) * kBQ + threadIdx.x;
  if (r >= n) return;
  const Line<float, 0, kTiles> ln(q, k, v, out, blockIdx.x / per_line, n, d,
                                  halo);
  const int c0 = blockIdx.y * kF32Slice;
  const int nv = min(kF32Slice, d - c0);
  const float* qr = ln.q + static_cast<int64_t>(r) * d;
  const auto key = [&](int o) {
    return static_cast<int64_t>(min(max(r + o, ln.lo), ln.hi - 1)) * d;
  };
  float m = -INFINITY;
  double sum = 0.0;
  for (int o = -hw; o <= hw; ++o) {
    const float x = row_dot(qr, ln.k + key(o), d) * scale;
    const float m_new = fmaxf(m, x);
    sum = sum * expf(m - m_new) + expf(x - m_new);  // 0 * 0 at the first
    m = m_new;
  }
  const float den = static_cast<float>(sum);
  double acc[kF32Slice];
#pragma unroll
  for (int c = 0; c < kF32Slice; ++c) acc[c] = 0.0;
  for (int o = -hw; o <= hw; ++o) {
    const double p = expf(row_dot(qr, ln.k + key(o), d) * scale - m) / den;
    const float* vr = ln.v + key(o) + c0;
#pragma unroll
    for (int c = 0; c < kF32Slice; c += 4) {
      if (c >= nv) break;
      const float4 y = *reinterpret_cast<const float4*>(vr + c);
      acc[c] += p * y.x;
      acc[c + 1] += p * y.y;
      acc[c + 2] += p * y.z;
      acc[c + 3] += p * y.w;
    }
  }
  float* dst = ln.out + static_cast<int64_t>(r) * d + c0;
#pragma unroll
  for (int c = 0; c < kF32Slice; c += 4) {
    if (c >= nv) break;
    *reinterpret_cast<float4*>(dst + c) = make_float4(
        static_cast<float>(acc[c]), static_cast<float>(acc[c + 1]),
        static_cast<float>(acc[c + 2]), static_cast<float>(acc[c + 3]));
  }
}

// The f32 kernel over `lines` lines of n queries.
template <bool kTiles>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int64_t lines, int n, int d, int hw, float scale,
                       cudaStream_t stream) {
  const int per_line = (n + kBQ - 1) / kBQ;
  const int64_t blocks = lines * per_line;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks),
                  (d + kF32Slice - 1) / kF32Slice);
  tile_band_fwd_f32<kTiles><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, per_line, d,
      hw, halo_of(hw), scale);
  return cudaGetLastError();
}

// The wgmma kernel's shared memory at slice width no: two blocks an SM up
// to no = 128 (at 192 the accumulator spills under two blocks' register
// cap); Q kept (keep_q) where that leaves the ring tb90::kMinStages
// stages, else streamed through it (tb90::kStreamStages); past one slice
// the first slice's weights kept (keep_p) where the ring keeps its least
// stages beside them. `resident` is the kept tiles' bytes (Q's, and the
// weights').
inline void sm90_plan(int d, int hw, int no, int* keep_q, int* keep_p,
                      int* ns, int* resident) {
  const int per_sm = no <= 128 ? 2 : 1;
  const int edges = tb90::edge_bytes(d);
  *keep_q = tb90::ring_stages(tb90::col_tiles(d) * tb90::kTileBytes + edges,
                              per_sm) > 0;
  const int q = *keep_q ? tb90::col_tiles(d) * tb90::kTileBytes : 0;
  const int least = *keep_q ? tb90::kMinStages : tb90::kStreamStages;
  const int w = (kStep + 2 * halo_of(hw) + 63) / 64 * tb90::kTileBytes;
  *keep_p = d > no && tb90::ring_stages(q + w + edges, per_sm, least) > 0;
  *resident = q + (*keep_p ? w : 0);
  *ns = tb90::ring_stages(*resident + edges, per_sm, least);
}

// The wgmma kernel at output slices of NO columns: its maps, then the
// launch. K8's window tiles hold n + 2 halo rows a line.
template <int NO, bool kTiles>
cudaError_t launch_sm90_no(const void* q, const void* k, const void* v,
                           void* out, int64_t lines, int n, int d, int hw,
                           float scale, cudaStream_t stream) {
  if (lines > INT32_MAX) return cudaErrorInvalidConfiguration;
  const int halo = halo_of(hw);
  const int nk = kTiles ? n + 2 * halo : n;  // rows of a K or V line
  CUtensorMap tq, tk, tv, tk1, tv1;
  cudaError_t err = tb90::map_rows(&tq, q, lines, n, d, 64);
  const void* src[4] = {k, v, k, v};
  CUtensorMap* dst[4] = {&tk, &tv, &tk1, &tv1};
  for (int x = 0; x < 4 && err == cudaSuccess; ++x) {
    err = tb90::map_rows(dst[x], src[x], lines, nk, d, x < 2 ? 64 : 1);
  }
  if (err != cudaSuccess) return err;
  int keep_q = 0, keep_p = 0, ns = 0, resident = 0;
  sm90_plan(d, hw, NO, &keep_q, &keep_p, &ns, &resident);
  if (ns == 0) return cudaErrorInvalidConfiguration;
  const int smem = tb90::smem_bytes(resident, ns, tb90::edge_bytes(d));
  err = cudaFuncSetAttribute(tile_band_fwd_sm90<NO, kTiles>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int steps = (n + kStep - 1) / kStep;
  const int64_t blocks = lines * steps;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  tile_band_fwd_sm90<NO, kTiles>
      <<<static_cast<unsigned>(blocks), tb90::kThreads, smem, stream>>>(
          tq, tk, tv, tk1, tv1, static_cast<const bf16*>(q),
          static_cast<bf16*>(out), n, steps, d, hw, halo, ns, keep_q, keep_p,
          scale);
  return cudaGetLastError();
}

// The wgmma kernel at d's slice width (tb90::slice_width).
template <bool kTiles>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        void* out, int64_t lines, int n, int d, int hw,
                        float scale, cudaStream_t stream) {
  switch (tb90::slice_width(d)) {
    case 64:
      return launch_sm90_no<64, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                        stream);
    case 128:
      return launch_sm90_no<128, kTiles>(q, k, v, out, lines, n, d, hw,
                                         scale, stream);
    case 192:
      return launch_sm90_no<192, kTiles>(q, k, v, out, lines, n, d, hw,
                                         scale, stream);
    default:
      return launch_sm90_no<256, kTiles>(q, k, v, out, lines, n, d, hw,
                                         scale, stream);
  }
}

// The wide bf16 kernel: one block a 64-query step.
template <int D, bool kTiles>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, int64_t lines, int n, int d, int hw,
                        float scale, cudaStream_t stream) {
  const int halo = halo_of(hw);
  const int smem = wide_smem_bytes(D, halo);
  const cudaError_t err =
      cudaFuncSetAttribute(tile_band_fwd_wide<D, kTiles>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int steps = (n + kStep - 1) / kStep;
  const int64_t blocks = lines * steps;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  tile_band_fwd_wide<D, kTiles><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, steps, d, hw,
      halo, scale);
  return cudaGetLastError();
}

// `lines` lines of n queries: K6's (b*h) rows, K8's tiles; the ring kernel
// at head dim D (16, 32, 64, 128) and hw <= 16.
template <int D, bool kTiles>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int64_t lines, int n, int hw, float scale, int device,
                     cudaStream_t stream) {
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

// The ring kernel where it applies (hw <= 16 and d in 16, 32, 64, 128),
// else the wide kernel, at d's tile width D.
template <int D, bool kTiles>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* out,
                     int64_t lines, int n, int d, int hw, float scale,
                     int device, cudaStream_t stream) {
  if constexpr (D == 16 || D == 32 || D == 64 || D == 128) {
    if (d == D && hw <= kHalo) {
      return launch_d<D, kTiles>(q, k, v, out, lines, n, hw, scale, device,
                                 stream);
    }
  }
  return launch_wide<D, kTiles>(q, k, v, out, lines, n, d, hw, scale, stream);
}

// The f32 kernel at every (hw, d); in bf16 the wgmma kernel where it takes
// the call, else the ring or wide kernel.
template <bool kTiles>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t lines, int n, int d, int hw, int is_bf16, float scale,
           int device, void* stream) {
  if (lines <= 0 || n < 1 || hw < 0 || d < 8 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 == 0) {
    return static_cast<int>(
        launch_f32<kTiles>(q, k, v, out, lines, n, d, hw, scale, st));
  }
  if (sm90_takes(d, hw)) {
    return static_cast<int>(
        launch_sm90<kTiles>(q, k, v, out, lines, n, d, hw, scale, st));
  }
  switch (flash::tile_width(d)) {
    case 16:
      err = launch_w<16, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                 device, st);
      break;
    case 32:
      err = launch_w<32, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                 device, st);
      break;
    case 64:
      err = launch_w<64, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                 device, st);
      break;
    case 80:
      err = launch_w<80, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                 device, st);
      break;
    case 128:
      err = launch_w<128, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                  device, st);
      break;
    case 192:
      err = launch_w<192, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                  device, st);
      break;
    default:
      err = launch_w<256, kTiles>(q, k, v, out, lines, n, d, hw, scale,
                                  device, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launch (0 on success); the kernels allocate nothing and do not
// synchronise. Tensors are device pointers to contiguous tensors of one
// dtype (is_bf16 = 1 for bf16, 0 for f32), 16-byte aligned; hw >= 0; d is a
// multiple of 8; `stream` is the caller's cudaStream_t.
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
// [rows, n_t, t + 2 halo, d] window tiles, halo = max(16, ceil(hw / 16) 16)
// (JAX's _halo).
extern "C" int mhla_tile_band_fwd_tiles(const void* q, const void* k,
                                        const void* v, void* out,
                                        long long rows, int n_t, int t, int d,
                                        int hw, int is_bf16, float scale,
                                        int device, void* stream) {
  if (n_t < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, k, v, out, rows * n_t, t, d, hw, is_bf16, scale,
                      device, stream);
}

// Dynamic shared memory of the bf16 kernel that runs at head dim d and
// half window hw (-1 for a pair the kernels do not take), for the build
// report: the ring kernel's at hw <= 16 and d in 16, 32, 64, 128, the
// wgmma kernel's (Q's tiles and the ring) where it takes the call, else the
// wide kernel's.
extern "C" int mhla_tile_band_fwd_smem(int d, int hw) {
  if (hw < 0 || d < 8 || d % 8 != 0) return -1;
  if (sm90_takes(d, hw)) {
    int keep_q = 0, keep_p = 0, ns = 0, resident = 0;
    sm90_plan(d, hw, tb90::slice_width(d), &keep_q, &keep_p, &ns, &resident);
    return tb90::smem_bytes(resident, ns, tb90::edge_bytes(d));
  }
  const int w = flash::tile_width(d);
  if (d == w && hw <= kHalo) {
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
        break;
    }
  }
  return wide_smem_bytes(w, halo_of(hw));
}

// MHLA tile band, backward, for Hopper (sm_90a): K7.
//
// Replaces: focused_attention_vit_tpu/ops/mhla_kernel_v4.py::_bwd_kernel
// (:104; pallas_call at :255 in the custom VJP's _bwd_rule) together with
// the plain _edge_fold (:285) that _bwd_rule runs after it. Wrapper and
// plain PyTorch versions: focused_attention_vit_tpu_torch/ops/
// mhla_kernel_v4.py.
//
// What it computes, for the clamped band of mhla_tile_band_fwd.cu (query r
// reads position r + o, o = -hw..hw, at key c(r + o) = clamp(r + o, 0, S-1)),
// from q, k, v and the cotangent g, all contiguous [B*h, S, d]:
//   p_ro  = softmax_o(q_r . k_c(r+o) * d^-1/2)      (recomputed)
//   dp_ro = g_r . v_c(r+o),  ds_ro = p_ro (dp_ro - sum_o' dp_ro' p_ro') scale
//   dq_r  = sum_o ds_ro k_c(r+o)
//   dk_j  = sum_{r + o = j} ds_ro q_r,   dv_j = sum_{r + o = j} p_ro g_r
// over in-range positions j, and then JAX's edge fold: row 0 of dk gets
// sum_{r < hw} m_r q_r and of dv sum_{r < hw} n_r g_r, where m_r and n_r are
// the sums of ds_ro and p_ro over the clamped positions of query r (r + o
// outside [0, S)); row S-1 the same over r >= S - hw. Like JAX, a query
// counts all its clamped positions, on both sides, towards its edge row: at
// S > 2 hw that is the exact gradient of the clamp, below it JAX's count
// (which the plain _edge_fold shares). ds and p are rounded to the input
// dtype for the second products, as the TPU kernel rounds them; every sum,
// the fold's included, is f32 and rounded once.
//
// What bounds it on this card: bytes. At B*h = 384, S = 3137, d = 64, W = 7
// a call must read q, k, v, g and write dq, dk, dv, 1.08 GB in bf16 (0.322 ms
// at 3.35 TB/s), against 5 W d multiply-adds a query (1.7 GFLOP). The
// products run on mma.sync.m16n8k16 over 16-query by 48-key band tiles;
// wgmma would not pay: its 64-row M widens a band 2 hw + 1 <= 33 keys wide
// to 64 + 2 hw columns of products, and the tensor cores sit far below
// their rate either way. So the design is about moving each byte once, with
// the next loads in flight:
//   - A block walks along a (b*h) row in steps of 64 rows. Step i owns the
//     queries [64 i, 64 i + 64) (dq) and the keys [64 i - 16, 64 i + 48)
//     (dk, dv): the key range is offset by the halo, so the keys' queries,
//     [64 i - 32, 64 i + 64), are this step's and the previous step's last
//     32. Each query's p and ds is then computed once per segment.
//   - Rings of 160 rows of Q, G, K and V in shared memory. A step loads only
//     its new 64 rows of each (Q and G at [t, t + 64), K and V at
//     [t + 16, t + 80), t = 64 i), issued at the start of the step before,
//     so they land under that step's products: one step in flight. Within
//     a segment every row is read from device memory once; a segment's start
//     re-reads a halo of 32 rows of each tensor (the previous queries' Q, G
//     and their keys' K, V). Ring row j holds position p with j = p mod 160.
//   - Copies are 16-byte cp.async, not TMA: a copy's source row is chosen
//     per copy, so the K and V rows outside [0, S) are copied straight from
//     the clamped row 0 or S-1 (nothing is written into the ring after a
//     copy lands, so no later write can race a copy of the same row), and
//     the Q and G rows outside [0, S) are zeros stored by the issuing
//     thread (g = 0 gives those queries p g = ds = 0). Rows are unpadded and
//     their 16-byte chunks XOR-swizzled by the ring row, so ldmatrix reads
//     8 rows of one chunk from 8 bank groups. The ring helpers (ring rows,
//     swizzle, row copies, staged stores) are tile_ring.cuh's, shared with
//     K6 and K8.
//   - p and ds once per query: a pair of warps takes 16 of the step's
//     queries, each warp half of the 48 keys that meet their band (24: a
//     16-key block and 8 rows of the middle one). Each forms its logits and
//     dp on the tensor cores and its partial softmax sums in registers; one
//     exchange of three numbers a row through shared memory (and a barrier
//     of the pair) gives both the row's max, denominator and sum of dp p.
//     Each writes its half of p and ds (bf16, [16 queries][48 keys]) into a
//     ring of six 16-query tiles (this step's four and the previous step's
//     last two); after a second pair barrier each computes half of dq's
//     columns, ds from the tile times K. Splitting every block over two
//     warps keeps all eight warps on the band work, which bounds a step's
//     time: one warp a block ran the kernel 1.5 times as long. A segment's
//     first step also recomputes the 32 queries before it (pairs 0 and 1
//     once more), its only repeated band work.
//   - After a barrier, all eight warps take one 16-key block each, dk
//     (ds^T Q) in warps 0-3 and dv (p^T G) in warps 4-7, reading p and ds
//     transposed (ldmatrix.trans) from the tiles of the three query blocks
//     that reach them.
//   - The fold: each query near an edge also sums its ds and p over its
//     clamped positions into two f32 scalars; the warp whose key block holds
//     row 0 (S-1) adds sum_r m_r q_r (n_r g_r) over the edge queries, read
//     from the rings, to that row's f32 sum before the store.
//   - Stores. K and V rows [t - 16, t + 48) are dead once the step's
//     products are done, and the step's dq, dk and dv are 64 rows each:
//     pair j's first warp writes its dq columns, then dk, into the dead K
//     rows of key block j, its second warp its dq columns, then dv, into
//     the dead V rows, with stmatrix, and each sends them out in 16-byte
//     row chunks. No extra shared memory is spent on staging.
//   - Persistent blocks: the (row, step) units of all rows are split into
//     equal runs, one a block, over as many blocks as the card holds at
//     once (and no fewer than 8 units a block). A run that crosses a row
//     ends one segment and starts another. At B*h = 384, S = 3137 (50
//     steps a row) on 132 SMs at 2 blocks each, a block takes 72 or 73
//     steps in 2 or 3 segments: about 650 segment starts re-read 16 KB
//     each, under 2% of the 617 MB of reads, and no tail wave is left.
// Every output element is written by one thread: no atomics, the same bits
// from run to run. Shared memory: 4 x 160 x d bf16 of rings, 21.5 KB of p/ds
// tiles, 3 KB of fold sums and softmax partials: 106,496 bytes at d = 64
// (2 blocks an SM, at most 128 registers a thread), 188,416 at d = 128
// (1 block).
//
// The f32 calls take two scalar-FMA kernels for parity runs (a thread per
// query, then a thread per key, reading q, k, v, g from device memory and
// recomputing p and ds, in 32-column slices) at every hw and head dim; they
// fold the edges the same way.
//
// Range. The design above (the ring kernel) takes hw <= 16 and the head
// dims 16, 32, 64 and 128. The card takes JAX's v4 range beyond it, every
// W and every head dim that is a multiple of 8, at JAX's halo: up to hw =
// 64 (W = 129) and d = 256 at d's tile width (zeros past d) in the two
// wide kernels below (tile_band_bwd_wide_band, tile_band_bwd_wide_keys),
// past either limit in the two streamed kernels (tile_band_bwd_stream_band,
// tile_band_bwd_stream_keys); both pairs pass p and ds through a scratch
// buffer from the wrapper.

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

constexpr int kHalo = 16;          // the ring kernel's halo: hw <= 16
constexpr int kStep = 64;          // queries (keys) a step owns
constexpr int kRing = 160;         // rows of each of the Q, G, K and V rings
constexpr int kPTiles = 6;         // 16-query tiles of p and ds kept
constexpr int kBand = 48;          // keys a 16-query block reaches
constexpr int kLDP = kBand + 8;    // a p or ds tile row: conflict-free reads
constexpr int kThreads = 256;      // 8 warps
constexpr int kMinUnits = 8;       // steps a block takes at least
constexpr int kF32Threads = 128;  // rows (keys) an f32 block

__device__ __forceinline__ int clamp_row(int x, int s) {
  return min(max(x, 0), s - 1);
}

// The p/ds tile of the 16-query block holding position p (p >= -96).
__device__ __forceinline__ int ptile(int p) {
  return ((p + 16 * kPTiles) >> 4) % kPTiles;
}

struct Smem {
  bf16* q;   // rings, kRing rows of D
  bf16* g;
  bf16* k;
  bf16* v;
  bf16* p;   // kPTiles tiles of [16 queries][kLDP]: p
  bf16* ds;  // and ds
  float* fk;   // [2 halves][kPTiles][16]: per query, the sum of ds over the
  float* fv;   // clamped keys of each half of its band, and of p
  float* xch;  // [4 pairs][2 halves][16 rows][3]: softmax partials
};

template <int D>
constexpr int smem_bytes() {
  return 4 * kRing * D * 2 + 2 * kPTiles * 16 * kLDP * 2 +
         2 * 2 * kPTiles * 16 * 4 + 4 * 2 * 16 * 3 * 4;
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// A barrier of the two warps of pair `pair` (named barrier 1 + pair).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// Q and G at [qa, qa + NQ), K and V at [ka, ka + 64), by NT threads.
template <int D, int NQ, int NT>
__device__ __forceinline__ void issue_step(const Smem& sm, const bf16* q,
                                           const bf16* k, const bf16* v,
                                           const bf16* g, int qa, int ka,
                                           int s, int tid) {
  issue_rows<D, NQ, NT, kRing>(sm.q, q, qa, 0, s, false, tid);
  issue_rows<D, NQ, NT, kRing>(sm.g, g, qa, 0, s, false, tid);
  issue_rows<D, kStep, NT, kRing>(sm.k, k, ka, 0, s, true, tid);
  issue_rows<D, kStep, NT, kRing>(sm.v, v, ka, 0, s, true, tid);
}

// Half `half` of the band of the 16 queries [qb, qb + 16), in warp pair
// `pair`, whose other warp takes the other half. The band's 48 keys
// [qb - 16, qb + 32) are six 8-key n-tiles; half h takes n-tiles 3h..3h+2
// (column c is key qb - 16 + c): logits and dp on the tensor cores, then
// the softmax over both halves from one exchange of each row's partial max,
// sum of exponentials and sum of dp times them. p and ds (with the scale)
// are rounded to bf16 into the queries' p/ds tiles; for queries near an
// edge, the half's sums of ds and p over clamped keys go to fk and fv. On
// return (after a second pair barrier) the tiles hold the whole band.
template <int D>
__device__ __forceinline__ void band_half(const Smem& sm, int qb, int pair,
                                          int half, int s, int hw,
                                          float scale, int lane) {
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  float sc[3][4], dp[3][4];
  flash::zero(sc);
  flash::zero(dp);
  const LaneAddr<D> la = pattern_a<D>(lane);
  const LaneAddr<D> lb = pattern_b<D>(lane);
  // The half's 16-key block, and 8 rows of the middle block (x2 loads).
  const LaneAddr<D> lm((8 * half) + (lane & 7), (lane >> 3) & 1);
  const int jq = ring_row<kRing>(qb);
  const int jfull = ring_row<kRing>(half ? qb + 16 : qb - kHalo);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4], gf[4], b[4], m[2];
    flash::ldsm_x4(qf, la.at(sm.q, jq, kk));
    flash::ldsm_x4(gf, la.at(sm.g, jq, kk));
    flash::ldsm_x4(b, lb.at(sm.k, jfull, kk));
    ldsm_x2(m, lm.at(sm.k, jq, kk));
    if (half) {
      flash::mma_bf16(sc[1], qf, b[0], b[1]);
      flash::mma_bf16(sc[2], qf, b[2], b[3]);
      flash::mma_bf16(sc[0], qf, m[0], m[1]);
    } else {
      flash::mma_bf16(sc[0], qf, b[0], b[1]);
      flash::mma_bf16(sc[1], qf, b[2], b[3]);
      flash::mma_bf16(sc[2], qf, m[0], m[1]);
    }
    flash::ldsm_x4(b, lb.at(sm.v, jfull, kk));
    ldsm_x2(m, lm.at(sm.v, jq, kk));
    if (half) {
      flash::mma_bf16(dp[1], gf, b[0], b[1]);
      flash::mma_bf16(dp[2], gf, b[2], b[3]);
      flash::mma_bf16(dp[0], gf, m[0], m[1]);
    } else {
      flash::mma_bf16(dp[0], gf, b[0], b[1]);
      flash::mma_bf16(dp[1], gf, b[2], b[3]);
      flash::mma_bf16(dp[2], gf, m[0], m[1]);
    }
  }

  // Column c = 24 half + 8 nt + 2 t4 + (r & 1) is offset c - qi - 16 from
  // query qi = gq + 8 (r >> 1).
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = 24 * half + nt * 8 + 2 * t4 + (r & 1) -
                      (gq + 8 * (r >> 1)) - kHalo;
      const float x = (off >= -hw && off <= hw) ? sc[nt][r] * scale
                                                : -INFINITY;
      sc[nt][r] = x;
      mx[r >> 1] = fmaxf(mx[r >> 1], x);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  // A row may have no key in this half (mx = -inf): its terms are 0.
  float den[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = sc[nt][r];
      const float e = x == -INFINITY ? 0.f : expf(x - mx[r >> 1]);
      sc[nt][r] = e;
      den[r >> 1] += e;
      rs[r >> 1] += dp[nt][r] * e;
    }
  }
  float* mine = sm.xch + ((pair * 2 + half) * 16) * 3;
  const float* other = sm.xch + ((pair * 2 + (1 - half)) * 16) * 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    if (t4 == 0) {
      float* at = mine + (gq + 8 * h) * 3;
      at[0] = mx[h];
      at[1] = den[h];
      at[2] = rs[h];
    }
  }
  pair_sync(pair);
  // Both halves: p = e exp(mx - M) / L, rs = sum_o dp p over the band.
  float f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* at = other + (gq + 8 * h) * 3;
    const float om = at[0];
    const float big = fmaxf(mx[h], om);
    const float fm = mx[h] == -INFINITY ? 0.f : expf(mx[h] - big);
    const float fo = om == -INFINITY ? 0.f : expf(om - big);
    const float total = den[h] * fm + at[1] * fo;
    rs[h] = (rs[h] * fm + at[2] * fo) / total;
    f[h] = fm / total;
  }
  const int tile = ptile(qb);
  bf16* pw = sm.p + tile * 16 * kLDP + 24 * half;
  bf16* dw = sm.ds + tile * 16 * kLDP + 24 * half;
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = 24 * half + nt * 8 + 2 * t4 + (r & 1) -
                      (gq + 8 * (r >> 1)) - kHalo;
      const float pr = sc[nt][r] * f[r >> 1];
      sc[nt][r] = pr;
      dp[nt][r] = (off >= -hw && off <= hw)
                      ? (pr * (dp[nt][r] - rs[r >> 1])) * scale
                      : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (gq + 8 * h) * kLDP + nt * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(pw + at) =
          flash::pack_bf16(sc[nt][2 * h], sc[nt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dw + at) =
          flash::pack_bf16(dp[nt][2 * h], dp[nt][2 * h + 1]);
    }
  }

  // The fold's sums, for blocks that hold a query within hw of an edge.
  if (hw > 0 && (qb < kHalo || qb + 16 + kHalo > s)) {
    float fk[2] = {0.f, 0.f}, fv[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = qb - kHalo + 24 * half + nt * 8 + 2 * t4 + (r & 1);
        if (key < 0 || key >= s) {
          fk[r >> 1] += dp[nt][r];
          fv[r >> 1] += sc[nt][r];
        }
      }
    }
    float* fkh = sm.fk + half * kPTiles * 16 + tile * 16;
    float* fvh = sm.fv + half * kPTiles * 16 + tile * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 1);
      fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 2);
      fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 1);
      fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 2);
      if (t4 == 0) {
        fkh[gq + 8 * h] = fk[h];
        fvh[gq + 8 * h] = fv[h];
      }
    }
  }
  pair_sync(pair);
}

// dq of the 16 queries [qb, qb + 16), columns [C0 * 8, (C0 + NC) * 8): ds
// from their tile times the K rows of their band.
template <int D, int C0, int NC>
__device__ __forceinline__ void query_grad(const Smem& sm, int qb,
                                           float (&acc)[NC][4], int lane) {
  flash::zero(acc);
  const LaneAddr<D> la = pattern_a<D>(lane);
  const bf16* tile = sm.ds + ptile(qb) * 16 * kLDP;
  const int mi = lane >> 3;
#pragma unroll
  for (int kc = 0; kc < 3; ++kc) {
    uint32_t a[4];
    flash::ldsm_x4(a, tile + ((lane & 7) + 8 * (mi & 1)) * kLDP + 16 * kc +
                          8 * (mi >> 1));
    const int jk = ring_row<kRing>(qb - kHalo + 16 * kc);
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t b[4];
      flash::ldsm_x4_trans(b, la.at(sm.k, jk, C0 / 2 + np));
      flash::mma_bf16(acc[2 * np], a, b[0], b[1]);
      flash::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// dk (tiles = ds, rows = Q) or dv (tiles = p, rows = G) of the 16 keys
// [kb, kb + 16), from the query blocks kb - 16, kb and kb + 16, whose tiles
// hold these keys at columns 32, 16 and 0.
template <int D>
__device__ __forceinline__ void key_grad(const bf16* tiles, bf16* rows,
                                         int kb, float (&acc)[D / 8][4],
                                         int lane) {
  flash::zero(acc);
  const int mi = lane >> 3;
  const LaneAddr<D> la = pattern_a<D>(lane);
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int qb = kb - kHalo + 16 * u;
    uint32_t a[4];
    flash::ldsm_x4_trans(a, tiles + ptile(qb) * 16 * kLDP +
                                ((lane & 7) + 8 * (mi >> 1)) * kLDP +
                                (32 - 16 * u) + 8 * (mi & 1));
    const int jq = ring_row<kRing>(qb);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      flash::ldsm_x4_trans(b, la.at(rows, jq, np));
      flash::mma_bf16(acc[2 * np], a, b[0], b[1]);
      flash::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Adds sum_{r in [r0, r1)} f_r x_r to row rho of a warp's 16 x D f32 sum:
// x the ring rows of Q or G, f_r the query's fold sum (its two halves').
template <int D>
__device__ __forceinline__ void add_edge(float (&acc)[D / 8][4], bf16* rows,
                                         const float* fold, int r0, int r1,
                                         int rho, int lane) {
  if ((lane >> 2) != (rho & 7)) return;
  const bool hi = rho >= 8;
  const int t4 = lane & 3;
  for (int r = r0; r < r1; ++r) {
    const int at = ptile(r) * 16 + (r & 15);
    const float f = fold[at] + fold[kPTiles * 16 + at];
    const int j = ring_row<kRing>(r);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
          ring_at<D>(rows, j, nt) + 4 * t4);
      const float lo = f * __low2float(x);
      const float up = f * __high2float(x);
      if (hi) {
        acc[nt][2] += lo;
        acc[nt][3] += up;
      } else {
        acc[nt][0] += lo;
        acc[nt][1] += up;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    tile_band_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      bf16* __restrict__ dq, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int s, int n_steps,
                      long long units, int hw, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem sm;
  sm.q = reinterpret_cast<bf16*>(smem_raw);
  sm.g = sm.q + kRing * D;
  sm.k = sm.g + kRing * D;
  sm.v = sm.k + kRing * D;
  sm.p = sm.v + kRing * D;
  sm.ds = sm.p + kPTiles * 16 * kLDP;
  sm.fk = reinterpret_cast<float*>(sm.ds + kPTiles * 16 * kLDP);
  sm.fv = sm.fk + 2 * kPTiles * 16;
  sm.xch = sm.fv + 2 * kPTiles * 16;

  constexpr int C = D / 8;
  constexpr int CH = C / 2;  // the chunks of one half of a row's columns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = warp & 3;   // warps w and w + 4 share a 16-row block
  const int half = warp >> 2;
  const long long blocks = gridDim.x;
  long long u = units * blockIdx.x / blocks;
  const long long u_end = units * (blockIdx.x + 1) / blocks;

  while (u < u_end) {
    // One segment: steps [i0, i1) of one (b*h) row.
    const long long row = u / n_steps;
    const int i0 = static_cast<int>(u - row * n_steps);
    const int i1 = static_cast<int>(
        min(static_cast<long long>(n_steps), i0 + (u_end - u)));
    u += i1 - i0;
    const int64_t base = row * static_cast<int64_t>(s) * D;
    const bf16* qr = q + base;
    const bf16* kr = k + base;
    const bf16* vr = v + base;
    const bf16* gr = g + base;

    __syncthreads();  // the previous segment's last step is done
    const int t0 = i0 * kStep;
    // The queries [t0 - 32, t0) and their keys, then step i0's rows.
    issue_step<D, 2 * kHalo, kThreads>(sm, qr, kr, vr, gr, t0 - 2 * kHalo,
                                       t0 - 3 * kHalo, s, threadIdx.x);
    issue_step<D, kStep, kThreads>(sm, qr, kr, vr, gr, t0, t0 + kHalo, s,
                                   threadIdx.x);
    band_stage::cp_async_commit();

    for (int i = i0; i < i1; ++i) {
      const int t = i * kStep;
      const bool first = i == i0;
      const bool more = i + 1 < i1;
      band_stage::cp_async_wait<0>();
      __syncthreads();
      // The next step's rows go to ring rows no warp reads in this step.
      // At a segment's first step the halo queries still read K and V rows
      // among them ([t - 48, t - 16)): there the copies start after the
      // band work.
      if (more && !first) {
        issue_step<D, kStep, kThreads>(sm, qr, kr, vr, gr, t + kStep,
                                       t + kStep + kHalo, s, threadIdx.x);
        band_stage::cp_async_commit();
      }

      // Each pair of warps: the band of 16 of the step's queries, then half
      // of their dq's columns (at d = 16 the first warp takes all); at a
      // segment's first step pairs 0 and 1 also take the 32 queries before.
      const int qb = t + 16 * pair;
      if (first && pair < 2) {
        band_half<D>(sm, t - 2 * kHalo + 16 * pair, pair, half, s, hw, scale,
                     lane);
      }
      band_half<D>(sm, qb, pair, half, s, hw, scale, lane);
      float dqa[C > 2 ? CH : C][4];
      if constexpr (C > 2) {
        if (half == 0) {
          query_grad<D, 0, CH>(sm, qb, dqa, lane);
        } else {
          query_grad<D, CH, CH>(sm, qb, dqa, lane);
        }
      } else if (half == 0) {
        query_grad<D, 0, C>(sm, qb, dqa, lane);
      }
      __syncthreads();
      if (more && first) {
        issue_step<D, kStep, kThreads>(sm, qr, kr, vr, gr, t + kStep,
                                       t + kStep + kHalo, s, threadIdx.x);
        band_stage::cp_async_commit();
      }

      // K and V rows [t - 16, t + 48) are dead: pair j's key block kb
      // stages its results there, warp j in the K rows (its dq columns,
      // then dk), warp j + 4 in the V rows (its dq columns, then dv).
      const int kb = t - kHalo + 16 * pair;
      const int jk = ring_row<kRing>(kb);
      const bool is_dv = half == 1;
      bf16* stage = is_dv ? sm.v : sm.k;
      if constexpr (C > 2) {
        if (half == 0) {
          store_rows<D, 0, CH>(dq + base, dqa, stage, jk, qb, s, lane);
        } else {
          store_rows<D, CH, CH>(dq + base, dqa, stage, jk, qb, s, lane);
        }
      } else if (half == 0) {
        store_rows<D, 0, C>(dq + base, dqa, stage, jk, qb, s, lane);
      }
      float acc[C][4];
      key_grad<D>(is_dv ? sm.p : sm.ds, is_dv ? sm.g : sm.q, kb, acc, lane);
      if (hw > 0) {
        bf16* rows = is_dv ? sm.g : sm.q;
        const float* fold = is_dv ? sm.fv : sm.fk;
        if (kb <= 0 && 0 < kb + 16) {
          add_edge<D>(acc, rows, fold, 0, min(hw, s), -kb, lane);
        }
        if (kb <= s - 1 && s - 1 < kb + 16) {
          add_edge<D>(acc, rows, fold, max(s - hw, 0), s, s - 1 - kb, lane);
        }
      }
      store_rows<D, 0, C>((is_dv ? dv : dk) + base, acc, stage, jk, kb, s,
                          lane);
    }
  }
}

// --- f32: scalar FMA ---------------------------------------------------------

// The wide kernels' scratch, carved from one buffer of
// wide_scratch_bytes: p and ds of every 16-query block as [16][16 + 2 halo]
// bf16 tiles (column c is key qb - halo + c), [rows][nqb] of each, then the
// f32 fold sums of every query, [rows][s] of ds and of p over its clamped
// keys.
struct Scratch {
  bf16* p;
  bf16* ds;
  float* fk;
  float* fv;
};

inline int64_t wide_tile_elems(int64_t rows, int s, int halo) {
  return rows * ((s + 15) / 16) * 16 * (16 + 2 * halo);
}

inline int64_t wide_scratch_bytes(int64_t rows, int s, int halo) {
  return 2 * wide_tile_elems(rows, s, halo) * 2 + 2 * rows * s * 4;
}

inline Scratch carve(void* base, int64_t rows, int s, int halo) {
  Scratch sc;
  const int64_t tiles = wide_tile_elems(rows, s, halo);
  sc.p = static_cast<bf16*>(base);
  sc.ds = sc.p + tiles;
  sc.fk = reinterpret_cast<float*>(sc.ds + tiles);
  sc.fv = sc.fk + rows * s;
  return sc;
}

// --- bf16, any halo and tile width: two kernels through a scratch ----------
//
// The ring kernel keeps a 16-row halo, head dims 16, 32, 64 and 128, and the
// p/ds tiles of six query blocks in shared memory. Every other (hw, d) the
// card takes (hw <= 64, d a multiple of 8 up to 256, at d's tile width D
// with zeros past d and JAX's halo 16, 32, 48 or 64) runs in two kernels:
//   - band: a block stages the Q and G rows of 64 queries (32 at D = 256
//     and halo 64, where 64 would not fit shared memory) and the K and V
//     rows of their band; each warp walks its 16 queries' band in chunks
//     of 48 keys in two passes, as the wide forward does: the first keeps
//     the running maximum, the sum of exponentials and the sum of dp times
//     them, the second forms p and ds = p (dp - sum dp p) scale, writes
//     both as bf16 into the scratch tiles, sums them over clamped keys for
//     the fold, and adds ds K into dq (ds rounded to bf16, as the ring
//     kernel and the TPU kernel round it);
//   - keys: a block takes 64 keys and one of dk (ds^T Q) and dv (p^T G),
//     blockIdx.y; it stages the Q (G) rows and the ds (p) tiles of the
//     queries whose band reaches its keys, and each warp sums its 16 keys'
//     products over those query blocks, adding the fold's mass to rows 0
//     and S-1 as the ring kernel does.
// The scratch (p and ds tiles, 2 (16 + 2 halo) bytes a query each) is
// written once and read once; at halo 64 it is about as large as q.

// The logits and dp of chunk ch (keys [qb - halo + 48 ch, + 48)) of a
// warp's 16 queries; logits -inf outside the band |offset| <= hw. Blocks
// that meet no query's band are skipped.
template <int D>
__device__ __forceinline__ void wide_scores(bf16* qs, bf16* gs, bf16* ks,
                                            bf16* vs, int jq, int jk, int ch,
                                            int halo, int hw, float scale,
                                            int lane, float (&sc)[6][4],
                                            float (&dp)[6][4]) {
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
  flash::zero(dp);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4], gf[4];
    flash::ldsm_x4(qf, la.at(qs, jq, kk));
    flash::ldsm_x4(gf, la.at(gs, jq, kk));
#pragma unroll
    for (int kc = 0; kc < 3; ++kc) {
      if (!used[kc]) continue;
      const int j = jk + 48 * ch + 16 * kc;
      uint32_t b[4];
      flash::ldsm_x4(b, lb.at(ks, j, kk));
      flash::mma_bf16(sc[2 * kc], qf, b[0], b[1]);
      flash::mma_bf16(sc[2 * kc + 1], qf, b[2], b[3]);
      flash::ldsm_x4(b, lb.at(vs, j, kk));
      flash::mma_bf16(dp[2 * kc], gf, b[0], b[1]);
      flash::mma_bf16(dp[2 * kc + 1], gf, b[2], b[3]);
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

// Shared memory of the band kernel at nq queries a block.
constexpr int wide_band_smem(int d_tile, int halo, int nq) {
  return (2 * nq + 2 * (nq + 2 * halo)) * d_tile * 2;
}

template <int D>
__global__ void __launch_bounds__(kStep * 2, D <= 128 ? 2 : 1)
    tile_band_bwd_wide_band(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ g,
                            bf16* __restrict__ dq, Scratch scr, int s,
                            int steps, int d, int hw, int halo, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nq = blockDim.x / 2;  // queries a block: 16 a warp
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + nq * D;
  bf16* ks = gs + nq * D;
  bf16* vs = ks + (nq + 2 * halo) * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const long long row = blockIdx.x / steps;
  const int t = static_cast<int>(blockIdx.x % steps) * nq;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  // Q and G [t, t + nq) (zeros past S: their p g and ds are 0); K and V
  // [t - halo, t + nq + halo), clamped.
  issue_rows_n<D>(qs, q + base, t, nq, 0, s, false, tid, 2 * nq, d);
  issue_rows_n<D>(gs, g + base, t, nq, 0, s, false, tid, 2 * nq, d);
  issue_rows_n<D>(ks, k + base, t - halo, nq + 2 * halo, 0, s, true, tid,
                  2 * nq, d);
  issue_rows_n<D>(vs, v + base, t - halo, nq + 2 * halo, 0, s, true, tid,
                  2 * nq, d);
  band_stage::cp_async_commit();
  band_stage::cp_async_wait<0>();
  __syncthreads();

  const int qb = t + 16 * warp;
  if (qb >= s) return;
  const int jq = 16 * warp;  // the warp's Q and G rows; its keys start there
  const int nch = (16 + 2 * halo + 47) / 48;
  float sc[6][4], dp[6][4];

  // Pass 1: running maximum m, sum of exponentials l and of dp times them
  // rs, of rows gq and gq + 8 (m quad-uniform, l and rs this lane's share).
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  for (int ch = 0; ch < nch; ++ch) {
    if (!wide_chunk_live(ch, halo, hw)) continue;
    wide_scores<D>(qs, gs, ks, vs, jq, jq, ch, halo, hw, scale, lane, sc, dp);
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
      if (m_new == -INFINITY) continue;
      float sum = 0.f, rsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = expf(sc[nt][2 * h + e] - m_new);
          sum += x;
          rsum += dp[nt][2 * h + e] * x;
        }
      }
      const float alpha = expf(m[h] - m_new);
      l[h] = l[h] * alpha + sum;
      rs[h] = rs[h] * alpha + rsum;
      m[h] = m_new;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    rs[h] /= l[h];  // sum_o dp p
  }

  // Pass 2: p and ds into the scratch tiles, the fold sums, dq += ds K.
  const int lt = 16 + 2 * halo;
  const int64_t tile0 = (row * ((s + 15) / 16) + qb / 16) * 16 * lt;
  bf16* pw = scr.p + tile0;
  bf16* dw = scr.ds + tile0;
  float o[D / 8][4];
  flash::zero(o);
  float fk[2] = {0.f, 0.f}, fv[2] = {0.f, 0.f};
  const bool edge = qb < halo || qb + 16 + halo > s;
  const LaneAddr<D> la = pattern_a<D>(lane);
  for (int ch = 0; ch < nch; ++ch) {
    if (!wide_chunk_live(ch, halo, hw)) {
      // Zeros, so that the keys kernel reads no stale tile columns.
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        const int c = 48 * ch + nt * 8 + 2 * t4;
        if (c >= lt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (gq + 8 * h) * lt + c;
          *reinterpret_cast<uint32_t*>(pw + at) = 0u;
          *reinterpret_cast<uint32_t*>(dw + at) = 0u;
        }
      }
      continue;
    }
    wide_scores<D>(qs, gs, ks, vs, jq, jq, ch, halo, hw, scale, lane, sc, dp);
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;
        const float x = sc[nt][r];
        const bool real = qb + gq + 8 * h < s;
        const float pr =
            (x == -INFINITY || !real) ? 0.f : expf(x - m[h]) / l[h];
        sc[nt][r] = pr;
        dp[nt][r] = x == -INFINITY ? 0.f : (pr * (dp[nt][r] - rs[h])) * scale;
        if (edge) {
          const int key = qb - halo + 48 * ch + nt * 8 + 2 * t4 + (r & 1);
          if (key < 0 || key >= s) {
            fk[h] += dp[nt][r];
            fv[h] += pr;
          }
        }
      }
      const int c = 48 * ch + nt * 8 + 2 * t4;
      if (c < lt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (gq + 8 * h) * lt + c;
          *reinterpret_cast<uint32_t*>(pw + at) =
              flash::pack_bf16(sc[nt][2 * h], sc[nt][2 * h + 1]);
          *reinterpret_cast<uint32_t*>(dw + at) =
              flash::pack_bf16(dp[nt][2 * h], dp[nt][2 * h + 1]);
        }
      }
    }
#pragma unroll
    for (int kc = 0; kc < 3; ++kc) {
      if (!block_live(16 * (3 * ch + kc) - halo, hw)) continue;
      const uint32_t da[4] = {
          flash::pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
          flash::pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
          flash::pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
          flash::pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bk[4];
        flash::ldsm_x4_trans(bk, la.at(ks, jq + 48 * ch + 16 * kc, np));
        flash::mma_bf16(o[2 * np], da, bk[0], bk[1]);
        flash::mma_bf16(o[2 * np + 1], da, bk[2], bk[3]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 1);
    fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 2);
    fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 1);
    fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 2);
    const int i = qb + gq + 8 * h;
    if (t4 == 0 && i < s) {
      scr.fk[row * s + i] = fk[h];
      scr.fv[row * s + i] = fv[h];
    }
  }
  // The warp's Q rows are dead: stage dq there.
  store_rows<D, 0, D / 8>(dq + base, o, qs, jq, qb, s, lane, d);
}

// Shared memory of the keys kernel: the Q (G) rows of 64 + 2 halo queries
// and their ds (p) tiles, rows padded by 8 columns (conflict-free ldmatrix).
constexpr int wide_keys_smem(int d_tile, int halo) {
  return (kStep + 2 * halo) * d_tile * 2 +
         (kStep + 2 * halo) * (16 + 2 * halo + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kStep * 2, D <= 128 ? 2 : 1)
    tile_band_bwd_wide_keys(const bf16* __restrict__ q,
                            const bf16* __restrict__ g, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, Scratch scr, int s,
                            int steps, int d, int hw, int halo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const bool is_dv = blockIdx.y == 1;
  const int nr = kStep + 2 * halo;  // staged query rows
  const int lt = 16 + 2 * halo;     // a scratch tile's row
  const int ldp = lt + 8;           // and a staged tile's
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ts = xs + nr * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row = blockIdx.x / steps;
  const int t = static_cast<int>(blockIdx.x % steps) * kStep;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const int nqb = (s + 15) / 16;
  const bf16* tiles = (is_dv ? scr.p : scr.ds) +
                      row * static_cast<int64_t>(nqb) * 16 * lt;
  // Q (G) rows [t - halo, t + 64 + halo), zeros outside [0, S); the tiles
  // of those query blocks, zeros for blocks outside [0, S).
  issue_rows_n<D>(xs, (is_dv ? g : q) + base, t - halo, nr, 0, s, false,
                  tid, blockDim.x, d);
  {
    const int cpr = lt / 8;  // 16-byte chunks a tile row
    for (int f = tid; f < nr * cpr; f += blockDim.x) {
      const int r = f / cpr;
      const int c = f % cpr;
      const int qi = t - halo + r;  // the query
      char* dst = reinterpret_cast<char*>(ts + r * ldp) + 16 * c;
      if (qi >= 0 && qi < 16 * nqb) {
        band_stage::cp_async16(
            dst, tiles + ((qi >> 4) * 16 + (qi & 15)) * lt + 8 * c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  band_stage::cp_async_commit();
  band_stage::cp_async_wait<0>();
  __syncthreads();

  // Keys [kb, kb + 16): the query blocks qb = kb - halo + 16 u, u <
  // nb, hold them at tile columns 2 halo - 16 u.
  const int kb = t + 16 * warp;
  const int nb = 1 + halo / 8;
  const int mi = lane >> 3;
  const LaneAddr<D> la = pattern_a<D>(lane);
  float acc[D / 8][4];
  flash::zero(acc);
  for (int u = 0; u < nb; ++u) {
    if (!block_live(halo - 16 * u, hw)) continue;  // key minus query block
    uint32_t a[4];
    flash::ldsm_x4_trans(a, ts + (16 * (warp + u) + (lane & 7) +
                                  8 * (mi >> 1)) * ldp +
                                (2 * halo - 16 * u) + 8 * (mi & 1));
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      flash::ldsm_x4_trans(b, la.at(xs, 16 * (warp + u), np));
      flash::mma_bf16(acc[2 * np], a, b[0], b[1]);
      flash::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
  // The fold: row 0 gets sum_{r < hw} f_r x_r, row S-1 the same over
  // r >= S - hw (f the query's sum over its clamped keys, x its Q or G).
  if (hw > 0 && kb < s) {
    const float* fold = (is_dv ? scr.fv : scr.fk) + row * s;
    const int gq = lane >> 2;
    const int t4 = lane & 3;
    auto add_edge = [&](int r0, int r1, int rho) {
      if (gq != (rho & 7)) return;
      const bool hi = rho >= 8;
      for (int r = r0; r < r1; ++r) {
        const float f = fold[r];
        const int j = r - (t - halo);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              ring_at<D>(xs, j, nt) + 4 * t4);
          acc[nt][hi ? 2 : 0] += f * __low2float(x);
          acc[nt][hi ? 3 : 1] += f * __high2float(x);
        }
      }
    };
    if (kb <= 0 && 0 < kb + 16) add_edge(0, min(hw, s), -kb);
    if (kb <= s - 1 && s - 1 < kb + 16) {
      add_edge(max(s - hw, 0), s, s - 1 - kb);
    }
  }
  __syncthreads();  // every warp is done with the staged rows
  if (kb < s) {
    store_rows<D, 0, D / 8>((is_dv ? dv : dk) + base, acc, xs, 16 * warp, kb,
                            s, lane, d);
  }
}

// --- bf16 past the wide kernels' range: the streamed band and keys --------
//
// The wide band kernel stages the K and V rows of a step's whole band and
// the keys kernel the Q (G) rows and p/ds tiles of the 64 + 2 halo queries
// that reach its keys: 230 KB at W = 257 even at d = 80, and whole rows of
// d. Past halo 64 or d = 256 two streamed kernels take their place, over
// the same scratch of p/ds tiles and fold sums (csrc/tile_ring.cuh's
// streamed helpers, flash_wide.cuh's layout: 64-row chunks of 64 columns of
// d in padded rows, a two-stage cp.async ring, four warps of 16 rows):
//   - band: a block owns 64 queries and 64 columns of dq (grid y, d / 64
//     slices). In each of two passes it walks the keys [t - halo,
//     t + 64 + halo) in chunks of 64, forming the logits (Q K^T) and dP
//     (G V^T) over all of d chunk by chunk, the block's own dq columns
//     last (flash_wide.cuh's walk), skipping a warp's dead 16-key blocks.
//     Pass 1 keeps each query's running maximum, sum of exponentials and
//     sum of dP times them; pass 2 forms p and ds = p (dP - sum dP p) scale,
//     adds ds K (ds rounded to bf16) into dq and, in slice 0, writes p and
//     ds as bf16 tiles into the scratch with the fold sums over clamped
//     keys. Each pass reads K and V again: 2 (64 + 2 halo) / 64 rows of
//     each a query row (10 at halo 128), from L2 for the most part, and
//     each slice recomputes both passes' products.
//   - keys: a block owns 64 keys and 64 columns of one of dk (ds^T Q) and
//     dv (p^T G) (grid y: 2 x d / 64); it walks the queries [t - halo,
//     t + 64 + halo) in chunks of 64, staging their Q (G) columns and the
//     64 tile columns of its keys, and adds the fold's mass to rows 0 and
//     S-1 from the fold sums and the edge rows read from device memory.
//     No product is recomputed: the slice needs only its own columns.
// The scratch stays 2 (16 + 2 halo) bytes a query for each of p and ds
// (about 0.5 GB at W = 683, B*h = 128, S = 1370).

__global__ void __launch_bounds__(fw::kThreads)
    tile_band_bwd_stream_band(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ g,
                              bf16* __restrict__ dq, Scratch scr, int s,
                              int steps, int d, int hw, int halo,
                              float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage b: Q, G, K, V
  constexpr int E = fw::kChunkElems;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const long long row = blockIdx.x / steps;
  const int t = static_cast<int>(blockIdx.x % steps) * kStep;
  const int slice = blockIdx.y;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const int nc = (d + fw::kCh - 1) / fw::kCh;
  const int k0 = t - halo;
  const int nk = (kStep + 2 * halo + kChunk - 1) / kChunk;
  const int total = nk * nc;  // items a pass
  const int qb = t + 16 * warp;  // the warp's first query
  const int r = qb + gq;         // its rows r and r + 8
  const int lt = 16 + 2 * halo;
  const int nqb = (s + 15) / 16;
  const bool tiles_out = slice == 0 && qb < s;  // this warp writes scratch
  const int64_t tile0 = (row * nqb + qb / 16) * 16 * lt;
  const bool edge = qb < halo || qb + 16 + halo > s;

  auto issue = [&](int i) {
    bf16* st = ring + (i & 1) * 4 * E;
    const int e = i % total;
    const int c0 = fw::walk_chunk(e % nc, slice, nc) * fw::kCh;
    const int kj = k0 + (e / nc) * kChunk;
    stage_rows<fw::kCh, fw::kPitch>(st, q + base, t, c0, 0, s, false, d);
    stage_rows<fw::kCh, fw::kPitch>(st + E, g + base, t, c0, 0, s, false, d);
    stage_rows<fw::kCh, fw::kPitch>(st + 2 * E, k + base, kj, c0, 0, s, true,
                                    d);
    stage_rows<fw::kCh, fw::kPitch>(st + 3 * E, v + base, kj, c0, 0, s, true,
                                    d);
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  float fk[2] = {0.f, 0.f}, fv[2] = {0.f, 0.f};
  float dq_acc[fw::kBwdSlice / 2];
#pragma unroll
  for (int i = 0; i < fw::kBwdSlice / 2; ++i) dq_acc[i] = 0.f;
  float sa[32], pa[32];

  issue(0);
  fw::commit();
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < nk; ++j) {
      const int kj = k0 + j * kChunk;
      bool live[4];
      chunk_live(live, kj, qb, hw);
      const bool any = live[0] || live[1] || live[2] || live[3];
#pragma unroll
      for (int i = 0; i < 32; ++i) sa[i] = pa[i] = 0.f;
      const bf16* last = ring;
      for (int c = 0; c < nc; ++c) {
        const int i = (pass * nk + j) * nc + c;
        fw::wait_all();
        __syncthreads();  // item i landed; the products of i - 1 are done
        if (i + 1 < 2 * total) issue(i + 1);
        fw::commit();
        const bf16* st = ring + (i & 1) * 4 * E;
        if (any) {
          const int kks = steps_below(
              d, fw::walk_chunk(c, slice, nc) * fw::kCh, fw::kCh);
          band_product(sa, st, st + 2 * E, warp, lane, live, kks);
          band_product(pa, st + E, st + 3 * E, warp, lane, live, kks);
        }
        last = st;
      }
      if (pass == 0) {
        if (!any) continue;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const int off = kj + (i >> 2) * 8 + 2 * t4 + (i & 1) - (r + 8 * h);
          sa[i] = (off >= -hw && off <= hw) ? sa[i] * scale : -INFINITY;
          mx[h] = fmaxf(mx[h], sa[i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          if (m_new == -INFINITY) continue;  // no key of these rows yet
          const float alpha = expf(m[h] - m_new);
          l[h] *= alpha;
          rs[h] *= alpha;
          m[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          if (sa[i] == -INFINITY) continue;
          const float e = expf(sa[i] - m[h]);
          l[h] += e;
          rs[h] += pa[i] * e;
        }
        continue;
      }
      // Pass 2: p and ds (0 off the band and for rows past S), the fold
      // sums over clamped keys, the tiles, dq += ds K.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int key = kj + (i >> 2) * 8 + 2 * t4 + (i & 1);
        const int off = key - (r + 8 * h);
        const bool in = any && off >= -hw && off <= hw && r + 8 * h < s;
        const float p = in ? expf(sa[i] * scale - m[h]) / l[h] : 0.f;
        const float ds = in ? (p * (pa[i] - rs[h])) * scale : 0.f;
        if (edge && in && (key < 0 || key >= s)) {
          fk[h] += ds;
          fv[h] += p;
        }
        sa[i] = p;
        pa[i] = ds;
      }
      if (tiles_out) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = 64 * j - 16 * warp + 8 * nt + 2 * t4;
          if (col < 0 || col >= lt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t at = tile0 + (gq + 8 * h) * lt + col;
            const int i = 4 * nt + 2 * h;
            *reinterpret_cast<uint32_t*>(scr.p + at) =
                flash::pack_bf16(sa[i], sa[i + 1]);
            *reinterpret_cast<uint32_t*>(scr.ds + at) =
                flash::pack_bf16(pa[i], pa[i + 1]);
          }
        }
      }
      if (any) {
        band_weights<fw::kBwdSlice, fw::kPitch>(
            dq_acc, pa, last + 2 * E, lane, live,
            steps_below(d, slice * fw::kBwdSlice, fw::kBwdSlice));
      }
    }
    if (pass == 0) {
      // The rows' sums over the quad; rs becomes sum dP p.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        rs[h] /= l[h];
      }
    }
  }
  if (slice == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 1);
      fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 2);
      fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 1);
      fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 2);
      const int i = r + 8 * h;
      if (t4 == 0 && i < s) {
        scr.fk[row * s + i] = fk[h];
        scr.fv[row * s + i] = fv[h];
      }
    }
  }
  fw::store_rows<fw::kBwdSlice>(dq + base, dq_acc, r, slice * fw::kBwdSlice,
                                s, d);
}

// x rounded to bf16 and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The keys kernel's shared memory: two stages of 64 rows and 64 tile rows.
constexpr int kStreamKeysSmem = 4 * fw::kChunkElems * 2;

__global__ void __launch_bounds__(fw::kThreads)
    tile_band_bwd_stream_keys(const bf16* __restrict__ q,
                              const bf16* __restrict__ g,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              Scratch scr, int s, int steps, int d, int hw,
                              int halo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage b: rows, tiles
  constexpr int E = fw::kChunkElems;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int mi = lane >> 3;
  const bool is_dv = blockIdx.y & 1;
  const int c0 = (blockIdx.y >> 1) * fw::kBwdSlice;
  const long long row = blockIdx.x / steps;
  const int t = static_cast<int>(blockIdx.x % steps) * kStep;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const bf16* xs = (is_dv ? g : q) + base;  // the rows of the products
  const int lt = 16 + 2 * halo;
  const int nqb = (s + 15) / 16;
  const bf16* tiles = (is_dv ? scr.p : scr.ds) +
                      row * static_cast<int64_t>(nqb) * 16 * lt;
  const int q0 = t - halo;
  const int nq = (kStep + 2 * halo + kChunk - 1) / kChunk;
  const int kb = t + 16 * warp;  // the warp's first key
  const int nps = steps_below(d, c0, fw::kBwdSlice);

  // Query rows [qm, qm + 64): their X columns [c0, c0 + 64), and their
  // tiles' columns of the keys [t, t + 64) (tile column c of the block at
  // qb holds key qb - halo + c), zeros outside the tiles.
  auto issue = [&](int m_) {
    bf16* st = ring + (m_ & 1) * 2 * E;
    const int qm = q0 + m_ * kChunk;
    stage_rows<fw::kCh, fw::kPitch>(st, xs, qm, c0, 0, s, false, d);
#pragma unroll
    for (int f0 = 0; f0 < kChunk * 8; f0 += fw::kThreads) {
      const int f = f0 + tid;
      const int rr = f / 8;
      const int e = (f % 8) * 8;
      const int qi = qm + rr;
      const int col = t - (qi & ~15) + halo + e;
      const bool real = qi >= 0 && qi < 16 * nqb && col >= 0 && col < lt;
      fw::cp16(st + E + rr * fw::kPitch + e,
               real ? tiles + static_cast<int64_t>(qi) * lt + col : tiles,
               real);
    }
  };

  float acc[fw::kBwdSlice / 2];
#pragma unroll
  for (int i = 0; i < fw::kBwdSlice / 2; ++i) acc[i] = 0.f;

  issue(0);
  fw::commit();
  for (int m_ = 0; m_ < nq; ++m_) {
    fw::wait_all();
    __syncthreads();  // chunk m_ landed; the products of m_ - 1 are done
    if (m_ + 1 < nq) issue(m_ + 1);
    fw::commit();
    const bf16* st = ring + (m_ & 1) * 2 * E;
    bool live[4];
    chunk_live(live, q0 + m_ * kChunk, kb, hw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!live[u]) continue;
      // A = the tile block transposed: keys (m) by queries (k).
      uint32_t a[4];
      flash::ldsm_x4_trans(
          a, st + E + (16 * u + (lane & 7) + 8 * (mi >> 1)) * fw::kPitch +
                 16 * warp + 8 * (mi & 1));
#pragma unroll
      for (int np = 0; np < fw::kBwdSlice / 16; ++np) {
        if (np >= nps) break;
        uint32_t bf[4];
        flash::ldsm_x4_trans(
            bf, fw::at_a<fw::kPitch>(st + u * 16 * fw::kPitch, lane, np * 16));
        fw::mma(acc + 8 * np, a, bf[0], bf[1]);
        fw::mma(acc + 8 * np + 4, a, bf[2], bf[3]);
      }
    }
  }
  // The fold: row 0 gets sum_{r < hw} f_r x_r, row S-1 the same over
  // r >= S - hw (f the query's sum over its clamped keys, x its Q or G).
  // As JAX's _bwd_rule adds them: the row's in-range sum and the fold's
  // mass each rounded to bf16, then their sum (the staged kernels round
  // once; the two differ by an ulp on those two rows).
  if (hw > 0) {
    const float* fold = (is_dv ? scr.fv : scr.fk) + row * s;
    auto add_edge = [&](int r0, int r1, int rho) {
      if (gq != (rho & 7)) return;
      const bool hi = rho >= 8;
      float mass[fw::kBwdSlice / 8][2] = {};
      for (int rq = r0; rq < r1; ++rq) {
        const float f = fold[rq];
        const bf16* x = xs + static_cast<int64_t>(rq) * d + c0;
#pragma unroll
        for (int nt = 0; nt < fw::kBwdSlice / 8; ++nt) {
          const int col = 8 * nt + 2 * t4;
          if (c0 + col >= d) break;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + col);
          mass[nt][0] += f * __low2float(xv);
          mass[nt][1] += f * __high2float(xv);
        }
      }
      // Rows rho and rho + 8 hold acc[4 nt + 0, 1] and [4 nt + 2, 3]: each
      // index a constant, so that acc stays in registers.
#pragma unroll
      for (int nt = 0; nt < fw::kBwdSlice / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = hi ? acc[4 * nt + 2 + e] : acc[4 * nt + e];
          const float b = round_bf16(round_bf16(a) + round_bf16(mass[nt][e]));
          if (hi) {
            acc[4 * nt + 2 + e] = b;
          } else {
            acc[4 * nt + e] = b;
          }
        }
      }
    };
    if (kb <= 0 && 0 < kb + 16) add_edge(0, min(hw, s), -kb);
    if (kb <= s - 1 && s - 1 < kb + 16) {
      add_edge(max(s - hw, 0), s, s - 1 - kb);
    }
  }
  fw::store_rows<fw::kBwdSlice>((is_dv ? dv : dk) + base, acc, kb + gq, c0,
                                s, d);
}

// --- f32: scalar FMA ---------------------------------------------------------
//
// Two kernels at every hw and head dim, full f32 products, for parity runs,
// not for speed: a thread per query (rows) forms its logits and dP over all
// of d, twice (the running maximum, sum and sum of dP times the weights
// first), then dq for a slice of kF32Slice columns (grid y) and, in slice
// 0, the query's maximum, sum of exponentials, sum dP p and fold sums into
// a scratch of five f32 [rows, s]; then a thread per key (keys) recomputes
// p = e / sum and ds of the 2 hw + 1 queries that reach it for a slice of
// dk or dv (grid y), and rows 0 and S-1 add the fold's mass. p and ds are
// f32 as in the plain version; the sums over the band are f64, rounded
// once, as the plain version's (mhla_tile_band_fwd.cu's f32 kernel says
// why).

constexpr int kF32Slice = 32;  // f64 sums: 64 registers

struct F32Stats {
  float* m;    // the logits' maximum
  float* den;  // sum_o exp(logit - m)
  float* rs;   // sum_o dp p
  float* fk;   // the fold sums of ds and p over clamped positions
  float* fv;
};

inline F32Stats carve_f32(void* base, int64_t rows, int s) {
  F32Stats st;
  st.m = static_cast<float*>(base);
  st.den = st.m + rows * s;
  st.rs = st.den + rows * s;
  st.fk = st.rs + rows * s;
  st.fv = st.fk + rows * s;
  return st;
}

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

// acc[c] += w x[c] for the n <= kF32Slice columns of x (n a multiple of 4).
__device__ __forceinline__ void axpy(double (&acc)[kF32Slice], double w,
                                     const float* x, int n) {
#pragma unroll
  for (int c = 0; c < kF32Slice; c += 4) {
    if (c >= n) break;
    const float4 y = *reinterpret_cast<const float4*>(x + c);
    acc[c] += w * y.x;
    acc[c + 1] += w * y.y;
    acc[c + 2] += w * y.z;
    acc[c + 3] += w * y.w;
  }
}

__device__ __forceinline__ void store_f32(float* dst,
                                          const double (&acc)[kF32Slice],
                                          int n) {
#pragma unroll
  for (int c = 0; c < kF32Slice; c += 4) {
    if (c >= n) break;
    *reinterpret_cast<float4*>(dst + c) = make_float4(
        static_cast<float>(acc[c]), static_cast<float>(acc[c + 1]),
        static_cast<float>(acc[c + 2]), static_cast<float>(acc[c + 3]));
  }
}

// p of a logit x at the query's statistics, f32 as the plain version's
// softmax forms it.
__device__ __forceinline__ float weight(float x, float m, float den) {
  return expf(x - m) / den;
}

__global__ void __launch_bounds__(kF32Threads)
    tile_band_bwd_f32_rows(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ g,
                           float* __restrict__ dq, F32Stats st, int s,
                           int per_row, int d, int hw, float scale) {
  const int r = (blockIdx.x % per_row) * kF32Threads + threadIdx.x;
  if (r >= s) return;
  const int64_t row = blockIdx.x / per_row;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const int c0 = blockIdx.y * kF32Slice;
  const int nv = min(kF32Slice, d - c0);
  const float* qr = q + base + static_cast<int64_t>(r) * d;
  const float* gr = g + base + static_cast<int64_t>(r) * d;
  float m = -INFINITY;
  double dsum = 0.0, rsum = 0.0;
  for (int o = -hw; o <= hw; ++o) {
    const int64_t key = base + static_cast<int64_t>(clamp_row(r + o, s)) * d;
    const float x = row_dot(qr, k + key, d) * scale;
    const float dp = row_dot(gr, v + key, d);
    const float m_new = fmaxf(m, x);
    const float alpha = expf(m - m_new);  // 0 at the first key
    const float e = expf(x - m_new);
    m = m_new;
    dsum = dsum * alpha + e;
    rsum = rsum * alpha + static_cast<double>(dp) * e;
  }
  const float den = static_cast<float>(dsum);
  const float rs = static_cast<float>(rsum / dsum);
  double acc[kF32Slice];
#pragma unroll
  for (int c = 0; c < kF32Slice; ++c) acc[c] = 0.0;
  double fk = 0.0, fv = 0.0;
  for (int o = -hw; o <= hw; ++o) {
    const int64_t key = base + static_cast<int64_t>(clamp_row(r + o, s)) * d;
    const float p = weight(row_dot(qr, k + key, d) * scale, m, den);
    const float ds = (p * (row_dot(gr, v + key, d) - rs)) * scale;
    if (r + o < 0 || r + o >= s) {
      fk += ds;
      fv += p;
    }
    axpy(acc, ds, k + key + c0, nv);
  }
  store_f32(dq + base + static_cast<int64_t>(r) * d + c0, acc, nv);
  if (blockIdx.y == 0) {
    const int64_t i = row * s + r;
    st.m[i] = m;
    st.den[i] = den;
    st.rs[i] = rs;
    st.fk[i] = static_cast<float>(fk);
    st.fv[i] = static_cast<float>(fv);
  }
}

__global__ void __launch_bounds__(kF32Threads)
    tile_band_bwd_f32_keys(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ g,
                           float* __restrict__ dk, float* __restrict__ dv,
                           F32Stats st, int s, int per_row, int d, int hw,
                           float scale) {
  const int j = (blockIdx.x % per_row) * kF32Threads + threadIdx.x;
  if (j >= s) return;
  const int64_t row = blockIdx.x / per_row;
  const int64_t base = row * static_cast<int64_t>(s) * d;
  const bool is_dv = blockIdx.y & 1;
  const int c0 = (blockIdx.y >> 1) * kF32Slice;
  const int nv = min(kF32Slice, d - c0);
  const float* kj = k + base + static_cast<int64_t>(j) * d;
  const float* vj = v + base + static_cast<int64_t>(j) * d;
  const float* xs = (is_dv ? g : q) + base;  // the rows of the sums
  const int64_t vec = row * s;
  double acc[kF32Slice];
#pragma unroll
  for (int c = 0; c < kF32Slice; ++c) acc[c] = 0.0;
  // Key j is position r + o of the queries r = j - o.
  for (int o = -hw; o <= hw; ++o) {
    const int rq = j - o;
    if (rq < 0 || rq >= s) continue;
    const float* qr = q + base + static_cast<int64_t>(rq) * d;
    const float p = weight(row_dot(qr, kj, d) * scale, st.m[vec + rq],
                           st.den[vec + rq]);
    const float w =
        is_dv ? p
              : (p * (row_dot(g + base + static_cast<int64_t>(rq) * d, vj,
                              d) -
                      st.rs[vec + rq])) *
                    scale;
    axpy(acc, w, xs + static_cast<int64_t>(rq) * d + c0, nv);
  }
  if (hw > 0 && (j == 0 || j == s - 1)) {
    const float* fold = (is_dv ? st.fv : st.fk) + vec;
    const auto add_edge = [&](int r0, int r1) {
      for (int rq = r0; rq < r1; ++rq) {
        axpy(acc, fold[rq], xs + static_cast<int64_t>(rq) * d + c0, nv);
      }
    };
    if (j == 0) add_edge(0, min(hw, s));
    if (j == s - 1) add_edge(max(s - hw, 0), s);
  }
  store_f32((is_dv ? dv : dk) + base + static_cast<int64_t>(j) * d + c0, acc,
            nv);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* g, void* dq, void* dk, void* dv,
                       void* scratch, int64_t rows, int s, int d, int hw,
                       float scale, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int per_row = (s + kF32Threads - 1) / kF32Threads;
  const int64_t blocks = rows * per_row;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const F32Stats st = carve_f32(scratch, rows, s);
  const unsigned n_slices = (d + kF32Slice - 1) / kF32Slice;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(g);
  tile_band_bwd_f32_rows<<<dim3(static_cast<unsigned>(blocks), n_slices),
                           kF32Threads, 0, stream>>>(
      qp, kp, vp, gp, static_cast<float*>(dq), st, s, per_row, d, hw, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_band_bwd_f32_keys<<<dim3(static_cast<unsigned>(blocks), 2 * n_slices),
                           kF32Threads, 0, stream>>>(
      qp, kp, vp, gp, static_cast<float*>(dk), static_cast<float*>(dv), st, s,
      per_row, d, hw, scale);
  return cudaGetLastError();
}

// The queries a band block takes at tile width d_tile and this halo: 64,
// or 32 where 64 would not fit shared memory (D = 256 at halo 64).
inline int wide_band_queries(int d_tile, int halo) {
  return wide_band_smem(d_tile, halo, kStep) <= 227 * 1024 ? kStep
                                                           : kStep / 2;
}

template <int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv,
                        void* scratch, int64_t rows, int s, int d, int hw,
                        float scale, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int halo = halo_of(hw);
  const Scratch scr = carve(scratch, rows, s, halo);
  const int nq = wide_band_queries(D, halo);
  const int band_smem = wide_band_smem(D, halo, nq);
  cudaError_t err = cudaFuncSetAttribute(
      tile_band_bwd_wide_band<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      band_smem);
  if (err != cudaSuccess) return err;
  const int band_steps = (s + nq - 1) / nq;
  if (rows * band_steps > INT32_MAX) return cudaErrorInvalidConfiguration;
  tile_band_bwd_wide_band<D>
      <<<static_cast<unsigned>(rows * band_steps), 2 * nq, band_smem,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                   static_cast<bf16*>(dq), scr, s, band_steps, d, hw, halo,
                   scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int keys_smem = wide_keys_smem(D, halo);
  err = cudaFuncSetAttribute(tile_band_bwd_wide_keys<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             keys_smem);
  if (err != cudaSuccess) return err;
  const int steps = (s + kStep - 1) / kStep;
  tile_band_bwd_wide_keys<D>
      <<<dim3(static_cast<unsigned>(rows * steps), 2), 2 * kStep, keys_smem,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(g),
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), scr, s,
                   steps, d, hw, halo);
  return cudaGetLastError();
}

// The streamed kernels: band (64 queries, 64 dq columns a block), then keys
// (64 keys, 64 columns of dk or dv).
cudaError_t launch_stream(const void* q, const void* k, const void* v,
                          const void* g, void* dq, void* dk, void* dv,
                          void* scratch, int64_t rows, int s, int d, int hw,
                          float scale, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int halo = halo_of(hw);
  const Scratch scr = carve(scratch, rows, s, halo);
  const int steps = (s + kStep - 1) / kStep;
  if (rows * steps > INT32_MAX) return cudaErrorInvalidConfiguration;
  const unsigned n_slices = fw::slices(d, fw::kBwdSlice);
  cudaError_t err = cudaFuncSetAttribute(
      tile_band_bwd_stream_band, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fw::kBwdSmem);
  if (err != cudaSuccess) return err;
  tile_band_bwd_stream_band<<<dim3(static_cast<unsigned>(rows * steps),
                                   n_slices),
                              fw::kThreads, fw::kBwdSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<bf16*>(dq), scr, s, steps, d, hw, halo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_band_bwd_stream_keys<<<dim3(static_cast<unsigned>(rows * steps),
                                   2 * n_slices),
                              fw::kThreads, kStreamKeysSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(g),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), scr, s, steps, d, hw,
      halo);
  return cudaGetLastError();
}

// The ring kernel at head dim D (16, 32, 64, 128) and hw <= 16.
template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv, int64_t rows,
                     int s, int hw, float scale, int device,
                     cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  // Blocks an SM, found once: the attribute first, then the occupancy at
  // this shared memory (0 if either fails).
  static const int per_sm = [] {
    int n = 0;
    if (cudaFuncSetAttribute(tile_band_bwd_mma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, tile_band_bwd_mma<D>, kThreads, kSmem) != cudaSuccess) {
      return 0;
    }
    return n;
  }();
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_steps = (s + kHalo + kStep - 1) / kStep;
  const int64_t units = rows * n_steps;
  const int64_t blocks = std::min<int64_t>(
      (units + kMinUnits - 1) / kMinUnits, static_cast<int64_t>(sms) * per_sm);
  tile_band_bwd_mma<D><<<static_cast<unsigned>(blocks), kThreads, kSmem,
                         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      s, n_steps, units, hw, scale);
  return cudaGetLastError();
}

// Whether the ring kernel runs at (d, hw) in bf16; else the wide kernels.
inline bool ring_kernel(int d, int hw) {
  return hw <= kHalo && (d == 16 || d == 32 || d == 64 || d == 128);
}

// The ring kernel where it applies, else the wide kernels, at d's tile
// width D.
template <int D>
cudaError_t launch_w(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv,
                     void* scratch, int64_t rows, int s, int d, int hw,
                     float scale, int device, cudaStream_t stream) {
  if constexpr (D == 16 || D == 32 || D == 64 || D == 128) {
    if (ring_kernel(d, hw)) {
      return launch_d<D>(q, k, v, g, dq, dk, dv, rows, s, hw, scale, device,
                         stream);
    }
  }
  return launch_wide<D>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                        scale, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// first launch that failed (0 on success). q, k, v, g and dq, dk, dv are
// device pointers to contiguous [rows, s, d] tensors of one dtype (is_bf16
// = 1 for bf16, 0 for f32), 16-byte aligned; hw >= 0; d a multiple of 8;
// `scratch` a device buffer of mhla_tile_band_bwd_scratch(rows, s, d, hw,
// is_bf16) bytes, 16-byte aligned (null where that is 0); `stream` is the
// caller's cudaStream_t. dk and dv come with the clamped positions' mass
// already folded into rows 0 and S-1. The kernels allocate nothing and do
// not synchronise.
extern "C" int mhla_tile_band_bwd(const void* q, const void* k, const void* v,
                                  const void* g, void* dq, void* dk, void* dv,
                                  void* scratch, long long rows, int s, int d,
                                  int hw, int is_bf16, float scale, int device,
                                  void* stream) {
  if (rows <= 0 || s < 1 || hw < 0 || d < 8 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 == 0) {
    return static_cast<int>(launch_f32(q, k, v, g, dq, dk, dv, scratch, rows,
                                       s, d, hw, scale, st));
  }
  if (!staged_range(d, hw)) {
    return static_cast<int>(launch_stream(q, k, v, g, dq, dk, dv, scratch,
                                          rows, s, d, hw, scale, st));
  }
  switch (flash::tile_width(d)) {
    case 16:
      err = launch_w<16>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                         scale, device, st);
      break;
    case 32:
      err = launch_w<32>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                         scale, device, st);
      break;
    case 64:
      err = launch_w<64>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                         scale, device, st);
      break;
    case 80:
      err = launch_w<80>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                         scale, device, st);
      break;
    case 128:
      err = launch_w<128>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                          scale, device, st);
      break;
    case 192:
      err = launch_w<192>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                          scale, device, st);
      break;
    default:
      err = launch_w<256>(q, k, v, g, dq, dk, dv, scratch, rows, s, d, hw,
                          scale, device, st);
  }
  return static_cast<int>(err);
}

// The bytes of scratch mhla_tile_band_bwd needs at these arguments, into
// the long long at `bytes`: 0 for the ring kernel, the f32 kernels' five
// f32 [rows, s] (softmax maximum and sum, sum dP p, fold sums), the wide
// and streamed kernels' p/ds tiles and fold sums. Returns
// cudaErrorInvalidValue (and writes nothing) for arguments the kernels do
// not take, else 0.
extern "C" int mhla_tile_band_bwd_scratch(long long rows, int s, int d,
                                          int hw, int is_bf16, void* bytes) {
  if (rows <= 0 || s < 1 || hw < 0 || d < 8 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *static_cast<long long*>(bytes) =
      is_bf16 == 0          ? 20 * rows * static_cast<long long>(s)
      : ring_kernel(d, hw) ? 0
                            : wide_scratch_bytes(rows, s, halo_of(hw));
  return 0;
}

// Dynamic shared memory of the bf16 kernel that runs at head dim d and
// half window hw (-1 for a pair the kernels do not take), for the build
// report: the ring kernel's, or the larger of the wide (streamed) kernels'
// two.
extern "C" int mhla_tile_band_bwd_smem(int d, int hw) {
  if (hw < 0 || d < 8 || d % 8 != 0) return -1;
  if (!staged_range(d, hw)) return std::max(fw::kBwdSmem, kStreamKeysSmem);
  if (ring_kernel(d, hw)) {
    switch (d) {
      case 16:
        return smem_bytes<16>();
      case 32:
        return smem_bytes<32>();
      case 64:
        return smem_bytes<64>();
      default:
        return smem_bytes<128>();
    }
  }
  const int w = flash::tile_width(d);
  const int halo = halo_of(hw);
  return std::max(wide_band_smem(w, halo, wide_band_queries(w, halo)),
                  wide_keys_smem(w, halo));
}

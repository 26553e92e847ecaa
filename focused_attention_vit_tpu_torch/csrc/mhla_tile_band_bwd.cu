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
// past either limit, and at d > 128 with W = 128 or 129, in the two wgmma
// kernels (tile_band_bwd_sm90_band, tile_band_bwd_sm90_rows); both pairs
// pass p and ds through a scratch buffer from the wrapper.

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

// --- bf16 past the wide kernels' range: two wgmma kernels through a scratch
//
// Past hw = 64 or d = 256, and at d > 128 with hw = 64 (tile_ring.cuh
// sm90_takes), K7 runs in two kernels on tile_band_sm90.cuh's ring (one
// producer thread loading 64 x 64 tiles by TMA, 3 to 16 stages deep, one
// consumer warpgroup on wgmma),
// through the scratch of p/ds tiles and fold sums that the wrapper
// allocates (the wide kernels' layout):
//   - band: a block owns the 64 queries [t, t + 64) and keeps their Q and G
//     in shared memory (2 ceil(d / 64) tiles; where they do not fit beside
//     the ring, d past 768, tile c of Q or G streams through the ring just
//     before tile c of K or V instead) while it walks the keys
//     [t - halo, t + 64 + halo) in chunks of 64 twice, K and V streamed
//     (positions outside [0, S) as zeros): the logits (Q K^T) and dp
//     (G V^T) over d's 16-column steps, each once a pass; at positions
//     outside [0, S) a clamped block takes each query's logit and dp
//     against row 0 or S - 1, formed once from the kept edge rows.
//     Pass 1 keeps each query's running maximum, sum of exponentials and
//     sum of dp times them; pass 2 forms p and ds = p (dp - sum dp p) scale,
//     writes both as bf16 into the query block's scratch tiles, and sums
//     them over clamped keys for the fold. The logits are formed twice a
//     query, whatever d: no output columns are held, so nothing is sliced;
//   - rows: a block owns 64 rows of one of dq (ds K, over the keys of the
//     queries' band), dk (ds^T Q) and dv (p^T G, over the queries whose
//     band reaches the keys), and a slice of at most 256 columns
//     (tb90::slice_width), grid y = 3 x slices. Per chunk of 64 keys
//     (queries) it loads one 64 x 64 tile of ds or p from the scratch and
//     the slice's tiles of K (clamped rows), Q or G (zeros outside [0, S)),
//     and adds their product on wgmma: ds as A read K-major for dq, MN-major
//     (transposed) for dk and dv, the rows MN-major as B. Chunks of queries
//     wholly outside [0, S) are skipped. Rows 0 and S - 1 of dk and dv take
//     the fold's mass as JAX's _bwd_rule adds it: the in-range sum and the
//     mass each rounded to bf16, then their sum; the block's threads sum the
//     mass a column pair each over the hw edge queries.
// So p and ds are formed once a query (the streamed kernels they replaced
// formed them again for every 64 columns of dq), ds is rounded to bf16
// before ds K (and dk), and every output element is one thread's sum in a
// fixed order: two runs give the same bits. The scratch keeps its layout
// (2 (16 + 2 halo) bytes a query for each of p and ds, and 8 bytes of fold
// sums), written once and read twice (ds by dq and dk).

// Maps (tile_band_sm90.cuh): tq, tg, tk, tv over the [rows, s, d] tensors
// (64 x 64 boxes; K's and V's positions outside [0, s) arrive as zeros),
// tk1 and tv1 over k and v with one-row boxes (the edge rows). kKeep: Q
// and G kept in shared memory (two blocks an SM where they fit), else
// streamed through the ring (one block an SM: its registers), and q and g
// themselves read for the logits and dp against the edge rows.
template <bool kKeep>
__global__ void __launch_bounds__(tb90::kThreads, kKeep ? 2 : 1)
    tile_band_bwd_sm90_band(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tg,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tk1,
                            const __grid_constant__ CUtensorMap tv1,
                            const bf16* __restrict__ q,
                            const bf16* __restrict__ g, Scratch scr, int s,
                            int steps, int d, int hw, int halo, int ns,
                            float scale) {
  namespace hp = hopper;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * tb90::kMaxStages + 2];
  // A clamped block's logits and dp of each query against row 0 and row
  // s - 1 of K and V (q.k_0, q.k_{s-1}, g.v_0, g.v_{s-1}): every position
  // outside [0, s) in the band takes them.
  __shared__ float edge_dots[4][kStep];
  uint8_t* smem = hp::align1024(smem_raw);
  const int nd = tb90::col_tiles(d);
  // With kKeep, nd tiles of Q, then of G, before the ring.
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + nd * tb90::kTileElems;
  const tb90::Ring ring = tb90::make_ring(
      smem, kKeep ? 2 * nd * tb90::kTileBytes : 0, bars, ns);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = static_cast<int>(blockIdx.x / steps);
  const int t = static_cast<int>(blockIdx.x % steps) * kStep;
  const int k0 = t - halo;
  const int nk = (kStep + 2 * halo + 63) / 64;
  // Chunks that leave the row: their positions outside [0, s) are copies
  // of row 0 or s - 1 (the clamped band), which the consumers take from the
  // edge rows.
  const bool clamped = k0 < 0 || k0 + 64 * nk > s;
  const tb90::Edges ed = ring.edge_rows(d);

  if (warp == tb90::kConsumers / 32) {
    // The producer warp: Q and G (one thread, with kKeep), the edge rows
    // where the chunks leave the row, then each pass's K and V tiles, chunk
    // by chunk, each after its Q or G tile without kKeep.
    if (kKeep && lane == 0) {
      hp::mbar_arrive_expect_tx(ring.kept, 2 * nd * tb90::kTileBytes);
      for (int c = 0; c < nd; ++c) {
        hp::tma_load_3d(qs + c * tb90::kTileElems, &tq, ring.kept, 64 * c, t,
                        row);
        hp::tma_load_3d(gs + c * tb90::kTileElems, &tg, ring.kept, 64 * c, t,
                        row);
      }
    }
    if (clamped) tb90::load_edges(ed, &tk1, &tv1, ring.edges, s, row, lane);
    int i = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int j = 0; j < nk; ++j) {
        for (int x = 0; x < 2; ++x) {
          for (int c = 0; c < nd; ++c, ++i) {
            if (!kKeep) {
              tb90::load_full(ring.tile(i), x ? &tg : &tq, ring.acquire(i),
                              64 * c, t, row, lane);
              ++i;
            }
            tb90::load_full(ring.tile(i), x ? &tv : &tk, ring.acquire(i),
                            64 * c, k0 + 64 * j, row, lane);
          }
        }
      }
    }
    return;
  }

  // The consumer warpgroup: query rows r and r + 8 of the warp's 16-query
  // block qb, columns 8 j + 2 wq (+1) of each chunk.
  const int gq = lane >> 2;
  const int wq = lane & 3;
  const int qb = t + 16 * warp;
  const int r = qb + gq;
  const int lt = 16 + 2 * halo;
  const int nqb = (s + 15) / 16;
  const bool tiles_out = qb < s;  // the warp's query block has tiles
  const int64_t tile0 = (static_cast<int64_t>(row) * nqb + qb / 16) * 16 * lt;
  const bool edge = qb < halo || qb + 16 + halo > s;
  float sa[32], pa[32];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  float fk[2] = {0.f, 0.f}, fv[2] = {0.f, 0.f};
  int i = 0;
  if (kKeep) hp::mbar_wait(ring.kept, 0);
  if (clamped) {
    hp::mbar_wait(ring.edges, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * warp + gq + 8 * h;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      // Without kKeep from device memory: a query past s has zero rows
      // (its dots 0) there, as the kept tiles hold.
      const int64_t at = (static_cast<int64_t>(row) * s + t + rr) * d;
      for (int c = 2 * wq; c < d && (kKeep || t + rr < s); c += 8) {
        const float2 x = kKeep ? tb90::kept_pair(qs, rr, c)
                               : tb90::row_pair(q + at, c);
        const float2 y = kKeep ? tb90::kept_pair(gs, rr, c)
                               : tb90::row_pair(g + at, c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 e = tb90::edge_pair(ed, u >> 1, u & 1, c);
          const float2 z = u < 2 ? x : y;
          dot[u] += z.x * e.x + z.y * e.y;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], 1);
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], 2);
        if (wq == 0) edge_dots[u][rr] = dot[u];
      }
    }
    __syncwarp();  // a warp reads its own rows' dots
  }

  // The logits (sa) and dp (pa) of chunk j, each product a committed group
  // of kPer ring items (K or V, after its Q or G tile without kKeep), which
  // are released once the product after it has been issued. The positions
  // of a clamped chunk outside [0, s) take the edge rows'.
  constexpr int kPer = kKeep ? 1 : 2;
  auto scores = [&](int kj) {
    hp::fence_regs(sa);
    hp::fence_regs(pa);
    for (int x = 0; x < 2; ++x) {
      for (int c = 0; c < nd; ++c, ++i) {
        if constexpr (!kKeep) ring.wait(i++);  // the Q or G tile
        ring.wait(i);
        hp::wgmma_fence();
        if (x == 0) {
          tb90::tile_product<0, 0>(
              sa, kKeep ? qs + c * tb90::kTileElems : ring.tile(i - 1),
              ring.tile(i), tb90::steps_of(d, c), c > 0);
        } else {
          tb90::tile_product<0, 0>(
              pa, kKeep ? gs + c * tb90::kTileElems : ring.tile(i - 1),
              ring.tile(i), tb90::steps_of(d, c), c > 0);
        }
        hp::wgmma_commit();
        if (x > 0 || c > 0) {
          hp::wgmma_wait<1>();
          ring.release_last(i - kPer, kPer, lane);
        }
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(sa);
    hp::fence_regs(pa);
    ring.release_last(i - 1, kPer, lane);
    if (clamped && (kj < 0 || kj + 64 > s)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = kj + (e >> 2) * 8 + 2 * wq + (e & 1);
        const int rr = 16 * warp + gq + 8 * ((e >> 1) & 1);
        if (key < 0) {
          sa[e] = edge_dots[0][rr];
          pa[e] = edge_dots[2][rr];
        } else if (key >= s) {
          sa[e] = edge_dots[1][rr];
          pa[e] = edge_dots[3][rr];
        }
      }
    }
  };

  // Logits in log2 units (scaled by d^-1/2 log2 e); ds keeps d^-1/2.
  const float scale2 = scale * 1.4426950408889634f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < nk; ++j) {
      const int kj = k0 + 64 * j;
      scores(kj);
      if (pass == 0) {
        // A chunk inside every row's band needs no mask.
        const bool inside = kj + 63 - t <= hw && t + 63 - kj <= hw;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int h = (e >> 1) & 1;
          const int off = kj + (e >> 2) * 8 + 2 * wq + (e & 1) - (r + 8 * h);
          sa[e] = (inside || (off >= -hw && off <= hw)) ? sa[e] * scale2
                                                         : -INFINITY;
          mx[h] = fmaxf(mx[h], sa[e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          if (m_new == -INFINITY) continue;  // no key of these rows yet
          const float alpha = exp2f(m[h] - m_new);
          l[h] *= alpha;
          rs[h] *= alpha;
          m[h] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int h = (e >> 1) & 1;
          if (sa[e] == -INFINITY) continue;  // m may still be -inf
          const float x = exp2f(sa[e] - m[h]);
          l[h] += x;
          rs[h] += pa[e] * x;
        }
        continue;
      }
      // Pass 2: p and ds (0 off the band and for rows past S), the fold
      // sums over clamped keys, the scratch tiles.
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        const int key = kj + (e >> 2) * 8 + 2 * wq + (e & 1);
        const int off = key - (r + 8 * h);
        const bool in = off >= -hw && off <= hw && r + 8 * h < s;
        const float p = in ? exp2f(sa[e] * scale2 - m[h]) * l[h] : 0.f;
        const float ds = in ? (p * (pa[e] - rs[h])) * scale : 0.f;
        if (edge && in && (key < 0 || key >= s)) {
          fk[h] += ds;
          fv[h] += p;
        }
        sa[e] = p;
        pa[e] = ds;
      }
      if (tiles_out) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = 64 * j - 16 * warp + 8 * nt + 2 * wq;
          if (col < 0 || col >= lt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t at = tile0 + (gq + 8 * h) * lt + col;
            const int e = 4 * nt + 2 * h;
            *reinterpret_cast<uint32_t*>(scr.p + at) =
                flash::pack_bf16(sa[e], sa[e + 1]);
            *reinterpret_cast<uint32_t*>(scr.ds + at) =
                flash::pack_bf16(pa[e], pa[e + 1]);
          }
        }
      }
    }
    if (pass == 0) {
      // The rows' sums over the quad; rs becomes sum dp p.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        rs[h] /= l[h];
        l[h] = 1.f / l[h];  // from here on the sum's reciprocal
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 1);
    fk[h] += __shfl_xor_sync(0xffffffffu, fk[h], 2);
    fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 1);
    fv[h] += __shfl_xor_sync(0xffffffffu, fv[h], 2);
    const int qi = r + 8 * h;
    if (wq == 0 && qi < s) {
      scr.fk[static_cast<int64_t>(row) * s + qi] = fk[h];
      scr.fv[static_cast<int64_t>(row) * s + qi] = fv[h];
    }
  }
}

// x rounded to bf16 and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The rows kernel's roles (grid y = 3 slice + role).
constexpr int kRoleDq = 0;
constexpr int kRoleDk = 1;
constexpr int kRoleDv = 2;

// Maps: tp and tds over the scratch's p and ds (tb90::map_scratch), tk,
// tq, tg over the [rows, s, d] tensors (64 x 64 boxes; positions outside
// [0, s) arrive as zeros), tk1 and tv1 over k and v with one-row boxes (the
// edge rows); q and g themselves for the fold.
template <int NO>
__global__ void __launch_bounds__(tb90::kThreads, NO <= 128 ? 2 : 1)
    tile_band_bwd_sm90_rows(const __grid_constant__ CUtensorMap tp,
                            const __grid_constant__ CUtensorMap tds,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tk1,
                            const __grid_constant__ CUtensorMap tv1,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tg,
                            const bf16* __restrict__ q,
                            const bf16* __restrict__ g,
                            bf16* __restrict__ dq, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, Scratch scr, int s,
                            int steps, int d, int hw, int halo, int ns) {
  namespace hp = hopper;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * tb90::kMaxStages + 2];
  __shared__ float mass[NO];  // the fold's mass of one edge row
  uint8_t* smem = hp::align1024(smem_raw);
  const tb90::Ring ring = tb90::make_ring(smem, 0, bars, ns);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int role = blockIdx.y % 3;
  const int c0 = (blockIdx.y / 3) * NO;
  const int nv = min(NO / 64, tb90::col_tiles(d - c0));
  const int row = static_cast<int>(blockIdx.x / steps);
  const int t = static_cast<int>(blockIdx.x % steps) * kStep;
  const int64_t base = static_cast<int64_t>(row) * s * d;
  const int nq = (s + 15) / 16 * 16;  // queries with scratch rows
  const int k0 = t - halo;
  const int nk = (kStep + 2 * halo + 63) / 64;
  // Chunk j: keys (dq) or queries (dk, dv) [k0 + 64 j, + 64); a chunk of
  // queries wholly outside the scratch rows adds nothing.
  auto live = [&](int j) {
    const int j0 = k0 + 64 * j;
    return role == kRoleDq || (j0 + 64 > 0 && j0 < nq);
  };
  // dq's chunks that leave the row: their keys outside [0, s) are row 0 or
  // s - 1 of K (the clamped band), which the consumers add from the edge
  // rows.
  const bool clamped = role == kRoleDq && (k0 < 0 || k0 + 64 * nk > s);
  const tb90::Edges ed = ring.edge_rows(d);

  if (warp == tb90::kConsumers / 32) {
    // The producer warp: per chunk the p or ds tile (one thread), then the
    // slice's tiles of K, Q or G.
    const CUtensorMap* pds = role == kRoleDv ? &tp : &tds;
    const CUtensorMap* xs =
        role == kRoleDq ? &tk : (role == kRoleDk ? &tq : &tg);
    if (clamped) tb90::load_edges(ed, &tk1, &tv1, ring.edges, s, row, lane);
    int i = 0;
    for (int j = 0; j < nk; ++j) {
      if (!live(j)) continue;
      const int j0 = k0 + 64 * j;
      uint64_t* bar = ring.acquire(i);
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(bar, tb90::kTileBytes);
        if (role == kRoleDq) {
          tb90::load_scratch(ring.tile(i), pds, bar, t, j0, halo, row);
        } else {
          tb90::load_scratch(ring.tile(i), pds, bar, j0, t, halo, row);
        }
      }
      ++i;
      for (int vb = 0; vb < nv; ++vb, ++i) {
        tb90::load_full(ring.tile(i), xs, ring.acquire(i), c0 + 64 * vb, j0,
                        row, lane);
      }
    }
    return;
  }

  float acc[NO / 2];
#pragma unroll
  for (int e = 0; e < NO / 2; ++e) acc[e] = 0.f;
  // dq of a clamped block: each query's ds at keys below 0 (sl) and past
  // s - 1 (sh), as the tiles hold them (bf16), summed; added times row 0
  // and s - 1 of K after the chunks (the K tiles hold zeros there).
  const int gq = lane >> 2;
  const int wq = lane & 3;
  float sl[2] = {0.f, 0.f}, sh[2] = {0.f, 0.f};
  int i = 0;
  for (int j = 0; j < nk; ++j) {
    if (!live(j)) continue;
    const int it = i++;  // the chunk's p or ds tile, kept to its end
    ring.wait(it);
    const bf16* a = ring.tile(it);
    const int j0 = k0 + 64 * j;
    if (clamped && (j0 < 0 || j0 + 64 > s)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (int c = 2 * wq; c < 64; c += 8) {
          const float2 x = tb90::kept_pair(a, 16 * warp + gq + 8 * h, c);
          const int key = j0 + c;
          if (key < 0) sl[h] += x.x;
          if (key >= s) sh[h] += x.x;
          if (key + 1 < 0) sl[h] += x.y;
          if (key + 1 >= s) sh[h] += x.y;
        }
      }
    }
    hp::fence_regs(acc);
#pragma unroll
    for (int vb = 0; vb < NO / 64; ++vb) {
      if (vb >= nv) break;
      ring.wait(i);
      hp::wgmma_fence();
      if (role == kRoleDq) {
        tb90::tile_product<0, 1>(hp::slice<32>(acc, 32 * vb), a, ring.tile(i),
                                 4, true);
      } else {
        tb90::tile_product<1, 1>(hp::slice<32>(acc, 32 * vb), a, ring.tile(i),
                                 4, true);
      }
      hp::wgmma_commit();
      if (vb > 0) {
        hp::wgmma_wait<1>();
        ring.release(i - 1, lane);
      }
      ++i;
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    ring.release(i - 1, lane);
    ring.release(it, lane);
  }

  if (clamped) {
    hp::mbar_wait(ring.edges, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int sh_ = 1; sh_ <= 2; sh_ <<= 1) {
        sl[h] += __shfl_xor_sync(0xffffffffu, sl[h], sh_);
        sh[h] += __shfl_xor_sync(0xffffffffu, sh[h], sh_);
      }
    }
#pragma unroll
    for (int jj = 0; jj < NO / 8; ++jj) {
      const int col = c0 + 8 * jj + 2 * wq;
      if (col >= d) break;
      const float2 lo = tb90::edge_pair(ed, 0, 0, col);
      const float2 hi = tb90::edge_pair(ed, 0, 1, col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * jj + 2 * h] += sl[h] * lo.x + sh[h] * hi.x;
        acc[4 * jj + 2 * h + 1] += sl[h] * lo.y + sh[h] * hi.y;
      }
    }
  }

  // The fold: row 0 of dk (dv) gets sum_{r < hw} f_r x_r, row S-1 the same
  // over r >= S - hw (f the query's sum over its clamped keys, x its Q or
  // G), as JAX's _bwd_rule adds them: the row's in-range sum and the mass
  // each rounded to bf16, then their sum.
  if (role != kRoleDq && hw > 0) {
    const float* fold =
        (role == kRoleDk ? scr.fk : scr.fv) + static_cast<int64_t>(row) * s;
    const bf16* xs = (role == kRoleDk ? q : g) + base;
    for (int side = 0; side < 2; ++side) {
      const int key = side == 0 ? 0 : s - 1;
      if (key < t || key >= t + kStep) continue;
      const int r0 = side == 0 ? 0 : max(s - hw, 0);
      const int r1 = side == 0 ? min(hw, s) : s;
      const int col = c0 + 2 * tid;
      float m0 = 0.f, m1 = 0.f;
      if (2 * tid < NO && col < d) {
        for (int rq = r0; rq < r1; ++rq) {
          const float f = fold[rq];
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              xs + static_cast<int64_t>(rq) * d + col);
          m0 += f * __low2float(x);
          m1 += f * __high2float(x);
        }
      }
      hp::named_sync(tb90::kConsumerBar, tb90::kConsumers);
      if (2 * tid < NO) {
        mass[2 * tid] = m0;
        mass[2 * tid + 1] = m1;
      }
      hp::named_sync(tb90::kConsumerBar, tb90::kConsumers);
      const int rr = key - t;
      if (warp == rr >> 4 && gq == (rr & 7)) {
        const bool hi = (rr >> 3) & 1;
        // Each index a constant, so that acc stays in registers.
#pragma unroll
        for (int nt = 0; nt < NO / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a0 = hi ? acc[4 * nt + 2 + e] : acc[4 * nt + e];
            const float mv = mass[8 * nt + 2 * wq + e];
            const float b = round_bf16(round_bf16(a0) + round_bf16(mv));
            if (hi) {
              acc[4 * nt + 2 + e] = b;
            } else {
              acc[4 * nt + e] = b;
            }
          }
        }
      }
    }
  }
  tb90::store_acc<NO>(
      (role == kRoleDq ? dq : role == kRoleDk ? dk : dv) + base, acc, t, c0, s,
      d, tid);
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

// The maps of the wgmma kernels (tile_band_sm90.cuh): q, g, k, v with
// 64 x 64 boxes, k and v with one-row boxes (the edge rows), the scratch's
// p and ds.
struct Maps {
  CUtensorMap q, g, k, v, k1, v1, p, ds;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                      const void* g, const Scratch& scr, int64_t rows, int s,
                      int d, int halo) {
  const void* src[6] = {q, g, k, v, k, v};
  CUtensorMap* dst[6] = {&m->q, &m->g, &m->k, &m->v, &m->k1, &m->v1};
  for (int x = 0; x < 6; ++x) {
    const cudaError_t err =
        tb90::map_rows(dst[x], src[x], rows, s, d, x < 4 ? 64 : 1);
    if (err != cudaSuccess) return err;
  }
  const int nqb = (s + 15) / 16;
  const cudaError_t err =
      tb90::map_scratch(&m->p, scr.p, rows, nqb, 16 + 2 * halo);
  if (err != cudaSuccess) return err;
  return tb90::map_scratch(&m->ds, scr.ds, rows, nqb, 16 + 2 * halo);
}

// The rows kernel's ring stages (no kept tiles; the edge rows after it).
inline int rows_stages(int d, int no) {
  return tb90::ring_stages(tb90::edge_bytes(d), no <= 128 ? 2 : 1);
}

// The rows kernel at output slices of NO columns.
template <int NO>
cudaError_t launch_rows(const Maps& m, const void* q, const void* g,
                        void* dq, void* dk, void* dv, const Scratch& scr,
                        int64_t rows, int s, int d, int hw,
                        cudaStream_t stream) {
  const int ns = rows_stages(d, NO);
  const int smem = tb90::smem_bytes(0, ns, tb90::edge_bytes(d));
  const cudaError_t err = cudaFuncSetAttribute(
      tile_band_bwd_sm90_rows<NO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int steps = (s + kStep - 1) / kStep;
  const unsigned slices = (d + NO - 1) / NO;
  tile_band_bwd_sm90_rows<NO>
      <<<dim3(static_cast<unsigned>(rows * steps), 3 * slices),
         tb90::kThreads, smem, stream>>>(
          m.p, m.ds, m.k, m.k1, m.v1, m.q, m.g,
          static_cast<const bf16*>(q), static_cast<const bf16*>(g),
          static_cast<bf16*>(dq), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), scr, s, steps, d, hw, halo_of(hw), ns);
  return cudaGetLastError();
}

// The band kernel's ring stages beside Q's and G's tiles (keep): two blocks
// an SM where that leaves at least kMinStages, else one; where neither
// does, no kept tiles and Q and G through the ring (at least kStreamStages,
// one block an SM). *resident: the kept tiles' bytes.
inline int band_stages(int d, int* keep, int* resident) {
  const int edges = tb90::edge_bytes(d);
  const int kept = 2 * tb90::col_tiles(d) * tb90::kTileBytes;
  *keep = 1;
  *resident = kept;
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    const int ns = tb90::ring_stages(kept + edges, per_sm);
    if (ns) return ns;
  }
  *keep = 0;
  *resident = 0;
  return tb90::ring_stages(edges, 1, tb90::kStreamStages);
}

// The band kernel with Q and G kept (kKeep) or streamed.
template <bool kKeep>
cudaError_t launch_band(const Maps& m, const void* q, const void* g,
                        const Scratch& scr, int64_t rows, int s, int steps,
                        int d, int hw, int halo, int ns, int smem, float scale,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      tile_band_bwd_sm90_band<kKeep>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tile_band_bwd_sm90_band<kKeep>
      <<<static_cast<unsigned>(rows * steps), tb90::kThreads, smem, stream>>>(
          m.q, m.g, m.k, m.v, m.k1, m.v1, static_cast<const bf16*>(q),
          static_cast<const bf16*>(g), scr, s, steps, d, hw, halo, ns, scale);
  return cudaGetLastError();
}

// The wgmma kernels: band (64 queries a block), then rows (64 rows of dq,
// dk or dv and a slice of columns a block).
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv,
                        void* scratch, int64_t rows, int s, int d, int hw,
                        float scale, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int halo = halo_of(hw);
  const Scratch scr = carve(scratch, rows, s, halo);
  const int steps = (s + kStep - 1) / kStep;
  if (rows * steps > INT32_MAX) return cudaErrorInvalidConfiguration;
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, g, scr, rows, s, d, halo);
  if (err != cudaSuccess) return err;
  int keep = 0, resident = 0;
  const int ns = band_stages(d, &keep, &resident);
  if (ns == 0) return cudaErrorInvalidConfiguration;
  const int smem = tb90::smem_bytes(resident, ns, tb90::edge_bytes(d));
  err = keep ? launch_band<true>(m, q, g, scr, rows, s, steps, d, hw, halo,
                                 ns, smem, scale, stream)
             : launch_band<false>(m, q, g, scr, rows, s, steps, d, hw, halo,
                                  ns, smem, scale, stream);
  if (err != cudaSuccess) return err;
  switch (tb90::slice_width(d)) {
    case 64:
      return launch_rows<64>(m, q, g, dq, dk, dv, scr, rows, s, d, hw,
                             stream);
    case 128:
      return launch_rows<128>(m, q, g, dq, dk, dv, scr, rows, s, d, hw,
                              stream);
    case 192:
      return launch_rows<192>(m, q, g, dq, dk, dv, scr, rows, s, d, hw,
                              stream);
    default:
      return launch_rows<256>(m, q, g, dq, dk, dv, scr, rows, s, d, hw,
                              stream);
  }
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
  if (sm90_takes(d, hw)) {
    return static_cast<int>(launch_sm90(q, k, v, g, dq, dk, dv, scratch, rows,
                                        s, d, hw, scale, st));
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
// and wgmma kernels' p/ds tiles and fold sums. Returns
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
// report: the ring kernel's, or the larger of the wide (wgmma) kernels'
// two.
extern "C" int mhla_tile_band_bwd_smem(int d, int hw) {
  if (hw < 0 || d < 8 || d % 8 != 0) return -1;
  if (sm90_takes(d, hw)) {
    int keep = 0, resident = 0;
    const int ns = band_stages(d, &keep, &resident);
    const int band = tb90::smem_bytes(resident, ns, tb90::edge_bytes(d));
    const int rows = tb90::smem_bytes(
        0, rows_stages(d, tb90::slice_width(d)), tb90::edge_bytes(d));
    return std::max(band, rows);
  }
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

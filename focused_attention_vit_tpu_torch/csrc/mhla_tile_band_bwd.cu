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
// The f32 instantiation is a scalar-FMA kernel for parity runs, a block per
// 64 rows (a thread per query that reaches them, then a thread per key for
// dk and one for dv), reading q, k, v, g from device memory with p and ds in
// shared memory; it folds the edges the same way.

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
constexpr int kStep = 64;          // queries (keys) a step owns
constexpr int kRing = 160;         // rows of each of the Q, G, K and V rings
constexpr int kPTiles = 6;         // 16-query tiles of p and ds kept
constexpr int kBand = 48;          // keys a 16-query block reaches
constexpr int kLDP = kBand + 8;    // a p or ds tile row: conflict-free reads
constexpr int kThreads = 256;      // 8 warps
constexpr int kMinUnits = 8;       // steps a block takes at least
constexpr int kF32Threads = 128;
constexpr int kF32Rows = 64;       // rows an f32 block owns
constexpr int kF32Queries = kF32Rows + 2 * kHalo;
constexpr int kMaxBand = 2 * kHalo + 1;

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

template <int D>
__device__ __forceinline__ float row_dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return acc;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float* x) {
  const float4 y = *reinterpret_cast<const float4*>(x);
  acc.x += w * y.x;
  acc.y += w * y.y;
  acc.z += w * y.z;
  acc.w += w * y.w;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    tile_band_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      float* __restrict__ dq, float* __restrict__ dk,
                      float* __restrict__ dv, int s, int per_row, int hw,
                      float scale) {
  __shared__ float p_s[kF32Queries][kMaxBand];
  __shared__ float ds_s[kF32Queries][kMaxBand];
  __shared__ float fk_s[kF32Queries];
  __shared__ float fv_s[kF32Queries];

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / per_row;
  const int t0 = (blockIdx.x % per_row) * kF32Rows;
  const int64_t base = row * static_cast<int64_t>(s) * D;
  const float* qr = q + base;
  const float* kr = k + base;
  const float* vr = v + base;
  const float* gr = g + base;
  const int n = 2 * hw + 1;

  // A thread per query position t0 - 16 + tid: p and ds of its band (in
  // shared memory), dq of an owned query, and its sums over clamped keys;
  // a position outside [0, S) has g = 0 and so p g = ds = 0.
  if (tid < kF32Queries) {
    const int pos = t0 - kHalo + tid;
    float* pr = p_s[tid];
    float* dr = ds_s[tid];
    float fk = 0.f, fv = 0.f;
    if (pos >= 0 && pos < s) {
      float mx = -INFINITY;
      for (int o = 0; o < n; ++o) {
        const int64_t key = clamp_row(pos + o - hw, s);
        pr[o] = row_dot<D>(qr + static_cast<int64_t>(pos) * D, kr + key * D) *
                scale;
        dr[o] = row_dot<D>(gr + static_cast<int64_t>(pos) * D, vr + key * D);
        mx = fmaxf(mx, pr[o]);
      }
      float den = 0.f;
      for (int o = 0; o < n; ++o) {
        pr[o] = expf(pr[o] - mx);
        den += pr[o];
      }
      float rs = 0.f;
      for (int o = 0; o < n; ++o) {
        pr[o] /= den;
        rs += dr[o] * pr[o];
      }
      for (int o = 0; o < n; ++o) {
        dr[o] = (pr[o] * (dr[o] - rs)) * scale;
        const int key = pos + o - hw;
        if (key < 0 || key >= s) {
          fk += dr[o];
          fv += pr[o];
        }
      }
      if (tid >= kHalo && tid < kHalo + kF32Rows) {
        for (int c = 0; c < D; c += 4) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int o = 0; o < n; ++o) {
            fma4(acc, dr[o],
                 kr + static_cast<int64_t>(clamp_row(pos + o - hw, s)) * D +
                     c);
          }
          *reinterpret_cast<float4*>(dq + base +
                                     static_cast<int64_t>(pos) * D + c) = acc;
        }
      }
    } else {
      for (int o = 0; o < n; ++o) pr[o] = dr[o] = 0.f;
    }
    fk_s[tid] = fk;
    fv_s[tid] = fv;
  }
  __syncthreads();

  // Key position t0 + j gets offset o - hw from the query at position
  // t0 + j + hw - o, staged query j + 16 + hw - o. Threads 0-63 sum dk,
  // 64-127 dv; rows 0 and S-1 add the edge queries' clamped mass.
  const int j = tid & (kF32Rows - 1);
  const int pos = t0 + j;
  if (pos >= s) return;
  const bool is_dv = tid >= kF32Rows;
  const float* src = is_dv ? gr : qr;
  const float* fold = is_dv ? fv_s : fk_s;
  for (int c = 0; c < D; c += 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int o = 0; o < n; ++o) {
      const int i = j + kHalo + hw - o;
      fma4(acc, is_dv ? p_s[i][o] : ds_s[i][o],
           src + static_cast<int64_t>(clamp_row(pos + hw - o, s)) * D + c);
    }
    if (hw > 0 && pos == 0) {
      for (int r = 0; r < min(hw, s); ++r) {
        fma4(acc, fold[r - t0 + kHalo], src + static_cast<int64_t>(r) * D + c);
      }
    }
    if (hw > 0 && pos == s - 1) {
      for (int r = max(s - hw, 0); r < s; ++r) {
        fma4(acc, fold[r - t0 + kHalo], src + static_cast<int64_t>(r) * D + c);
      }
    }
    *reinterpret_cast<float4*>((is_dv ? dv : dk) + base +
                               static_cast<int64_t>(pos) * D + c) = acc;
  }
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* g, void* dq, void* dk, void* dv, int64_t rows,
                     int s, int hw, bool is_bf16, float scale, int device,
                     cudaStream_t stream) {
  if (!is_bf16) {
    const int per_row = (s + kF32Rows - 1) / kF32Rows;
    const int64_t blocks = rows * per_row;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    tile_band_bwd_f32<D><<<static_cast<unsigned>(blocks), kF32Threads, 0,
                           stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g),
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), s, per_row, hw, scale);
    return cudaGetLastError();
  }
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

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). q, k, v, g and dq, dk, dv are device pointers to
// contiguous [rows, s, d] tensors of one dtype (is_bf16 = 1 for bf16, 0 for
// f32), 16-byte aligned; 0 <= hw <= 16; d is 16, 32, 64 or 128; `stream` is
// the caller's cudaStream_t. dk and dv come with the clamped positions'
// mass already folded into rows 0 and S-1. The kernel allocates nothing and
// does not synchronise.
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
      err = launch_d<16>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale,
                         device, st);
      break;
    case 32:
      err = launch_d<32>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale,
                         device, st);
      break;
    case 64:
      err = launch_d<64>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale,
                         device, st);
      break;
    case 128:
      err = launch_d<128>(q, k, v, g, dq, dk, dv, rows, s, hw, bf, scale,
                          device, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of the bf16 kernel at head dim d (-1 for a d it
// does not take), for the build report.
extern "C" int mhla_tile_band_bwd_smem(int d) {
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

// The dense attention kernels' blocks for head dims past 256 (d a multiple
// of 8 above 256): the forward of flash_attention_fwd.cu and
// fused_mha_fwd.cu, the dkv and dq kernels of flash_attention_bwd.cu and
// fused_mha_bwd.cu. The fused op passes its Philox mask through the same
// Mask parameter as flash_fwd_block.cuh and flash_bwd_blocks.cuh; the
// dense op passes their NoMask.
//
// Replaces, past d = 256, what the narrower blocks replace:
// focused_attention_vit_tpu/ops/flash_attention_pallas.py::flash_attention_tpu
// (:28, JAX's bundled flash kernel, forward and backward) and
// focused_attention_vit_tpu/ops/mha_kernel.py::_fwd_kernel (:59) and
// ::_bwd_kernel (:83), which take any head dim that is a multiple of 8.
//
// Why another block: the blocks up to 256 hold a 64 x d accumulator of the
// output (or of dk, dv, dq) in one warpgroup's registers, which past 256 no
// longer fit. So the output columns are split into slices over the grid's
// y dimension, and a block forms the logits (and dP) over all of d once per
// slice. What bounds it: operations, times that recomputation, which the
// slice plan keeps small (ops/flash_attention.py wide_plan: the slices and
// each warpgroup's share of a slice are launch arguments, and PERF.md's
// recomputation factors come from the same function).
//
// A block is two warpgroups that run wgmma, 256 threads and nothing else:
// each keeps a ring of 64 x 64 bf16 tiles (tile_band_sm90.cuh: the tiles,
// the Ring's full mbarriers, the 3-D maps over [rows, S, d] that read
// zeros past S and past d and never the next head) that its own thread 0
// refills by TMA as soon as the warpgroup's four warps have passed a named
// barrier after the products that read the stages. 256 threads leave a
// thread 255 registers: a 64 x 256 f32 accumulator beside the logits and
// the other warpgroup's half tile, no spill. (A third, producer warpgroup
// held ptxas to the launch's 168 registers a thread, setmaxnreg split
// 40/232 or 24/240 alike, and a 64 x 192 accumulator spilled; refills
// gated on an empty mbarrier that the producing thread waited on took half
// of a step, and the stage and phase divided out of the item's index 500
// cycles an item in the refilling thread: both are counted instead.)
// A block owns 64 rows (queries, or keys for dkv) of one head, and steps
// over the other side's 64-row tiles:
//   - forward (64 queries, a slice of up to 2 x 256 output columns): the
//     two warpgroups split d's 64-column chunks (even and odd) for Q K^T,
//     each adds the other's 64 x 64 f32 partial through shared memory, and
//     both run the same online softmax (exp2 with the scale folded in, keys
//     past S at -inf, then mask.apply); each then adds P V over its own
//     share of the slice, P a register A operand. So every logit is formed
//     once per slice, and the forward does (slices + 1) / 2 times its
//     4 S^2 d operations;
//   - dkv (64 keys, a slice of up to 256 columns of dk and of dv):
//     warpgroup 0 forms S^T = K Q^T over d and adds dv += P^T g, warpgroup
//     1 forms dP^T = V g^T over d, reads S^T from warpgroup 0 through shared
//     memory and adds dk += dS^T Q (both through mask.dkv);
//   - dq (64 queries, a slice of up to 2 x 256 columns of dq): warpgroup 0
//     forms S = Q K^T, warpgroup 1 dP = g V^T, they swap them through shared
//     memory, both form dS (mask.dq), and each adds dq += dS K over its
//     share of the slice.
// dkv and dq stay two kernels: each of dq, dk, dv is written by one thread
// once, so a run gives the same bits as the last. The block's own 64 rows
// of the products' A operand (Q, or K and V, or Q and g) stay in shared
// memory where they fit beside the exchange and the rings, else they come
// through the ring just before the tile they multiply; a ring needs its
// share of a slice plus two stages. The products run in groups (two chunks
// of logits, or a step's slice), each completed before the code goes on:
// with a product in flight across a loop's back edge, or a branch between
// the products of a group, ptxas serialized every wgmma of the kernel. The
// masks act on a warp's 16 rows of the wgmma accumulator layout
// (hopper_common.cuh), that of the blocks up to 256.
// (The f32 calls, at every head dim, take flash_f32.cuh's scalar kernels.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "tile_band_sm90.cuh"

namespace flash_wide {


namespace hp = hopper;
using bf16 = __nv_bfloat16;
using tb90::kTileBytes;
using tb90::kTileElems;
using tb90::Ring;

constexpr int kConsumers = 256;  // two consumer warpgroups, nothing else
constexpr int kThreads = kConsumers;
constexpr int kXchgBar = 1;        // named barrier of the two consumers
constexpr int kRingBar = 2;        // + w: consumer w's own named barrier
constexpr int kGroup = 2;          // chunks a group of wgmmas
constexpr int kXBytes = 64 * 64 * 4;  // one warpgroup's f32 tile to swap

enum Kind { kFwd = 0, kDkv = 1, kDq = 2 };

// 64-column output tiles a consumer accumulates, at most: 256 columns, 128
// registers a thread.
constexpr int kMaxTiles = 4;

// The head dims these blocks take.
inline bool takes(int d) { return d > 256 && d % 8 == 0; }

// Warpgroups that split a slice's output columns: both for the forward and
// dq, one (each its own tensor, dv and dk) for dkv.
__host__ __device__ constexpr int split_of(int kind) {
  return kind == kDkv ? 1 : 2;
}

// What a block works on: S, d, the 64-row tiles of a head (blockIdx.x =
// head * tiles + tile), the block's own A-operand tiles kept in shared
// memory (keep) or streamed, and the stages of each consumer's ring.
struct Geom {
  int s, d, tiles, keep, ns;
};

// Pointers besides the maps: the forward's out (and lse, written with
// kLse); the backward's lse and delta (read) and dv and dk (dkv: warpgroup
// 0 writes dv, 1 dk) or dq (both).
struct Io {
  bf16* out0;
  bf16* out1;
  float* lse;
  const float* delta;
  float scale, scale_log2;
};

// --- host: the slice plan's checks, shared memory, grid ----------------------

// A plan of `slices` slices of `tiles` 64-column tiles a warpgroup covers d
// with no empty slice.
inline bool plan_ok(int kind, int d, int slices, int tiles) {
  const int ct = tb90::col_tiles(d);
  const int per = split_of(kind) * tiles;
  return tiles >= 2 && tiles <= kMaxTiles && slices >= 1 &&
         slices * per >= ct && (slices - 1) * per < ct;
}

// Bytes of the f32 exchange: one tile each way, but dkv's one way.
__host__ __device__ constexpr int xchg_bytes(int kind) {
  return kind == kDkv ? kXBytes : 2 * kXBytes;
}

// The rings and the kept tiles: keep the own tiles (forward: Q's ct;
// backward: two operands' 2 ct) where each ring then keeps tiles + 2
// stages, else stream them; returns the dynamic shared memory (0 where not
// even the streamed rings fit).
inline int smem_plan(int kind, int d, int tiles, Geom* g) {
  const int ct = tb90::col_tiles(d);
  const int own = (kind == kFwd ? ct : 2 * ct) * kTileBytes;
  const int room = tb90::smem_budget(1) - xchg_bytes(kind);
  const int least = tiles + 2;
  auto stages = [&](int resident) {
    int n = (room - resident) / (2 * kTileBytes);
    n = n > tb90::kMaxStages ? tb90::kMaxStages : n;
    return n < least ? 0 : n;
  };
  g->keep = stages(own) > 0;
  const int resident = g->keep ? own : 0;
  g->ns = stages(resident);
  if (g->ns == 0) return 0;
  return 1024 + resident + xchg_bytes(kind) + 2 * g->ns * kTileBytes;
}

// The grid: (heads x 64-row tiles, slices).
inline cudaError_t grid_of(dim3* grid, Geom* g, int64_t rows, int s,
                           int slices) {
  g->tiles = (s + 63) / 64;
  const int64_t blocks = rows * g->tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  *grid = dim3(static_cast<unsigned>(blocks), slices);
  return cudaSuccess;
}

// The maps of a [rows, s, d] bf16 tensor: 64 x 64 boxes (128-byte swizzle),
// through the shared cache of maps.
inline cudaError_t map_of(CUtensorMap* map, const void* base, int64_t rows,
                          int s, int d) {
  return tb90::map_rows(map, base, rows, s, d, 64);
}

// --- device -----------------------------------------------------------------

// The maps a warpgroup's ring reads: A the block's own rows (the logits'
// A operand), B the other side's tile of each step (their B operand), X
// the tile whose columns the slice product accumulates.
struct Maps {
  const CUtensorMap* a;
  const CUtensorMap* b;
  const CUtensorMap* x;
};

// The chunks of d (64 columns) that consumer w multiplies: the forward's
// two split them (even, odd); the backward's each take all.
template <int KIND>
__device__ __forceinline__ int chunk_count(int ct, int w) {
  return KIND == kFwd ? (ct - w + 1) / 2 : ct;
}
template <int KIND>
__device__ __forceinline__ int chunk_at(int u, int w) {
  return KIND == kFwd ? 2 * u + w : u;
}

// The 64-column output tile that slice `sl`'s tile t of consumer w is
// (past d for some tiles of the last slice: they arrive as zeros and are
// not stored).
template <int KIND, int NT>
__device__ __forceinline__ int out_tile(int sl, int w, int t) {
  return KIND == kDkv ? sl * NT + t : (sl * 2 + w) * NT + t;
}

// The kept tile of consumer w's chunk c (the forward's Q is one set of
// tiles for both; the backward keeps two operands).
template <int KIND>
__device__ __forceinline__ int kept_slot(int c, int w, int ct) {
  return KIND == kFwd ? c : w * ct + c;
}

// A consumer's ring, fed by its own thread 0: item n is the tile the
// consumer reads n-th (per step j: each of its chunks' A tile, where not
// kept, and B tile, then its NT slice tiles). Thread 0 loads item n once
// the consumer's four warps have released item n - ns, the ring's previous
// tile in that stage; it loads the kept tiles first, on the ring's `kept`
// barrier.
template <int KIND, int NT>
struct Feed {
  Ring ring;
  Maps m;
  const Geom& g;
  int row, r0, sl, w, nu, per;
  int sent = 0;                // items whose loads have started
  int j = 0, r = 0, stage = 0;  // the next one's step, place in it, stage

  __device__ __forceinline__ void kept(bf16* tiles, int ct) {
    hp::prefetch_tensor_map(m.a);
    hp::prefetch_tensor_map(m.b);
    hp::prefetch_tensor_map(m.x);
    hp::mbar_arrive_expect_tx(ring.kept, nu * kTileBytes);
    for (int u = 0; u < nu; ++u) {
      const int c = chunk_at<KIND>(u, w);
      hp::tma_load_3d(tiles + kept_slot<KIND>(c, w, ct) * kTileElems, m.a,
                      ring.kept, 64 * c, r0, row);
    }
  }
  // Start the loads of every item below n (and below the last).
  __device__ __forceinline__ void upto(int n) {
    const int chunk_items = nu * per;
    for (; sent < n && j < g.tiles; ++sent) {
      const CUtensorMap* map = m.x;
      int c0, p0 = 64 * j;
      if (r < chunk_items) {
        c0 = 64 * chunk_at<KIND>(per == 2 ? r >> 1 : r, w);
        if (per == 2 && (r & 1) == 0) {
          map = m.a;
          p0 = r0;
        } else {
          map = m.b;
        }
      } else {
        c0 = 64 * out_tile<KIND, NT>(sl, w, r - chunk_items);
      }
      tb90::load_full(reinterpret_cast<bf16*>(ring.base + stage * kTileBytes),
                      map, &ring.full[stage], c0, p0, row, 0);
      if (++stage == ring.ns) stage = 0;
      if (++r == chunk_items + NT) {
        r = 0;
        ++j;
      }
    }
  }
};

// The consumer's side of its ring: items in order, each waited for on its
// stage's full barrier (the stage and the barrier's phase counted, not
// divided out).
struct Taker {
  Ring ring;
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ const bf16* next() {
    hp::mbar_wait(&ring.full[stage], phase);
    const bf16* tile =
        reinterpret_cast<const bf16*>(ring.base + stage * kTileBytes);
    if (++stage == ring.ns) {
      stage = 0;
      phase ^= 1;
    }
    return tile;
  }
};

// This thread's 32 accumulator floats to (from) its consumer's exchange
// tile: element e of thread t at e * 128 + t, so a warp's stores and loads
// are 128 consecutive bytes.
__device__ __forceinline__ void put(float* x, const float (&a)[32], int t) {
#pragma unroll
  for (int e = 0; e < 32; ++e) x[e * 128 + t] = a[e];
}
template <int N>
__device__ __forceinline__ void get(float (&a)[N], const float* x, int t) {
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = x[e * 128 + t];
}
__device__ __forceinline__ void add(float (&a)[32], const float* x, int t) {
#pragma unroll
  for (int e = 0; e < 32; ++e) a[e] += x[e * 128 + t];
}


// acc (+)= A B^T over one 64-column chunk: A and B 64 x 64 tiles read
// K-major, four 16-column steps (zeros past d add nothing).
__device__ __forceinline__ void chunk_product(float (&acc)[32], const bf16* a,
                                              const bf16* b,
                                              bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    tb90::mma_ss<0, 0>(acc, tb90::desc_k(a, kk), tb90::desc_k(b, kk),
                       (accumulate || kk > 0) ? 1 : 0);
  }
}

// Consumer w of a block (t its thread in the warpgroup, 0..127): per step
// j, the logits (or dP) over its chunks, the exchange, the elementwise
// step, and the slice product over its NT output tiles. Both consumers run
// this code; only the elementwise step and the stores branch on w. Its
// thread 0 feeds the ring.
template <int KIND, int NT, bool kLse, class Mask>
__device__ __forceinline__ void consume(const Ring ring, bf16* kept,
                                        const Maps maps, float* xbuf,
                                        float* lse_s, float* delta_s,
                                        const Geom& g, const Io& io,
                                        const Mask& mask, int row, int r0,
                                        int sl, int w) {
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int wq = lane & 3;
  const int gr = warp * 16 + (lane >> 2);  // rows gr, gr + 8 of the 64
  const int ct = tb90::col_tiles(g.d);
  const int nu = chunk_count<KIND>(ct, w);
  const int per = g.keep ? 1 : 2;  // ring items a logits product reads
  const int64_t vec = static_cast<int64_t>(row) * g.s;

  float acc[NT * 32];  // the slice's accumulator: NT tiles of 64 x 64
#pragma unroll
  for (int e = 0; e < NT * 32; ++e) acc[e] = 0.f;
  float a[32];        // this consumer's product
  uint32_t pa[4][4];  // the A operand of the slice product
  // Forward: the running maximum (log2 units) and this lane's share of the
  // sum of rows gr, gr + 8. dq: those rows' lse (log2 units) and delta.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  if constexpr (KIND == kDq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = r0 + gr + 8 * h;
      m[h] = qi < g.s ? io.lse[vec + qi] * flash::kLog2e : INFINITY;
      l[h] = qi < g.s ? io.delta[vec + qi] : 0.f;
    }
  }
  Feed<KIND, NT> feed{ring, maps, g, row, r0, sl, w, nu, per};
  if (t == 0) {
    if (g.keep) feed.kept(kept, ct);
    feed.upto(g.ns);
  }
  if (g.keep) hp::mbar_wait(ring.kept, 0);

  // Chunk u's A tile (kept, or the ring's item `item`, which it passes),
  // once its B tile, the next item, has landed too.
  Taker take{ring};
  auto operand = [&](int u, int& item, const bf16*& bt) {
    const bf16* at = kept + kept_slot<KIND>(chunk_at<KIND>(u, w), w, ct) *
                                kTileElems;
    if (!g.keep) {
      at = take.next();
      ++item;
    }
    bt = take.next();
    ++item;
    return at;
  };

  int i = 0;  // the next ring item
  for (int j = 0; j < g.tiles; ++j) {
    // dkv: this step's lse (log2 units, +inf past S) and delta, staged by
    // consumer 0 between the exchange's barriers.
    float staged = 0.f;
    if (KIND == kDkv && w == 0) {
      const int qi = 64 * j + (t & 63);
      staged = t < 64 ? (qi < g.s ? io.lse[vec + qi] * flash::kLog2e
                                  : INFINITY)
                      : (qi < g.s ? io.delta[vec + qi] : 0.f);
    }

    // 1. The logits (dkv: S^T or dP^T; dq: S or dP) over this consumer's
    // chunks, two chunks a group of wgmmas. Every group completes before
    // the code goes on; past the warpgroup's barrier its stages are free
    // and thread 0 refills them.
    int u = 0;
    for (; u + kGroup <= nu; u += kGroup) {
      const bf16 *at[kGroup], *bt[kGroup];
#pragma unroll
      for (int x = 0; x < kGroup; ++x) at[x] = operand(u + x, i, bt[x]);
      hp::wgmma_fence();
#pragma unroll
      for (int x = 0; x < kGroup; ++x) {
        chunk_product(a, at[x], bt[x], u + x > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::named_sync(kRingBar + w, 128);  // every warp's products have completed
      if (t == 0) feed.upto(i + g.ns);
    }
    for (; u < nu; ++u) {
      const bf16 *b0, *a0 = operand(u, i, b0);
      hp::wgmma_fence();
      chunk_product(a, a0, b0, u > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::named_sync(kRingBar + w, 128);
      if (t == 0) feed.upto(i + g.ns);
    }
    hp::fence_regs(a);

    // 2. The exchange: the first barrier frees the tiles the other
    // consumer read last step, the second publishes this step's.
    hp::named_sync(kXchgBar, kConsumers);
    if (KIND != kDkv || w == 0) put(xbuf + w * 4096, a, t);
    if (KIND == kDkv && w == 0) (t < 64 ? lse_s : delta_s)[t & 63] = staged;
    hp::named_sync(kXchgBar, kConsumers);

    // 3. The elementwise step, into the slice product's A operand.
    if constexpr (KIND == kFwd) {
      add(a, xbuf + (1 - w) * 4096, t);
      const int key0 = 64 * j;
      if (key0 + 64 > g.s) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (key0 + (e >> 2) * 8 + 2 * wq + (e & 1) >= g.s) a[e] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], a[e]);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // The tile's first key is real, so m_new is finite.
        const float m_new = fmaxf(m[h], mx[h] * io.scale_log2);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        const float p = exp2f(fmaf(a[e], io.scale_log2, -m[h]));
        a[e] = p;
        l[h] += p;
      }
      mask.apply(a, row, r0 + gr, key0);
#pragma unroll
      for (int e = 0; e < NT * 32; ++e) acc[e] *= alpha[(e >> 1) & 1];
    } else if constexpr (KIND == kDkv) {
      // Consumer 0 keeps p^T (with the mask's keep) in a; consumer 1 turns
      // dP^T into dS^T in a from the S^T it reads, half a tile (32 queries)
      // at a time, to hold 16 of the other's floats and not 32.
      if (w == 0) {
        float unused[32] = {};  // dP^T: consumer 1's
        mask.dkv(a, unused, lse_s, delta_s, io.scale, io.scale_log2, row,
                 r0 + warp * 16, 64 * j);
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float st[16];
          get(st, xbuf + hf * 16 * 128, t);
          mask.dkv(st, hp::slice<16>(a, 16 * hf), lse_s + 32 * hf,
                   delta_s + 32 * hf, io.scale, io.scale_log2, row,
                   r0 + warp * 16, 64 * j + 32 * hf);
        }
      }
    } else {
      // Both form dS into a, half a tile (32 keys) at a time: consumer 0
      // from its S and the dP it reads, consumer 1 from its dP and the S.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float other[16];
        get(other, xbuf + (1 - w) * 4096 + hf * 16 * 128, t);
        float (&mine)[16] = hp::slice<16>(a, 16 * hf);
        if (w == 0) {
          mask.dq(mine, other, m, l, io.scale, io.scale_log2, g.s, row,
                  r0 + gr, 64 * j + 32 * hf);
#pragma unroll
          for (int e = 0; e < 16; ++e) mine[e] = other[e];
        } else {
          mask.dq(other, mine, m, l, io.scale, io.scale_log2, g.s, row,
                  r0 + gr, 64 * j + 32 * hf);
        }
      }
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) hp::pack_a(pa[kc], a, kc);

    // 4. The slice product over this consumer's output tiles, one group.
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    const bf16* xt[NT];
#pragma unroll
    for (int x = 0; x < NT; ++x) xt[x] = take.next();
    hp::wgmma_fence();
#pragma unroll
    for (int x = 0; x < NT; ++x) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        hp::Wgmma<64>::rs(hp::slice<32>(acc, 32 * x), pa[kc],
                          tb90::desc_mn(xt[x], kc), 1);
      }
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    hp::fence_regs(pa);
    i += NT;
    hp::named_sync(kRingBar + w, 128);
    if (t == 0) feed.upto(i + g.ns);
  }

  // The results: rows past S and columns past d are not written.
  bf16* base = (KIND == kDkv && w == 1) ? io.out1 : io.out0;
  if constexpr (KIND == kFwd) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = mask.inv_keep / l[h];
      const int qi = r0 + gr + 8 * h;
      if (kLse && w == 0 && sl == 0 && wq == 0 && qi < g.s) {
        io.lse[vec + qi] = (m[h] + log2f(l[h])) * flash::kLn2;
      }
    }
#pragma unroll
    for (int e = 0; e < NT * 32; ++e) acc[e] *= inv[(e >> 1) & 1];
  }
  base += vec * g.d;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    tb90::store_acc<64>(base, hp::slice<32>(acc, 32 * u), r0,
                        64 * out_tile<KIND, NT>(sl, w, u), g.s, g.d, t);
  }
}

// The block of a kernel of kThreads threads (its maps __grid_constant__
// kernel parameters): the A, B and X maps of each consumer (Maps).
template <int KIND, int NT, bool kLse, class Mask>
__device__ __forceinline__ void block(const Maps& m0, const Maps& m1,
                                      const Geom& g, const Io& io,
                                      const Mask& mask) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2][2 * tb90::kMaxStages + 2];
  __shared__ float lse_s[64], delta_s[64];  // dkv: one query tile's
  uint8_t* smem = hp::align1024(smem_raw);
  const int ct = tb90::col_tiles(g.d);
  const int kept_bytes = g.keep ? (KIND == kFwd ? ct : 2 * ct) * kTileBytes
                                : 0;
  bf16* kept = reinterpret_cast<bf16*>(smem);
  float* xbuf = reinterpret_cast<float*>(smem + kept_bytes);
  const int rings = kept_bytes + xchg_bytes(KIND);
  const Ring ring0 = tb90::make_ring(smem, rings, bars[0], g.ns);
  const Ring ring1 =
      tb90::make_ring(smem, rings + g.ns * kTileBytes, bars[1], g.ns);

  const int w = threadIdx.x >> 7;  // the consumer warpgroup
  const int row = static_cast<int>(blockIdx.x / g.tiles);
  const int r0 = static_cast<int>(blockIdx.x % g.tiles) * 64;
  const int sl = static_cast<int>(blockIdx.y);
  consume<KIND, NT, kLse>(w ? ring1 : ring0, kept, w ? m1 : m0, xbuf, lse_s,
                          delta_s, g, io, mask, row, r0, sl, w);
}

// --- host: the launch -------------------------------------------------------

// One launch of `kernel` (of kind `kind`, built for `tiles` output tiles a
// warpgroup; every wide kernel takes four maps, the forward's fourth
// unused, then the geometry, the pointers and the mask) over contiguous
// [rows, s, d] bf16 q, k, v and x (the backward's g; the forward passes v
// again), in `slices` slices.
template <class KernelT, class Mask>
inline cudaError_t launch(KernelT kernel, int kind, int tiles,
                          const void* q, const void* k, const void* v,
                          const void* x, int64_t rows, int s, int d,
                          int slices, const Io& io, const Mask& mask,
                          cudaStream_t stream) {
  if (!plan_ok(kind, d, slices, tiles)) return cudaErrorInvalidValue;
  Geom g{s, d, 0, 0, 0};
  dim3 grid;
  cudaError_t err = grid_of(&grid, &g, rows, s, slices);
  if (err != cudaSuccess) return err;
  const int smem = smem_plan(kind, d, tiles, &g);
  if (smem == 0) return cudaErrorInvalidConfiguration;
  CUtensorMap m[4];
  const void* src[4] = {q, k, v, x};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = map_of(&m[i], src[i], rows, s, d);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], g, io,
                                           mask);
  return cudaGetLastError();
}

// The dynamic shared memory of a kind's kernel at head dim d and `tiles`
// (0 where the head dim is not a wide one or no ring fits).
inline int smem_of(int kind, int d, int tiles) {
  Geom g{};
  return takes(d) && tiles >= 2 && tiles <= kMaxTiles
             ? smem_plan(kind, d, tiles, &g)
             : 0;
}

}  // namespace flash_wide

// MHLA window band, backward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/mhla_band_roll.py::_bwd_kernel
// (:199, the Pallas lane-roll backward, reached through _roll_bwd :481),
// with the halo fold of _fold_ext (:330) as its spec. Wrapper and plain
// PyTorch version: focused_attention_vit_tpu_torch/ops/mhla_band_roll.py.
//
// What it computes, for each (b*h) row, from q, k, v, the output cotangent g
// (all [B*h, d, S] of one dtype), the forward's pre-dropout softmax weights
// w (f32 [B*h, W, S], written by mhla_band_fwd.cu) and, with dropout, the
// forward's mask regenerated from the seed (philox.cuh):
//   per query i and slot o (key j_o, the forward's edge rule):
//     u_o   = g_i . v_{j_o}
//     dw_o  = keep_o ? u_o / (1-rate) : 0     (u_o without dropout)
//     wd_o  = keep_o ? w_o / (1-rate) : 0     (w_o without dropout)
//     dlog_o = w_o * (dw_o - sum_p w_p dw_p)  (softmax backward)
//     dq_i  = sum_o dlog_o * k_{j_o} * scale
//   and for each key j, summed over every (query i, slot o) that read it:
//     dk_j  = sum dlog_o * scale * q_i,   dv_j = sum wd_o * g_i.
// All sums are in f32; dq, dk and dv are rounded once to the input dtype.
//
// The TPU kernel adds each query tile's dk/dv into a VMEM scratch that
// persists across the tiles of a row (a sequential grid), then folds the
// halo on the last tile. On this card blocks run in parallel and in no
// order, so the sum is turned around and made key-centred, in two passes
// with no atomics (float atomics would make the sum order, and so the
// result, change from run to run):
//   pass 1, a block per tile of kTile queries of a row: u, the softmax
//     backward and dq; it writes the per-slot coefficients dlog_o * scale
//     and wd_o (f32 [2, B*h, W, S] scratch, allocated by the wrapper, in
//     the weights' [W, S] layout);
//   pass 2, a block per tile of kTile keys, dk in its even warps and dv in
//     its odd ones: an interior key j is read by exactly one slot of each of
//     the W queries i = j + W/2 - o, so dk/dv gather those W terms. Only
//     keys S-1 and 0 also collect the slots that
//     wrapped past the edges (queries i < W/2 for S-1, i >= S - (W-1-W/2)
//     for 0): the fold of _fold_ext. A block that holds one of those keys
//     computes the fold of every channel once, before its channel loop, into
//     shared memory; the thread that owns the key adds one value a channel.
//
// What bounds it on this card: bytes, by the function. A query costs about
// 10*W*d flops against 7 d-vectors of 2 bytes and 4W f32 words of weights
// and scratch, far below the card's flop-to-byte ratio. The two passes move
// 718 MB and 684 MB at B*h=384, S=3137, W=7, d=64 (0.42 ms at 3.35 TB/s;
// the function's own floor, without the scratch, is 0.33 ms). In practice
// the instructions come close to the bytes: each staged bf16 value is
// widened to f32 once per run that reads it, and the FMAs are scalar f32
// (the tensor cores take no product of this shape). The design:
//   - Tiles in shared memory (the helpers are band_stage.cuh's, shared with
//     the forward). A block stages the rows it reads in chunks of
//     kChunk channels, double-buffered: the next chunk's copies run under
//     this chunk's FMAs. Each channel row holds the tile's columns and its
//     halo (kTile + W - 1, plus the alignment slack). Copies are 16-byte
//     cp.async (L1 bypassed; neighbouring tiles' halos come from L2).
//   - Alignment. In the S-minor layout channel c of row r starts at element
//     (r*d + c)*S, which at odd S is 2-byte aligned for most channels. So a
//     channel's columns are copied as the 16-byte-aligned span that covers
//     them, and the staged row keeps the channel's element offset within
//     16 bytes: column x sits at x - c_lo + lead(c_lo). The slack belongs to
//     the neighbouring channel or row and is never read into a sum. TMA does
//     not fit this layout: a tensor map's strides must be multiples of
//     16 bytes, and a channel's stride, S*2 bytes, is not one at odd S.
//   - The halo at a row's two ends follows the edge rule, not the memory:
//     after a chunk lands, the columns below 0 are filled from column S-1
//     and those past S-1 from column 0 (pass 1), or with zeros (pass 2,
//     whose out-of-row queries carry no coefficient).
//   - Runs of consecutive queries (keys) a thread: kRun = 4 in pass 1,
//     kKeyRun = 8 in pass 2 (4 past slot cap 8). For one channel a thread
//     reads run + W - 1 staged values as 8-byte words and does run * W
//     FMAs, where one query a thread would issue W + 1 scalar loads for W
//     FMAs. In pass 2 a thread gives one of dk and dv, so its coefficients
//     (run * WMAX f32) and its one run of staged values fit the registers
//     of a run twice as long.
//   - The slot count is a template parameter, WMAX in {8, 16}, dispatched by
//     W inside the entry point: at W = 7 the slot arrays and loops are 8
//     wide. The head dim is an argument (a multiple of 8: whole chunks).
//   - Past 16 slots (W = 17..129) the runs' slots no longer fit the
//     registers, and both passes take them in groups of 16, as the
//     forward's wide kernel does: pass 1 sums u group by group (g and the
//     group's v columns staged) and writes dw and wd to the scratch while it
//     sums the softmax backward's dot product, then turns each of its own
//     queries' dw into dlog * scale in place, then stages k with the whole
//     halo chunk by chunk and sums dq over the groups, each group's
//     coefficients read back once for the chunk's channels; pass 2 stages q
//     and g with the whole halo and sums dk and dv the same way, in runs of
//     4 keys. The scratch keeps its [2, B*h, W, S] shape.
//   - dq, dk and dv go out through a staged tile as well (written there in
//     bf16 pairs), so the stores are 16 bytes wide but for each channel's
//     two ragged ends.
//   - The scratch keeps the weights' [W, S] layout: the wrapper's
//     [2, B*h, W, S] allocation leaves no room for padding a row to whole
//     tiles. Its reads and writes are scalar but coalesced across a warp.
// Tried and not kept (in turns on one card): 3 stages, or 4 stages of
// 4-channel chunks, or 16-channel chunks, all of which cost blocks an SM;
// 64-thread blocks; the channel loop unrolled by 2 (more registers, fewer
// blocks); runs of 8 queries in pass 1 (64 threads a block).
// The f32 instantiation runs the same kernels (4 channels a chunk, scalar
// reads of the staged rows): it is the parity version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "band_stage.cuh"
#include "philox.cuh"

namespace {

using namespace band_stage;

constexpr int kMaxWindow = 129;  // the wrapper raises above this
constexpr int kMaxSlots = 16;    // slots in registers: W's cap, then a group
constexpr int kTile = 512;       // queries (keys) a block
constexpr int kRun = 4;         // consecutive queries a thread (pass 1)
constexpr int kThreads = kTile / kRun;
// Consecutive keys a thread of pass 2, which gives dk and dv to different
// warps: 8 at slot cap 8 (128 threads), 4 at 16 (256 threads), so that a
// thread's coefficients stay at 64 registers.
template <int WMAX>
constexpr int kKeyRun = WMAX <= 8 ? 8 : 4;
template <int WMAX>
constexpr int kKeyThreads = 2 * kTile / kKeyRun<WMAX>;

template <typename T>
constexpr int kChunk = sizeof(T) == 2 ? 8 : 4;  // channels a staged chunk
constexpr int kStages = 2;  // chunks staged at once: one computed, the rest
                            // in flight
// Elements of one staged channel row: the tile, its halo (W - 1) and the
// slack of aligning both ends to 16 bytes; a multiple of 8 elements, so
// every row starts 16-byte aligned.
template <int WMAX>
constexpr int kWidth = kTile + WMAX + 16;
// The wide kernels' staged rows: the tile, the whole halo (W - 1 <= 128),
// the alignment slack and the 8-byte words that the last group's runs read
// past its one real slot.
constexpr int kWideWidth = kTile + kMaxWindow - 1 + 32;
constexpr int kWideKeyRun = 4;  // keys a thread of the wide pass 2
constexpr int kWideKeyThreads = 2 * kTile / kWideKeyRun;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Dropout {
  uint64_t seed;
  uint32_t threshold;
  float one_minus_rate;
};

template <typename T, int WIDTH>
constexpr int query_smem_bytes() {
  // kStages stages of (v or k, g) and the dq tile.
  return (2 * kStages + 1) * kChunk<T> * WIDTH * static_cast<int>(sizeof(T));
}
template <typename T, int WIDTH>
constexpr int key_smem_bytes(int d) {
  // kStages stages of (q, g), the dk and dv tiles, and the edge fold.
  return (2 * kStages + 2) * kChunk<T> * WIDTH * static_cast<int>(sizeof(T)) +
         4 * d * static_cast<int>(sizeof(float));
}

// The edge fold of a block that holds key S-1 or key 0, one channel a
// thread, into fold[edge: S-1, 0][dk, dv][d]: the wrapped slots of queries
// i < hw (slots o < hw - i) land on key S-1, those of queries
// i >= S - (w-1-hw) (slots o >= S + hw - i) on key 0. q and g point at the
// row's channel 0, ckr and cvr at its coefficient rows.
template <typename T, int NT>
__device__ __forceinline__ void edge_fold(float* fold, const T* q, const T* g,
                                          const float* ckr, const float* cvr,
                                          int d, int s, int w, bool has_last,
                                          bool has_first) {
  if (!has_last && !has_first) return;
  const int64_t sl = s;
  const int hw = w / 2;
  for (int c = threadIdx.x; c < d; c += NT) {
    const T* qr = q + c * sl;
    const T* gr = g + c * sl;
    float fk = 0.f, fv = 0.f;
    if (has_last) {
      for (int i = 0; i < hw; ++i) {
        const float qv = to_f32(qr[i]);
        const float gv = to_f32(gr[i]);
        for (int o = 0; o < hw - i; ++o) {
          fk += ckr[o * sl + i] * qv;
          fv += cvr[o * sl + i] * gv;
        }
      }
    }
    fold[c] = fk;
    fold[d + c] = fv;
    fk = fv = 0.f;
    if (has_first) {
      for (int i = s - (w - 1 - hw); i < s; ++i) {
        const float qv = to_f32(qr[i]);
        const float gv = to_f32(gr[i]);
        for (int o = s + hw - i; o < w; ++o) {
          fk += ckr[o * sl + i] * qv;
          fv += cvr[o * sl + i] * gv;
        }
      }
    }
    fold[2 * d + c] = fk;
    fold[3 * d + c] = fv;
  }
}

// Pass 1: a block per kTile queries of a row; thread t owns the run of
// queries i0 + kRun*t + r. Chunks 0..NC-1 stage v and g and sum u; chunks
// NC..2NC-1 stage k, and the first of them turns u into the coefficients.
template <typename T, int WMAX, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    band_bwd_query_kernel(const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ g,
                          const float* __restrict__ wts, T* __restrict__ dq,
                          float* __restrict__ coef_k,
                          float* __restrict__ coef_v, int nc, int s, int w,
                          int tiles_per_row, float scale, Dropout drop) {
  constexpr int C = kChunk<T>;
  constexpr int WIDTH = kWidth<WMAX>;
  // The chunk count is an argument, not d / C: read from the parameter
  // bank, it takes no register (the eval kernel is held to 96).
  const int NC = nc;
  const int d = nc * C;
  constexpr int RUN = kRun + WMAX - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SC = C * WIDTH;  // elements of one staged chunk
  T* const buf_a = reinterpret_cast<T*>(smem_raw);  // [kStages][SC]: v, k
  T* const buf_g = buf_a + kStages * SC;            // [kStages][SC]: g
  T* const buf_out = buf_g + kStages * SC;          // [SC]: dq

  const int64_t row = blockIdx.x / tiles_per_row;
  const int i0 = (blockIdx.x % tiles_per_row) * kTile;
  const int nq = min(kTile, s - i0);
  const int hw = w / 2;
  const int c_lo = i0 - hw;  // staged key columns [c_lo, c_hi)
  const int c_hi = i0 + nq + (w - 1 - hw);
  const int lo = max(c_lo, 0);
  const int hi = min(c_hi, s);
  const bool edge = c_lo < 0 || c_hi > s;
  const int64_t sl = s;
  const int64_t base = row * d * sl;
  const int64_t wbase = row * w * sl;
  const int t = threadIdx.x;
  const int q0 = kRun * t;  // this thread's first query, within the tile

  const Leads<T> lv(v + base, sl), lk(k + base, sl), lg(g + base, sl),
      ld(dq + base, sl);

  // Stages chunk n (none past the last: the group stays, empty, so that
  // the wait below counts the same in every iteration).
  auto issue = [&](int n) {
    const int b = n % kStages;
    if (n < NC) {
      stage<T, kTile, C, WIDTH, WMAX, kThreads>(buf_a + b * SC, v + base, sl,
                                                lv, n * C, c_lo, lo, hi);
      stage<T, kTile, C, WIDTH, WMAX, kThreads>(buf_g + b * SC, g + base, sl,
                                                lg, n * C, i0, i0, i0 + nq);
    } else if (n < 2 * NC) {
      stage<T, kTile, C, WIDTH, WMAX, kThreads>(buf_a + b * SC, k + base, sl,
                                                lk, (n - NC) * C, c_lo, lo,
                                                hi);
    }
    cp_async_commit();
  };

  float u[kRun][WMAX];  // then dlog
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
#pragma unroll
    for (int o = 0; o < WMAX; ++o) u[r][o] = 0.f;
  }

  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < 2 * NC; ++n) {
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int b = n % kStages;
    const T* a = buf_a + b * SC;
    const T* src =
        n < NC ? v + base + n * C * sl : k + base + (n - NC) * C * sl;
    if (edge) {
      fill_halo<T, C, WIDTH, kThreads>(buf_a + b * SC, src, sl, c_lo, c_hi,
                                       false);
      __syncthreads();
    }
    if (n < NC) {
      const T* gs = buf_g + b * SC;
#pragma unroll 1
      for (int cc = 0; cc < C; ++cc) {
        float gr[kRun];
        load_run(gr, gs + cc * WIDTH, q0 + lg.at(n * C + cc, i0));
        float vr[RUN];
        load_run(vr, a + cc * WIDTH, q0 + lv.at(n * C + cc, c_lo));
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
#pragma unroll
          for (int o = 0; o < WMAX; ++o) {
            if (o < w) u[r][o] += gr[r] * vr[r + o];
          }
        }
      }
    } else {
      if (n == NC) {
        // u -> dlog (kept in u), and the coefficients for pass 2.
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          const int i = i0 + q0 + r;
          const bool valid = q0 + r < nq;
          float wt[WMAX];
          float wd[WMAX];  // the weights the forward used (after dropout)
#pragma unroll
          for (int o = 0; o < WMAX; ++o) {
            wt[o] = valid && o < w ? wts[wbase + o * sl + i] : 0.f;
            wd[o] = wt[o];
          }
          if constexpr (kDrop) {
            const uint32_t keep =
                valid ? philox::band_keep_mask(drop.seed, row, i, w,
                                               drop.threshold)
                      : 0u;
#pragma unroll
            for (int o = 0; o < WMAX; ++o) {
              const bool kept = (keep >> o) & 1u;
              u[r][o] = kept ? u[r][o] / drop.one_minus_rate : 0.f;
              wd[o] = kept ? wt[o] / drop.one_minus_rate : 0.f;
            }
          }
          float dot = 0.f;
#pragma unroll
          for (int o = 0; o < WMAX; ++o) {
            if (o < w) dot += wt[o] * u[r][o];
          }
#pragma unroll
          for (int o = 0; o < WMAX; ++o) {
            u[r][o] = valid && o < w ? wt[o] * (u[r][o] - dot) : 0.f;
            if (valid && o < w) {
              coef_k[wbase + o * sl + i] = u[r][o] * scale;
              coef_v[wbase + o * sl + i] = wd[o];
            }
          }
        }
      }
      const int c0 = (n - NC) * C;
#pragma unroll 1
      for (int cc = 0; cc < C; ++cc) {
        float kr[RUN];
        load_run(kr, a + cc * WIDTH, q0 + lk.at(c0 + cc, c_lo));
        float acc[kRun];
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int o = 0; o < WMAX; ++o) {
            if (o < w) acc[r] += u[r][o] * kr[r + o];
          }
          acc[r] *= scale;
        }
        store_run(buf_out + cc * WIDTH, q0 + ld.at(c0 + cc, i0), acc);
      }
      __syncthreads();
      unstage<T, kTile, C, WIDTH, kThreads>(dq + base, buf_out, sl, ld, c0,
                                            i0, i0 + nq);
    }
    __syncthreads();  // before stage b is refilled, by the next issue()
  }
}

// Pass 2: a block per kTile keys of a row. Warps of even index give dk
// (from q and the dlog coefficients), odd ones dv (from g and the dropped
// weights); thread t of a role owns the run of keys j0 + R*t + r. Slot o of
// query i = j + W/2 - o reads key j, so with the slots taken in reverse order
// (p = W-1-o) the queries of key r are the staged columns r + p of the
// thread's run.
template <typename T, int WMAX>
__global__ void __launch_bounds__(kKeyThreads<WMAX>)
    band_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ g,
                        const float* __restrict__ coef_k,
                        const float* __restrict__ coef_v, T* __restrict__ dk,
                        T* __restrict__ dv, int nc, int s, int w,
                        int tiles_per_row) {
  constexpr int C = kChunk<T>;
  constexpr int WIDTH = kWidth<WMAX>;
  // The chunk count is an argument, not d / C: read from the parameter
  // bank, it takes no register (the eval kernel is held to 96).
  const int NC = nc;
  const int d = nc * C;
  constexpr int R = kKeyRun<WMAX>;
  constexpr int NT = kKeyThreads<WMAX>;
  constexpr int RUN = R + WMAX - 1;
  constexpr int SC = C * WIDTH;  // elements of one staged chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf_q = reinterpret_cast<T*>(smem_raw);  // [kStages][SC]
  T* const buf_g = buf_q + kStages * SC;            // [kStages][SC]
  T* const out_k = buf_g + kStages * SC;            // [SC]
  T* const out_v = out_k + SC;                      // [SC]
  // [edge: S-1, 0][dk, dv][d]
  float* const fold = reinterpret_cast<float*>(out_v + SC);

  const int64_t row = blockIdx.x / tiles_per_row;
  const int j0 = (blockIdx.x % tiles_per_row) * kTile;
  const int nk = min(kTile, s - j0);
  const int hw = w / 2;
  const int c_lo = j0 - (w - 1 - hw);  // staged query columns [c_lo, c_hi)
  const int c_hi = j0 + nk + hw;
  const int lo = max(c_lo, 0);
  const int hi = min(c_hi, s);
  const bool edge = c_lo < 0 || c_hi > s;
  const int64_t sl = s;
  const int64_t base = row * d * sl;
  const float* ckr = coef_k + row * w * sl;
  const float* cvr = coef_v + row * w * sl;
  const int t = threadIdx.x;
  const int role = (t >> 5) & 1;  // 0: dk, 1: dv; the same across a warp
  const int k0 = R * (((t >> 6) << 5) | (t & 31));  // first key, in the tile
  const Leads<T> lq(q + base, sl), lg(g + base, sl), lk(dk + base, sl),
      lv(dv + base, sl);

  auto issue = [&](int n) {  // as pass 1's
    const int b = n % kStages;
    if (n < NC) {
      stage<T, kTile, C, WIDTH, WMAX, NT>(buf_q + b * SC, q + base, sl, lq,
                                          n * C, c_lo, lo, hi);
      stage<T, kTile, C, WIDTH, WMAX, NT>(buf_g + b * SC, g + base, sl, lg,
                                          n * C, c_lo, lo, hi);
    }
    cp_async_commit();
  };
  for (int n = 0; n < kStages - 1; ++n) issue(n);

  // Coefficients of the W in-row queries of each of this thread's keys.
  const float* cr = role ? cvr : ckr;
  float cf[WMAX][R];
#pragma unroll
  for (int p = 0; p < WMAX; ++p) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = w - 1 - p;
      const int i = j0 + k0 + r + hw - o;
      const bool valid = p < w && k0 + r < nk && i >= 0 && i < s;
      cf[p][r] = valid ? cr[o * sl + i] : 0.f;
    }
  }

  const bool has_last = j0 + nk == s;
  const bool has_first = j0 == 0;
  edge_fold<T, NT>(fold, q + base, g + base, ckr, cvr, d, s, w, has_last,
                   has_first);
  // The runs that hold key S-1 and key 0 (-1: none).
  const int r_last = has_last && s - 1 - j0 - k0 >= 0 && s - 1 - j0 - k0 < R
                         ? s - 1 - j0 - k0
                         : -1;
  const int r_first = has_first && k0 == 0 ? 0 : -1;
  const float* fold_last = fold + role * d;
  const float* fold_first = fold + (2 + role) * d;
  const T* buf_in = role ? buf_g : buf_q;
  T* const out_s = role ? out_v : out_k;
  const Leads<T> lin = role ? lg : lq;
  const Leads<T> lout = role ? lv : lk;

  for (int n = 0; n < NC; ++n) {
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int b = n % kStages;
    if (edge) {
      fill_halo<T, C, WIDTH, NT>(buf_q + b * SC, q + base + n * C * sl, sl,
                                 c_lo, c_hi, true);
      fill_halo<T, C, WIDTH, NT>(buf_g + b * SC, g + base + n * C * sl, sl,
                                 c_lo, c_hi, true);
      __syncthreads();
    }
    const T* in = buf_in + b * SC;
    const int c0 = n * C;
#pragma unroll 1
    for (int cc = 0; cc < C; ++cc) {
      float run[RUN];
      load_run(run, in + cc * WIDTH, k0 + lin.at(c0 + cc, c_lo));
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = 0.f;
#pragma unroll
        for (int p = 0; p < WMAX; ++p) {
          if (p < w) acc[r] += cf[p][r] * run[r + p];
        }
      }
      if (r_last >= 0 || r_first >= 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == r_last) acc[r] += fold_last[c0 + cc];
          if (r == r_first) acc[r] += fold_first[c0 + cc];
        }
      }
      store_run(out_s + cc * WIDTH, k0 + lout.at(c0 + cc, j0), acc);
    }
    __syncthreads();
    unstage<T, kTile, C, WIDTH, NT>(dk + base, out_k, sl, lk, c0, j0, j0 + nk);
    unstage<T, kTile, C, WIDTH, NT>(dv + base, out_v, sl, lv, c0, j0, j0 + nk);
    __syncthreads();  // before stage b is refilled, by the next issue()
  }
}

// Pass 1 past kMaxSlots slots: groups of kMaxSlots (see the header).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    band_bwd_query_wide_kernel(const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ g,
                               const float* __restrict__ wts,
                               T* __restrict__ dq, float* __restrict__ coef_k,
                               float* __restrict__ coef_v, int d, int s, int w,
                               int tiles_per_row, float scale, Dropout drop) {
  constexpr int C = kChunk<T>;
  constexpr int G = kMaxSlots;
  constexpr int WIDTH = kWideWidth;
  constexpr int RUN = kRun + G - 1;
  constexpr int SC = C * WIDTH;  // elements of one staged chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf_a = reinterpret_cast<T*>(smem_raw);  // [kStages][SC]: v, k
  T* const buf_g = buf_a + kStages * SC;            // [kStages][SC]: g
  T* const buf_out = buf_g + kStages * SC;          // [SC]: dq

  const int64_t row = blockIdx.x / tiles_per_row;
  const int i0 = (blockIdx.x % tiles_per_row) * kTile;
  const int nq = min(kTile, s - i0);
  const int hw = w / 2;
  const int nc = d / C;
  const int groups = (w + G - 1) / G;
  const int64_t sl = s;
  const int64_t base = row * d * sl;
  const int64_t wbase = row * w * sl;
  const int t = threadIdx.x;
  const int q0 = kRun * t;  // this thread's first query, within the tile

  const Leads<T> lv(v + base, sl), lk(k + base, sl), lg(g + base, sl),
      ld(dq + base, sl);

  float dot[kRun];  // sum_o w_o dw_o
#pragma unroll
  for (int r = 0; r < kRun; ++r) dot[r] = 0.f;

  // u group by group; dw (for now) and wd out to the scratch.
  for (int gi = 0; gi < groups; ++gi) {
    const int o0 = gi * G;
    const int gw = min(G, w - o0);
    const int c_lo = i0 - hw + o0;  // the group's value columns
    const int c_hi = c_lo + nq + G - 1;
    const int lo = max(c_lo, 0);
    const int hi = min(c_hi, s);
    const bool edge = c_lo < 0 || c_hi > s;
    auto issue = [&](int n) {
      const int b = n % kStages;
      if (n < nc) {
        stage<T, kTile, C, WIDTH, G, kThreads>(buf_a + b * SC, v + base, sl,
                                               lv, n * C, c_lo, lo, hi);
        stage<T, kTile, C, WIDTH, G, kThreads>(buf_g + b * SC, g + base, sl,
                                               lg, n * C, i0, i0, i0 + nq);
      }
      cp_async_commit();
    };
    float u[kRun][G];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
#pragma unroll
      for (int o = 0; o < G; ++o) u[r][o] = 0.f;
    }
    for (int n = 0; n < kStages - 1; ++n) issue(n);
    for (int n = 0; n < nc; ++n) {
      issue(n + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int b = n % kStages;
      if (edge) {
        fill_halo<T, C, WIDTH, kThreads, true>(
            buf_a + b * SC, v + base + n * C * sl, sl, c_lo, c_hi, false);
        __syncthreads();
      }
      const T* a = buf_a + b * SC;
      const T* gs = buf_g + b * SC;
#pragma unroll 1
      for (int cc = 0; cc < C; ++cc) {
        float gr[kRun];
        load_run(gr, gs + cc * WIDTH, q0 + lg.at(n * C + cc, i0));
        float vr[RUN];
        load_run(vr, a + cc * WIDTH, q0 + lv.at(n * C + cc, c_lo));
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
#pragma unroll
          for (int o = 0; o < G; ++o) {
            if (o < gw) u[r][o] += gr[r] * vr[r + o];
          }
        }
      }
      __syncthreads();  // before stage b is refilled
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (q0 + r >= nq) continue;
      const int i = i0 + q0 + r;
      [[maybe_unused]] uint32_t keep = 0;
      if constexpr (kDrop) {
        keep = philox::band_keep_group(drop.seed, row, i, gi, w,
                                       drop.threshold);
      }
#pragma unroll
      for (int o = 0; o < G; ++o) {
        if (o < gw) {
          const int64_t at = wbase + (o0 + o) * sl + i;
          const float wt = wts[at];
          float dw = u[r][o], wd = wt;
          if constexpr (kDrop) {
            const bool kept = (keep >> o) & 1u;
            dw = kept ? dw / drop.one_minus_rate : 0.f;
            wd = kept ? wt / drop.one_minus_rate : 0.f;
          }
          dot[r] += wt * dw;
          coef_k[at] = dw;
          coef_v[at] = wd;
        }
      }
    }
  }

  // Each thread's own dw -> dlog * scale, in place.
#pragma unroll 1
  for (int r = 0; r < kRun; ++r) {
    if (q0 + r >= nq) continue;
    const int64_t at = wbase + i0 + q0 + r;
#pragma unroll 1
    for (int o = 0; o < w; ++o) {
      coef_k[at + o * sl] = wts[at + o * sl] * (coef_k[at + o * sl] - dot[r]) *
                            scale;
    }
  }

  // dq: k with the whole halo, chunk by chunk; the groups summed inside.
  const int c_lo = i0 - hw;  // staged key columns [c_lo, c_hi)
  const int c_hi = i0 + nq + (w - 1 - hw);
  const int lo = max(c_lo, 0);
  const int hi = min(c_hi, s);
  const bool edge = c_lo < 0 || c_hi > s;
  auto issue_k = [&](int n) {
    if (n < nc) {
      stage<T, kTile, C, WIDTH, kMaxWindow, kThreads>(
          buf_a + (n % kStages) * SC, k + base, sl, lk, n * C, c_lo, lo, hi);
    }
    cp_async_commit();
  };
  for (int n = 0; n < kStages - 1; ++n) issue_k(n);
  for (int n = 0; n < nc; ++n) {
    issue_k(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int b = n % kStages;
    if (edge) {
      fill_halo<T, C, WIDTH, kThreads>(buf_a + b * SC, k + base + n * C * sl,
                                       sl, c_lo, c_hi, false);
      __syncthreads();
    }
    const T* a = buf_a + b * SC;
    const int c0 = n * C;
    float acc[C][kRun];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
#pragma unroll
      for (int r = 0; r < kRun; ++r) acc[cc][r] = 0.f;
    }
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
      const int o0 = gi * G;
      float cf[kRun][G];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const float* at = coef_k + wbase + o0 * sl + i0 + q0 + r;
#pragma unroll
        for (int o = 0; o < G; ++o) {
          cf[r][o] = q0 + r < nq && o0 + o < w ? at[o * sl] : 0.f;
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        float kr[RUN];
        load_run(kr, a + cc * WIDTH, q0 + o0 + lk.at(c0 + cc, c_lo));
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
#pragma unroll
          for (int o = 0; o < G; ++o) {
            if (o0 + o < w) acc[cc][r] += cf[r][o] * kr[r + o];
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      store_run(buf_out + cc * WIDTH, q0 + ld.at(c0 + cc, i0), acc[cc]);
    }
    __syncthreads();
    unstage<T, kTile, C, WIDTH, kThreads>(dq + base, buf_out, sl, ld, c0, i0,
                                          i0 + nq);
    __syncthreads();  // before stage b is refilled, by the next issue_k()
  }
}

// Pass 2 past kMaxSlots slots: as band_bwd_key_kernel, with the q and g
// columns of the whole halo staged and the slots taken in groups, each
// group's coefficients read once for all the chunk's channels.
template <typename T>
__global__ void __launch_bounds__(kWideKeyThreads)
    band_bwd_key_wide_kernel(const T* __restrict__ q, const T* __restrict__ g,
                             const float* __restrict__ coef_k,
                             const float* __restrict__ coef_v,
                             T* __restrict__ dk, T* __restrict__ dv, int d,
                             int s, int w, int tiles_per_row) {
  constexpr int C = kChunk<T>;
  constexpr int G = kMaxSlots;
  constexpr int WIDTH = kWideWidth;
  constexpr int R = kWideKeyRun;
  constexpr int NT = kWideKeyThreads;
  constexpr int RUN = R + G - 1;
  constexpr int SC = C * WIDTH;  // elements of one staged chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf_q = reinterpret_cast<T*>(smem_raw);  // [kStages][SC]
  T* const buf_g = buf_q + kStages * SC;            // [kStages][SC]
  T* const out_k = buf_g + kStages * SC;            // [SC]
  T* const out_v = out_k + SC;                      // [SC]
  // [edge: S-1, 0][dk, dv][d]
  float* const fold = reinterpret_cast<float*>(out_v + SC);

  const int64_t row = blockIdx.x / tiles_per_row;
  const int j0 = (blockIdx.x % tiles_per_row) * kTile;
  const int nk = min(kTile, s - j0);
  const int hw = w / 2;
  const int c_lo = j0 - (w - 1 - hw);  // staged query columns [c_lo, c_hi)
  const int c_hi = j0 + nk + hw;
  const int lo = max(c_lo, 0);
  const int hi = min(c_hi, s);
  const bool edge = c_lo < 0 || c_hi > s;
  const int nc = d / C;
  const int groups = (w + G - 1) / G;
  const int64_t sl = s;
  const int64_t base = row * d * sl;
  const float* ckr = coef_k + row * w * sl;
  const float* cvr = coef_v + row * w * sl;
  const int t = threadIdx.x;
  const int role = (t >> 5) & 1;  // 0: dk, 1: dv; the same across a warp
  const int k0 = R * (((t >> 6) << 5) | (t & 31));  // first key, in the tile
  const Leads<T> lq(q + base, sl), lg(g + base, sl), lk(dk + base, sl),
      lv(dv + base, sl);

  auto issue = [&](int n) {
    const int b = n % kStages;
    if (n < nc) {
      stage<T, kTile, C, WIDTH, kMaxWindow, NT>(buf_q + b * SC, q + base, sl,
                                                lq, n * C, c_lo, lo, hi);
      stage<T, kTile, C, WIDTH, kMaxWindow, NT>(buf_g + b * SC, g + base, sl,
                                                lg, n * C, c_lo, lo, hi);
    }
    cp_async_commit();
  };
  for (int n = 0; n < kStages - 1; ++n) issue(n);

  const bool has_last = j0 + nk == s;
  const bool has_first = j0 == 0;
  edge_fold<T, NT>(fold, q + base, g + base, ckr, cvr, d, s, w, has_last,
                   has_first);
  // The runs that hold key S-1 and key 0 (-1: none).
  const int r_last = has_last && s - 1 - j0 - k0 >= 0 && s - 1 - j0 - k0 < R
                         ? s - 1 - j0 - k0
                         : -1;
  const int r_first = has_first && k0 == 0 ? 0 : -1;
  const float* fold_last = fold + role * d;
  const float* fold_first = fold + (2 + role) * d;
  const float* cr = role ? cvr : ckr;
  const T* buf_in = role ? buf_g : buf_q;
  T* const out_s = role ? out_v : out_k;
  const Leads<T> lin = role ? lg : lq;
  const Leads<T> lout = role ? lv : lk;

  for (int n = 0; n < nc; ++n) {
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int b = n % kStages;
    if (edge) {
      fill_halo<T, C, WIDTH, NT>(buf_q + b * SC, q + base + n * C * sl, sl,
                                 c_lo, c_hi, true);
      fill_halo<T, C, WIDTH, NT>(buf_g + b * SC, g + base + n * C * sl, sl,
                                 c_lo, c_hi, true);
      __syncthreads();
    }
    const T* in = buf_in + b * SC;
    const int c0 = n * C;
    float acc[C][R];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[cc][r] = 0.f;
    }
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
      const int p0 = gi * G;
      // Slot o = w-1-p of query i = j + hw - o reads key j.
      float cf[G][R];
#pragma unroll
      for (int p = 0; p < G; ++p) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int o = w - 1 - (p0 + p);
          const int i = j0 + k0 + r + hw - o;
          const bool valid = p0 + p < w && k0 + r < nk && i >= 0 && i < s;
          cf[p][r] = valid ? cr[o * sl + i] : 0.f;
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        float run[RUN];
        load_run(run, in + cc * WIDTH, k0 + p0 + lin.at(c0 + cc, c_lo));
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int p = 0; p < G; ++p) {
            if (p0 + p < w) acc[cc][r] += cf[p][r] * run[r + p];
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      if (r_last >= 0 || r_first >= 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r == r_last) acc[cc][r] += fold_last[c0 + cc];
          if (r == r_first) acc[cc][r] += fold_first[c0 + cc];
        }
      }
      store_run(out_s + cc * WIDTH, k0 + lout.at(c0 + cc, j0), acc[cc]);
    }
    __syncthreads();
    unstage<T, kTile, C, WIDTH, NT>(dk + base, out_k, sl, lk, c0, j0, j0 + nk);
    unstage<T, kTile, C, WIDTH, NT>(dv + base, out_v, sl, lv, c0, j0, j0 + nk);
    __syncthreads();  // before stage b is refilled, by the next issue()
  }
}

// Raises a kernel's dynamic shared memory limit where it passes 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Launch {
  const void *q, *k, *v, *g;
  const float* wts;
  void *dq, *dk, *dv;
  float *coef_k, *coef_v;
  int d, s, w, tiles;
  dim3 grid;
  float scale;
  bool dropout;
  Dropout drop;
  cudaStream_t stream;
};

template <typename T, int WMAX>
cudaError_t launch_w(const Launch& a) {
  constexpr int kQuerySmem = query_smem_bytes<T, kWidth<WMAX>>();
  auto* query = a.dropout ? band_bwd_query_kernel<T, WMAX, true>
                          : band_bwd_query_kernel<T, WMAX, false>;
  cudaError_t err = allow_smem(query, kQuerySmem);
  if (err != cudaSuccess) return err;
  query<<<a.grid, kThreads, kQuerySmem, a.stream>>>(
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.wts, static_cast<T*>(a.dq), a.coef_k,
      a.coef_v, a.d / kChunk<T>, a.s, a.w, a.tiles, a.scale, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int key_smem = key_smem_bytes<T, kWidth<WMAX>>(a.d);
  auto* key = band_bwd_key_kernel<T, WMAX>;
  err = allow_smem(key, key_smem);
  if (err != cudaSuccess) return err;
  key<<<a.grid, kKeyThreads<WMAX>, key_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.g), a.coef_k,
      a.coef_v, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.d / kChunk<T>, a.s, a.w, a.tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const Launch& a) {
  constexpr int kQuerySmem = query_smem_bytes<T, kWideWidth>();
  auto* query = a.dropout ? band_bwd_query_wide_kernel<T, true>
                          : band_bwd_query_wide_kernel<T, false>;
  cudaError_t err = allow_smem(query, kQuerySmem);
  if (err != cudaSuccess) return err;
  query<<<a.grid, kThreads, kQuerySmem, a.stream>>>(
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.wts, static_cast<T*>(a.dq), a.coef_k,
      a.coef_v, a.d, a.s, a.w, a.tiles, a.scale, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int key_smem = key_smem_bytes<T, kWideWidth>(a.d);
  auto* key = band_bwd_key_wide_kernel<T>;
  err = allow_smem(key, key_smem);
  if (err != cudaSuccess) return err;
  key<<<a.grid, kWideKeyThreads, key_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.g), a.coef_k,
      a.coef_v, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.d, a.s, a.w,
      a.tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Launch& a) {
  if (a.w <= 8) return launch_w<T, 8>(a);
  if (a.w <= kMaxSlots) return launch_w<T, kMaxSlots>(a);
  return launch_wide<T>(a);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launches (0 on success). q, k, v, g, dq, dk and dv are device pointers to
// contiguous [rows, d, s] tensors of one dtype (is_bf16 = 1 for bf16, 0 for
// f32; d a multiple of 8), each at least 2-byte (bf16) or
// 4-byte (f32) aligned; wts is the forward's f32 [rows, w, s] weights;
// scratch is f32 [2, rows, w, s], written and read here. With dropout != 0
// the forward's mask is regenerated by philox.cuh's rule under (seed_lo,
// seed_hi, threshold). `stream` is the caller's cudaStream_t. Nothing is
// allocated and nothing synchronises.
extern "C" int mhla_band_bwd(const void* q, const void* k, const void* v,
                             const void* g, const void* wts, void* dq,
                             void* dk, void* dv, void* scratch,
                             long long rows, int d, int s, int w, int is_bf16,
                             float scale, int dropout, unsigned int seed_lo,
                             unsigned int seed_hi, unsigned int threshold,
                             float one_minus_rate, int device, void* stream) {
  if (rows <= 0 || w < 1 || w > kMaxWindow || s <= 2 * w ||
      !band_stage::head_dim_ok(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (s + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  float* sp = static_cast<float*>(scratch);
  const Launch a{q,
                 k,
                 v,
                 g,
                 static_cast<const float*>(wts),
                 dq,
                 dk,
                 dv,
                 sp,
                 sp + rows * w * static_cast<int64_t>(s),
                 d,
                 s,
                 w,
                 tiles,
                 dim3(static_cast<unsigned>(blocks)),
                 scale,
                 dropout != 0,
                 {(static_cast<uint64_t>(seed_hi) << 32) | seed_lo, threshold,
                  one_minus_rate},
                 static_cast<cudaStream_t>(stream)};
  err = is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of pass 1 (pass = 1) or pass 2 (pass = 2)
// at head dim d and window w, for the build report; 0 for what the kernels
// do not take.
extern "C" int mhla_band_bwd_smem(int pass, int is_bf16, int d, int w) {
  if (w < 1 || w > kMaxWindow || !band_stage::head_dim_ok(d) ||
      (pass != 1 && pass != 2)) {
    return 0;
  }
  if (is_bf16) {
    using T = __nv_bfloat16;
    if (pass == 1) {
      return w <= 8           ? query_smem_bytes<T, kWidth<8>>()
             : w <= kMaxSlots ? query_smem_bytes<T, kWidth<kMaxSlots>>()
                              : query_smem_bytes<T, kWideWidth>();
    }
    return w <= 8           ? key_smem_bytes<T, kWidth<8>>(d)
           : w <= kMaxSlots ? key_smem_bytes<T, kWidth<kMaxSlots>>(d)
                            : key_smem_bytes<T, kWideWidth>(d);
  }
  if (pass == 1) {
    return w <= 8           ? query_smem_bytes<float, kWidth<8>>()
           : w <= kMaxSlots ? query_smem_bytes<float, kWidth<kMaxSlots>>()
                            : query_smem_bytes<float, kWideWidth>();
  }
  return w <= 8           ? key_smem_bytes<float, kWidth<8>>(d)
         : w <= kMaxSlots ? key_smem_bytes<float, kWidth<kMaxSlots>>(d)
                          : key_smem_bytes<float, kWideWidth>(d);
}

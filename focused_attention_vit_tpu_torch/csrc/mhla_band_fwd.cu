// MHLA window band, forward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/mhla_band_roll.py::_fwd_kernel
// (:158, the Pallas lane-roll kernel), on both of its paths:
//   - eval (primal) path: no saved softmax weights, dropout rate 0;
//   - custom-VJP forward: the pre-dropout softmax weights are written for
//     the backward (mhla_band_bwd.cu), and per-slot inverted dropout runs
//     with the mask drawn in the kernel (philox.cuh).
// Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/mhla_band_roll.py.
//
// What it computes, for each (b*h) row and each query i of S tokens:
//   slot o in [0, W) reads key j = i - W/2 + o, where j < 0 reads row S-1
//   and j >= S reads row 0 (the reference edge rule: a duplicated edge key
//   counts once per slot it fills; no mask, no deduplication);
//   logit_o = (q_i . k_j) * d^-1/2 in f32, softmax over the W slots in f32;
//   training: wts[o, i] = the softmax weight (f32), and with dropout the
//   weight of a dropped slot becomes 0 and a kept one w_o / (1 - rate);
//   out_i = sum_o w_o * v_j accumulated in f32 and rounded once to the
//   input dtype (f32 or bf16).
// Layout: q, k, v and out are contiguous S-minor [B*h, d, S], the layout the
// model's projections emit; wts is f32 [B*h, W, S].
//
// What bounds it on this card: bytes, by the function. Per query it reads d
// values each of q, k and v and writes d of out (plus W f32 weights in
// training), and does about 4*W*d flops, far below the card's flop-to-byte
// ratio: 617 MB (eval) and 650 MB (training) at B*h=384, S=3137, W=7, d=64,
// 0.184 and 0.194 ms at 3.35 TB/s. In practice the instructions come close
// to the bytes, as in the backward's first pass, whose shape this kernel
// shares: the FMAs are scalar f32 (no tensor-core product has this shape)
// and each staged bf16 value is widened once per run that reads it. The
// design (the staging helpers are band_stage.cuh's, shared with the
// backward):
//   - A block per tile of kTile = 512 queries of a row; thread t owns the
//     run of kRun = 4 consecutive queries i0 + 4t .. i0 + 4t + 3.
//   - The block stages what it reads in chunks of kChunk channels (8 in
//     bf16, 4 in f32), double-buffered, by 16-byte cp.async copies of each
//     channel's 16-byte-aligned span (odd S leaves every channel row at its
//     own offset within 16 bytes, which the staged row keeps; TMA's 16-byte
//     strides do not fit). Chunks 0..NC-1 stage q (the tile's columns) and
//     k (the tile and its W - 1 halo columns) and sum the run's W logits;
//     chunks NC..2NC-1 stage v (with its halo) and sum out. One ring runs
//     across the two phases, so v's first chunk is in flight while the last
//     q/k chunk computes and while the softmax, the mask and the weights'
//     write run.
//   - The halo at a row's two ends follows the edge rule, not the memory:
//     after a chunk lands, its columns below 0 are filled from column S-1
//     and those past S-1 from column 0, behind one more barrier (another
//     thread's copy of the same 16 bytes may land after a halo column is
//     written before it).
//   - Register-blocked runs: for one channel a thread reads run + W - 1
//     staged k (or v) values as 8-byte words and its run of q values, and
//     does run * W FMAs, where one query a thread would issue W + 1 scalar
//     global loads for W FMAs. The run's logits (then weights) are
//     kRun * WMAX f32 registers.
//   - The slot count is a template parameter, WMAX in {8, 16}, dispatched
//     by W inside the entry point: at W = 7 the slot loops are 8 wide. The
//     head dim is an argument (a multiple of 8: whole chunks of channels).
//   - Past 16 slots (W = 17..129, JAX's roll-band range) the run's logits
//     no longer fit the registers, and band_fwd_wide_kernel takes the slots
//     in groups of 16: pass 1 sums each group's logits over all channel
//     chunks (q and the group's k columns staged as above), folds them into
//     a running max and sum per query (the online softmax) and writes them
//     to an f32 [W, S] buffer; each thread then turns its own queries'
//     logits into weights (saved before the dropout in training) in place;
//     pass 2 stages v with the whole halo (W - 1 <= 128 columns) and, chunk
//     by chunk, sums out over the groups, each group's weights read back
//     (from L2) into registers once for all the chunk's channels. The
//     buffer is the saved weights where they are the ones applied, else
//     scratch from the wrapper. Bound at W = 129 by the scalar FMAs (about
//     4*W*d a query) and the weights' round trips, not by the bytes of q,
//     k, v and out.
//   - out leaves through a staged tile (written there in bf16 pairs), in
//     16-byte stores but for each channel's two ragged ends.
//   - Training: the mask is drawn per query by philox::band_keep_mask, the
//     call the backward makes to regenerate it (never stored, never drawn
//     per tile), at the kernel's start, under the first copies, into one
//     word of kRun * WMAX bits. The f32 weights go out through the q
//     stages, free once the logits are summed, in 16-byte stores (scalar at
//     a slot row's ends; at odd S a slot row is only 4-byte aligned). The
//     eval instantiation (kSave = kDrop = false) compiles neither the
//     weights' write nor the mask.
//   - The bf16 kernels at slot cap 8 without dropout are held to 102
//     registers, so that 5 blocks (20 warps) share an SM, and the dropout
//     forms to 128 (4 blocks); the others take the registers they need.
// Tried and not kept (device time in turns on one H100 80GB HBM3 at 700 W,
// bf16, d=64, S=3137, W=7, utils/band_ab.py): 3 stages (21% slower in eval,
// 14% with dropout: 3 blocks an SM by shared memory); a tile balanced over
// the row's blocks (456 queries at S=3137: 7% and 23% slower); the weights
// stored straight from registers (2-4% slower with dropout than through
// the q stages); 5 blocks an SM for the dropout forms (they spill, and run
// no faster).
// The f32 instantiation runs the same kernels (4 channels a chunk, scalar
// reads of the staged rows): it is the parity version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "band_stage.cuh"
#include "philox.cuh"

namespace {

using namespace band_stage;

constexpr int kMaxWindow = 129;  // the wrapper raises above this
constexpr int kMaxSlots = 16;    // slots in registers: W's cap, then a group
constexpr int kTile = 512;       // queries a block
constexpr int kRun = 4;         // consecutive queries a thread
constexpr int kThreads = kTile / kRun;

template <typename T>
constexpr int kChunk = sizeof(T) == 2 ? 8 : 4;  // channels a staged chunk
constexpr int kStages = 2;  // chunks staged at once: one computed, one in
                            // flight
// Elements of one staged channel row: the tile, its halo (W - 1) and the
// slack of aligning both ends to 16 bytes; a multiple of 8 elements, so
// every row starts 16-byte aligned.
template <int WMAX>
constexpr int kWidth = kTile + WMAX + 16;
// The wide kernel's staged rows: the tile, the whole halo (W - 1 <= 128),
// the alignment slack and the 8-byte words that the last group's runs read
// past its one real slot.
constexpr int kWideWidth = kTile + kMaxWindow - 1 + 32;
// Slot rows of weights staged at once, and the f32 elements of one staged
// slot row (the tile and its 16-byte slack).
constexpr int kWeightRows = 8;
constexpr int kWeightWidth = kTile + 4;
// Blocks an SM that the register budget is cut for: 5 (102 registers a
// thread) for the bf16 kernels at slot cap 8 without dropout, which then
// spill nothing and run 5% faster than with no bound (4 blocks; H100, in
// turns); 4 (128 registers) for the dropout forms (they spill at 5; with
// no bound ptxas gave them 145 registers, 3 blocks, and the training
// forward ran 13% slower in turns, utils/band_ab.py); no bound elsewhere.
template <typename T, int WMAX, bool kDrop>
constexpr int kMinBlocks =
    sizeof(T) == 2 && WMAX <= 8 ? (kDrop ? 4 : 5) : 1;

struct Dropout {
  uint64_t seed;
  uint32_t threshold;    // keep iff bits >= threshold
  float one_minus_rate;  // kept weights are divided by this
};

template <typename T, int WIDTH>
constexpr int smem_bytes() {
  // kStages stages of q and of k (then v), and the out tile.
  return (2 * kStages + 1) * kChunk<T> * WIDTH * static_cast<int>(sizeof(T));
}

// Writes the weights of slots [O0, O0 + kWeightRows) of the tile's queries
// (the runs' p[r][o]) to the f32 [W, S] slot rows at wr: staged in buf as
// slot rows that keep each row's offset within 16 bytes, then 16-byte
// stores. The caller has passed a barrier since buf was last read; this
// ends with one.
template <int O0, int WMAX>
__device__ __forceinline__ void save_weights(float* wr, float* buf,
                                             const float (&p)[kRun][WMAX],
                                             int64_t s, int w, int i0, int nq,
                                             int q0) {
  const Leads<float> lw(wr, s);
#pragma unroll
  for (int o = 0; o < kWeightRows; ++o) {
    float* row = buf + o * kWeightWidth + q0 + lw.at(O0 + o, i0);
#pragma unroll
    for (int r = 0; r < kRun; ++r) row[r] = p[r][O0 + o];
  }
  __syncthreads();
  const int rows = min(kWeightRows, w - O0);
  constexpr int kStores = (kTile + 2 * 4 - 2) / 4;  // a slot row, at most
  for (int f = threadIdx.x; f < rows * kStores; f += kThreads) {
    const int o = f / kStores;
    const int m = f - o * kStores;
    const int x0 = i0 - lw.at(O0 + o, i0) + 4 * m;  // 16-byte aligned
    if (x0 < i0 + nq) {
      float* row = wr + (O0 + o) * s;
      const float* from = buf + o * kWeightWidth + 4 * m;
      if (x0 >= i0 && x0 + 4 <= i0 + nq) {
        *reinterpret_cast<float4*>(row + x0) =
            *reinterpret_cast<const float4*>(from);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x0 + e >= i0 && x0 + e < i0 + nq) row[x0 + e] = from[e];
        }
      }
    }
  }
  __syncthreads();
}

// A block per kTile queries of a row; thread t owns the run of queries
// i0 + kRun*t + r. Chunks 0..NC-1 stage q and k and sum the logits; after
// the last of them the logits become the (saved, dropped) weights; chunks
// NC..2NC-1 stage v and sum out.
template <typename T, int WMAX, bool kSave, bool kDrop>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, WMAX, kDrop>))
    band_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ wts, int nc, int s, int w,
                    int tiles_per_row, float scale, Dropout drop) {
  constexpr int C = kChunk<T>;
  constexpr int WIDTH = kWidth<WMAX>;
  const int NC = nc;  // chunks of C channels: d / C
  const int d = nc * C;
  constexpr int RUN = kRun + WMAX - 1;
  constexpr int SC = C * WIDTH;  // elements of one staged chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf_q = reinterpret_cast<T*>(smem_raw);  // [kStages][SC]
  T* const buf_a = buf_q + kStages * SC;            // [kStages][SC]: k, v
  T* const buf_out = buf_a + kStages * SC;          // [SC]
  // The weights' staging reuses the q stages.
  static_assert(kWeightRows * kWeightWidth * 4 <=
                    kStages * SC * static_cast<int>(sizeof(T)),
                "the weights' staging does not fit the q stages");

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
  const int t = threadIdx.x;
  const int q0 = kRun * t;  // this thread's first query, within the tile

  const Leads<T> lq(q + base, sl), lk(k + base, sl), lv(v + base, sl),
      lout(out + base, sl);

  // Stages chunk n (none past the last: the group stays, empty, so that
  // the wait below counts the same in every iteration).
  auto issue = [&](int n) {
    const int b = n % kStages;
    if (n < NC) {
      stage<T, kTile, C, WIDTH, WMAX, kThreads>(buf_q + b * SC, q + base, sl,
                                                lq, n * C, i0, i0, i0 + nq);
      stage<T, kTile, C, WIDTH, WMAX, kThreads>(buf_a + b * SC, k + base, sl,
                                                lk, n * C, c_lo, lo, hi);
    } else if (n < 2 * NC) {
      stage<T, kTile, C, WIDTH, WMAX, kThreads>(buf_a + b * SC, v + base, sl,
                                                lv, (n - NC) * C, c_lo, lo,
                                                hi);
    }
    cp_async_commit();
  };

  float p[kRun][WMAX];  // the logits, then the weights
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
#pragma unroll
    for (int o = 0; o < WMAX; ++o) p[r][o] = 0.f;
  }

  for (int n = 0; n < kStages - 1; ++n) issue(n);

  // Training: the run's dropout mask (bit WMAX*r + o keeps slot o of query
  // r), drawn while the first chunk's copies are in flight, so that the
  // Philox state is not live beside the weights.
  using Bits = std::conditional_t<WMAX <= 8, uint32_t, uint64_t>;
  [[maybe_unused]] Bits keep = 0;
  if constexpr (kDrop) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (q0 + r < nq) {
        keep |= static_cast<Bits>(philox::band_keep_mask(
                    drop.seed, row, i0 + q0 + r, w, drop.threshold))
                << (WMAX * r);
      }
    }
  }

  // Chunks 0..NC-1: q and k, the logits. The two phases run as two loops
  // (the head dim is an argument: one loop over both, with a branch on the
  // phase, needs registers that the 96 of the eval kernel do not have).
  for (int n = 0; n < NC; ++n) {
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int b = n % kStages;
    const T* a = buf_a + b * SC;
    if (edge) {
      fill_halo<T, C, WIDTH, kThreads>(buf_a + b * SC, k + base + n * C * sl,
                                       sl, c_lo, c_hi, false);
      __syncthreads();
    }
    const T* qs = buf_q + b * SC;
    const int c0 = n * C;
#pragma unroll 1
    for (int cc = 0; cc < C; ++cc) {
      float qr[kRun];
      load_run(qr, qs + cc * WIDTH, q0 + lq.at(c0 + cc, i0));
      float kr[RUN];
      load_run(kr, a + cc * WIDTH, q0 + lk.at(c0 + cc, c_lo));
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
#pragma unroll
        for (int o = 0; o < WMAX; ++o) {
          if (o < w) p[r][o] += qr[r] * kr[r + o];
        }
      }
    }
    __syncthreads();  // before stage b is refilled, by the next issue()
  }

  // Logits -> softmax weights, saved before the dropout; v's first chunk is
  // in flight meanwhile.
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int o = 0; o < WMAX; ++o) {
      if (o < w) {
        p[r][o] *= scale;
        m = fmaxf(m, p[r][o]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int o = 0; o < WMAX; ++o) {
      if (o < w) {
        p[r][o] = expf(p[r][o] - m);
        sum += p[r][o];
      }
    }
#pragma unroll
    for (int o = 0; o < WMAX; ++o) {
      p[r][o] = o < w ? p[r][o] / sum : 0.f;
    }
  }
  if constexpr (kSave) {
    float* const wr = wts + row * w * sl;
    float* const wbuf = reinterpret_cast<float*>(buf_q);
    save_weights<0>(wr, wbuf, p, sl, w, i0, nq, q0);
    if constexpr (WMAX > kWeightRows) {
      static_assert(WMAX <= 2 * kWeightRows, "two rounds of slot rows");
      if (w > kWeightRows) {
        save_weights<kWeightRows>(wr, wbuf, p, sl, w, i0, nq, q0);
      }
    }
  }
  if constexpr (kDrop) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
#pragma unroll
      for (int o = 0; o < WMAX; ++o) {
        p[r][o] = (keep >> (WMAX * r + o)) & 1u ? p[r][o] / drop.one_minus_rate
                                                : 0.f;
      }
    }
  }

  // Chunks NC..2NC-1: v, out.
  for (int n = NC; n < 2 * NC; ++n) {
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int b = n % kStages;
    const T* a = buf_a + b * SC;
    const int c0 = (n - NC) * C;
    if (edge) {
      fill_halo<T, C, WIDTH, kThreads>(buf_a + b * SC, v + base + c0 * sl,
                                       sl, c_lo, c_hi, false);
      __syncthreads();
    }
#pragma unroll 1
    for (int cc = 0; cc < C; ++cc) {
      float vr[RUN];
      load_run(vr, a + cc * WIDTH, q0 + lv.at(c0 + cc, c_lo));
      float acc[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        acc[r] = 0.f;
#pragma unroll
        for (int o = 0; o < WMAX; ++o) {
          if (o < w) acc[r] += p[r][o] * vr[r + o];
        }
      }
      store_run(buf_out + cc * WIDTH, q0 + lout.at(c0 + cc, i0), acc);
    }
    __syncthreads();
    unstage<T, kTile, C, WIDTH, kThreads>(out + base, buf_out, sl, lout, c0,
                                          i0, i0 + nq);
    __syncthreads();  // before stage b is refilled, by the next issue()
  }
}

// W > kMaxSlots: the slots in groups of kMaxSlots (see the header). `lw` is
// the f32 [B*h, W, S] buffer of the logits, then of the weights applied
// (the saved weights `wts` themselves when there is no dropout).
template <typename T, bool kSave, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    band_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ wts, float* __restrict__ lw,
                         int d, int s, int w, int tiles_per_row, float scale,
                         Dropout drop) {
  constexpr int C = kChunk<T>;
  constexpr int G = kMaxSlots;
  constexpr int WIDTH = kWideWidth;
  constexpr int RUN = kRun + G - 1;
  constexpr int SC = C * WIDTH;  // elements of one staged chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf_q = reinterpret_cast<T*>(smem_raw);  // [kStages][SC]
  T* const buf_a = buf_q + kStages * SC;            // [kStages][SC]: k, v
  T* const buf_out = buf_a + kStages * SC;          // [SC]

  const int64_t row = blockIdx.x / tiles_per_row;
  const int i0 = (blockIdx.x % tiles_per_row) * kTile;
  const int nq = min(kTile, s - i0);
  const int hw = w / 2;
  const int nc = d / C;
  const int groups = (w + G - 1) / G;
  const int64_t sl = s;
  const int64_t base = row * d * sl;
  float* const lwr = lw + row * w * sl;
  const int t = threadIdx.x;
  const int q0 = kRun * t;  // this thread's first query, within the tile

  const Leads<T> lq(q + base, sl), lk(k + base, sl), lv(v + base, sl),
      lout(out + base, sl);

  float m[kRun], l[kRun];  // running max and sum of the scaled logits
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  // Pass 1, group by group: slot o0 + o of query i reads key column
  // i - hw + o0 + o, so the group's key columns are [c_lo, c_lo + nq + G - 1).
  for (int g = 0; g < groups; ++g) {
    const int o0 = g * G;
    const int gw = min(G, w - o0);
    const int c_lo = i0 - hw + o0;
    const int c_hi = c_lo + nq + G - 1;
    const int lo = max(c_lo, 0);
    const int hi = min(c_hi, s);
    const bool edge = c_lo < 0 || c_hi > s;
    auto issue = [&](int n) {
      const int b = n % kStages;
      if (n < nc) {
        stage<T, kTile, C, WIDTH, G, kThreads>(buf_q + b * SC, q + base, sl,
                                               lq, n * C, i0, i0, i0 + nq);
        stage<T, kTile, C, WIDTH, G, kThreads>(buf_a + b * SC, k + base, sl,
                                               lk, n * C, c_lo, lo, hi);
      }
      cp_async_commit();
    };
    float p[kRun][G];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
#pragma unroll
      for (int o = 0; o < G; ++o) p[r][o] = 0.f;
    }
    for (int n = 0; n < kStages - 1; ++n) issue(n);
    for (int n = 0; n < nc; ++n) {
      issue(n + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const int b = n % kStages;
      if (edge) {
        fill_halo<T, C, WIDTH, kThreads, true>(
            buf_a + b * SC, k + base + n * C * sl, sl, c_lo, c_hi, false);
        __syncthreads();
      }
      const T* qs = buf_q + b * SC;
      const T* a = buf_a + b * SC;
#pragma unroll 1
      for (int cc = 0; cc < C; ++cc) {
        float qr[kRun];
        load_run(qr, qs + cc * WIDTH, q0 + lq.at(n * C + cc, i0));
        float kr[RUN];
        load_run(kr, a + cc * WIDTH, q0 + lk.at(n * C + cc, c_lo));
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
#pragma unroll
          for (int o = 0; o < G; ++o) {
            if (o < gw) p[r][o] += qr[r] * kr[r + o];
          }
        }
      }
      __syncthreads();  // before stage b is refilled
    }
    // The group's scaled logits: into the running max and sum, and out.
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int o = 0; o < G; ++o) {
        if (o < gw) {
          p[r][o] *= scale;
          mx = fmaxf(mx, p[r][o]);
        }
      }
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int o = 0; o < G; ++o) {
        if (o < gw) sum += expf(p[r][o] - m_new);
      }
      l[r] = l[r] * expf(m[r] - m_new) + sum;
      m[r] = m_new;
      if (q0 + r < nq) {
        float* at = lwr + o0 * sl + i0 + q0 + r;
#pragma unroll
        for (int o = 0; o < G; ++o) {
          if (o < gw) at[o * sl] = p[r][o];
        }
      }
    }
  }

  // Each thread's own logits -> weights, in place (the saved ones before
  // the dropout, the applied ones after it); 4 slots a Philox draw.
#pragma unroll 1
  for (int r = 0; r < kRun; ++r) {
    if (q0 + r >= nq) continue;
    const int i = i0 + q0 + r;
    const float inv = 1.f / l[r];
#pragma unroll 1
    for (int grp = 0; 4 * grp < w; ++grp) {
      [[maybe_unused]] uint32_t words[4] = {0u, 0u, 0u, 0u};
      if constexpr (kDrop) {
        const uint4 x = philox::band_words(drop.seed, row, i, grp);
        words[0] = x.x, words[1] = x.y, words[2] = x.z, words[3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 4 * grp + e;
        if (o < w) {
          float* at = lwr + o * sl + i;
          const float p = expf(*at - m[r]) * inv;
          if constexpr (kSave) wts[(row * w + o) * sl + i] = p;
          if constexpr (kDrop) {
            *at = words[e] >= drop.threshold ? p / drop.one_minus_rate : 0.f;
          } else {
            *at = p;
          }
        }
      }
    }
  }

  // Pass 2: v with the whole halo, chunk by chunk; out sums the groups.
  const int c_lo = i0 - hw;  // staged value columns [c_lo, c_hi)
  const int c_hi = i0 + nq + (w - 1 - hw);
  const int lo = max(c_lo, 0);
  const int hi = min(c_hi, s);
  const bool edge = c_lo < 0 || c_hi > s;
  auto issue_v = [&](int n) {
    if (n < nc) {
      stage<T, kTile, C, WIDTH, kMaxWindow, kThreads>(
          buf_a + (n % kStages) * SC, v + base, sl, lv, n * C, c_lo, lo, hi);
    }
    cp_async_commit();
  };
  for (int n = 0; n < kStages - 1; ++n) issue_v(n);
  for (int n = 0; n < nc; ++n) {
    issue_v(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int b = n % kStages;
    if (edge) {
      fill_halo<T, C, WIDTH, kThreads>(buf_a + b * SC, v + base + n * C * sl,
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
    for (int g = 0; g < groups; ++g) {
      const int o0 = g * G;
      float wt[kRun][G];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const float* at = lwr + o0 * sl + i0 + q0 + r;
#pragma unroll
        for (int o = 0; o < G; ++o) {
          wt[r][o] = q0 + r < nq && o0 + o < w ? at[o * sl] : 0.f;
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        float vr[RUN];
        load_run(vr, a + cc * WIDTH, q0 + o0 + lv.at(c0 + cc, c_lo));
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
#pragma unroll
          for (int o = 0; o < G; ++o) {
            if (o0 + o < w) acc[cc][r] += wt[r][o] * vr[r + o];
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      store_run(buf_out + cc * WIDTH, q0 + lout.at(c0 + cc, i0), acc[cc]);
    }
    __syncthreads();
    unstage<T, kTile, C, WIDTH, kThreads>(out + base, buf_out, sl, lout, c0,
                                          i0, i0 + nq);
    __syncthreads();  // before stage b is refilled, by the next issue_v()
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
  const void *q, *k, *v;
  void* out;
  float *wts, *lw;
  int d, s, w, tiles;
  dim3 grid;
  float scale;
  bool dropout;
  Dropout drop;
  cudaStream_t stream;
};

template <typename T, int WMAX>
cudaError_t launch_w(const Launch& a) {
  constexpr int kSmem = smem_bytes<T, kWidth<WMAX>>();
  auto* kernel =
      a.wts == nullptr
          ? (a.dropout ? band_fwd_kernel<T, WMAX, false, true>
                       : band_fwd_kernel<T, WMAX, false, false>)
          : (a.dropout ? band_fwd_kernel<T, WMAX, true, true>
                       : band_fwd_kernel<T, WMAX, true, false>);
  const cudaError_t err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.wts,
      a.d / kChunk<T>, a.s, a.w, a.tiles, a.scale, a.drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const Launch& a) {
  constexpr int kSmem = smem_bytes<T, kWideWidth>();
  auto* kernel =
      a.wts == nullptr
          ? (a.dropout ? band_fwd_wide_kernel<T, false, true>
                       : band_fwd_wide_kernel<T, false, false>)
          : (a.dropout ? band_fwd_wide_kernel<T, true, true>
                       : band_fwd_wide_kernel<T, true, false>);
  const cudaError_t err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.wts, a.lw, a.d,
      a.s, a.w, a.tiles, a.scale, a.drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Launch& a) {
  if (a.w <= 8) return launch_w<T, 8>(a);
  if (a.w <= kMaxSlots) return launch_w<T, kMaxSlots>(a);
  return launch_wide<T>(a);
}

__global__ void keep_bits_kernel(uint32_t* __restrict__ out, int64_t rows,
                                 int s, int w, uint64_t seed) {
  const int64_t n = rows * s;
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= n) return;
  const int64_t row = idx / s;
  const int i = static_cast<int>(idx % s);
  for (int grp = 0; 4 * grp < w; ++grp) {
    const uint4 r = philox::band_words(seed, row, i, grp);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
    for (int b = 0; b < 4 && 4 * grp + b < w; ++b) {
      out[(row * w + 4 * grp + b) * static_cast<int64_t>(s) + i] = words[b];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous
// [rows, d, s] tensors of one dtype (is_bf16 = 1 for bf16, 0 for f32), each
// at least 2-byte (bf16) or 4-byte (f32) aligned; `wts` is a contiguous f32
// [rows, w, s] tensor to receive the pre-dropout softmax weights, or null
// for the eval kernel. With dropout != 0 the slots are dropped by
// philox.cuh's rule under (seed_lo, seed_hi, threshold). `stream` is the
// caller's cudaStream_t. The kernel allocates nothing and does not
// synchronise.
// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous
// [rows, d, s] tensors of one dtype (is_bf16 = 1 for bf16, 0 for f32), each
// at least 2-byte (bf16) or 4-byte (f32) aligned; `wts` is a contiguous f32
// [rows, w, s] tensor to receive the pre-dropout softmax weights, or null
// for the eval kernel. Past 16 slots (w > 16) the kernel writes its logits
// and applied weights to `scratch`, an f32 [rows, w, s] tensor, or to `wts`
// when scratch is null (training without dropout). With dropout != 0 the
// slots are dropped by philox.cuh's rule under (seed_lo, seed_hi,
// threshold). `stream` is the caller's cudaStream_t. The kernel allocates
// nothing and does not synchronise.
extern "C" int mhla_band_fwd(const void* q, const void* k, const void* v,
                             void* out, void* wts, void* scratch,
                             long long rows, int d, int s, int w, int is_bf16,
                             float scale, int dropout, unsigned int seed_lo,
                             unsigned int seed_hi, unsigned int threshold,
                             float one_minus_rate, int device, void* stream) {
  if (rows <= 0 || w < 1 || w > kMaxWindow || s <= 2 * w ||
      !band_stage::head_dim_ok(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* wp = static_cast<float*>(wts);
  float* lw = scratch != nullptr ? static_cast<float*>(scratch) : wp;
  if (w > kMaxSlots && (lw == nullptr || (dropout != 0 && lw == wp))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (s + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const Launch a{q,     k,     v,
                 out,   wp,    lw,
                 d,     s,     w,
                 tiles, dim3(static_cast<unsigned>(blocks)), scale,
                 dropout != 0,
                 {(static_cast<uint64_t>(seed_hi) << 32) | seed_lo, threshold,
                  one_minus_rate},
                 static_cast<cudaStream_t>(stream)};
  err = is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of the forward at head dim d and window
// w (the same for the eval and the training form), for the build report; 0
// for what the kernel does not take.
extern "C" int mhla_band_fwd_smem(int is_bf16, int d, int w) {
  if (w < 1 || w > kMaxWindow || !band_stage::head_dim_ok(d)) return 0;
  if (is_bf16) {
    return w <= 8           ? smem_bytes<__nv_bfloat16, kWidth<8>>()
           : w <= kMaxSlots ? smem_bytes<__nv_bfloat16, kWidth<kMaxSlots>>()
                            : smem_bytes<__nv_bfloat16, kWideWidth>();
  }
  return w <= 8           ? smem_bytes<float, kWidth<8>>()
         : w <= kMaxSlots ? smem_bytes<float, kWidth<kMaxSlots>>()
                          : smem_bytes<float, kWideWidth>();
}

// The band's dropout bits as the kernels draw them: out[row, o, i] is the
// 32-bit word that decides slot o of query i (kept iff >= the threshold).
// Used to hold the generator to its plain version; not on the model's path.
extern "C" int mhla_band_keep_bits(void* out, long long rows, int s, int w,
                                   unsigned int seed_lo, unsigned int seed_hi,
                                   int device, void* stream) {
  if (rows <= 0 || s <= 0 || w < 1 || w > kMaxWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = rows * static_cast<int64_t>(s);
  const int64_t blocks = (n + 255) / 256;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  keep_bits_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), rows, s, w,
      (static_cast<uint64_t>(seed_hi) << 32) | seed_lo);
  return static_cast<int>(cudaGetLastError());
}

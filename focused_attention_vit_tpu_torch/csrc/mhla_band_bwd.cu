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
//     wide.
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

constexpr int kMaxWindow = 16;  // the wrapper raises above this
constexpr int kTile = 512;      // queries (keys) a block
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Dropout {
  uint64_t seed;
  uint32_t threshold;
  float one_minus_rate;
};

template <typename T, int WMAX>
constexpr int query_smem_bytes() {
  // kStages stages of (v or k, g) and the dq tile.
  return (2 * kStages + 1) * kChunk<T> * kWidth<WMAX> *
         static_cast<int>(sizeof(T));
}
template <typename T, int WMAX>
constexpr int key_smem_bytes(int d) {
  // kStages stages of (q, g), the dk and dv tiles, and the edge fold.
  return (2 * kStages + 2) * kChunk<T> * kWidth<WMAX> *
             static_cast<int>(sizeof(T)) +
         4 * d * static_cast<int>(sizeof(float));
}

// Pass 1: a block per kTile queries of a row; thread t owns the run of
// queries i0 + kRun*t + r. Chunks 0..NC-1 stage v and g and sum u; chunks
// NC..2NC-1 stage k, and the first of them turns u into the coefficients.
template <typename T, int D, int WMAX, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    band_bwd_query_kernel(const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ g,
                          const float* __restrict__ wts, T* __restrict__ dq,
                          float* __restrict__ coef_k,
                          float* __restrict__ coef_v, int s, int w,
                          int tiles_per_row, float scale, Dropout drop) {
  constexpr int C = kChunk<T>;
  constexpr int WIDTH = kWidth<WMAX>;
  constexpr int NC = D / C;
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
  const int64_t base = row * D * sl;
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
template <typename T, int D, int WMAX>
__global__ void __launch_bounds__(kKeyThreads<WMAX>)
    band_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ g,
                        const float* __restrict__ coef_k,
                        const float* __restrict__ coef_v, T* __restrict__ dk,
                        T* __restrict__ dv, int s, int w, int tiles_per_row) {
  constexpr int C = kChunk<T>;
  constexpr int WIDTH = kWidth<WMAX>;
  constexpr int NC = D / C;
  constexpr int R = kKeyRun<WMAX>;
  constexpr int NT = kKeyThreads<WMAX>;
  constexpr int RUN = R + WMAX - 1;
  constexpr int SC = C * WIDTH;  // elements of one staged chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf_q = reinterpret_cast<T*>(smem_raw);  // [kStages][SC]
  T* const buf_g = buf_q + kStages * SC;            // [kStages][SC]
  T* const out_k = buf_g + kStages * SC;            // [SC]
  T* const out_v = out_k + SC;                      // [SC]
  // [edge: S-1, 0][dk, dv][D]
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
  const int64_t base = row * D * sl;
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

  // The edge fold, one channel a thread: the wrapped slots of queries
  // i < hw (slots o < hw - i) land on key S-1, those of queries
  // i >= S - (w-1-hw) (slots o >= S + hw - i) on key 0.
  const bool has_last = j0 + nk == s;
  const bool has_first = j0 == 0;
  if (has_last || has_first) {
    for (int c = t; c < D; c += NT) {
      const T* qr = q + base + c * sl;
      const T* gr = g + base + c * sl;
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
      fold[D + c] = fv;
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
      fold[2 * D + c] = fk;
      fold[3 * D + c] = fv;
    }
  }
  // The runs that hold key S-1 and key 0 (-1: none).
  const int r_last = has_last && s - 1 - j0 - k0 >= 0 && s - 1 - j0 - k0 < R
                         ? s - 1 - j0 - k0
                         : -1;
  const int r_first = has_first && k0 == 0 ? 0 : -1;
  const float* fold_last = fold + role * D;
  const float* fold_first = fold + (2 + role) * D;
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

// Raises a kernel's dynamic shared memory limit where it passes 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D, int WMAX>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* g,
                     const float* wts, T* dq, T* dk, T* dv, float* coef_k,
                     float* coef_v, int s, int w, dim3 grid, int tiles,
                     float scale, bool dropout, Dropout drop,
                     cudaStream_t stream) {
  constexpr int kQuerySmem = query_smem_bytes<T, WMAX>();
  auto* query = dropout ? band_bwd_query_kernel<T, D, WMAX, true>
                        : band_bwd_query_kernel<T, D, WMAX, false>;
  cudaError_t err = allow_smem(query, kQuerySmem);
  if (err != cudaSuccess) return err;
  query<<<grid, kThreads, kQuerySmem, stream>>>(
      k, v, g, wts, dq, coef_k, coef_v, s, w, tiles, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kKeySmem = key_smem_bytes<T, WMAX>(D);
  auto* key = band_bwd_key_kernel<T, D, WMAX>;
  err = allow_smem(key, kKeySmem);
  if (err != cudaSuccess) return err;
  key<<<grid, kKeyThreads<WMAX>, kKeySmem, stream>>>(q, g, coef_k, coef_v,
                                                     dk, dv, s, w, tiles);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_w(const T* q, const T* k, const T* v, const T* g,
                     const float* wts, T* dq, T* dk, T* dv, float* coef_k,
                     float* coef_v, int s, int w, dim3 grid, int tiles,
                     float scale, bool dropout, Dropout drop,
                     cudaStream_t stream) {
  if (w <= 8) {
    return launch_d<T, D, 8>(q, k, v, g, wts, dq, dk, dv, coef_k, coef_v, s,
                             w, grid, tiles, scale, dropout, drop, stream);
  }
  return launch_d<T, D, kMaxWindow>(q, k, v, g, wts, dq, dk, dv, coef_k,
                                    coef_v, s, w, grid, tiles, scale, dropout,
                                    drop, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const float* wts, void* dq, void* dk,
                   void* dv, float* scratch, int64_t rows, int d, int s,
                   int w, float scale, bool dropout, Dropout drop,
                   cudaStream_t stream) {
  const int tiles = (s + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  float* coef_k = scratch;
  float* coef_v = scratch + rows * w * static_cast<int64_t>(s);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  switch (d) {
    case 16:
      return launch_w<T, 16>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                             coef_v, s, w, grid, tiles, scale, dropout, drop,
                             stream);
    case 32:
      return launch_w<T, 32>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                             coef_v, s, w, grid, tiles, scale, dropout, drop,
                             stream);
    case 64:
      return launch_w<T, 64>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                             coef_v, s, w, grid, tiles, scale, dropout, drop,
                             stream);
    case 128:
      return launch_w<T, 128>(qp, kp, vp, gp, wts, dqp, dkp, dvp, coef_k,
                              coef_v, s, w, grid, tiles, scale, dropout, drop,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launches (0 on success). q, k, v, g, dq, dk and dv are device pointers to
// contiguous [rows, d, s] tensors of one dtype (is_bf16 = 1 for bf16, 0 for
// f32), each at least 2-byte (bf16) or 4-byte (f32) aligned; wts is the
// forward's f32 [rows, w, s] weights; scratch is f32 [2, rows, w, s],
// written and read here. With dropout != 0 the forward's mask is
// regenerated by philox.cuh's rule under (seed_lo, seed_hi, threshold).
// `stream` is the caller's cudaStream_t. Nothing is allocated and nothing
// synchronises.
extern "C" int mhla_band_bwd(const void* q, const void* k, const void* v,
                             const void* g, const void* wts, void* dq,
                             void* dk, void* dv, void* scratch,
                             long long rows, int d, int s, int w, int is_bf16,
                             float scale, int dropout, unsigned int seed_lo,
                             unsigned int seed_hi, unsigned int threshold,
                             float one_minus_rate, int device, void* stream) {
  if (rows <= 0 || w < 1 || w > kMaxWindow || s <= 2 * w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{(static_cast<uint64_t>(seed_hi) << 32) | seed_lo,
                     threshold, one_minus_rate};
  const float* wp = static_cast<const float*>(wts);
  float* sp = static_cast<float*>(scratch);
  err = is_bf16
            ? launch<__nv_bfloat16>(q, k, v, g, wp, dq, dk, dv, sp, rows, d,
                                    s, w, scale, dropout != 0, drop, st)
            : launch<float>(q, k, v, g, wp, dq, dk, dv, sp, rows, d, s, w,
                            scale, dropout != 0, drop, st);
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of pass 1 (pass = 1) or pass 2 (pass = 2)
// at head dim d and window w, for the build report; 0 for what the kernels
// do not take.
extern "C" int mhla_band_bwd_smem(int pass, int is_bf16, int d, int w) {
  if (w < 1 || w > kMaxWindow || (d != 16 && d != 32 && d != 64 && d != 128)) {
    return 0;
  }
  if (pass == 1) {
    if (is_bf16) {
      return w <= 8 ? query_smem_bytes<__nv_bfloat16, 8>()
                    : query_smem_bytes<__nv_bfloat16, kMaxWindow>();
    }
    return w <= 8 ? query_smem_bytes<float, 8>()
                  : query_smem_bytes<float, kMaxWindow>();
  }
  if (pass != 2) return 0;
  if (is_bf16) {
    return w <= 8 ? key_smem_bytes<__nv_bfloat16, 8>(d)
                  : key_smem_bytes<__nv_bfloat16, kMaxWindow>(d);
  }
  return w <= 8 ? key_smem_bytes<float, 8>(d)
                : key_smem_bytes<float, kMaxWindow>(d);
}

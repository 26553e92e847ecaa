// Staging helpers of the S-minor window-band kernels (mhla_band_fwd.cu,
// mhla_band_bwd.cu): channel rows of [B*h, d, S] tensors copied into shared
// memory by 16-byte asynchronous copies, read back as register runs of
// consecutive queries (keys), and results written out through a staged tile.
// The tile band's backward (mhla_tile_band_bwd.cu) uses the cp.async
// helpers alone.
//
// In the S-minor layout channel c of row r starts at element (r*d + c)*S,
// which at odd S is 2-byte aligned for most channels. So a channel's columns
// are copied as the 16-byte-aligned span that covers them, and the staged
// row keeps the channel's element offset within 16 bytes (its lead): column
// x sits at x - c_lo + lead(c_lo). The slack belongs to the neighbouring
// channel or row and is never read into a sum. TMA does not fit this layout:
// a tensor map's strides must be multiples of 16 bytes, and a channel's
// stride, S*2 bytes, is not one at odd S.
//
// Template parameters: T the element type (bf16 or f32), TILE the queries
// (keys) a block owns, C the channels of one staged chunk, WIDTH the
// elements of one staged channel row, WMAX the slot cap (a staged key row
// holds TILE + WMAX - 1 columns), NT the threads of the block.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace band_stage {

// The head dims the band kernels take: whole chunks of 8 (bf16) or 4 (f32)
// channels, any number of them (the wrapper pads other head dims with zero
// channels). Nothing a block keeps grows with d but the backward's edge
// fold, 16 d bytes of shared memory beside 64 KB of stages.
inline bool head_dim_ok(int d) { return d >= 8 && d % 8 == 0; }

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a copy

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The element offset within its 16-byte block of column x of the channel
// row at p (x may lie outside the row: the offset is taken modulo kVec).
template <typename T>
__device__ __forceinline__ int lead(const T* p, int x) {
  const int64_t e =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) / sizeof(T)) + x;
  return static_cast<int>(e & (kVec<T> - 1));
}

// lead() of the channel rows of one (b*h) row, by channel: channel c starts
// c*S elements after channel 0.
template <typename T>
struct Leads {
  int first;   // lead(channel 0, 0)
  int stride;  // S mod kVec
  __device__ __forceinline__ Leads(const T* row0, int64_t s)
      : first(lead(row0, 0)), stride(static_cast<int>(s & (kVec<T> - 1))) {}
  __device__ __forceinline__ int at(int c, int x) const {
    return (first + c * stride + x) & (kVec<T> - 1);
  }
};

// Stages columns [lo, hi) (at most TILE + WMAX - 1 of them) of the C
// channel rows from channel c0 of one (b*h) row (channel c at row0 + c*s,
// offsets `leads`) into rows of WIDTH elements at dst: column x lands at
// x - c_lo + lead(c_lo), by 16-byte asynchronous copies of the aligned span
// that covers [lo, hi). The caller commits the group.
template <typename T, int TILE, int C, int WIDTH, int WMAX, int NT>
__device__ __forceinline__ void stage(T* dst, const T* row0, int64_t s,
                                     const Leads<T>& leads, int c0, int c_lo,
                                     int lo, int hi) {
  constexpr int V = kVec<T>;
  // Copies of one row, at most.
  constexpr int kCopies = (TILE + WMAX - 1 + 2 * V - 2) / V;
#pragma unroll
  for (int f0 = 0; f0 < C * kCopies; f0 += NT) {
    const int f = f0 + threadIdx.x;
    const int cc = f / kCopies;
    const int m = f - cc * kCopies;
    const int off = leads.at(c0 + cc, lo);
    if (f < C * kCopies && m * V < off + hi - lo) {
      cp_async16(dst + cc * WIDTH + (lo - c_lo) + leads.at(c0 + cc, c_lo) -
                     off + m * V,
                 row0 + (c0 + cc) * s + (lo - off + m * V));
    }
  }
}

// Writes the staged columns of [c_lo, c_hi) that lie outside the row (the
// halo) of the C rows staged from src into dst: from column S-1 below 0 and
// column 0 past S-1 (the forward's edge rule), or zeros. With kFar the span
// may lie wholly outside the row (a far slot group of a wide window);
// without it, c_lo < S and c_hi > 0.
template <typename T, int C, int WIDTH, int NT, bool kFar = false>
__device__ __forceinline__ void fill_halo(T* dst, const T* src, int64_t s,
                                         int c_lo, int c_hi, bool zeros) {
  int left, right, r_lo;  // r_lo: the first column past S-1
  if constexpr (kFar) {
    left = c_lo < 0 ? min(c_hi, 0) - c_lo : 0;
    r_lo = max(c_lo, static_cast<int>(s));
    right = c_hi > r_lo ? c_hi - r_lo : 0;
  } else {
    left = c_lo < 0 ? -c_lo : 0;
    r_lo = static_cast<int>(s);
    right = c_hi > s ? c_hi - r_lo : 0;
  }
  const int n = left + right;
  for (int f = threadIdx.x; f < C * n; f += NT) {
    const int cc = f / n;
    const int e = f - cc * n;
    const int x = e < left ? c_lo + e : r_lo + (e - left);
    const T* row = src + cc * s;
    const T val = zeros ? T(0.f) : (e < left ? row[s - 1] : row[0]);
    dst[cc * WIDTH + x - c_lo + lead(row, c_lo)] = val;
  }
}

// Writes columns [lo, hi) (at most TILE) of the C channel rows from channel
// c0 of one (b*h) row (as stage()'s) from the staged rows at src (column x
// at x - lo + lead(lo)): 16-byte stores, element stores in the two partial
// blocks at a row's ends.
template <typename T, int TILE, int C, int WIDTH, int NT>
__device__ __forceinline__ void unstage(T* row0, const T* src, int64_t s,
                                       const Leads<T>& leads, int c0, int lo,
                                       int hi) {
  constexpr int V = kVec<T>;
  constexpr int kStores = (TILE + 2 * V - 2) / V;  // a row, at most
#pragma unroll
  for (int f0 = 0; f0 < C * kStores; f0 += NT) {
    const int f = f0 + threadIdx.x;
    const int cc = f / kStores;
    const int m = f - cc * kStores;
    const int x0 = lo - leads.at(c0 + cc, lo) + m * V;  // 16-byte aligned
    if (f < C * kStores && x0 < hi) {
      T* row = row0 + (c0 + cc) * s;
      const T* from = src + cc * WIDTH + m * V;
      if (x0 >= lo && x0 + V <= hi) {
        *reinterpret_cast<uint4*>(row + x0) =
            *reinterpret_cast<const uint4*>(from);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (x0 + e >= lo && x0 + e < hi) row[x0 + e] = from[e];
        }
      }
    }
  }
}

// Value j of a run that starts E bf16 elements into the words h.
template <int E, int N, int M>
__device__ __forceinline__ void take_run(float (&out)[N],
                                         const uint32_t (&h)[M]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t word = h[(E + j) >> 1];
    out[j] = __uint_as_float(((E + j) & 1) ? (word & 0xffff0000u)
                                           : (word << 16));
  }
}

// The N staged values at positions [pos, pos + N) of a row, as f32. bf16:
// 8-byte shared loads from the 4-element boundary at or below pos (a warp's
// threads, 4 or more elements apart, read conflict-free), then a branch on
// pos % 4, which is the same in every thread of the block.
template <int N>
__device__ __forceinline__ void load_run(float (&out)[N],
                                         const __nv_bfloat16* row, int pos) {
  constexpr int kWords = (N + 3 + 3) / 4;
  const uint2* p = reinterpret_cast<const uint2*>(row + (pos & ~3));
  uint32_t h[2 * kWords];
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    const uint2 x = p[m];
    h[2 * m] = x.x;
    h[2 * m + 1] = x.y;
  }
  switch (pos & 3) {
    case 0: take_run<0>(out, h); break;
    case 1: take_run<1>(out, h); break;
    case 2: take_run<2>(out, h); break;
    default: take_run<3>(out, h); break;
  }
}
template <int N>
__device__ __forceinline__ void load_run(float (&out)[N], const float* row,
                                         int pos) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = row[pos + j];
}

// Rounds the N values and writes them to positions [pos, pos + N) of a
// staged row. bf16: in pairs (4-byte stores) from the first even position;
// the parity of pos is the same in every thread of the block.
template <int N>
__device__ __forceinline__ void store_run(__nv_bfloat16* row, int pos,
                                          const float (&val)[N]) {
  if (pos & 1) {
    row[pos] = __float2bfloat16(val[0]);
#pragma unroll
    for (int j = 1; j + 1 < N; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(row + pos + j) =
          __floats2bfloat162_rn(val[j], val[j + 1]);
    }
    if (N % 2 == 0) row[pos + N - 1] = __float2bfloat16(val[N - 1]);
  } else {
#pragma unroll
    for (int j = 0; j + 1 < N; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(row + pos + j) =
          __floats2bfloat162_rn(val[j], val[j + 1]);
    }
    if (N % 2 == 1) row[pos + N - 1] = __float2bfloat16(val[N - 1]);
  }
}
template <int N>
__device__ __forceinline__ void store_run(float* row, int pos,
                                          const float (&val)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) row[pos + j] = val[j];
}

}  // namespace band_stage

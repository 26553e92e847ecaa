// Ring helpers of the tile-band kernels (mhla_tile_band_fwd.cu, K6 and K8;
// mhla_tile_band_bwd.cu, K7): blocks that walk along a token-major row keep
// rings of rows of D bf16 in shared memory, filled by 16-byte cp.async
// copies (band_stage.cuh's), read by ldmatrix, and send their results out
// through dead ring rows with stmatrix and 16-byte stores.
//
// A ring of R rows holds position p at ring row (p + R) mod R. Rows are
// unpadded; chunk c (16 bytes) of ring row j is stored at chunk c ^ swz(j),
// so that 8 consecutive rows hold one chunk in 8 different 16-byte bank
// groups and ldmatrix reads 8 rows of one chunk without conflicts. R is a
// multiple of 16 and the kernels address 16-row blocks that start at
// positions that are multiples of 16, so such a block starts at a ring row
// that is a multiple of 16 and never wraps.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "band_stage.cuh"
#include "flash_common.cuh"

namespace tile_ring {

using bf16 = __nv_bfloat16;

// Ring row of position p (p >= -R).
template <int R>
__device__ __forceinline__ int ring_row(int p) {
  return (p + R) % R;
}

// The XOR swizzle of ring row j.
template <int D>
__device__ __forceinline__ int swz(int j) {
  constexpr int kChunks = D / 8;
  constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  return (j / kRowsPerLine) & kMask;
}

template <int D>
__device__ __forceinline__ char* ring_at(bf16* ring, int j, int c) {
  return reinterpret_cast<char*>(ring) + j * (2 * D) + ((c ^ swz<D>(j)) << 4);
}

// A lane's address in an ldmatrix (stmatrix) x4 over a block of 16 ring
// rows, which starts at a ring row that is a multiple of 16, so the
// swizzle of its row r is that of r alone. Pattern A (also B read
// transposed, and stmatrix): matrix lane / 8 holds rows 8 (lane / 8 & 1)..
// and chunk lane / 16; pattern B: rows 8 (lane / 16).. and chunk
// lane / 8 & 1. at(ring, j0, m): the block at ring row j0, chunk pair m.
template <int D>
struct LaneAddr {
  int row;  // byte offset of the lane's row in the block
  int x16;  // (the lane's chunk ^ its row's swizzle) << 4
  __device__ __forceinline__ LaneAddr(int r, int chunk)
      : row(r * 2 * D), x16((chunk ^ swz<D>(r)) << 4) {}
  // Chunk 2m + chunk of row r: (2m + chunk) ^ s == 2m ^ (chunk ^ s).
  __device__ __forceinline__ char* at(bf16* ring, int j0, int m) const {
    return reinterpret_cast<char*>(ring) + j0 * (2 * D) + row +
           ((m << 5) ^ x16);
  }
};

template <int D>
__device__ __forceinline__ LaneAddr<D> pattern_a(int lane) {
  return LaneAddr<D>(((lane >> 3) & 1) * 8 + (lane & 7), lane >> 4);
}

template <int D>
__device__ __forceinline__ LaneAddr<D> pattern_b(int lane) {
  return LaneAddr<D>((lane >> 4) * 8 + (lane & 7), (lane >> 3) & 1);
}

__device__ __forceinline__ void stsm_x4(void* ptr, uint32_t r0, uint32_t r1,
                                        uint32_t r2, uint32_t r3) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// Positions [p0, p0 + N) of a row of D-element rows into a ring of R rows,
// by NT threads with 16-byte cp.async copies: position p in [lo, hi) is
// copied from src + p D; one outside is copied from the nearest of lo and
// hi - 1 (clamp: the band's replicas of the edge rows) or stored as zeros
// by the issuing thread. Nothing is written into the ring after a copy
// lands. The caller commits the group.
template <int D, int N, int NT, int R>
__device__ __forceinline__ void issue_rows(bf16* ring, const bf16* src, int p0,
                                           int lo, int hi, bool clamp,
                                           int tid) {
  constexpr int C = D / 8;
  constexpr int kItems = N * C;
  const int j0 = ring_row<R>(p0);
#pragma unroll
  for (int f0 = 0; f0 < kItems; f0 += NT) {
    const int f = f0 + tid;
    if (kItems % NT == 0 || f < kItems) {
      const int r = f / C;
      const int c = f % C;
      const int p = p0 + r;
      const int j = j0 + r < R ? j0 + r : j0 + r - R;
      char* dst = ring_at<D>(ring, j, c);
      if ((p >= lo && p < hi) || clamp) {
        band_stage::cp_async16(
            dst,
            src + static_cast<int64_t>(min(max(p, lo), hi - 1)) * D + c * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// Columns [C0 * 8, (C0 + NC) * 8) of a warp's 16-row f32 result, rounded
// to bf16, to rows pos0..pos0+15 of dst (those in [0, n)) in 16-byte
// stores: through the same columns of ring rows j0..j0+15 of `stage`, which
// no other warp touches meanwhile.
template <int D, int C0, int NC>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[NC][4],
                                           bf16* stage, int j0, int pos0,
                                           int n, int lane) {
  const LaneAddr<D> la = pattern_a<D>(lane);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < NC; nt += 2) {
    stsm_x4(la.at(stage, j0, (C0 + nt) / 2),
            flash::pack_bf16(acc[nt][0], acc[nt][1]),
            flash::pack_bf16(acc[nt][2], acc[nt][3]),
            flash::pack_bf16(acc[nt + 1][0], acc[nt + 1][1]),
            flash::pack_bf16(acc[nt + 1][2], acc[nt + 1][3]));
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < (16 * NC + 31) / 32; ++it) {
    const int f = it * 32 + lane;
    const int r = f / NC;
    const int c = C0 + f % NC;
    const int pos = pos0 + r;
    if (f < 16 * NC && pos >= 0 && pos < n) {
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(pos) * D + c * 8) =
          *reinterpret_cast<const uint4*>(ring_at<D>(stage, j0 + r, c));
    }
  }
  __syncwarp();
}

}  // namespace tile_ring

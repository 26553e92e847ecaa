// Ring helpers of the tile-band kernels (mhla_tile_band_fwd.cu, K6 and K8;
// mhla_tile_band_bwd.cu, K7): blocks that walk along a token-major row keep
// rings of rows of D bf16 in shared memory, filled by 16-byte cp.async
// copies (band_stage.cuh's), read by ldmatrix, and send their results out
// through dead ring rows with stmatrix and 16-byte stores. (Past the wide
// kernels' range, hw > 64 or d > 256, the sources run tile_band_sm90.cuh's
// wgmma kernels.)
//
// A ring of R rows holds position p at ring row (p + R) mod R. Rows are
// unpadded; chunk c (16 bytes) of ring row j is stored at chunk c ^ swz(j),
// so that 8 consecutive rows hold one chunk in 8 different 16-byte bank
// groups and ldmatrix reads 8 rows of one chunk without conflicts. R is a
// multiple of 16 and the kernels address 16-row blocks that start at
// positions that are multiples of 16, so such a block starts at a ring row
// that is a multiple of 16 and never wraps.
//
// D is the tile width (16, 32, 64, 80, 128, 192 or 256); a head dim d < D
// is copied into the first d / 8 chunks of a row and the rest are zeros.
// At D = 80 (ten chunks, 160 bytes a row) the swizzle flips the low bit of
// the chunk index in rows 4-7 of each 8, which keeps a chunk pair inside
// the row: rows 0-3 start 32 bytes apart modulo 128, rows 4-7 land on the
// other 16 bytes of each 32, so 8 rows of one chunk meet 8 bank groups.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "band_stage.cuh"
#include "flash_common.cuh"

namespace tile_ring {

using bf16 = __nv_bfloat16;

// The wide kernels' range (mhla_tile_band_{fwd,bwd}.cu): hw <= 64, W <= 129,
// and d up to 256; the wgmma kernels take every (hw, d) beyond it, and some
// inside it (sm90_takes).
constexpr int kMaxHalo = 64;

// Whether the ring or wide kernels could take (d, hw).
inline bool staged_range(int d, int hw) {
  return hw <= kMaxHalo && flash::tile_width(d) != 0;
}

// Whether a bf16 call of K6, K7 or K8 runs the wgmma kernels
// (tile_band_sm90.cuh): past the wide kernels' range, and inside it at
// d > 128 with hw = 64 (W = 128, 129), the one window of the range where
// the card timed them against the wide kernels at d = 136, 192 and 256 and
// they ran faster (PERF.md section 6). Elsewhere the ring and wide kernels.
inline bool sm90_takes(int d, int hw) {
  return !staged_range(d, hw) || (d > 128 && hw == kMaxHalo);
}

// JAX's halo (mhla_kernel_v4.py _halo): hw rounded up to a multiple of 16,
// at least 16.
inline int halo_of(int hw) { return hw <= 16 ? 16 : (hw + 15) / 16 * 16; }

// Whether a block of 16 keys meets the band |key - query| <= hw of any of a
// warp's 16 queries, b being its first key's offset from the first query.
// A dead block's logits are -inf and its weights 0 in every slot.
__device__ __forceinline__ bool block_live(int b, int hw) {
  return b - 15 <= hw && b + 15 >= -hw;
}

// Whether chunk ch of the wide kernels' band walk (the 48 keys from offset
// 48 ch - halo of the warp's first query) meets the band of any query.
__device__ __forceinline__ bool wide_chunk_live(int ch, int halo, int hw) {
  const int b = 48 * ch - halo;
  return b - 15 <= hw && b + 47 >= -hw;
}

// Ring row of position p (p >= -R).
template <int R>
__device__ __forceinline__ int ring_row(int p) {
  return (p + R) % R;
}

// The XOR swizzle of ring row j.
template <int D>
__device__ __forceinline__ int swz(int j) {
  constexpr int kChunks = D / 8;
  if constexpr (kChunks > 8 && kChunks % 8 != 0) {
    static_assert(kChunks % 2 == 0, "chunk pairs");
    return (j >> 2) & 1;
  } else {
    constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
    constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
    return (j / kRowsPerLine) & kMask;
  }
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

// Positions [p0, p0 + N) of a row of d-element rows (d <= D) into a ring
// of R rows, by NT threads with 16-byte cp.async copies: position p in
// [lo, hi) is copied from src + p d; one outside is copied from the nearest
// of lo and hi - 1 (clamp: the band's replicas of the edge rows) or stored
// as zeros by the issuing thread, as are the chunks past d. Nothing is
// written into the ring after a copy lands. The caller commits the group.
template <int D, int N, int NT, int R>
__device__ __forceinline__ void issue_rows(bf16* ring, const bf16* src, int p0,
                                           int lo, int hi, bool clamp,
                                           int tid, int d = D) {
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
      if (8 * c < d && ((p >= lo && p < hi) || clamp)) {
        band_stage::cp_async16(
            dst,
            src + static_cast<int64_t>(min(max(p, lo), hi - 1)) * d + c * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// The same for a run-time count of rows, by nt threads, into a linear
// buffer (row r of the buffer holds position p0 + r).
template <int D>
__device__ __forceinline__ void issue_rows_n(bf16* buf, const bf16* src,
                                             int p0, int rows, int lo, int hi,
                                             bool clamp, int tid, int nt,
                                             int d) {
  constexpr int C = D / 8;
  for (int f = tid; f < rows * C; f += nt) {
    const int r = f / C;
    const int c = f % C;
    const int p = p0 + r;
    char* dst = ring_at<D>(buf, r, c);
    if (8 * c < d && ((p >= lo && p < hi) || clamp)) {
      band_stage::cp_async16(
          dst, src + static_cast<int64_t>(min(max(p, lo), hi - 1)) * d + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Columns [C0 * 8, (C0 + NC) * 8) of a warp's 16-row f32 result, rounded
// to bf16, to rows pos0..pos0+15 of dst (those in [0, n); rows of d
// elements, the columns past d not stored) in 16-byte stores: through the
// same columns of ring rows j0..j0+15 of `stage`, which no other warp
// touches meanwhile.
template <int D, int C0, int NC>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[NC][4],
                                           bf16* stage, int j0, int pos0,
                                           int n, int lane, int d = D) {
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
    if (f < 16 * NC && pos >= 0 && pos < n && 8 * c < d) {
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(pos) * d + c * 8) =
          *reinterpret_cast<const uint4*>(ring_at<D>(stage, j0 + r, c));
    }
  }
  __syncwarp();
}

}  // namespace tile_ring

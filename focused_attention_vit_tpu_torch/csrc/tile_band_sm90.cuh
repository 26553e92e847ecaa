// Hopper pieces of the tile band's kernels past the ring kernels' range
// (mhla_tile_band_fwd.cu: K6 and K8; mhla_tile_band_bwd.cu: K7): a deep
// ring of 64 x 64 bf16 tiles in shared memory, filled by one producer warp
// and read by one consumer warpgroup through wgmma.
//
// Tiles. Every tile is 64 rows of 64 bf16 columns, 128 bytes a row, its
// 16-byte chunk c of row r stored at chunk c ^ (r % 8): the layout TMA
// writes for a 128-byte-swizzled 64 x 64 box, and the one wgmma reads
// through a descriptor of that swizzle mode (hopper_common.cuh desc_k,
// desc_mn with D = R = 64). Tile bases are 1024-byte aligned. A head dim
// d runs in ceil(d / 64) column tiles, zeros past d; products over d stop at
// its last 16-column step.
//
// Copies. One thread of the producer warp brings every tile in by TMA
// (hopper_common.cuh tma_load_3d), completing on the stage's `full`
// barrier: a 64 x 64 box of a [lines, n, d] tensor map, zeros past the
// tensor's rows and columns. So K6's and K7's clamped band, which reads
// positions outside [0, S) as copies of row 0 or S - 1, gets zero rows
// there: the kernels keep those two rows of K and V (all of d, one-row
// boxes, each swizzled by its own address as the 64-row box would be: the
// pattern follows the shared-memory address bits) and add their terms
// themselves. K7's p/ds scratch arrives as four 16-row boxes of a 4-D map
// (one per 16-query block, each at its own column offset, zeros outside a
// block's columns and outside the line). (A draft copied every tile by
// 16-byte cp.async from the 32 lanes of the producer warp, which kept too
// few copies in flight; another filled the clamped rows into the tiles,
// with 8-row and one-row boxes for the rest, and left K6 well behind K8.)
//
// Ring. Item i (the i-th tile the producer stages after the kept ones) goes
// to stage i % ns of ns stages (3 to kMaxStages, as many as shared memory
// holds). The consumers wait on `full` of the stage they read, and after
// the products that read it have completed, each consumer warp's lane 0
// arrives on its `empty` barrier (4 arrivals a phase). The producer waits
// on `empty` before it overwrites a stage. There is no block-wide barrier
// after the set-up.
//
// Kept or streamed. A block keeps its 64 queries' Q (and K7's G) in shared
// memory where those tiles fit beside at least kMinStages stages; past that
// (K7 from d = 776, K6/K8 from d = 1480) tile c of Q (G) comes through the
// ring as the item just before tile c of K (V), so a product reads two
// items and the consumers release both after the next product is issued:
// at least kStreamStages stages then. The logits against the clamped
// band's edge rows read the queries' rows from device memory either way.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_common.cuh"

namespace tb90 {

namespace hp = hopper;
using bf16 = __nv_bfloat16;

constexpr int kTileElems = 64 * 64;
constexpr int kTileBytes = kTileElems * 2;  // 8 KB
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxStages = 16;
constexpr int kMinStages = 3;
constexpr int kStreamStages = 4;  // two items a product, two products held
constexpr int kConsumerBar = 1;  // named barrier of the consumer warpgroup

// Dynamic shared memory a block may ask for with `per_sm` blocks an SM,
// kept clear of the 1 KB of alignment slack and of up to 2 KB of static
// shared memory (the barriers, a fold row).
constexpr int smem_budget(int per_sm) {
  return (per_sm == 1 ? 232448 : 114688) - 1024 - 2048;
}

// The ring's stages beside `resident` bytes of tiles that stay (0 where
// fewer than `least` fit).
inline int ring_stages(int resident, int per_sm, int least = kMinStages) {
  int n = (smem_budget(per_sm) - resident) / kTileBytes;
  n = n > kMaxStages ? kMaxStages : n;
  return n < least ? 0 : n;
}

// The dynamic shared memory of `resident` bytes of kept tiles, `stages`
// stages and `extra` bytes after them.
inline int smem_bytes(int resident, int stages, int extra = 0) {
  return 1024 + resident + stages * kTileBytes + extra;
}

// Column tiles of a head dim.
__host__ __device__ __forceinline__ int col_tiles(int d) {
  return (d + 63) / 64;
}

// Output columns a block takes: all of d up to 256, else d in equal slices
// of at most 256; rounded up to whole column tiles.
inline int slice_width(int d) {
  const int n = (d + 255) / 256;
  return (((d + n - 1) / n) + 63) / 64 * 64;
}

// --- copies -----------------------------------------------------------------

// The edge rows of a clamped line (row 0 and row n - 1 of K and of V, every
// column tile), kept in shared memory: 4 nd rows of 128 bytes, each
// swizzled as a one-row box lands at its address.
struct Edges {
  uint8_t* base;
  int nd;
  __device__ __forceinline__ uint8_t* row(int x, int end, int c) const {
    return base + ((2 * x + end) * nd + c) * 128;
  }
};

__host__ __device__ __forceinline__ int edge_bytes(int d) {
  return 4 * col_tiles(d) * 128;
}

// Columns c, c + 1 of row `row` of kept 64-row tiles (one a 64 columns,
// 128-byte swizzled), as floats.
__device__ __forceinline__ float2 kept_pair(const bf16* tiles, int row,
                                            int c) {
  const uint8_t* t =
      reinterpret_cast<const uint8_t*>(tiles + (c >> 6) * kTileElems);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      t + hp::swizzle128_offset<64>(row, c & 63)));
}

// Columns c, c + 1 of a row of bf16 in device memory, as floats.
__device__ __forceinline__ float2 row_pair(const bf16* row, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + c));
}

// Columns c, c + 1 of an edge row, as floats.
__device__ __forceinline__ float2 edge_pair(const Edges& ed, int x, int end,
                                            int c) {
  const uint8_t* row = ed.row(x, end, c >> 6);
  const int rho = (hp::smem_u32(row) >> 7) & 7;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      row + ((((c & 63) >> 3) ^ rho) << 4) + ((c & 7) << 1)));
}

// The producer warp: load the edge rows of K (x = 0) and V (x = 1) of
// line `line` (n rows) through their one-row maps and wait for them.
__device__ __forceinline__ void load_edges(const Edges& ed,
                                           const CUtensorMap* k1,
                                           const CUtensorMap* v1,
                                           uint64_t* bar, int n, int line,
                                           int lane) {
  if (lane == 0) {
    hp::mbar_arrive_expect_tx(bar, 4 * ed.nd * 128);
    for (int x = 0; x < 2; ++x) {
      for (int end = 0; end < 2; ++end) {
        for (int c = 0; c < ed.nd; ++c) {
          hp::tma_load_3d(ed.row(x, end, c), x ? v1 : k1, bar, 64 * c,
                          end ? n - 1 : 0, line);
        }
      }
    }
  }
  hp::mbar_wait(bar, 0);
}

// K7's p/ds scratch (mhla_tile_band_bwd.cu Scratch) through a 4-D map
// (columns of a block's row, its 16 rows, the line's 16-query blocks, the
// lines; box 64 x 16 x 1 x 1): tile row r, column c gets query q0 + r's
// entry at key k0 + c, the block at 16 b holding key 16 b - halo + c in
// column c; zeros where a block has no such column or the line no such
// block. q0 is a multiple of 16.
__device__ __forceinline__ void load_scratch(bf16* tile,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int q0, int k0,
                                             int halo, int line) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int b = q0 / 16 + u;
    const uint32_t dst = hp::smem_u32(reinterpret_cast<uint8_t*>(tile) +
                                      u * 16 * 128);
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
        "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(hp::smem_u32(bar)),
        "r"(k0 - 16 * b + halo), "r"(0), "r"(b), "r"(line)
        : "memory");
  }
}

// --- the ring ---------------------------------------------------------------

struct Ring {
  uint8_t* base;    // ns stages of one tile
  uint64_t* full;   // kMaxStages barriers each
  uint64_t* empty;
  uint64_t* kept;   // the kept tiles' barrier
  uint64_t* edges;  // the edge rows' barrier
  int ns;

  __device__ __forceinline__ bf16* tile(int i) const {
    return reinterpret_cast<bf16*>(base + (i % ns) * kTileBytes);
  }
  // Producer (any of its lanes): wait until the stage's previous item has
  // been released; returns the barrier item i's loads complete on.
  __device__ __forceinline__ uint64_t* acquire(int i) const {
    if (i >= ns) hp::mbar_wait(&empty[i % ns], ((i / ns) & 1) ^ 1);
    return &full[i % ns];
  }
  // Consumers: item i has landed and may be read by wgmma.
  __device__ __forceinline__ void wait(int i) const {
    hp::mbar_wait(&full[i % ns], (i / ns) & 1);
  }
  // Consumers, after the products reading item i have completed.
  __device__ __forceinline__ void release(int i, int lane) const {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[i % ns]);
  }
  // The same for the n items i - n + 1 .. i (a kept or streamed product's).
  __device__ __forceinline__ void release_last(int i, int n, int lane) const {
    __syncwarp();
    if (lane == 0) {
      for (int u = 0; u < n; ++u) hp::mbar_arrive(&empty[(i - u) % ns]);
    }
  }
  // The kept edge rows, after the ring.
  __device__ __forceinline__ Edges edge_rows(int d) const {
    return Edges{base + ns * kTileBytes, col_tiles(d)};
  }
};

// The 64 x 64 tile of a map with 64 x 64 boxes at columns [c0, + 64),
// rows [p0, + 64) of line `line`, completing on `bar` (lane 0 of the
// producer).
__device__ __forceinline__ void load_full(bf16* tile, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int p0,
                                          int line, int lane) {
  if (lane != 0) return;
  hp::mbar_arrive_expect_tx(bar, kTileBytes);
  hp::tma_load_3d(tile, map, bar, c0, p0, line);
}

// The barriers (static shared memory of the kernel: 2 kMaxStages + 2) and
// the ring after `resident` bytes of the aligned dynamic shared memory;
// thread 0 initialises the barriers, then the block synchronises once.
__device__ __forceinline__ Ring make_ring(uint8_t* smem, int resident,
                                          uint64_t* bars, int ns) {
  Ring r{smem + resident, bars, bars + kMaxStages, bars + 2 * kMaxStages,
         bars + 2 * kMaxStages + 1, ns};
  if (threadIdx.x == 0) {
    for (int i = 0; i < ns; ++i) {
      hp::mbar_init(&r.full[i], 1);
      hp::mbar_init(&r.empty[i], kConsumers / 32);
    }
    hp::mbar_init(r.kept, 1);
    hp::mbar_init(r.edges, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// --- wgmma m64n64k16 with either operand MN-major ---------------------------

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both in shared memory; TA (TB) 1
// reads A (B) MN-major: A stored [k][m], B stored [k][n].
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// Operand descriptors of a tile: rows [0, 64) x columns [16 kk, + 16) read
// K-major (the rows are M or N), or rows [16 kk, + 16) read MN-major (the
// rows are the contraction).
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return hp::desc_k<64, 64>(tile, 0, kk);
}
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return hp::desc_mn<64, 64>(tile, kk);
}

// acc (+)= A B over the first `steps` 16-wide steps of the contraction
// (A[64 x 64] and B[64 x 64] tiles), as one committed group.
template <int TA, int TB>
__device__ __forceinline__ void tile_product(float (&acc)[32], const bf16* a,
                                             const bf16* b, int steps,
                                             bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= steps) break;
    mma_ss<TA, TB>(acc, TA ? desc_mn(a, kk) : desc_k(a, kk),
                   TB ? desc_mn(b, kk) : desc_k(b, kk),
                   (accumulate || kk > 0) ? 1 : 0);
  }
}

// The 16-column steps of column tile c of a head dim d.
__device__ __forceinline__ int steps_of(int d, int c) {
  const int left = (d - 64 * c + 15) / 16;
  return left < 4 ? left : 4;
}

// Columns [c0 + 64 vb, + 64) of a 64-row accumulator of NO columns (the
// wgmma layout: thread t of the warpgroup holds rows 16 (t / 32) + g and
// + 8, g = t % 32 / 4, columns 8 j + 2 (t % 4) (+1)) to rows r0.. of dst
// (rows below n, columns below d), rounded to bf16.
template <int NO>
__device__ __forceinline__ void store_acc(bf16* dst,
                                          const float (&acc)[NO / 2], int r0,
                                          int c0, int n, int d, int tid) {
  const int row = r0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int col = c0 + 2 * (tid & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= n) continue;
    bf16* out = dst + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      if (col + 8 * j >= d) break;
      *reinterpret_cast<__nv_bfloat162*>(out + col + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// --- host: tensor maps ------------------------------------------------------

// The cache of maps (hopper_common.cuh), shared with flash_wide.cuh.
using hp::cached_map;
using hp::MapKey;

// A map over a contiguous bf16 [lines, n, d] tensor whose box is 64 columns
// (128-byte swizzled, zeros past d) x box_rows rows of one line.
inline cudaError_t map_rows(CUtensorMap* map, const void* base, int64_t lines,
                            int n, int d, int box_rows) {
  return cached_map(map, MapKey{base, lines, n, d, box_rows},
                    [&](CUtensorMap* m) {
                      return hp::tensor_map_3d(m, base, lines, n, d,
                                               box_rows, 64);
                    });
}

// The 4-D map over K7's p or ds scratch: [lines, nqb, 16, lt] bf16, box
// 64 columns x 16 rows of one block, 128-byte swizzled.
inline cudaError_t encode_scratch(CUtensorMap* map, const void* base,
                                  int64_t lines, int nqb, int lt) {
  const hp::EncodeTiled encode = hp::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(lt), 16,
                              static_cast<cuuint64_t>(nqb),
                              static_cast<cuuint64_t>(lines)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(lt) * 2,
                                 static_cast<cuuint64_t>(lt) * 32,
                                 static_cast<cuuint64_t>(nqb) * lt * 32};
  const cuuint32_t box[4] = {64, 16, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same through the cache of maps.
inline cudaError_t map_scratch(CUtensorMap* map, const void* base,
                               int64_t lines, int nqb, int lt) {
  return cached_map(map, MapKey{base, lines, nqb, lt, 0}, [&](CUtensorMap* m) {
    return encode_scratch(m, base, lines, nqb, lt);
  });
}

}  // namespace tb90

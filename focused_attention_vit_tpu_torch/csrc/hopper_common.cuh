// Hopper pieces of the dense flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) and of the fused short-S attention kernels
// (fused_mha_fwd.cu, fused_mha_bwd.cu): warpgroup matrix products (wgmma)
// with their shared-memory descriptors and fences, mbarriers, named
// barriers, TMA tile loads, and the host-side encoding of the TMA tensor
// maps.
//
// Tiles. Every bf16 tile of R rows and D columns (D a multiple of 16) that a
// kernel stages is brought in by TMA as D / span column blocks of R rows x
// span columns, one after the other, span the widest of 64, 32 and 16 that
// divides D (Span<D>), each row of a block span * 2 bytes (128, 64 or 32)
// and swizzled by that span: the hardware XORs the 16-byte
// chunk index of an address with its row bits, so that 8 consecutive rows
// read the same column from 8 different bank groups. wgmma reads the same
// bytes through a descriptor of the same swizzle mode:
//   - K-major (the product contracts over the tile's columns: Q K^T, where
//     K's rows are the N of the product): 8-row groups at SBO = 8 * span
//     bytes; a step of 16 columns moves the start address by 32 bytes inside
//     the span, or to the next column block;
//   - MN-major (the product contracts over the tile's rows: P V, where V's
//     columns are the N of the product; the B-transpose bit): 8-row groups at
//     SBO = 8 * span, column blocks at LBO = R * span; a step of 16 rows
//     moves the start address by 16 * span.
// Tile bases are 1024-byte aligned, so the swizzle pattern that TMA writes
// and the one wgmma reads start at the same row. A tile may be wider than
// the tensor (a head dim padded to the next width the kernels are built
// for): the map's box reaches past the last column, and TMA fills what lies
// outside the tensor with zeros, which add nothing to a product.
//
// Accumulator layout of wgmma.m64nNk16 (f32), thread t of the warpgroup,
// warp w = t / 32, g = (t % 32) / 4, q = t % 4: d[4j + 2h + e] is row
// 16w + g + 8h, column 8j + 2q + e. A register A operand of one 16-deep step
// is the same layout over 16 columns packed to bf16 pairs:
//   a0 = (row g, cols 2q, 2q+1)      a1 = (row g + 8, cols 2q, 2q+1)
//   a2 = (row g, cols 2q+8, 2q+9)    a3 = (row g + 8, cols 2q+8, 2q+9)
// so two neighbouring 8-column groups of an accumulator become the A operand
// of the next product without leaving registers.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

using bf16 = __nv_bfloat16;

// --- addresses, barriers -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// requested with 1 KB to spare for it).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// follow it with __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that has not
// completed after 2^30 polls (seconds) traps, so that a fault in the
// pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++polls == (1u << 30)) __trap();
  } while (!done);
}

// A barrier among `count` threads (a multiple of 32) of the block, id >= 1
// (0 is __syncthreads's).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Arrive at such a barrier without waiting for it.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Makes this thread's ordinary writes to shared memory visible to the async
// proxy, through which wgmma reads its operands; follow it with a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Move registers between the warpgroups of a block, whose total is fixed at
// launch: a producer warpgroup lowers its limit and the consumer warpgroups
// raise theirs (a multiple of 8 in [24, 256]; every thread of a warpgroup
// executes it).
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Row span in columns and bytes of one column block of a D-column bf16 tile,
// and the descriptor's swizzle mode for it (1: 128 B, 2: 64 B, 3: 32 B).
template <int D>
struct Span {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "tile width");
  static constexpr int kCols = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kBytes = kCols * 2;
  static constexpr uint64_t kMode = kBytes == 128 ? 1 : kBytes == 64 ? 2 : 3;
};

// Rows [r0, r0 + R) of head `row` of a [rows, S, d] tensor into a tile of
// D / Span<D>::kCols column blocks (rows past S and columns past d arrive as
// zeros). The map's box is Span<D>::kCols x R x 1.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int r0) {
  constexpr int kCols = Span<D>::kCols;
#pragma unroll
  for (int cb = 0; cb < D / kCols; ++cb) {
    tma_load_3d(dst + cb * R * kCols, map, bar, cb * kCols, r0, row);
  }
}

// --- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous product reads or writes, so that the
// compiler neither reads them early nor reuses them before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Elements [off, off + N) of an accumulator or row array, as an array of
// their own (off a compile-time constant once unrolled, so that both stay in
// registers): one product's share of a longer row of accumulators.
template <int N, int M>
__device__ __forceinline__ float (&slice(float (&a)[M], int off))[N] {
  return *reinterpret_cast<float(*)[N]>(a + off);
}

// Byte offset of element (r, c) of a bf16 tile stored as TMA stores a
// 128-byte-swizzled tile of R rows: 64-column blocks of R rows, 128 bytes a
// row, the 16-byte chunk index XORed with r % 8. For a kernel that writes
// such a tile from registers and reads it back with wgmma.
template <int R>
__device__ __forceinline__ uint32_t swizzle128_offset(int r, int c) {
  const uint32_t off = (c & 63) * 2;
  return (c >> 6) * (R * 128) + r * 128 +
         ((((off >> 4) ^ (r & 7)) << 4) | (off & 15));
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// K-major operand: rows [r0, r0 + 64) (A) or [r0, r0 + N) (B) of an R-row,
// D-column tile, columns [16 kk, 16 kk + 16).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int kk) {
  using Sp = Span<D>;
  const int c0 = kk * 16;
  const uint32_t addr = smem_u32(tile) + (c0 / Sp::kCols) * (R * Sp::kBytes) +
                        r0 * Sp::kBytes + (c0 % Sp::kCols) * 2;
  return make_desc(addr, 16, 8 * Sp::kBytes, Sp::kMode);
}

// MN-major B operand (the transpose bit): rows [16 kk, 16 kk + 16) of an
// R-row, D-column tile as the contraction, its columns from n0 (a multiple
// of the span) as N. With D = 64 it is also the MN-major A operand (ss_t) of
// 64 columns as M.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk,
                                            int n0 = 0) {
  using Sp = Span<D>;
  const uint32_t addr = smem_u32(tile) + (n0 / Sp::kCols) * (R * Sp::kBytes) +
                        kk * 16 * Sp::kBytes;
  return make_desc(addr, R * Sp::kBytes, 8 * Sp::kBytes, Sp::kMode);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D[64 x 16] (+)= A[64 x 16] B[16 x 16], A in registers (the
  // accumulator layout of a 16-column slice, packed to bf16 pairs), B
  // MN-major in shared memory (the transpose bit).
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // D[64 x 16] (+)= A[64 x 16] B[16 x 16], A and B in shared memory, B
  // K-major (its rows are the N of the product).
  __device__ __forceinline__ static void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 16] (+)= A[64 x 16] B[16 x 16], A and B MN-major in shared
  // memory (both transpose bits: A stored [k][m], B stored [k][n]).
  __device__ __forceinline__ static void ss_t(float (&d)[8], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  // D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B in shared memory, B
  // K-major (its rows are the N of the product).
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 32] (+)= A[64 x 16] B[16 x 32], A in registers (the
  // accumulator layout of a 16-column slice, packed to bf16 pairs), B
  // MN-major in shared memory (the transpose bit).
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // As ss, with A and B MN-major (both transpose bits: A stored [k][m] as
  // the MN-major B is stored [k][n]).
  __device__ __forceinline__ static void ss_t(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15"
        "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  // D[64 x 48] (+)= A[64 x 16] B[16 x 48], A and B in shared memory, B
  // K-major (its rows are the N of the product).
  __device__ __forceinline__ static void ss(float (&d)[24], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, B
  // K-major (its rows are the N of the product).
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (the
  // accumulator layout of a 16-column slice, packed to bf16 pairs), B
  // MN-major in shared memory (the transpose bit).
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // As ss, with A and B MN-major (both transpose bits: A stored [k][m] as
  // the MN-major B is stored [k][n]).
  __device__ __forceinline__ static void ss_t(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  // D[64 x 80] (+)= A[64 x 16] B[16 x 80], A and B in shared memory, B
  // K-major (its rows are the N of the product).
  __device__ __forceinline__ static void ss(float (&d)[40], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  // D[64 x 96] (+)= A[64 x 16] B[16 x 96], A and B in shared memory, B
  // K-major (its rows are the N of the product).
  __device__ __forceinline__ static void ss(float (&d)[48], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
        "%42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory, B
  // K-major (its rows are the N of the product).
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers (the
  // accumulator layout of a 16-column slice, packed to bf16 pairs), B
  // MN-major in shared memory (the transpose bit).
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
  // As ss, with A and B MN-major (both transpose bits: A stored [k][m] as
  // the MN-major B is stored [k][n]).
  __device__ __forceinline__ static void ss_t(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// acc[64 x D] (+)= A[64 x 16] B[16 x D]: A in registers, B rows
// [16 kk, 16 kk + 16) of an R-row, D-column tile read MN-major (the
// transpose bit), as products of at most 128 columns (one for D in 16, 32,
// 64, 128; 64 + 16 at D = 80, 128 + 64 at 192, 128 + 128 at 256), each on
// its slice of the accumulator.
template <int D, int R, int N0 = 0>
__device__ __forceinline__ void rs_cols(float (&acc)[D / 2],
                                        const uint32_t (&a)[4],
                                        const bf16* tile, int kk) {
  constexpr int kRest = D - N0;
  constexpr int N = kRest >= 128 ? 128 : kRest >= 64 ? 64 : kRest >= 32 ? 32
                                                                        : 16;
  Wgmma<N>::rs(slice<N / 2>(acc, N0 / 2), a, desc_mn<D, R>(tile, kk, N0), 1);
  if constexpr (N0 + N < D) rs_cols<D, R, N0 + N>(acc, a, tile, kk);
}

// The A-operand registers of 16-column slice kc of an accumulator of
// wgmma.m64nNk16 (see the layout above), rounded to bf16.
template <int NACC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&acc)[NACC], int kc) {
  auto pk = [](float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  };
  a[0] = pk(acc[8 * kc + 0], acc[8 * kc + 1]);
  a[1] = pk(acc[8 * kc + 2], acc[8 * kc + 3]);
  a[2] = pk(acc[8 * kc + 4], acc[8 * kc + 5]);
  a[3] = pk(acc[8 * kc + 6], acc[8 * kc + 7]);
}

// --- host: tensor maps -------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 [rows, s, d] tensor (innermost first: d,
// s, rows) whose box is `cols` columns (Span<D>::kCols of the tile it
// fills; by default min(d, 64)) x box_rows rows of one head, swizzled by its
// row span. A box past S, or past d, is zero-filled and never reads the next
// head's rows or the next row's columns.
inline cudaError_t tensor_map_3d(CUtensorMap* map, const void* base,
                                 int64_t rows, int s, int d, int box_rows,
                                 int cols = 0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (cols == 0) cols = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps encoded earlier on this host thread, by tensor and shape, for the
// tile band's kernels and the wide flash blocks (tile_band_sm90.cuh,
// flash_wide.cuh): the allocator hands a training step the same buffers as
// the step before, so a call mostly finds its maps here instead of encoding
// them again (a map holds nothing but the address, the shape and the box).
// `box` is the box's rows (0 for the tile band's 4-D scratch map).
struct MapKey {
  const void* base;
  int64_t lines;
  int n, d, box;
  bool operator==(const MapKey& o) const {
    return base == o.base && lines == o.lines && n == o.n && d == o.d &&
           box == o.box;
  }
};

template <typename Encode>
inline cudaError_t cached_map(CUtensorMap* map, const MapKey& key,
                              Encode encode) {
  constexpr int kEntries = 64;
  struct Entry {
    MapKey key;
    CUtensorMap map;
  };
  thread_local Entry cache[kEntries] = {};
  thread_local int next = 0;
  for (const Entry& e : cache) {
    if (e.key == key) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = encode(map);
  if (err == cudaSuccess) {
    cache[next] = Entry{key, *map};
    next = (next + 1) % kEntries;
  }
  return err;
}

}  // namespace hopper

// Shared pieces of the attention kernels that do not run on wgmma: the
// tile band (mhla_tile_band_fwd.cu, mhla_tile_band_bwd.cu) and the f32
// parity kernels of the flash and fused short-S sources, and the constants
// and the backward's delta kernel that the wgmma kernels use too: the
// warp-level bf16 tensor-core product (mma.sync.m16n8k16, f32
// accumulation), ldmatrix fragment loads from shared-memory tiles, the f32
// tile loader, the delta kernel and the accumulator and row helpers.
//
// Fragment layout of mma.m16n8k16 for lane l, g = l / 4, t = l % 4:
//   A (16 x 16, row-major), 4 words of two bf16:
//     a0 = (row g,     cols 2t, 2t+1)      a1 = (row g + 8, cols 2t, 2t+1)
//     a2 = (row g,     cols 2t+8, 2t+9)    a3 = (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, "col"), 2 words: b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g)
//   C (16 x 8) f32: c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = (row g + 8, ...)
// so two neighbouring C tiles (16 columns) repack, in registers, into the A
// fragment of the next product: the softmax weights never touch memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Tile rows are padded by 8 bf16 (16 bytes): row starts then fall on all
// eight 16-byte bank groups in turn and ldmatrix reads without conflicts.
constexpr int kPad = 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats to one word of two bf16, `lo` in the low half (round to
// nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A shared-memory tile of bf16 rows, LD = D + kPad elements a row.
//
// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(a, tile + (r0 + (mi & 1) * 8 + (lane & 7)) * LD + c0 + (mi >> 1) * 8);
}

// B fragments with B[k][n] = tile[n0 + n][k0 + k] (the product contracts
// over the tile's columns): b[0], b[1] for columns n0..n0+7 of the result,
// b[2], b[3] for n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int n0,
                                       int k0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(b, tile + (n0 + (mi >> 1) * 8 + (lane & 7)) * LD + k0 + (mi & 1) * 8);
}

// B fragments with B[k][n] = tile[k0 + k][n0 + n] (the product contracts
// over the tile's rows), read transposed: b[0], b[1] for n0..n0+7, b[2],
// b[3] for n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* tile,
                                             int k0, int n0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_trans(
      b, tile + (k0 + (mi & 1) * 8 + (lane & 7)) * LD + n0 + (mi >> 1) * 8);
}

// Copy rows [row0, row0 + ROWS) of a contiguous [s, D] float matrix into
// an unpadded float tile, 16 bytes a thread and step; rows at or past s
// become zeros.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* src,
                                              int row0, int s, int tid) {
  constexpr int kVecs = D / 4;
  for (int idx = tid; idx < ROWS * kVecs; idx += THREADS) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) {
      val = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<float4*>(tile + r * D + c) = val;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta_i = sum_c g_ic out_ic for every query row of [n, D] `out` and `g`:
// the first kernel of a backward, a thread per row. `Caller` is one of the
// tags below and changes nothing but the kernel's name, so that a profile
// books the time under the op that launched it.
constexpr int kDeltaThreads = 128;
struct for_flash_bwd {};
struct for_fused_bwd {};

template <typename T, int D, typename Caller>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_delta(const T* __restrict__ out, const T* __restrict__ g,
                float* __restrict__ delta, int64_t n) {
  const int64_t i =
      blockIdx.x * static_cast<int64_t>(kDeltaThreads) + threadIdx.x;
  if (i >= n) return;
  constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  const T* orow = out + i * D;
  const T* grow = g + i * D;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += kVec) {
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += to_f32(oe[e]) * to_f32(ge[e]);
  }
  delta[i] = sum;
}

template <typename T, int D, typename Caller>
cudaError_t launch_delta(const void* out, const void* g, void* delta,
                         int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kDeltaThreads - 1) / kDeltaThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  flash_delta<T, D, Caller>
      <<<static_cast<unsigned>(blocks), kDeltaThreads, 0, stream>>>(
          static_cast<const T*>(out), static_cast<const T*>(g),
          static_cast<float*>(delta), n);
  return cudaGetLastError();
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[a][r] = 0.f;
  }
}

// Rows g and g + 8 of a warp's 16 x D accumulator to a [s, D] bf16 matrix.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[D / 8][4],
                                           int r0, int s, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + g + 8 * h;
    if (i >= s) continue;
    __nv_bfloat16* row = dst + static_cast<int64_t>(i) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// One row of D floats into registers (zeros when `real` is false), and back.
template <int D>
__device__ __forceinline__ void load_row(float (&x)[D], const float* src,
                                         bool real) {
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (real) val = *reinterpret_cast<const float4*>(src + c);
    x[c] = val.x, x[c + 1] = val.y, x[c + 2] = val.z, x[c + 3] = val.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[D]) {
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    *reinterpret_cast<float4*>(dst + c) =
        make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  }
}

}  // namespace flash

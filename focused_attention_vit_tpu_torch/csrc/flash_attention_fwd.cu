// Dense (non-causal) flash attention, forward, for Hopper (sm_90a).
//
// Replaces: focused_attention_vit_tpu/ops/flash_attention_pallas.py
// ::flash_attention_tpu (:28, the wrapper; :73, the call into JAX's bundled
// Pallas flash kernel), forward. Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/flash_attention.py.
//
// What it computes, for each (b*h) row of contiguous [B*h, S, d] q, k, v:
//   out_i = sum_j softmax_j(q_i . k_j * d^-1/2) v_j  over the S real keys,
// by the online-softmax recurrence over key tiles: f32 logits, a running
// maximum m, a running sum l and an f32 accumulator per query, one rounding
// to the input dtype at the end. The training instantiation also writes
// lse_i = m_i + log l_i (f32 [B*h, S]) for the backward
// (flash_attention_bwd.cu); the eval instantiation writes none and is
// otherwise the same code, so the two outputs agree bit for bit. The key
// length is an argument: keys at or past S in the last tile get a logit of
// -inf, so there are no padded copies of q, k, v and no segment ids (the TPU
// wrapper pads S to 512 and masks by segment id because Mosaic's blocks
// must divide the arrays). Query rows at or past S are never written.
//
// What bounds it on this card: operations. A call does 4*B*h*S^2*d flops
// (0.97 TFLOP at B*h=384, S=3137, d=64: 0.98 ms at the 989 TFLOP/s bf16
// peak) and must move only q, k, v and out once (617 MB, 0.18 ms at
// 3.35 TB/s); its B*h*S^2 exponentials (3.8e9) take about as long again on
// the special-function units. So the bf16 kernel is built around the
// tensor cores' asynchronous warpgroup products and keeps the exponentials
// beside them:
//   - a block owns 128 queries: two consumer warpgroups of 64 queries and
//     one producer warp;
//   - the producer brings the Q tile once and then K and V tiles of 128
//     keys (64 at d = 128) by TMA into a ring of 3 stages, each with a
//     "full" mbarrier per tensor (completed by the copy's bytes) and a
//     "free" mbarrier (completed by the 8 consumer warps); TMA's 3-D maps
//     over [B*h, S, d] zero-fill a tile past S without reading the next
//     head, and swizzle rows so that wgmma reads without bank conflicts;
//   - S = Q K^T is a wgmma with both operands in shared memory and f32
//     accumulators; the softmax runs on those registers (row statistics
//     reduced over the 4 lanes that share a row); P is rounded to bf16 in
//     registers and is the register A operand of O += P V, whose B operand
//     V is read through the transpose bit, so it stays [keys, d];
//   - each warpgroup issues the next tile's Q K^T together with the current
//     tile's P V and runs the softmax of the next tile while P V is still in
//     flight, and the two warpgroups take turns at issuing (named
//     barriers), so that one's exponentials run under the other's products.
//     The A operand and the accumulators are written only while no product
//     is in flight: ptxas serializes every product of a pipeline stage in
//     which other instructions write their registers.
// P is rounded to bf16 for the second product (the tensor cores take bf16),
// while l sums the unrounded f32 weights; the plain version keeps P in f32.
// The difference is a sum of S independent roundings of relative size 2^-9,
// far below one bf16 ulp of a typical output.
//
// f32 tensors, at every head dim, take flash_f32.cuh's scalar kernels (full
// f32 products, for parity runs and small shapes).
//
// Head dims. The bf16 kernels take every d that is a multiple of 8 (the
// TMA row stride, d * 2 bytes, must be a multiple of 16 bytes; the wrapper
// pads other head dims with zero columns). Up to 256 they are built for a
// few tile widths D (16, 32, 64, 80, 128, 192, 256) and a call takes the
// narrowest D >= d: the tensor maps' box reaches past column d and TMA
// zero-fills it, so Q K^T sums zeros past d (wgmma's k is 16 columns) and
// P V's columns past d are never stored. The scale is the caller's
// d^-1/2. D = 80 (ViT-H/14's head dim) is stored in 16-column,
// 32-byte-swizzled blocks and its P V runs as products of 64 and 16
// columns; D = 192 and 256 in 64-column blocks with products of 128 and
// 64 or 128, and key tiles of 64 and 32. Past 256 the forward runs
// flash_wide.cuh's block: two consumer warpgroups split the logits over d
// and swap their partials, then each adds P V over its share of an output
// slice of up to 512 columns (slices over the grid's y, the plan's
// arguments `slices` and `tiles`), wgmma on a TMA ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_fwd_block.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

using flash_fwd::Fwd;
using flash_fwd::kBM;
using flash_fwd::kThreads;

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ out, float* __restrict__ lse, int s,
                    int tiles_per_row, float scale_log2, int d) {
  flash_fwd::block<D, kLse>(tq, tk, tv, out, lse, s, tiles_per_row,
                            scale_log2, flash_fwd::NoMask{}, d);
}

// Past d = 256: flash_wide.cuh's forward block, NT output tiles of 64
// columns a warpgroup (the fourth map is unused).
template <int NT, bool kLse>
__global__ void __launch_bounds__(flash_wide::kThreads, 1)
    flash_fwd_wide(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap, flash_wide::Geom g,
                   flash_wide::Io io, flash_fwd::NoMask mask) {
  const flash_wide::Maps m{&tq, &tk, &tv};
  flash_wide::block<flash_wide::kFwd, NT, kLse>(m, m, g, io, mask);
}

template <bool kLse>
auto wide_kernel(int tiles) {
  return tiles == 2   ? &flash_fwd_wide<2, kLse>
         : tiles == 3 ? &flash_fwd_wide<3, kLse>
                      : &flash_fwd_wide<4, kLse>;
}

// The plan's `slices` slices of `tiles` 64-column tiles a warpgroup
// (ops/flash_attention.py wide_plan).
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, float* lse, int64_t rows, int s, int d,
                        float scale, int slices, int tiles,
                        cudaStream_t stream) {
  const flash_wide::Io io{static_cast<bf16*>(out), nullptr, lse, nullptr,
                          scale, scale * flash::kLog2e};
  return flash_wide::launch(
      lse != nullptr ? wide_kernel<true>(tiles) : wide_kernel<false>(tiles),
      flash_wide::kFwd, tiles, q, k, v, v, rows, s, d, slices, io,
      flash_fwd::NoMask{}, stream);
}

template <int D, bool kLse>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int64_t rows, int s, int d,
                         float scale, cudaStream_t stream) {
  using C = Fwd<D>;
  constexpr int kCols = hp::Span<D>::kCols;
  const int tiles = (s + kBM - 1) / kBM;
  const int64_t blocks = rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hp::tensor_map_3d(&tq, q, rows, s, d, kBM, kCols);
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tk, k, rows, s, d, C::kBN, kCols);
  }
  if (err == cudaSuccess) {
    err = hp::tensor_map_3d(&tv, v, rows, s, d, C::kBN, kCols);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma<D, kLse>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, s, tiles,
      scale * flash::kLog2e, d);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int64_t rows, int s, int d, float scale,
                     cudaStream_t stream) {
  return lse != nullptr
             ? launch_wgmma<D, true>(q, k, v, out, lse, rows, s, d, scale,
                                     stream)
             : launch_wgmma<D, false>(q, k, v, out, lse, rows, s, d, scale,
                                      stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 on success). q, k, v and out are device pointers to contiguous
// [rows, s, d] tensors of one dtype (is_bf16 = 1 for bf16, 0 for f32; d a
// multiple of 8), 16-byte aligned; `lse` is a contiguous f32
// [rows, s] tensor to receive the log-sum-exp of each query's scaled
// logits, or null for the eval kernel. `stream` is the caller's
// cudaStream_t. The kernel allocates nothing and does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   long long rows, int s, int d, int is_bf16,
                                   float scale, int device, void* stream,
                                   int slices, int tiles) {
  if (rows <= 0 || s < 1 || d < 8 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (!is_bf16) {
    return static_cast<int>(flash_f32::launch_fwd(
        q, k, v, out, lp, rows, s, d, scale, flash_f32::Drop{0, 0, 1.f, 0},
        st));
  }
  if (flash_wide::takes(d)) {
    return static_cast<int>(launch_wide(q, k, v, out, lp, rows, s, d, scale,
                                        slices, tiles, st));
  }
  switch (flash::tile_width(d)) {
    case 16:
      err = launch_d<16>(q, k, v, out, lp, rows, s, d, scale, st);
      break;
    case 32:
      err = launch_d<32>(q, k, v, out, lp, rows, s, d, scale, st);
      break;
    case 64:
      err = launch_d<64>(q, k, v, out, lp, rows, s, d, scale, st);
      break;
    case 80:
      err = launch_d<80>(q, k, v, out, lp, rows, s, d, scale, st);
      break;
    case 128:
      err = launch_d<128>(q, k, v, out, lp, rows, s, d, scale, st);
      break;
    case 192:
      err = launch_d<192>(q, k, v, out, lp, rows, s, d, scale, st);
      break;
    case 256:
      err = launch_d<256>(q, k, v, out, lp, rows, s, d, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory, in bytes, that the bf16 kernel at head dim d
// is launched with (0 for a head dim it does not take); past 256, at
// `tiles` output tiles a warpgroup.
extern "C" int flash_attention_fwd_smem(int d, int tiles) {
  if (flash_wide::takes(d)) {
    return flash_wide::smem_of(flash_wide::kFwd, d, tiles);
  }
  switch (flash::tile_width(d)) {
    case 16:
      return Fwd<16>::kSmem;
    case 32:
      return Fwd<32>::kSmem;
    case 64:
      return Fwd<64>::kSmem;
    case 80:
      return Fwd<80>::kSmem;
    case 128:
      return Fwd<128>::kSmem;
    case 192:
      return Fwd<192>::kSmem;
    case 256:
      return Fwd<256>::kSmem;
    default:
      return 0;
  }
}

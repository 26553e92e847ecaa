// Dense (non-causal) flash attention, backward, for Hopper (sm_90a).
//
// Replaces: the custom-VJP backward of JAX's bundled Pallas flash kernel
// (its dkv and dq kernels), reached through
// focused_attention_vit_tpu/ops/flash_attention_pallas.py::flash_attention_tpu
// (:28, call at :73). Wrapper and plain PyTorch versions:
// focused_attention_vit_tpu_torch/ops/flash_attention.py.
//
// What it computes, from q, k, v, the forward's out and lse (f32 [B*h, S])
// and the cotangent g of out, all contiguous [B*h, S, d]:
//   p_ij  = exp(q_i . k_j * scale - lse_i)         (the softmax, recomputed)
//   delta_i = sum_c g_ic out_ic
//   dv_j  = sum_i p_ij g_i
//   dp_ij = g_i . v_j,  ds_ij = p_ij (dp_ij - delta_i) scale
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// with f32 sums, rounded once to the input dtype. Nothing of size S x S is
// stored; only q, k, v, out and lse were saved.
//
// Three kernels, launched in order on one stream:
//   1. delta: a thread per query row (flash_common.cuh);
//   2. dkv: a block owns a tile of keys and loops over the query tiles;
//   3. dq: a block owns a tile of queries and loops over the key tiles.
// The TPU kernels carry the dk/dv (and dq) sums in scratch memory across a
// sequential grid. Blocks on this card run in parallel in no order, so the
// sum over the other axis is a loop inside the block, and each of dq, dk,
// dv is written by exactly one thread: no atomics, and the result is the
// same from run to run. The price is that the logits and dp are computed
// twice (7 matrix products instead of 5) and so are the exponentials.
//
// What bounds it on this card: operations. The function needs
// 10*B*h*S^2*d flops (2.4 TFLOP at B*h=384, S=3137, d=64: 2.4 ms at the
// 989 TFLOP/s bf16 peak) against 1.4 GB of q, k, v, out, g, dq, dk, dv
// (0.4 ms at 3.35 TB/s); the deterministic design does 7/5 of those
// products (3.4 ms) and 2 B*h*S^2 exponentials. So the bf16 kernels run
// every product as an asynchronous warpgroup product (wgmma, f32
// accumulators). Each block is two consumer warpgroups of 64 rows and a
// producer warpgroup, one warp of which brings tiles by TMA (3-D maps over
// [B*h, S, d]: a tile past S is zero-filled and never reads the next head)
// into a ring of 3 stages with "full" and "free" mbarriers; the
// producer keeps 24 registers a thread and the consumers take 240
// (setmaxnreg), which holds the d = 64 kernels free of spills:
//   - dkv: a block keeps 128 keys (K and V tiles, loaded once) and streams
//     Q and g tiles of 64 queries (32 at d = 128) with their lse and delta,
//     which the producer warp writes beside them. S^T = K Q^T and dP^T = V g^T are wgmmas with both
//     operands in shared memory; p^T and ds^T stay in registers, rounded to
//     bf16, as the register A operands of dv += P^T g and dk += dS^T Q,
//     whose B operands are read through the transpose bit. A query past S
//     arrives as zeros with lse = +inf, so its p and ds are 0. Each
//     warpgroup runs products, then exponentials, then products; the two
//     warpgroups overlap each other freely;
//   - dq: a block keeps 128 queries (Q and g tiles, loaded once) and streams
//     K and V tiles of 64 keys; S = Q K^T and dP = g V^T from shared memory,
//     ds in registers as the A operand of dq += dS K. Keys past S are masked
//     on the last tile. The two warpgroups take turns at the tensor cores:
//     a turn issues one tile's dq product and the next tile's S and dP, so
//     that one warpgroup's exponentials run under the other's products.
// Every wgmma's registers are written only while no product is in flight
// (ptxas serializes the products of a pipeline stage otherwise).
// p and ds are rounded to bf16 for the second products; the plain version
// keeps them in f32.
//
// f32 tensors, at every head dim, take flash_f32.cuh's scalar kernels (full
// f32 products, for parity runs and small shapes), after the same delta.
//
// Head dims: as the forward (flash_attention_fwd.cu), every multiple of 8;
// up to 256 run at the narrowest tile width D of 16, 32, 64, 80, 128, 192 and
// 256 that holds it, zeros past d in every staged tile. Past D = 128 the dkv
// kernel's two 64 x D accumulators would not fit the registers, so it runs
// twice, once for dk and once for dv, each recomputing S^T and dP^T; the dq
// kernel streams 32-key tiles there. Past 256 the dkv and dq kernels are
// flash_wide.cuh's blocks, after the same delta: dkv in slices of up to 256
// columns of dk and dv (one warpgroup forms S^T over d and adds dv, the
// other dP^T and dk), dq in slices of up to 512 columns (S and dP over d,
// one warpgroup each, swapped; each adds its share of dq).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_bwd_blocks.cuh"
#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "flash_wide.cuh"
#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

using flash_bwd::Dkv;
using flash_bwd::Dq;
using flash_bwd::kMmaThreads;
using flash_bwd::kOwn;

template <int D, int kPart>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tg,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int s, int tiles_per_row,
                        float scale, float scale_log2, int d) {
  flash_bwd::dkv_block<D, flash_bwd::NoMask, kPart>(
      tq, tk, tv, tg, lse, delta, dk, dv, s, tiles_per_row, scale, scale_log2,
      flash_bwd::NoMask{}, d);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tg,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int s, int tiles_per_row, float scale,
                       float scale_log2, int d) {
  flash_bwd::dq_block<D>(tq, tk, tv, tg, lse, delta, dq, s, tiles_per_row,
                         scale, scale_log2, flash_bwd::NoMask{}, d);
}

struct Args {
  const void *q, *k, *v, *out, *lse, *g;
  void *dq, *dk, *dv, *delta;
  int64_t rows;
  int s, d;
  float scale;
  cudaStream_t stream;
};

// Past d = 256: flash_wide.cuh's dkv and dq blocks, NT output tiles of 64
// columns a warpgroup.
template <int NT>
__global__ void __launch_bounds__(flash_wide::kThreads, 1)
    flash_bwd_dkv_wide(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tg,
                       flash_wide::Geom g, flash_wide::Io io,
                       flash_bwd::NoMask mask) {
  const flash_wide::Maps m0{&tk, &tq, &tg}, m1{&tv, &tg, &tq};
  flash_wide::block<flash_wide::kDkv, NT, false>(m0, m1, g, io, mask);
}

template <int NT>
__global__ void __launch_bounds__(flash_wide::kThreads, 1)
    flash_bwd_dq_wide(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg,
                      flash_wide::Geom g, flash_wide::Io io,
                      flash_bwd::NoMask mask) {
  const flash_wide::Maps m0{&tq, &tk, &tk}, m1{&tg, &tv, &tk};
  flash_wide::block<flash_wide::kDq, NT, false>(m0, m1, g, io, mask);
}

template <int KIND>
auto wide_kernel(int tiles) {
  if constexpr (KIND == flash_wide::kDkv) {
    return tiles == 2   ? &flash_bwd_dkv_wide<2>
           : tiles == 3 ? &flash_bwd_dkv_wide<3>
                        : &flash_bwd_dkv_wide<4>;
  } else {
    return tiles == 2   ? &flash_bwd_dq_wide<2>
           : tiles == 3 ? &flash_bwd_dq_wide<3>
                        : &flash_bwd_dq_wide<4>;
  }
}

// Past d = 256: the delta kernel, then the dkv and dq kernels at the
// plan's slices and tiles (ops/flash_attention.py wide_plan).
cudaError_t launch_wide(const Args& a, const int (&plan)[4]) {
  namespace fw = flash_wide;
  if (!fw::plan_ok(fw::kDkv, a.d, plan[0], plan[1]) ||
      !fw::plan_ok(fw::kDq, a.d, plan[2], plan[3])) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = flash::launch_delta<bf16, flash::for_flash_bwd>(
      a.out, a.g, a.delta, a.rows * a.s, a.d, a.stream);
  if (err != cudaSuccess) return err;
  float* lse = const_cast<float*>(static_cast<const float*>(a.lse));
  const float* delta = static_cast<const float*>(a.delta);
  const float scale_log2 = a.scale * flash::kLog2e;
  const fw::Io dkv{static_cast<bf16*>(a.dv), static_cast<bf16*>(a.dk), lse,
                   delta, a.scale, scale_log2};
  err = fw::launch(wide_kernel<fw::kDkv>(plan[1]), fw::kDkv, plan[1], a.q,
                   a.k, a.v, a.g, a.rows, a.s, a.d, plan[0], dkv,
                   flash_bwd::NoMask{}, a.stream);
  if (err != cudaSuccess) return err;
  const fw::Io dq{static_cast<bf16*>(a.dq), nullptr, lse, delta, a.scale,
                  scale_log2};
  return fw::launch(wide_kernel<fw::kDq>(plan[3]), fw::kDq, plan[3], a.q,
                    a.k, a.v, a.g, a.rows, a.s, a.d, plan[2], dq,
                    flash_bwd::NoMask{}, a.stream);
}

template <int D, int kPart>
cudaError_t launch_dkv(const Args& a, const CUtensorMap& q_str,
                       const CUtensorMap& k_own, const CUtensorMap& v_own,
                       const CUtensorMap& g_str, dim3 grid, int tiles) {
  auto dkv = flash_bwd_dkv_wgmma<D, kPart>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv<D>::kSmem);
  if (err != cudaSuccess) return err;
  dkv<<<grid, kMmaThreads, Dkv<D>::kSmem, a.stream>>>(
      q_str, k_own, v_own, g_str, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.s, tiles, a.scale, a.scale * flash::kLog2e,
      a.d);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  constexpr int kCols = hp::Span<D>::kCols;
  const int tiles = (a.s + kOwn - 1) / kOwn;
  const int64_t blocks = a.rows * tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  // Boxes of kOwn rows for the tiles a block keeps, of the staged tile's
  // rows for the ones it streams.
  CUtensorMap q_own, g_own, k_own, v_own, q_str, g_str, k_str, v_str;
  cudaError_t err = cudaSuccess;
  const struct {
    CUtensorMap* map;
    const void* base;
    int box;
  } maps[8] = {{&q_own, a.q, kOwn},         {&g_own, a.g, kOwn},
               {&k_own, a.k, kOwn},         {&v_own, a.v, kOwn},
               {&q_str, a.q, Dkv<D>::kBQ},  {&g_str, a.g, Dkv<D>::kBQ},
               {&k_str, a.k, Dq<D>::kBN},   {&v_str, a.v, Dq<D>::kBN}};
  for (const auto& m : maps) {
    if (err == cudaSuccess) {
      err = hp::tensor_map_3d(m.map, m.base, a.rows, a.s, a.d, m.box, kCols);
    }
  }
  if (err != cudaSuccess) return err;
  err = flash::launch_delta<bf16, flash::for_flash_bwd>(
      a.out, a.g, a.delta, a.rows * a.s, a.d, a.stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks));

  if constexpr (D <= 128) {
    err = launch_dkv<D, flash_bwd::kBoth>(a, q_str, k_own, v_own, g_str, grid,
                                          tiles);
  } else {
    err = launch_dkv<D, flash_bwd::kDkOnly>(a, q_str, k_own, v_own, g_str,
                                            grid, tiles);
    if (err == cudaSuccess) {
      err = launch_dkv<D, flash_bwd::kDvOnly>(a, q_str, k_own, v_own, g_str,
                                              grid, tiles);
    }
  }
  if (err != cudaSuccess) return err;

  auto dq = flash_bwd_dq_wgmma<D>;
  err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<D>::kSmem);
  if (err != cudaSuccess) return err;
  dq<<<grid, kMmaThreads, Dq<D>::kSmem, a.stream>>>(
      q_own, k_str, v_str, g_own, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.s,
      tiles, a.scale, a.scale * flash::kLog2e, a.d);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// first launch that failed (0 on success). q, k, v, out, g and dq, dk, dv
// are device pointers to contiguous [rows, s, d] tensors of one dtype
// (is_bf16 = 1 for bf16, 0 for f32; d a multiple of 8), 16-byte aligned;
// `lse` is the
// forward's f32 [rows, s]; `delta` is f32 [rows, s] scratch that the first
// kernel fills. `stream` is the caller's cudaStream_t. The kernels allocate
// nothing and do not synchronise.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* lse, const void* g, void* dq,
                                   void* dk, void* dv, void* delta,
                                   long long rows, int s, int d, int is_bf16,
                                   float scale, int device, void* stream,
                                   int kv_slices, int kv_tiles, int q_slices,
                                   int q_tiles) {
  if (rows <= 0 || s < 1 || d < 8 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q,    k,    v, out, lse,   g,
               dq,   dk,   dv, delta, rows, s,
               d,    scale, static_cast<cudaStream_t>(stream)};
  if (!is_bf16) {
    return static_cast<int>(flash_f32::launch_bwd<flash::for_flash_bwd>(
        q, k, v, out, g, lse, delta, dq, dk, dv, rows, s, d, scale,
        flash_f32::Drop{0, 0, 1.f, 0}, a.stream));
  }
  if (flash_wide::takes(d)) {
    const int plan[4] = {kv_slices, kv_tiles, q_slices, q_tiles};
    return static_cast<int>(launch_wide(a, plan));
  }
  switch (flash::tile_width(d)) {
    case 16:
      err = launch_wgmma<16>(a);
      break;
    case 32:
      err = launch_wgmma<32>(a);
      break;
    case 64:
      err = launch_wgmma<64>(a);
      break;
    case 80:
      err = launch_wgmma<80>(a);
      break;
    case 128:
      err = launch_wgmma<128>(a);
      break;
    case 192:
      err = launch_wgmma<192>(a);
      break;
    case 256:
      err = launch_wgmma<256>(a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory, in bytes, that the bf16 dkv (kernel = 0) or dq
// (kernel = 1) kernel at head dim d is launched with (0 for a head dim it
// does not take); past 256, at `tiles` output tiles a warpgroup.
extern "C" int flash_attention_bwd_smem(int d, int kernel, int tiles) {
  if (flash_wide::takes(d)) {
    return flash_wide::smem_of(
        kernel == 0 ? flash_wide::kDkv : flash_wide::kDq, d, tiles);
  }
  switch (flash::tile_width(d)) {
    case 16:
      return kernel == 0 ? Dkv<16>::kSmem : Dq<16>::kSmem;
    case 32:
      return kernel == 0 ? Dkv<32>::kSmem : Dq<32>::kSmem;
    case 64:
      return kernel == 0 ? Dkv<64>::kSmem : Dq<64>::kSmem;
    case 80:
      return kernel == 0 ? Dkv<80>::kSmem : Dq<80>::kSmem;
    case 128:
      return kernel == 0 ? Dkv<128>::kSmem : Dq<128>::kSmem;
    case 192:
      return kernel == 0 ? Dkv<192>::kSmem : Dq<192>::kSmem;
    case 256:
      return kernel == 0 ? Dkv<256>::kSmem : Dq<256>::kSmem;
    default:
      return 0;
  }
}

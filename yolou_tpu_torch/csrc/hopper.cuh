// Hopper (sm_90a) building blocks of the streamed band attention kernels
// (band_attention.cu) and the a2c2f kernels: tensor maps of the Tensor
// Memory Accelerator (TMA), encoded on the host (`head_map`: a head padded
// with zero channels by TMA itself); mbarriers and TMA tile loads; the
// wgmma matrix descriptor and warpgroup products; named barriers and
// register reallocation between warpgroups; the wgmma attention's row
// reductions and online-softmax step; the per-tile steps of the blocked
// forms (heads wider than 64); distributed shared memory and the barrier
// of a thread-block cluster.
//
// Shared-memory tiles. A band's rows of one head are 32 or 64 channels. f32
// tiles are blocks of 32 channels (128-byte rows; a 64-wide head is two
// blocks, one box each); bf16 rows are the whole head, 64 bytes at width 32
// and 128 at width 64. TMA writes them swizzled, the 16-byte chunk c of row
// r at chunk c ^ (r % 8) (128-byte swizzle: f32, and bf16 at width 64) or c
// ^ ((r / 2) % 4) (64-byte swizzle, bf16 at width 32): `kv_at`'s layouts.
// The pattern is a function of the shared-memory address bits, so every
// tile starts on a 1024-byte boundary and the wgmma descriptors (of the
// tile's swizzle) read what TMA wrote.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_attention.cuh"

namespace yolou {

constexpr float LOG2E = 1.4426950408889634f;

// Element offset of channel 8 * chunk (+ 0..7) of row `row` of a bf16
// head-wide tile W channels wide, as TMA writes it: at 32 (64-byte rows,
// the 64-byte swizzle) chunk c at c ^ ((row / 2) % 4), at 64 (128-byte
// rows, the 128-byte swizzle) at c ^ (row % 8).
template <int W = HD>
__device__ __forceinline__ int kv_at(int row, int chunk) {
  if constexpr (W == 64) return row * 64 + ((chunk ^ (row & 7)) << 3);
  else return row * HD + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// Two f32 values rounded to bf16 and packed, the first in the low half (the
// lower column index of a wgmma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The maximum and sum over the four threads of a quad (a fragment row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled is a driver function; the kernels' library links
// only the runtime and reaches it through the driver entry point.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The swizzle of a box whose rows are `bytes` long (64 or 128).
inline CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// A map of a (G, N, C) tensor as three dimensions (C, N, G), boxes of
// `cols` channels (32 in f32; the head width, 32 or 64, in bf16) x `rows`
// tokens of one band: a box that reaches past token N is zero-filled there
// and never reads the next band. With `bands` > 1 a box spans that many
// whole bands (rows = N): it lands as their rows one after the other, and
// bands past G read zero. Boxes of 128-byte rows take the 128-byte
// swizzle, of 64-byte rows the 64-byte one. Fails (cudaErrorInvalidValue,
// cudaErrorNotSupported without the driver function) rather than launch.
inline cudaError_t band_map(CUtensorMap* map, const void* ptr, int G, int N,
                            int C, int rows, bool f32, int cols = 32,
                            int bands = 1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elt = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)G};
  const cuuint64_t strides[2] = {C * elt, (cuuint64_t)N * C * elt};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows,
                             (cuuint32_t)bands};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(cols * (int)elt),
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map of a (G, N, heads * hd) tensor as four dimensions (hd, heads, N,
// G): boxes of `cols` channels x one head x `rows` tokens x `bands` bands,
// swizzled as `band_map`'s (its rows are `cols` channels long). A box may
// be wider than the head, or start past it: TMA fills every channel past
// hd with zeros, so a head of hd channels lands as a kernel width's (32,
// 64 or a 64-channel block) with zero channels after it, and no padded
// copy of the tensor is made. The rows of hd channels must be a multiple
// of 16 bytes (TMA's stride rule). Fails as `band_map` does.
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int G, int N,
                            int heads, int hd, int rows, bool f32, int cols,
                            int bands = 1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elt = f32 ? 4 : 2, C = (cuuint64_t)heads * hd;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)N, (cuuint64_t)G};
  const cuuint64_t strides[3] = {hd * elt, C * elt, (cuuint64_t)N * C * elt};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows,
                             (cuuint32_t)bands};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(cols * (int)elt),
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel width that holds a head of hd channels padded inside the
// kernel: 32, 64, or past 64 the next multiple of 64.
__host__ __device__ constexpr int padded_width(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : (hd + 63) / 64 * 64;
}

// Whether kernel C takes heads of hd channels padded inside the kernel (a
// width no kernel is built for, whose rows TMA can address); `kernels/
// attention.py::in_kernel_pad` mirrors it.
inline bool pads_in_kernel(int hd, bool f32) {
  return hd > 0 && hd != 32 && hd != 64 && hd % 64 != 0 &&
         hd * (f32 ? 4 : 2) % 16 == 0;
}

// A map of a (C, 3C) weight, boxes of 32 input rows x `cols` columns (32 in
// f32, the head width in bf16), swizzled as `band_map`'s.
inline cudaError_t weight_map(CUtensorMap* map, const void* ptr, int C,
                              bool f32, int cols = 32) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {3 * (cuuint64_t)C, (cuuint64_t)C};
  const cuuint64_t strides[1] = {3 * (cuuint64_t)C * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, 32};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(cols * (f32 ? 4 : 2)),
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lets `kernel` use all the dynamic shared memory a block may have (once).
template <auto kernel>
cudaError_t allow_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  return e;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = shared_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(shared_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// TMA unit; a __syncthreads() follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(shared_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(shared_addr(bar)) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity` (the
// k-th completion has parity k % 2).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(shared_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Box (c0, c1, c2) of a 3-D map into shared memory at dst; completion is
// reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(shared_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(shared_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(shared_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(shared_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Box of channels ch .. of head h, rows from `row` of band g: a 3-D map's
// (`band_map`) at channel h * hstride + ch, or with PAD a 4-D map's
// (`head_map`) at (ch, h).
template <bool PAD>
__device__ __forceinline__ void tma_load_head(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int h,
                                              int hstride, int ch, int row,
                                              int g) {
  if constexpr (PAD) tma_load_4d(dst, map, bar, ch, h, row, g);
  else tma_load_3d(dst, map, bar, h * hstride + ch, row, g);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(shared_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(shared_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Element offset of channels 4 * chunk .. + 3 of row `row` of a 128-byte-
// swizzled f32 tile of HD_ channels (TMA's layout): HD_ / 32 blocks of
// `rows` rows x 32 channels, one box each.
template <int HD_>
__device__ __forceinline__ int f32_at(int row, int chunk, int rows) {
  if constexpr (HD_ == 32) return row * 32 + ((chunk ^ (row & 7)) << 2);
  else
    return (chunk >> 3) * rows * 32 + row * 32 +
           (((chunk & 7) ^ (row & 7)) << 2);
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// A map of a row-major (rows, cols) f32 matrix (row stride `ld` elements),
// boxes of `box_cols` columns (a multiple of 4, at most 256) x `box_rows`
// rows, unswizzled: a box lands as a dense [box_rows][box_cols] tile;
// columns and rows past the matrix read zero. With `bf16` the matrix is
// bfloat16 and a box of 64 columns (128-byte rows) takes the 128-byte
// swizzle, as `band_map`'s: a wgmma operand tile (`smem_desc_sw128`).
inline cudaError_t matrix_map(CUtensorMap* map, const void* ptr, long rows,
                              int cols, int ld, int box_rows,
                              int box_cols = 32, bool bf16 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      bf16 ? swizzle_of(box_cols * 2) : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands written by threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (0 is __syncthreads): `count` threads, a multiple of 32.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

template <int REGS>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

// wgmma matrix descriptor of a 64-byte-swizzled bf16 tile at p (rows of 64
// bytes, 8-row groups 512 bytes apart): start address, leading and stride
// byte offsets in 16-byte units, layout 2 = 64-byte swizzle. K-major
// operands (q, k, x: the reduction runs along a row) ignore the leading
// offset; MN-major ones (v, the q weight columns: the reduction runs down
// the rows) of 32 columns have one swizzle atom across, so the leading
// offset is never used either; both offsets are given the group stride.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((shared_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(512 >> 4) << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// The same for a 128-byte-swizzled bf16 tile (rows of 128 bytes, 8-row
// groups 1024 bytes apart; layout 1): the tiles of a 64-wide head. A
// K-major operand steps 16 channels by adding 2 (32 bytes) to the start
// address within the swizzle atom; an MN-major one of 64 columns is one
// atom across.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return (uint64_t)((shared_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// The descriptor of a head-wide bf16 tile of head width HD (32: 64-byte
// swizzle, 64: 128-byte).
template <int HD>
__device__ __forceinline__ uint64_t head_desc(const void* p) {
  if constexpr (HD == 64) return smem_desc_sw128(p);
  else return smem_desc(p);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a register an
// asynchronous wgmma reads or writes across this point.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// d (64 x 128, f32) = a . b (+ d if accumulate): a 64 x 16 bf16 K-major
// from shared memory, b 16 x 128 K-major (128 rows of 16 channels) from
// shared memory.
__device__ __forceinline__ void wgmma_64x128_ss(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) += a . b: a 64 x 16 bf16 from registers (per warp its
// 16 rows: rows g, g + 8, channels 2 t .., 2 t + 8 .. of lane 4 g + t),
// b 16 x 32 MN-major (16 rows of 32 columns, the transpose bit) from shared
// memory.
__device__ __forceinline__ void wgmma_64x32_rs(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) = a . b (+ d if accumulate): a 64 x 16 K-major and b
// 16 x 32 MN-major, both from shared memory.
__device__ __forceinline__ void wgmma_64x32_ss(float (&d)[16], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += a . b: a 64 x 16 bf16 from registers, b 16 x 64
// MN-major (16 rows of 64 columns, the transpose bit) from shared memory.
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) = a . b (+ d if accumulate): a 64 x 16 bf16 from
// registers, b 16 x 64 K-major (64 rows of 16 channels) from shared memory:
// the scores of up to 64 keys against q held as A fragments.
__device__ __forceinline__ void wgmma_64x64_rs_k(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = a . b (+ d if accumulate): a 64 x 16 and b 16 x 64
// both K-major (b: 64 rows of 16 channels) from shared memory: the scores
// of up to 64 keys against q tile rows.
__device__ __forceinline__ void wgmma_64x64_ss_k(float (&d)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = a . b (+ d if accumulate): a 64 x 16 K-major and b
// 16 x 64 MN-major, both from shared memory.
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// P . V of one 16-key step for a head of HD channels: m64n32k16 (HD 32) or
// m64n64k16 (HD 64), v MN-major.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_64x64_rs(d, a, db);
  else wgmma_64x32_rs(d, a, db);
}

// x . Wq of one 16-channel step for a head of HD channels.
template <int HD>
__device__ __forceinline__ void wgmma_proj(float (&d)[HD / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (HD == 64) wgmma_64x64_ss(d, da, db, accumulate);
  else wgmma_64x32_ss(d, da, db, accumulate);
}

// Bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory; completion is
// reported to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// Generic-proxy writes to global memory ordered before later reads of the
// async proxy (TMA) that a barrier makes them visible to.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// 2^x on the special-function unit alone (exp2f adds a range fix-up for
// results below 2^-126, which these probabilities flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool MAX>
__device__ __forceinline__ float reduce2(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

// The softmax of the wgmma attention kernels (band_attention.cu,
// band_attention_short.cu, the bf16 a2c2f): max / sum of the 2 J scores of
// one row a thread holds of an S tile of 8 J keys, its elements s[4 j +
// OFF] and s[4 j + OFF + 1], j < J (16: a 128-key tile; 8: 64 keys), as a
// tree (the chain of dependent steps nvcc keeps in written order is what a
// warp waits on); every index a constant, so nothing leaves the registers
template <bool MAX, int OFF, int J = 16>
__device__ __forceinline__ float row_reduce(const float (&s)[4 * J]) {
  float t[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    t[j] = reduce2<MAX>(s[4 * j + OFF], s[4 * j + OFF + 1]);
  static_assert(J == 8 || J == 16, "a row of 64 or 128 keys");
  if constexpr (J == 16) {
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = reduce2<MAX>(t[j], t[j + 8]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = reduce2<MAX>(t[j], t[j + 4]);
  return reduce2<MAX>(reduce2<MAX>(t[0], t[2]), reduce2<MAX>(t[1], t[3]));
}

// One key tile's step of the wgmma attention's online softmax, on the
// 64 x 128 scores s a warpgroup's S = q k^T left (a thread's rows r_lo and
// r_lo + 8 at s[4 j + e] / s[4 j + 2 + e], keys past the band already
// -inf): the rows' maxima m and sums l move on, s becomes the unnormalised
// probabilities exp2(s sl2 - m sl2) (sl2 = scale * log2 e), and the factors
// that rescale o are returned (.x row r_lo, .y row r_lo + 8). The tile's
// first key exists, so every maximum is finite.
__device__ __forceinline__ float2 online_softmax(float (&s)[64], float sl2,
                                                 float& m_lo, float& m_hi,
                                                 float& l_lo, float& l_hi) {
  const float mx_lo = quad_max(fmaxf(m_lo, row_reduce<true, 0>(s)));
  const float mx_hi = quad_max(fmaxf(m_hi, row_reduce<true, 2>(s)));
  const float c_lo = ex2((m_lo - mx_lo) * sl2);
  const float c_hi = ex2((m_hi - mx_hi) * sl2);
  const float nb_lo = -mx_lo * sl2, nb_hi = -mx_hi * sl2;
  m_lo = mx_lo;
  m_hi = mx_hi;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, nb_lo));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sl2, nb_hi));
    }
  l_lo = l_lo * c_lo + row_reduce<false, 0>(s);
  l_hi = l_hi * c_hi + row_reduce<false, 2>(s);
  return make_float2(c_lo, c_hi);
}

// o (HD channels, 8 j + 2 t + e at o[4 j + e] / o[4 j + 2 + e]) rescaled by
// a tile's factors c, and the tile's probabilities s rounded to bf16 as the
// A fragments of P . V: 8 steps of 16 keys.
template <int HD>
__device__ __forceinline__ void rescale_and_pack(float (&o)[HD / 2],
                                                 uint32_t (&p)[8][4],
                                                 const float (&s)[64],
                                                 float2 c) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= c.x;
    o[4 * j + 1] *= c.x;
    o[4 * j + 2] *= c.y;
    o[4 * j + 3] *= c.y;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {               // keys 16 kk .. 16 kk + 15
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// --------------------------------------- the blocked forms' per-tile steps
// Heads wider than 64 are attended in 64-channel blocks, by kernel C's
// blocked kernels (band_attention.cu) and the a2c2f kernels' blocked forms
// (`attend_blocked`, `attend_f32_blocked`): a key tile's scores add over
// the head's blocks, then one online-softmax step and p.v on the output
// block's 64 channels of v. These are the steps the four share.

// bf16: S (+)= q_j k_j^T over one 64-channel block, a warpgroup's 64 x 128
// scores from q's block (64 rows) and k's (128 keys) at descriptors dq and
// dk (the 128-byte swizzle); `accumulate` 0 (block 0) starts the sum. The
// products are waited, so no wgmma group is left open across the caller's
// loop (ptxas would serialise it).
__device__ __forceinline__ void wgmma_block_scores(float (&s)[64],
                                                   uint64_t dq, uint64_t dk,
                                                   int accumulate) {
  wgmma_fence();
  wgmma_64x128_ss(s, dq, dk, accumulate);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)                 // 16 more: 32 bytes on
    wgmma_64x128_ss(s, dq + 2 * kk, dk + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 64; ++e) reg_fence(s[e]);
}

// bf16: the scores of keys past n (the tile's first key k0; a thread's
// keys 8 j + 2 t + e) set to -inf, by selects.
__device__ __forceinline__ void mask_keys_past(float (&s)[64], int k0, int n,
                                               int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool past = k0 + 8 * j + 2 * t + e >= n;
      s[4 * j + e] = past ? -INFINITY : s[4 * j + e];
      s[4 * j + 2 + e] = past ? -INFINITY : s[4 * j + 2 + e];
    }
}

// bf16: O += P V of one key tile (128 keys) on v's 64-channel block at Vt
// (`kv_at<64>`'s layout), waited, o's and p's registers fenced.
__device__ __forceinline__ void wgmma_block_pv(float (&o)[32],
                                               uint32_t (&p)[8][4],
                                               const __nv_bfloat16* Vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv<64>(o, p[kk], head_desc<64>(Vt + kk * 16 * 64));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 32; ++e) reg_fence(o[e]);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(p[kk][e]);
}

// f32 micro-tiles: a group of 16 threads (t = 0 .. 15) owns query rows
// 4 rg .. 4 rg + 3, a thread keys t + 16 w (w < 4) of a tile of 64;
// s[a][w] += q . k over one 64-channel block of q (QROWS rows) and k (64
// keys), both 128-byte-swizzled boxes of 32 channels (`f32_at<64>`), in
// FMAs over the channels in order.
template <int QROWS>
__device__ __forceinline__ void f32_block_scores(float (&s)[4][4],
                                                 const float* Qt,
                                                 const float* Kt, int rg,
                                                 int t) {
#pragma unroll
  for (int cc = 0; cc < 16; ++cc) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      qv[a] = *reinterpret_cast<const float4*>(
          Qt + f32_at<64>(4 * rg + a, cc, QROWS));
#pragma unroll
    for (int w = 0; w < 4; ++w)
      kv[w] = *reinterpret_cast<const float4*>(
          Kt + f32_at<64>(t + 16 * w, cc, 64));
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        s[a][w] = fmaf(qv[a].x, kv[w].x, s[a][w]);
        s[a][w] = fmaf(qv[a].y, kv[w].y, s[a][w]);
        s[a][w] = fmaf(qv[a].z, kv[w].z, s[a][w]);
        s[a][w] = fmaf(qv[a].w, kv[w].w, s[a][w]);
      }
  }
}

// f32: one key tile's step on its finished scores s (the tile's first key
// k0, keys past n masked; the first key exists, so every maximum is
// finite): the online softmax of the rows' m and l, acc (a thread's
// channels 4 cq + 32 b of rows 4 rg + a, cq = t % 8, its key half t / 8)
// rescaled, the probabilities through the group's rows Pg (LDP_ floats
// apart), then acc += P V over v's tile at Vt (64 keys x 64 channels).
template <int LDP_>
__device__ __forceinline__ void f32_softmax_pv(float (&s)[4][4],
                                               float (&m)[4], float (&l)[4],
                                               float (&acc)[4][8], float* Pg,
                                               const float* Vt, int k0,
                                               int n, int t, float sl2) {
  const int half = t >> 3, cq = t & 7;
  if (k0 + 64 > n) {                             // group-uniform
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (k0 + t + 16 * w >= n)
#pragma unroll
        for (int a = 0; a < 4; ++a) s[a][w] = -INFINITY;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
    for (int d = 1; d < 16; d <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, d));
    mx = fmaxf(mx, m[a]);
    const float c = exp2f((m[a] - mx) * sl2), nbias = -mx * sl2;
    m[a] = mx;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s[a][w] = exp2f(fmaf(s[a][w], sl2, nbias));
      sum += s[a][w];
    }
    l[a] = l[a] * c + sum;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] *= c;
  }
  __syncwarp();                                  // the last tile's P read
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      Pg[a * LDP_ + t + 16 * w + (w >= 2 ? 4 : 0)] = s[a][w];
  __syncwarp();
#pragma unroll 2
  for (int jj = 0; jj < 32; jj += 4) {
    float4 pv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      pv[a] = *reinterpret_cast<const float4*>(Pg + a * LDP_ + 36 * half +
                                               jj);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vt + f32_at<64>(32 * half + jj + w, cq + 8 * b, 64));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pw = lane_of(pv[a], w);
          float* ac = acc[a] + 4 * b;
          ac[0] = fmaf(pw, vv.x, ac[0]);
          ac[1] = fmaf(pw, vv.y, ac[1]);
          ac[2] = fmaf(pw, vv.z, ac[2]);
          ac[3] = fmaf(pw, vv.w, ac[3]);
        }
      }
    }
  }
}

// ------------------------------------------------ thread-block clusters

// This CTA's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The shared::cluster address of p's twin in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(shared_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// The cluster barrier in two halves, each taken by every thread of every
// CTA of the cluster, alternately: the arrival releases this thread's
// writes to shared memory, the wait (for every arrival of that phase)
// acquires the others'. `.aligned` wants the warp converged.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// f32: after the last key tile, the row sums l over the group and the two
// key halves of acc (threads t and t ^ 8) added.
__device__ __forceinline__ void f32_group_sums(float (&l)[4],
                                               float (&acc)[4][8]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) l[a] += __shfl_xor_sync(FULL, l[a], d);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[a][e] += __shfl_xor_sync(FULL, acc[a][e], 8);
  }
}

}  // namespace yolou

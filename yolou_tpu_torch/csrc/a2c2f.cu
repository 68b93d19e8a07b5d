// A whole A2C2f attention block (eval, BatchNorm folded) in one launch.
//
// Replaces yolou_tpu/ops/pallas_a2c2f.py::a2c2f_fused (Pallas body
// _a2c2f_kernel). With T the I/O type (f32 or bf16), every product
// accumulated in f32, and N = H*W tokens per image:
//   y0 = silu(x.Wcv1 + b) -> T;  t = y0
//   per stage, twice (two ABlocks):
//     qkv = (t.Wqkv + b) -> T                   (N, 3c_) role-major q | k | v
//     o   = per band of nb = N/area tokens and per head of 32 channels:
//           e = exp(q k^T / sqrt(32) - rowmax);  o = (e -> T) v / sum(e)
//     pe  = depthwise 7x7 over v viewed as (H, W, c_), zero padding, f32 taps
//     t   = (t + ((o + pe) -> T).Wproj + b) -> T
//     h   = silu(t.Wm1 + b) -> T;  t = (t + h.Wm2 + b) -> T
//   ys += [t]
//   out = silu(concat(y0, z1..zn).Wcv2 + b) -> T
//
// What bounds it on the H100: at YOLOv12n's serving shapes (batch 8, layer 6:
// 1600 tokens x 64 channels per image, layer 8: 400 x 128) the block does
// about 10 / 7 GFLOP on a few MB of input, output and weights, so its bound
// is operations; the TPU kernel's point - the intermediates never reach
// device memory as separate arrays between ~80 launches - carries over as one
// launch whose intermediates stay in the 50 MB L2.
//
// Both kernels below keep the TPU kernel's data flow. It holds one image and
// every weight in VMEM; a CTA here has 227 KB, so an image is spread over
// many CTAs and the design follows the data dependencies instead:
//  * every GEMM is per token, so a CTA that owns a tile of tokens runs
//    o + pe -> proj -> +t -> mlp -> +t -> next qkv (or cv2) on its own;
//  * attention needs k and v of the whole band and the 7x7 stencil needs v
//    of the neighbourhood: the one barrier the math asks for is grid-wide,
//    once per ABlock after qkv is written. The kernel is launched
//    cooperatively (cudaLaunchCooperativeKernel) with a grid no larger than
//    what is co-resident, walks the (image, band, tile) list with a
//    grid-stride loop and calls grid.sync() between the phases: 1 + 2 *
//    n_stages phases, 2 * n_stages barriers. A cluster per image was the
//    other candidate; it caps an image at 8 or 16 CTAs and their shared
//    memory (a layer-6 image's qkv would not fit), so the scratch lives in
//    global memory instead;
//  * t / ys (B, N, (n_stages+1) c_) and two qkv buffers (B, N, 3c_) are
//    scratch in global memory that the wrapper allocates; qkv is
//    double-buffered because a phase's tiles read k and v of the whole band
//    from one buffer while other CTAs already write the next ABlock's qkv;
//    the scratch is read with plain loads or cp.async.cg through
//    non-restrict pointers (never the read-only path), ordered by
//    grid.sync();
//  * the 7x7 stencil reads v from the qkv scratch (L1/L2), in f32;
//  * rounding points are those of the listing above; residual adds in f32.
//
// f32, the exact path (`a2c2f_kernel<float>`, SIMT): tiles of TM = 16
// tokens, the stencil's 49 taps unrolled into predicated loads, one (token,
// channel) a thread, activations transposed in shared memory as f32
// [channel][token]
// so that one 16-byte shared load feeds four FMAs of a thread that owns one
// output column and 4 or 8 token rows; weights stream from L2 with 16 loads
// in flight per thread; per head the CTA stages the band's keys
// (transposed) and values and runs the SIMT `attend` of the band attention
// kernels (warp per pair of query rows, online softmax). Shared memory per
// CTA: 4 * LD * (2 c_ + max(cin, 2 c_, (n_stages+1) c_)) + 4 * (32 * TM +
// 32 * (ceil32(nb) + 1) + 32 * ceil32(nb)) bytes, LD = TM + 4.
//
// bf16, the serving type (`a2c2f_mma_kernel<TILE>`, tensor cores): every
// GEMM operand is a value already rounded to bf16 (x, y0, t, u, h, the ys
// concat), so the activation tiles live in shared memory as bf16, row-major
// with rows padded by 16 bytes (conflict-free ldmatrix at any width), at no
// loss of accuracy:
//  * GEMMs: mma.sync m16n8k16, f32 accumulation. The weights stay (K, N)
//    row-major as the wrapper passes them and stream from L2 through a ring
//    of 3 slabs of 64 rows x 128 columns in shared memory by cp.async, two
//    slabs ahead of their use and across the GEMMs of a phase (the next
//    GEMM's first slabs land during this one's last, the first GEMM's during
//    the attention); a warp owns 16 columns of a panel for all the tile's
//    rows, reads its B fragments by ldmatrix.trans and the A fragments from
//    the tile by ldmatrix; the epilogues (bias, SiLU, residual, the stores
//    to t, h, ys, qkv or out) run on the accumulator fragments. Ragged
//    widths: K is zero-filled up to 16, columns past N are masked; a weight
//    whose rows are not whole 16-byte chunks, and an x whose rows are not,
//    are read with plain loads instead of 16-byte ones;
//  * attention (attention_mma.cuh): per head the band's k and v arrive by
//    cp.async in the swizzled [Np][32] layout of kernels A and C (the first
//    head's during the stencil, each next one's during the last one's
//    merge; a second buffer, to land them during the attend, cost more in
//    L1 than it hid); the 8
//    warps split the work as (query tile, key part): TILE / 16 query tiles
//    of 16 rows and S = 128 / TILE parts of whole 16-key blocks, each warp
//    an online softmax over its part with q's A fragments read straight
//    from the qkv scratch; the partial states (row maximum, row sum, f32
//    accumulator) are merged in f32 and the f32 o goes with pe into u;
//  * the 7x7 stencil: 8 channels of RUN consecutive tokens a thread,
//    16-byte predicated loads, the RUN tokens sharing each row's loads;
//  * token tile: 16, 32 or 64 tokens, whichever grid takes the fewest waves
//    over the co-resident CTAs (`launch_mma`).
//    Shared memory per CTA: 2 * (3 * 64 * 136 + 64 * ceil16(nb) + TILE *
//    (2 (c_ + 8) + max(ceil16(cin), 2 c_, (n_stages+1) c_) + 8)) + 4 * 8 *
//    544 bytes, plus 128 bytes of GEMM descriptors.
// The wrapper refuses a shape whose CTA passes the 227 KB a block may use.

#include <cooperative_groups.h>

#include <map>
#include <mutex>

#include "attention_mma.cuh"
#include "band_attention.cuh"

namespace cg = cooperative_groups;
using namespace yolou;

namespace {

constexpr int TM = 16;          // tokens per tile (one `attend` pass of 8 warps)
constexpr int LD = TM + 4;      // row stride of the transposed f32 tiles
constexpr int MAX_STAGES = 4;
constexpr int UNROLL = 16;     // weight loads in flight per thread

struct ABlockWeights {
  const void* wqkv; const float* bqkv;
  const float* wpe; const float* bpe;
  const void* wproj; const float* bproj;
  const void* wm1; const float* bm1;
  const void* wm2; const float* bm2;
};

struct Params {
  const void* x; void* out; void* ys; void* qkv0; void* qkv1;
  const void* wcv1; const float* bcv1;
  const void* wcv2; const float* bcv2;
  ABlockWeights blk[2 * MAX_STAGES];
  int B, H, W, cin, c_, c2, n_stages, area, heads;
  float scale;                  // f32(32 ** -0.5)
};

// keys transposed: [HD][ldk], ldk = ceil32(nb) + pad with an odd stride in
// 32-bit words, so that 32 lanes storing one key's 32 channels hit 32 banks
// (the SIMT kernel runs f32 only since bf16 has the tensor-core kernel)
template <typename T> __host__ __device__ constexpr int key_pad();
template <> __host__ __device__ constexpr int key_pad<float>() { return 1; }

__host__ __device__ inline int big_rows(int cin, int c_, int n_stages) {
  const int a = 2 * c_, b = (n_stages + 1) * c_, m = a > b ? a : b;
  return cin > m ? cin : m;
}

template <typename T>
size_t smem_bytes(int cin, int c_, int n_stages, int nb) {
  const int Np = (nb + 31) & ~31, ldk = Np + key_pad<T>();
  return sizeof(float) * LD * (size_t)(2 * c_ + big_rows(cin, c_, n_stages)) +
         sizeof(T) * ((size_t)HD * TM + (size_t)HD * ldk + (size_t)HD * Np);
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// rows x K values of T (row stride ld) -> dst[k * LD + r] as f32; rows past
// `rows` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t ld,
                                          int K, int rows) {
  for (int i = threadIdx.x; i < TM * K; i += blockDim.x) {
    const int r = i / K, k = i % K;
    dst[k * LD + r] = r < rows ? to_f(src[(size_t)r * ld + k]) : 0.f;
  }
}

// acc[row][col] = sum_k At[k][row] * Wt[k][col] for the tile's TM rows and
// all Nout columns; a thread owns one column and R rows. epi(row, col, acc).
template <int R, typename T, typename Epi>
__device__ __forceinline__ void gemm_rows(const float* At,
                                          const T* __restrict__ Wt, int K,
                                          int Nout, Epi epi) {
  constexpr int RG = TM / R;
  for (int item = threadIdx.x; item < Nout * RG; item += blockDim.x) {
    const int col = item % Nout, r0 = (item / Nout) * R;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    const T* w = Wt + col;
    const float* a = At + r0;
#pragma unroll UNROLL
    for (int k = 0; k < K; ++k) {
      const float wk = to_f(w[(size_t)k * Nout]);
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(a + k * LD + i);
        acc[i] = fmaf(v.x, wk, acc[i]);
        acc[i + 1] = fmaf(v.y, wk, acc[i + 1]);
        acc[i + 2] = fmaf(v.z, wk, acc[i + 2]);
        acc[i + 3] = fmaf(v.w, wk, acc[i + 3]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) epi(r0 + i, col, acc[i]);
  }
}

// 8 rows a thread where that still gives every thread a column, else 4
template <typename T, typename Epi>
__device__ __forceinline__ void gemm(const float* At, const void* Wt, int K,
                                     int Nout, Epi epi) {
  if (2 * Nout >= (int)blockDim.x)
    gemm_rows<8>(At, static_cast<const T*>(Wt), K, Nout, epi);
  else
    gemm_rows<4>(At, static_cast<const T*>(Wt), K, Nout, epi);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) a2c2f_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = p.H, W = p.W, N = H * W, cin = p.cin, c_ = p.c_, c2 = p.c2;
  const int nb = N / p.area, Np = (nb + 31) & ~31, ldk = Np + key_pad<T>();
  const int tiles_per_band = (nb + TM - 1) / TM;
  const int total = p.B * p.area * tiles_per_band;
  const int YS = (p.n_stages + 1) * c_, QS = 3 * c_;
  const int n_blocks = 2 * p.n_stages;

  float* tT = reinterpret_cast<float*>(smem_raw);        // [c_][LD]
  float* oT = tT + c_ * LD;                              // [c_][LD]
  float* big = oT + c_ * LD;                             // [big_rows][LD]
  T* Qs = reinterpret_cast<T*>(big + big_rows(cin, c_, p.n_stages) * LD);
  T* Kt = Qs + TM * HD;                                  // [HD][ldk]
  T* Vs = Kt + HD * ldk;                                 // [Np][HD]

  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  T* ys = static_cast<T*>(p.ys);                         // scratch: plain loads
  T* const qkv0 = static_cast<T*>(p.qkv0);
  T* const qkv1 = static_cast<T*>(p.qkv1);
  const float scale = p.scale;

  pad_keys(Kt, Vs, nb, Np, ldk);
  for (int i = threadIdx.x; i < c_ * LD; i += blockDim.x) oT[i] = 0.f;
  __syncthreads();

  // ---- phase 0: y0 = silu(x.Wcv1 + b), the first ABlock's qkv ------------
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int q0 = (tile % tiles_per_band) * TM;
    const int bg = tile / tiles_per_band;                // image * area + band
    const size_t tok0 = (size_t)bg * nb + q0;            // global token index
    const int rows = min(TM, nb - q0);
    load_tile(big, x + tok0 * cin, cin, cin, rows);
    __syncthreads();
    {
      const float* b = p.bcv1;
      gemm<T>(big, p.wcv1, cin, c_, [&](int row, int col, float acc) {
        const T y = from_f<T>(silu(acc + b[col]));
        tT[col * LD + row] = to_f(y);
        if (row < rows) ys[(tok0 + row) * YS + col] = y;
      });
    }
    __syncthreads();
    {
      const float* b = p.blk[0].bqkv;
      T* dst = qkv0;
      gemm<T>(tT, p.blk[0].wqkv, c_, QS, [&](int row, int col, float acc) {
        if (row < rows) dst[(tok0 + row) * QS + col] = from_f<T>(acc + b[col]);
      });
    }
    __syncthreads();
  }
  grid.sync();

  // ---- one phase per ABlock ----------------------------------------------
  for (int a = 0; a < n_blocks; ++a) {
    const ABlockWeights wb = p.blk[a];
    const T* cur = (a & 1) ? qkv1 : qkv0;
    T* const nxt = (a & 1) ? qkv0 : qkv1;
    const bool last = a == n_blocks - 1;
    const int slot_out = a / 2 + 1, slot_in = slot_out - 1 + (a & 1);
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int q0 = (tile % tiles_per_band) * TM;
      const int bg = tile / tiles_per_band;
      const int band = bg % p.area;
      const size_t band0 = (size_t)bg * nb;              // band's first token
      const size_t img0 = band0 - (size_t)band * nb;     // image's first token
      const size_t tok0 = band0 + q0;
      const int rows = min(TM, nb - q0);
      load_tile(tT, ys + tok0 * YS + slot_in * c_, YS, c_, rows);

      // attention, head by head: stage the band's k and v, attend the tile
      for (int h = 0; h < p.heads; ++h) {
        __syncthreads();                    // the last head's readers are done
        for (int m = warp; m < nb; m += WARPS) {
          const T* row = cur + (band0 + m) * QS + h * HD + lane;
          Kt[lane * ldk + m] = row[c_];
          Vs[m * HD + lane] = row[2 * c_];
        }
        for (int r = warp; r < TM; r += WARPS)
          Qs[r * HD + lane] = r < rows ? cur[(tok0 + r) * QS + h * HD + lane]
                                       : from_f<T>(0.f);
        __syncthreads();
        attend<T, true, float>(Qs, Kt, Vs, oT, 0, h * HD, 1, LD, nb, ldk, 0,
                               rows, scale);
      }
      __syncthreads();

      // u = (o + dw7x7(v) + bpe) -> T, in place over o
      for (int i = threadIdx.x; i < rows * c_; i += blockDim.x) {
        const int r = i / c_, c = i % c_;
        const int n = band * nb + q0 + r, y = n / W, xx = n % W;
        const T* v = cur + img0 * QS + 2 * c_ + c;
        // 49 independent predicated loads: no branch in the unrolled taps
        float acc = 0.f;
#pragma unroll
        for (int di = 0; di < 7; ++di) {
          const int yy = y + di - 3;
          const bool row_ok = yy >= 0 && yy < H;
#pragma unroll
          for (int dj = 0; dj < 7; ++dj) {
            const int xj = xx + dj - 3;
            const bool ok = row_ok && xj >= 0 && xj < W;
            const float vv = ok ? to_f(v[(size_t)(yy * W + xj) * QS]) : 0.f;
            acc = fmaf(vv, wb.wpe[(di * 7 + dj) * c_ + c], acc);
          }
        }
        const float u = oT[c * LD + r] + (acc + wb.bpe[c]);
        oT[c * LD + r] = to_f(from_f<T>(u));
      }
      __syncthreads();

      // t = (t + u.Wproj + b) -> T
      gemm<T>(oT, wb.wproj, c_, c_, [&](int row, int col, float acc) {
        float* t = tT + col * LD + row;
        *t = to_f(from_f<T>(*t + (acc + wb.bproj[col])));
      });
      __syncthreads();
      // h = silu(t.Wm1 + b) -> T
      gemm<T>(tT, wb.wm1, c_, 2 * c_, [&](int row, int col, float acc) {
        big[col * LD + row] = to_f(from_f<T>(silu(acc + wb.bm1[col])));
      });
      __syncthreads();
      // t = (t + h.Wm2 + b) -> T, kept for the next ABlock and for cv2
      gemm<T>(big, wb.wm2, 2 * c_, c_, [&](int row, int col, float acc) {
        float* t = tT + col * LD + row;
        const T tn = from_f<T>(*t + (acc + wb.bm2[col]));
        *t = to_f(tn);
        if (row < rows) ys[(tok0 + row) * YS + slot_out * c_ + col] = tn;
      });
      __syncthreads();

      if (!last) {
        const void* wq = p.blk[a + 1].wqkv;
        const float* bq = p.blk[a + 1].bqkv;
        gemm<T>(tT, wq, c_, QS, [&](int row, int col, float acc) {
          if (row < rows)
            nxt[(tok0 + row) * QS + col] = from_f<T>(acc + bq[col]);
        });
      } else {
        // out = silu(concat(y0, z1..zn).Wcv2 + b) -> T
        load_tile(big, ys + tok0 * YS, YS, YS, rows);
        __syncthreads();
        const float* b = p.bcv2;
        gemm<T>(big, p.wcv2, YS, c2, [&](int row, int col, float acc) {
          if (row < rows)
            out[(tok0 + row) * c2 + col] = from_f<T>(silu(acc + b[col]));
        });
      }
      __syncthreads();
    }
    if (!last) grid.sync();
  }
}

struct DeviceInfo { int sms; int cooperative; };

cudaError_t device_info(DeviceInfo* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&info->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(&info->cooperative,
                                cudaDevAttrCooperativeLaunch, dev);
}

// f32: the SIMT kernel
cudaError_t launch_simt(Params& p, cudaStream_t s, const DeviceInfo& info) {
  const int N = p.H * p.W, nb = N / p.area;
  const size_t smem = smem_bytes<float>(p.cin, p.c_, p.n_stages, nb);
  cudaError_t e = cudaFuncSetAttribute(
      a2c2f_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, a2c2f_kernel<float>, WARPS * 32, smem);
  if (e != cudaSuccess) return e;
  // the grid must be co-resident for grid.sync(); never shrink the tile or
  // the block to make it fit
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long total = (long long)p.B * p.area * ((nb + TM - 1) / TM);
  const long long resident = (long long)per_sm * info.sms;
  const int blocks = (int)(total < resident ? total : resident);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)a2c2f_kernel<float>,
                                  dim3(blocks), dim3(WARPS * 32), args, smem,
                                  s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 on tensor cores

using bf16 = __nv_bfloat16;

constexpr int KS = 64;                 // weight rows per staged slab
constexpr int WN = 16;                 // output columns a warp owns in a panel
constexpr int NP = MMA_WARPS * WN;     // columns per panel
constexpr int LDS = NP + 8;            // slab row stride: 272 B, conflict-free
constexpr int RING = 3;                // slabs in flight or in use
constexpr int SLAB = KS * LDS;         // elements of one slab
constexpr int KT_A2 = 64;              // keys per online-softmax step
constexpr int MAX_GEMMS = 4;           // GEMMs one tile runs in a phase

__host__ __device__ inline int pad16(int k) { return (k + 15) & ~15; }
// row stride of an activation tile of K columns: 16 bytes past a multiple
// of 32, so the 8 rows of one ldmatrix phase fall in 8 bank groups
__host__ __device__ inline int tile_ld(int k) { return pad16(k) + 8; }

__host__ __device__ inline int big_cols(int cin, int c_, int n_stages) {
  const int a = 2 * c_, b = (n_stages + 1) * c_, m = a > b ? a : b;
  return pad16(cin) > m ? pad16(cin) : m;
}

// Dynamic shared memory of the bf16 kernel at token tile TILE (bytes): the
// weight ring, one head's keys and values of a band, the attention
// partials, the t and u tiles and the `big` tile (x, h, the ys concat, or
// the f32 positional term).
__host__ __device__ inline size_t mma_smem_bytes(int TILE, int cin, int c_,
                                                 int n_stages, int nb) {
  return sizeof(bf16) * ((size_t)RING * SLAB + 2 * (size_t)pad16(nb) * HD +
                         (size_t)TILE * (2 * tile_ld(c_) +
                                       tile_ld(big_cols(cin, c_, n_stages)))) +
         sizeof(float) * (size_t)MMA_WARPS * PART_FLOATS;
}

// One GEMM of a phase: weight (K, N) row-major, streamed through the ring
// as stages of KS rows x NP columns, panel by panel (nk stages a panel).
// vec: the rows are whole 16-byte chunks, copied by cp.async.
struct GemmDesc {
  const bf16* w;
  int K, N, nk, total, vec;
};

__device__ __forceinline__ GemmDesc gemm_desc(const void* w, int K, int N) {
  GemmDesc d;
  d.w = static_cast<const bf16*>(w);
  d.K = K;
  d.N = N;
  d.nk = (K + KS - 1) / KS;
  d.total = d.nk * ((N + NP - 1) / NP);
  d.vec = N % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  return d;
}

// Stage i of d into dst ([KS][LDS]); rows >= K and columns >= N are zero.
__device__ __forceinline__ void stage_slab(const GemmDesc& d, int i,
                                           bf16* dst) {
  const int p = i / d.nk, k0 = (i - p * d.nk) * KS, n0 = p * NP;
  for (int idx = threadIdx.x; idx < KS * (NP / 8); idx += blockDim.x) {
    const int r = idx / (NP / 8), c8 = 8 * (idx % (NP / 8));
    const int k = k0 + r, n = n0 + c8;
    bf16* to = dst + r * LDS + c8;
    const bf16* from = d.w + (size_t)k * d.N + n;
    if (d.vec) {
      const bool ok = k < d.K && n < d.N;
      cp_async16(to, ok ? from : d.w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        to[e] = k < d.K && n + e < d.N ? from[e] : __float2bfloat16_rn(0.f);
    }
  }
}

// The weight stream of one tile's phase: the stages of its GEMMs in order
// through a ring of RING slabs, RING - 1 stages ahead of their use, so the
// next GEMM's first slabs arrive during this one's last ones (and the
// first GEMM's during the attention). Every issue commits one cp.async
// group, empty past the last stage, so that cp_async_wait<RING - 2> before
// a stage's use means that stage has landed.
struct WeightStream {
  const GemmDesc* d;      // MAX_GEMMS descriptors in shared memory
  int n;                  // GEMMs
  int g, i;               // the next stage to issue: GEMM g, stage i
  int slot;               // its ring slot
  int use;                // the ring slot of the next stage to use
  int cg;                 // the GEMM that runs next
};

__device__ __forceinline__ void issue(WeightStream& ws, bf16* ring) {
  if (ws.g < ws.n) {
    const GemmDesc& d = ws.d[ws.g];
    stage_slab(d, ws.i, ring + ws.slot * SLAB);
    if (++ws.i == d.total) {
      ws.i = 0;
      ++ws.g;
    }
  }
  cp_async_commit();
  ws.slot = ws.slot + 1 == RING ? 0 : ws.slot + 1;
}

__device__ __forceinline__ void stream_start(WeightStream& ws,
                                             const GemmDesc* d, int n,
                                             bf16* ring) {
  ws.d = d;
  ws.n = n;
  ws.g = ws.i = ws.slot = ws.use = ws.cg = 0;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) issue(ws, ring);
}

// acc = A . W for the tile's TILE rows (A: [TILE][lda] bf16 in shared memory,
// columns >= K zero up to pad16(K)) and all N columns of the stream's next
// GEMM, on the tensor cores: per panel of NP columns a warp owns WN of them
// for all TILE rows; per stage it reads W's B fragments from the slab by
// ldmatrix.trans and the A fragments from the tile by ldmatrix. At the end
// of each panel epi(row, col, v0, v1, two) gets the f32 sums of columns
// col and, if `two`, col + 1 (col < N) of every row of the tile.
template <int TILE, typename Epi>
__device__ __forceinline__ void gemm_mma(WeightStream& ws, bf16* ring,
                                         const bf16* A, int lda, Epi epi) {
  constexpr int MT = TILE / 16;
  const GemmDesc d = ws.d[ws.cg++];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int K = d.K, N = d.N, nk = d.nk, total = d.total;
  const int K16 = pad16(K);
  float acc[MT][2][4];
  for (int i = 0; i < total; ++i) {
    const int p = i / nk, s = i - p * nk;
    if (s == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    }
    cp_async_wait<RING - 2>();
    __syncthreads();                  // stage i landed for every thread
    const bf16* slab = ring + ws.use * SLAB;
    ws.use = ws.use + 1 == RING ? 0 : ws.use + 1;
    issue(ws, ring);                  // into the slot stage i - 1 used
    const int n_w = p * NP + warp * WN;
    if (n_w >= N) continue;           // warp-uniform: no column here
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const int k = s * KS + 16 * kk;
      if (k < K16) {                  // warp-uniform
        uint32_t b[4];
        ldsm_x4_trans(b, slab + (16 * kk + (lane & 15)) * LDS + warp * WN +
                             (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldsm_x4(a, A + (16 * m + (lane & 15)) * lda + k + (lane >> 4) * 8);
          mma_bf16(acc[m][0], a, b[0], b[1]);
          mma_bf16(acc[m][1], a, b[2], b[3]);
        }
      }
    }
    if (s == nk - 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n_w + 8 * j + 2 * t;
        if (col >= N) continue;
        const bool two = col + 1 < N;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          epi(16 * m + g, col, acc[m][j][0], acc[m][j][1], two);
          epi(16 * m + g + 8, col, acc[m][j][2], acc[m][j][3], two);
        }
      }
    }
  }
}

// rows x K values of src (row stride ld) -> dst [TILE][ldd]; columns
// [K, pad16(K)) and rows >= rows are zero. 16-byte loads where the rows
// allow them, else one element at a time.
template <int TILE>
__device__ __forceinline__ void load_rows(bf16* dst, int ldd, const bf16* src,
                                          size_t ld, int K, int rows) {
  const int K16 = pad16(K);
  if (K % 8 == 0 && ld % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int C8 = K16 / 8;
    for (int i = threadIdx.x; i < TILE * C8; i += blockDim.x) {
      const int r = i / C8, c = 8 * (i % C8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < K)
        v = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
      *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < TILE * K16; i += blockDim.x) {
      const int r = i / K16, c = i % K16;
      dst[r * ldd + c] = r < rows && c < K ? src[(size_t)r * ld + c]
                                           : __float2bfloat16_rn(0.f);
    }
  }
}

// Columns col and col + 1 (if `two`) of one row, rounded to bf16, at p;
// `pair`: p is 4-byte aligned.
__device__ __forceinline__ void store2(bf16* p, float v0, float v1, bool two,
                                       bool pair) {
  if (two && pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (two) p[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int RUN = 2;                 // tokens a thread of the stencil takes

// The 7x7 depthwise taps of L consecutive tokens (x0 .. x0 + L - 1) of image
// row y, 8 channels: acc[t][e] += v(yy, xj)[e] * w(di, dj)[e] in the
// reference's tap order, zero outside the image. v: channel c of the
// image's first token's v (row stride QS); w: channel c of the f32 taps
// (7, 7, c_). The taps are predicated loads, no branch between them, so
// they are in flight together (a branch per tap left each at L2 latency).
template <int L>
__device__ __forceinline__ void dw7x7_run(const bf16* v, int QS,
                                          const float* w, int c_, int H,
                                          int W, int y, int x0,
                                          float (&acc)[L][8]) {
#pragma unroll
  for (int di = 0; di < 7; ++di) {
    const int yy = y + di - 3;
    const bool row_ok = yy >= 0 && yy < H;
    uint4 raw[L + 6];
#pragma unroll
    for (int j = 0; j < L + 6; ++j) {
      const int xj = x0 + j - 3;
      raw[j] = row_ok && xj >= 0 && xj < W
                   ? *reinterpret_cast<const uint4*>(
                         v + (size_t)(yy * W + xj) * QS)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int dj = 0; dj < 7; ++dj) {
      const float4* w4 =
          reinterpret_cast<const float4*>(w + (di * 7 + dj) * c_);
      const float4 wa = w4[0], wc = w4[1];
      const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw[t + dj]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v2[e]);
          acc[t][2 * e] = fmaf(f.x, w8[2 * e], acc[t][2 * e]);
          acc[t][2 * e + 1] = fmaf(f.y, w8[2 * e + 1], acc[t][2 * e + 1]);
        }
      }
    }
  }
}

// The bf16 kernel: the phases, tiles and rounding points of a2c2f_kernel,
// with tiles of TILE tokens (TILE / 16 query tiles) whose activations are bf16
// in shared memory (every GEMM operand is a value already rounded to bf16),
// every GEMM on the tensor cores, and the attention of each head split
// over the 8 warps: query tile warp % QT, key part warp / QT of S = 8 / QT.
template <int TILE>
__global__ void __launch_bounds__(MMA_WARPS * 32)
a2c2f_mma_kernel(const Params p) {
  constexpr int QT = TILE / 16, S = MMA_WARPS / QT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ GemmDesc descs[MAX_GEMMS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = p.H, W = p.W, N = H * W, cin = p.cin, c_ = p.c_, c2 = p.c2;
  const int nb = N / p.area, Np = pad16(nb);
  const int tiles_per_band = (nb + TILE - 1) / TILE;
  const int total = p.B * p.area * tiles_per_band;
  const int YS = (p.n_stages + 1) * c_, QS = 3 * c_;
  const int n_blocks = 2 * p.n_stages;
  const int ldt = tile_ld(c_), ldb = tile_ld(big_cols(cin, c_, p.n_stages));

  bf16* ring = reinterpret_cast<bf16*>(smem_raw);      // [RING][KS][LDS]
  bf16* Ks = ring + RING * SLAB;                       // [Np][32] swizzled
  bf16* Vs = Ks + Np * HD;                             // [Np][32] swizzled
  float* parts = reinterpret_cast<float*>(Vs + Np * HD);  // [8][PART_FLOATS]
  bf16* tT = reinterpret_cast<bf16*>(parts + MMA_WARPS * PART_FLOATS);
  bf16* uT = tT + TILE * ldt;                            // [TILE][ldt]
  bf16* big = uT + TILE * ldt;                           // [TILE][ldb]
  float* pe = reinterpret_cast<float*>(big);           // [TILE][c_] f32

  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* out = static_cast<bf16*>(p.out);
  bf16* ys = static_cast<bf16*>(p.ys);                 // scratch: plain loads
  bf16* const qkv0 = static_cast<bf16*>(p.qkv0);
  bf16* const qkv1 = static_cast<bf16*>(p.qkv1);
  const float sl2 = p.scale * LOG2E;
  WeightStream ws;

  // ---- phase 0: y0 = silu(x.Wcv1 + b), the first ABlock's qkv ------------
  if (tid == 0) {
    descs[0] = gemm_desc(p.wcv1, cin, c_);
    descs[1] = gemm_desc(p.blk[0].wqkv, c_, QS);
  }
  __syncthreads();
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int q0 = (tile % tiles_per_band) * TILE;
    const int bg = tile / tiles_per_band;                // image * area + band
    const size_t tok0 = (size_t)bg * nb + q0;            // global token index
    const int rows = min(TILE, nb - q0);
    stream_start(ws, descs, 2, ring);
    load_rows<TILE>(big, ldb, x + tok0 * cin, cin, cin, rows);
    {
      const float* b = p.bcv1;
      gemm_mma<TILE>(ws, ring, big, ldb,
                   [&](int row, int col, float v0, float v1, bool two) {
        const float y0 = silu(v0 + b[col]);
        const float y1 = two ? silu(v1 + b[col + 1]) : 0.f;
        store2(tT + row * ldt + col, y0, y1, two, true);
        if (row < rows) store2(ys + (tok0 + row) * YS + col, y0, y1, two, true);
      });
    }
    {
      const float* b = p.blk[0].bqkv;
      gemm_mma<TILE>(ws, ring, tT, ldt,
                   [&](int row, int col, float v0, float v1, bool two) {
        if (row < rows)
          store2(qkv0 + (tok0 + row) * QS + col, v0 + b[col],
                 two ? v1 + b[col + 1] : 0.f, two, true);
      });
    }
    __syncthreads();
  }
  grid.sync();

  // ---- one phase per ABlock ----------------------------------------------
  for (int a = 0; a < n_blocks; ++a) {
    const ABlockWeights wb = p.blk[a];
    const bf16* cur = (a & 1) ? qkv1 : qkv0;
    bf16* const nxt = (a & 1) ? qkv0 : qkv1;
    const bool last = a == n_blocks - 1;
    const int slot_out = a / 2 + 1, slot_in = slot_out - 1 + (a & 1);
    if (tid == 0) {
      descs[0] = gemm_desc(wb.wproj, c_, c_);
      descs[1] = gemm_desc(wb.wm1, c_, 2 * c_);
      descs[2] = gemm_desc(wb.wm2, 2 * c_, c_);
      descs[3] = last ? gemm_desc(p.wcv2, YS, c2)
                      : gemm_desc(p.blk[a + 1].wqkv, c_, QS);
    }
    __syncthreads();
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int q0 = (tile % tiles_per_band) * TILE;
      const int bg = tile / tiles_per_band;
      const int band = bg % p.area;
      const size_t band0 = (size_t)bg * nb;              // band's first token
      const size_t img0 = band0 - (size_t)band * nb;     // image's first token
      const size_t tok0 = band0 + q0;
      const int rows = min(TILE, nb - q0);
      // head h's keys and values of the band -> Ks, Vs by cp.async, zero
      // past nb; one commit group
      auto stage_kv = [&](int h) {
        for (int i = tid; i < Np * 4; i += blockDim.x) {
          const int n = i >> 2, c = i & 3;
          const bf16* row = cur + (band0 + (n < nb ? n : 0)) * QS + h * HD +
                            8 * c;
          cp_async16(Ks + kv_at(n, c), row + c_, n < nb);
          cp_async16(Vs + kv_at(n, c), row + 2 * c_, n < nb);
        }
        cp_async_commit();
      };
      stream_start(ws, descs, MAX_GEMMS, ring);          // lands meanwhile
      stage_kv(0);                                       // this one too
      load_rows<TILE>(tT, ldt, ys + tok0 * YS + slot_in * c_, YS, c_, rows);

      // pe = dw7x7(v) + bpe, f32, SIMT: a thread takes 8 channels of RUN
      // consecutive tokens, which share each row's RUN + 6 loads where they
      // lie in one image row (else one token at a time)
      const int C8 = c_ / 8, runs = (rows + RUN - 1) / RUN;
      for (int i = tid; i < runs * C8; i += blockDim.x) {
        const int r0s = RUN * (i / C8), c = 8 * (i % C8);
        const int len = min(RUN, rows - r0s);
        const int n0 = band * nb + q0 + r0s, y = n0 / W, x0 = n0 % W;
        const bf16* v = cur + img0 * QS + 2 * c_ + c;
        const float* w = wb.wpe + c;
        if (x0 + len <= W) {
          float acc[RUN][8] = {};
          dw7x7_run<RUN>(v, QS, w, c_, H, W, y, x0, acc);
#pragma unroll
          for (int t = 0; t < RUN; ++t)
            if (t < len)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                pe[(r0s + t) * c_ + c + e] = acc[t][e] + wb.bpe[c + e];
        } else {
          for (int t = 0; t < len; ++t) {
            float acc[1][8] = {};
            dw7x7_run<1>(v, QS, w, c_, H, W, (n0 + t) / W, (n0 + t) % W, acc);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              pe[(r0s + t) * c_ + c + e] = acc[0][e] + wb.bpe[c + e];
          }
        }
      }

      // attention, head by head: the band's k and v by cp.async, then
      // warp (query tile qt, key part sp) -> a partial state -> merged into
      // u = (o + pe) -> bf16
      const int qt = warp % QT, sp = warp / QT, r0 = 16 * qt;
      const int nblk = Np / 16;
      const int kb = 16 * (sp * nblk / S), ke = 16 * ((sp + 1) * nblk / S);
      for (int h = 0; h < p.heads; ++h) {
        uint32_t qa[2][4];
        if (r0 < rows) {
          const uint32_t* qg =
              reinterpret_cast<const uint32_t*>(cur + tok0 * QS + h * HD);
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) {   // rows g, g + 8; cols +0, +8
              const int r = r0 + g + 8 * (e & 1);
              const int col = 16 * s + 8 * (e >> 1) + 2 * t4;
              qa[s][e] = r < rows ? qg[((size_t)r * QS + col) / 2] : 0u;
            }
        }
        cp_async_wait<0>();
        __syncthreads();               // head h's k/v landed for every thread
        if (r0 < rows) {               // warp-uniform
          AttnState st;
          attn_init(st);
          if (kb < ke)
            attend_keys_mma<KT_A2>(qa, Ks, Vs, kb, ke, min(nb, ke), sl2, st);
          store_partial(st, parts + warp * PART_FLOATS);
        }
        __syncthreads();               // k/v read, the partials written
        if (h + 1 < p.heads) stage_kv(h + 1);   // lands during the merge
        for (int i = tid; i < TILE * HD; i += blockDim.x) {
          const int r = i / HD, c = i % HD;
          float u = 0.f;
          if (r < rows)
            u = merge_partials(parts + (r / 16) * PART_FLOATS,
                               QT * PART_FLOATS, S, r % 16, c) +
                pe[r * c_ + h * HD + c];
          uT[r * ldt + h * HD + c] = __float2bfloat16_rn(u);
        }
      }

      // t = (t + u.Wproj + b) -> T
      gemm_mma<TILE>(ws, ring, uT, ldt,
                   [&](int row, int col, float v0, float v1, bool two) {
        bf16* tp = tT + row * ldt + col;
        const float t0 = __bfloat162float(tp[0]) + (v0 + wb.bproj[col]);
        const float t1 =
            two ? __bfloat162float(tp[1]) + (v1 + wb.bproj[col + 1]) : 0.f;
        store2(tp, t0, t1, two, true);
      });
      // h = silu(t.Wm1 + b) -> T
      gemm_mma<TILE>(ws, ring, tT, ldt,
                   [&](int row, int col, float v0, float v1, bool two) {
        store2(big + row * ldb + col, silu(v0 + wb.bm1[col]),
               two ? silu(v1 + wb.bm1[col + 1]) : 0.f, two, true);
      });
      // t = (t + h.Wm2 + b) -> T, kept for the next ABlock and for cv2
      gemm_mma<TILE>(ws, ring, big, ldb,
                   [&](int row, int col, float v0, float v1, bool two) {
        bf16* tp = tT + row * ldt + col;
        const float t0 =
            round_bf16(__bfloat162float(tp[0]) + (v0 + wb.bm2[col]));
        const float t1 =
            two ? round_bf16(__bfloat162float(tp[1]) + (v1 + wb.bm2[col + 1]))
                : 0.f;
        store2(tp, t0, t1, two, true);
        if (row < rows)
          store2(ys + (tok0 + row) * YS + slot_out * c_ + col, t0, t1, two,
                 true);
      });
      if (!last) {
        const float* bq = p.blk[a + 1].bqkv;
        gemm_mma<TILE>(ws, ring, tT, ldt,
                     [&](int row, int col, float v0, float v1, bool two) {
          if (row < rows)
            store2(nxt + (tok0 + row) * QS + col, v0 + bq[col],
                   two ? v1 + bq[col + 1] : 0.f, two, true);
        });
      } else {
        // out = silu(concat(y0, z1..zn).Wcv2 + b) -> T
        __syncthreads();              // h read, this tile's ys written
        load_rows<TILE>(big, ldb, ys + tok0 * YS, YS, YS, rows);
        const float* b = p.bcv2;
        const bool pair = c2 % 2 == 0;
        gemm_mma<TILE>(ws, ring, big, ldb,
                     [&](int row, int col, float v0, float v1, bool two) {
          if (row < rows)
            store2(out + (tok0 + row) * c2 + col, silu(v0 + b[col]),
                   two ? silu(v1 + b[col + 1]) : 0.f, two, pair);
        });
      }
      __syncthreads();
    }
    if (!last) grid.sync();
  }
}

// a block's 227 KB less the static GEMM descriptors
constexpr size_t SMEM_LIMIT = 227 * 1024 - sizeof(GemmDesc) * MAX_GEMMS;

// Lets a2c2f_mma_kernel<TILE> use all of SMEM_LIMIT (once).
template <int TILE>
cudaError_t allow_mma_smem() {
  static const cudaError_t e =
      cudaFuncSetAttribute(a2c2f_mma_kernel<TILE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_LIMIT);
  return e;
}

// CTAs of a2c2f_mma_kernel<TILE> an SM runs at once with `smem` bytes
// (0 where none or on error); kept, since a query costs more host time than
// a launch.
template <int TILE>
int mma_per_sm(size_t smem) {
  static std::mutex mu;
  static std::map<size_t, int> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(smem);
  if (it != known.end()) return it->second;
  int n = 0;
  if (allow_mma_smem<TILE>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, a2c2f_mma_kernel<TILE>, MMA_WARPS * 32, smem) != cudaSuccess)
    n = 0;
  known[smem] = n;
  return n;
}

// A launch plan: token tile, shared memory, co-resident CTAs and waves
// (tiles over co-resident CTAs, rounded up).
struct Plan {
  int tile;
  size_t smem;
  long long resident, waves;
};

// Plan TILE if it fits; take it over `best` if it needs fewer waves (so on
// a tie the smaller tile, considered first, stays: its CTAs do less in a
// row).
template <int TILE>
void consider(const Params& p, const DeviceInfo& info, Plan& best) {
  const int nb = p.H * p.W / p.area;
  const size_t smem = mma_smem_bytes(TILE, p.cin, p.c_, p.n_stages, nb);
  if (smem > SMEM_LIMIT) return;
  const long long resident = (long long)mma_per_sm<TILE>(smem) * info.sms;
  if (resident < 1) return;
  const long long tiles = (long long)p.B * p.area * ((nb + TILE - 1) / TILE);
  const long long waves = (tiles + resident - 1) / resident;
  if (best.tile == 0 || waves < best.waves)
    best = {TILE, smem, resident, waves};
}

// The grid must be co-resident for grid.sync(): no more CTAs than the
// plan's resident count.
template <int TILE>
cudaError_t launch_mma_tile(Params& p, cudaStream_t s, const Plan& plan) {
  const int nb = p.H * p.W / p.area;
  const long long total = (long long)p.B * p.area * ((nb + TILE - 1) / TILE);
  const int blocks = (int)(total < plan.resident ? total : plan.resident);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)a2c2f_mma_kernel<TILE>, dim3(blocks),
      dim3(MMA_WARPS * 32), args, plan.smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The token tile of 16, 32 or 64 whose grid takes the fewest waves (the
// smaller tile on a tie). On an
// H100 at batch 8 that is 64 for layer 6 (224 tiles, 2 waves, against 4 of
// 32-token tiles) and 32 for layer 8 (104 tiles, 1 wave).
cudaError_t launch_mma(Params& p, cudaStream_t s, const DeviceInfo& info) {
  Plan plan = {};
  consider<16>(p, info, plan);
  consider<32>(p, info, plan);
  consider<64>(p, info, plan);
  switch (plan.tile) {
    case 16: return launch_mma_tile<16>(p, s, plan);
    case 32: return launch_mma_tile<32>(p, s, plan);
    case 64: return launch_mma_tile<64>(p, s, plan);
    default: return cudaErrorCooperativeLaunchTooLarge;
  }
}

cudaError_t launch(Params& p, int dtype, cudaStream_t s) {
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  if (!info.cooperative) return cudaErrorNotSupported;
  return dtype == 0 ? launch_simt(p, s, info) : launch_mma(p, s, info);
}

}  // namespace

// x: (B, H, W, cin), out: (B, H, W, c2) of the I/O type, channels last.
// weights: host array of 4 + 20 * n_stages device pointers in the order
// [cv1_w, cv1_b] + per ABlock [qkv_w, qkv_b, pe_w (7,7,c_), pe_b, proj_w,
// proj_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b] + [cv2_w, cv2_b]; GEMM weights
// (cin_i, cout_i) of the I/O type, biases and pe_w f32. ys: scratch of
// B*H*W*(n_stages+1)*c_ elements, qkv: scratch of 2*B*H*W*3*c_ elements of
// the I/O type. dtype 0 = float32, 1 = bfloat16. Returns the launch status.
extern "C" int yolou_a2c2f(const void* x, const void* const* weights,
                           int n_weights, void* out, void* ys, void* qkv,
                           int B, int H, int W, int cin, int c_, int c2,
                           int n_stages, int area, int heads, int dtype,
                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || c2 <= 0 || heads <= 0 ||
      area <= 0 || c_ != heads * HD || n_stages < 1 ||
      n_stages > MAX_STAGES || n_weights != 4 + 20 * n_stages ||
      (H * W) % area || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.out = out; p.ys = ys;
  const size_t elt = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  p.qkv0 = qkv;
  p.qkv1 = static_cast<char*>(qkv) + elt * (size_t)B * H * W * 3 * c_;
  p.wcv1 = weights[0];
  p.bcv1 = static_cast<const float*>(weights[1]);
  for (int a = 0; a < 2 * n_stages; ++a) {
    const void* const* w = weights + 2 + 10 * a;
    ABlockWeights& k = p.blk[a];
    k.wqkv = w[0]; k.bqkv = static_cast<const float*>(w[1]);
    k.wpe = static_cast<const float*>(w[2]);
    k.bpe = static_cast<const float*>(w[3]);
    k.wproj = w[4]; k.bproj = static_cast<const float*>(w[5]);
    k.wm1 = w[6]; k.bm1 = static_cast<const float*>(w[7]);
    k.wm2 = w[8]; k.bm2 = static_cast<const float*>(w[9]);
  }
  p.wcv2 = weights[n_weights - 2];
  p.bcv2 = static_cast<const float*>(weights[n_weights - 1]);
  p.B = B; p.H = H; p.W = W; p.cin = cin; p.c_ = c_; p.c2 = c2;
  p.n_stages = n_stages; p.area = area; p.heads = heads;
  p.scale = ATTN_SCALE;
  return (int)launch(p, dtype, static_cast<cudaStream_t>(stream));
}

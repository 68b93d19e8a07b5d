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
// Design (simple and exact first; mma/wgmma tiles are later work). The TPU
// kernel holds one image and every weight in VMEM; a CTA here has 227 KB, so
// an image is spread over many CTAs and the design follows the data
// dependencies instead:
//  * every GEMM is per token, so a CTA that owns a tile of TM = 16 tokens
//    runs o + pe -> proj -> +t -> mlp -> +t -> next qkv (or cv2) on its own,
//    its activations transposed in shared memory as f32 [channel][token] so
//    that one 16-byte shared load feeds four FMAs of a thread that owns one
//    output column and 4 or 8 token rows; weights stream from L2 with 16
//    loads in flight per thread (the loop is latency-bound below that);
//  * the 7x7 stencil reads v from the qkv scratch (L1/L2) with its 49 taps
//    unrolled into predicated loads, one (token, channel) per thread;
//  * attention needs k and v of the whole band and the 7x7 stencil needs v of
//    the neighbourhood: the one barrier the math asks for is grid-wide, once
//    per ABlock after qkv is written. The kernel is launched cooperatively
//    (cudaLaunchCooperativeKernel) with a grid no larger than what is
//    co-resident, walks the (image, band, tile) list with a grid-stride loop
//    and calls grid.sync() between the phases: 1 + 2 * n_stages phases, 2 *
//    n_stages barriers. A cluster per image (as the band attention kernels
//    use per band) was the other candidate; it caps an image at 8 or 16 CTAs
//    and their shared memory (at most 3.6 MB of f32 qkv per layer-6 image
//    would not fit), so the scratch lives in global memory instead;
//  * t / ys (B, N, (n_stages+1) c_) and two qkv buffers (B, N, 3c_) are
//    scratch in global memory that the wrapper allocates; qkv is
//    double-buffered because a phase's tiles read k and v of the whole band
//    from one buffer while other CTAs already write the next ABlock's qkv;
//    the scratch is read with plain loads through non-restrict pointers
//    (never the read-only path), ordered by grid.sync();
//  * per head the CTA stages the band's keys (transposed, padded row stride
//    so the staging stores spread over the banks) and values in shared memory
//    and runs the same `attend` device function as the band attention
//    kernels (warp per pair of query rows, online softmax), unnormalised
//    probabilities rounded to T before p.v as the TPU kernel does;
//  * rounding points are those of the listing above; residual adds in f32.
// Shared memory per CTA: 4 * LD * (2 c_ + max(cin, 2 c_, (n_stages+1) c_))
// + sizeof(T) * (32 * TM + 32 * ldk + 32 * ceil32(nb)) bytes, LD = TM + 4;
// the wrapper refuses a shape that passes the 227 KB a block may use.

#include <cooperative_groups.h>

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
template <typename T> __host__ __device__ constexpr int key_pad();
template <> __host__ __device__ constexpr int key_pad<float>() { return 1; }
template <> __host__ __device__ constexpr int key_pad<__nv_bfloat16>() { return 2; }

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

template <typename T>
cudaError_t launch(Params& p, cudaStream_t s) {
  const int N = p.H * p.W, nb = N / p.area;
  const size_t smem = smem_bytes<T>(p.cin, p.c_, p.n_stages, nb);
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  if (!info.cooperative) return cudaErrorNotSupported;
  e = cudaFuncSetAttribute(a2c2f_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, a2c2f_kernel<T>, WARPS * 32, smem);
  if (e != cudaSuccess) return e;
  // the grid must be co-resident for grid.sync(); never shrink the tile or
  // the block to make it fit
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long total = (long long)p.B * p.area * ((nb + TM - 1) / TM);
  const long long resident = (long long)per_sm * info.sms;
  const int blocks = (int)(total < resident ? total : resident);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)a2c2f_kernel<T>, dim3(blocks),
                                  dim3(WARPS * 32), args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  return (int)launch<__nv_bfloat16>(p, s);
}

// A whole A2C2f attention block (eval, BatchNorm folded) in one launch: what
// the two kernels share. The f32 kernel is a2c2f_f32.cu, the bf16 one
// a2c2f_bf16.cu; this header holds their parameter block, the device query
// and the C entry (`yolou_a2c2f`, defined in a2c2f_bf16.cu from `entry`).
//
// Replaces yolou_tpu/ops/pallas_a2c2f.py::a2c2f_fused (Pallas body
// _a2c2f_kernel). With T the I/O type (f32 or bf16), every product
// accumulated in f32, N = H*W tokens per image, c_ the block's width and ca
// the attention's (c_, or heads * hdp where the wrapper padded each head
// with zero channels to a width the kernels take: hdp 32 or 64, or past 64
// a multiple of 64, which both kernels attend in 64-channel blocks: a (head,
// output block) pair at a time, its scores summed over the head's blocks):
//   y0 = silu(x.Wcv1 + b) -> T;  t = y0
//   per stage, twice (two ABlocks):
//     qkv = (t.Wqkv + b) -> T                   (N, 3ca) role-major q | k | v
//     o   = per band of nb = N/area tokens and per head of hd = ca / heads:
//           e = exp(q k^T * scale - rowmax);  o = (e -> T) v / sum(e)
//           (scale: the head's true width ** -0.5, padded or not)
//     pe  = depthwise 7x7 over v viewed as (H, W, ca), zero padding, f32 taps
//     t   = (t + ((o + pe) -> T).Wproj + b) -> T   (Wproj: (ca, c_))
//     h   = silu(t.Wm1 + b) -> T;  t = (t + h.Wm2 + b) -> T   (h: hid wide)
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
// Both kernels keep the TPU kernel's data flow. It holds one image and
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
//  * t / ys (B, N, (n_stages+1) c_) and two qkv buffers (B, N, 3ca) are
//    scratch in global memory that the wrapper allocates; qkv is
//    double-buffered because a phase's tiles read k and v of the whole band
//    from one buffer while other CTAs already write the next ABlock's qkv;
//    the scratch is read with plain loads through L2 or by TMA, never the
//    read-only path, ordered by grid.sync() and, for the TMA reads, a proxy
//    fence (fence.proxy.async.global) before it;
//  * the ABlocks' weight pointers are a device array the wrapper fills (10
//    a block, any number of stages), read once per phase;
//  * rounding points are those of the listing above; residual adds in f32.
#pragma once

#include <cooperative_groups.h>

#include "band_attention.cuh"
#include "hopper.cuh"

namespace yolou {
namespace a2c2f {

// The HD template argument of both kernels' form for heads wider than 64
// (a multiple of 64, in blocks of 64 channels); the others are 32 and 64.
constexpr int BLOCKED = 0;

struct ABlockWeights {
  const void* wqkv; const float* bqkv;
  const float* wpe; const float* bpe;
  const void* wproj; const float* bproj;
  const void* wm1; const float* bm1;
  const void* wm2; const float* bm2;
};

struct Params {
  const void* x; void* out; void* ys; void* qkv0; void* qkv1;
  float* work;                  // f32: the t1 | h | u scratch, per token;
                                // bf16: h (tokens, hid) where the plan
                                // keeps it in global memory, else null
  const void* wcv1; const float* bcv1;
  const void* wcv2; const float* bcv2;
  const ABlockWeights* blk;     // device array of 2 * n_stages ABlocks
  int B, H, W, cin, c_, ca, c2, hid, n_stages, area, heads;
  float scale;                  // f32(hd ** -0.5) of the true head width
  int tile;                     // bf16: the token tile (64 or 32)
  int ring;                     // bf16: stages of the weight ring
  int vb, nvb;                  // bf16: a stencil box's rows, boxes a block
                                // (0: the stencil reads through L2)
  // f32: x, ys, the work scratch (boxes of 32 columns x TM rows) and the two
  // qkv buffers (boxes of 32 channels x 64 keys); bf16: x, ys and h in the
  // work scratch (boxes of 64 columns x 64 rows) and the two qkv buffers
  // (boxes of a head x 128 keys)
  CUtensorMap x_map, ys_map, work_map, kv_map[2];
  // bf16: ys by slot (t, a box of 64 columns of one slot), the qkv buffers'
  // q (a head, or 64 channels of a wider one, x 64 rows) and v by image (64
  // channels x vb tokens); f32, heads wider than 64: q (32 channels x TM
  // rows)
  CUtensorMap slot_map, q_map[2], v_map[2];
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

struct DeviceInfo { int sms; int cooperative; };

inline cudaError_t device_info(DeviceInfo* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&info->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(&info->cooperative,
                                cudaDevAttrCooperativeLaunch, dev);
}

// The two launches (a2c2f_f32.cu, a2c2f_bf16.cu): every pointer of p set,
// the token tile the wrapper chose.
cudaError_t launch_f32(Params& p, int tile, cudaStream_t s,
                       const DeviceInfo& info);
cudaError_t launch_bf16(Params& p, int tile, cudaStream_t s,
                        const DeviceInfo& info);

// The C entry's body (`yolou_a2c2f` below).
inline int entry(const void* x, const void* const* weights, int n_weights,
                 void* out, void* ys, void* qkv, int B, int H, int W, int cin,
                 int c_, int c2, int hid, int n_stages, int area, int heads,
                 int dtype, const void* blocks, void* work, int ca,
                 float scale, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || c2 <= 0 || heads <= 0 ||
      area <= 0 || ca % heads ||
      (ca / heads != 32 && ca / heads % 64) || c_ <= 0 ||
      n_stages < 1 || hid <= 0 || (dtype == 1 && hid % 16) ||
      n_weights != 4 + 20 * n_stages || (H * W) % area ||
      (dtype != 0 && dtype != 1) || blocks == nullptr ||
      (dtype == 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.out = out; p.ys = ys;
  const size_t elt = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  p.qkv0 = qkv;
  p.qkv1 = static_cast<char*>(qkv) + elt * (size_t)B * H * W * 3 * ca;
  p.work = static_cast<float*>(work);
  p.wcv1 = weights[0];
  p.bcv1 = static_cast<const float*>(weights[1]);
  p.blk = static_cast<const ABlockWeights*>(blocks);
  p.wcv2 = weights[n_weights - 2];
  p.bcv2 = static_cast<const float*>(weights[n_weights - 1]);
  p.B = B; p.H = H; p.W = W; p.cin = cin; p.c_ = c_; p.ca = ca; p.c2 = c2;
  p.hid = hid; p.n_stages = n_stages; p.area = area; p.heads = heads;
  p.scale = scale;
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return (int)e;
  if (!info.cooperative) return (int)cudaErrorNotSupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_f32(p, tile, s, info)
                          : launch_bf16(p, tile, s, info));
}

}  // namespace a2c2f
}  // namespace yolou

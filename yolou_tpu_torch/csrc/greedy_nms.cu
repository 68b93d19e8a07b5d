// Kernel B: greedy NMS keep mask, batched over images.
//
// Replaces yolou_tpu/ops/pallas_nms.py::suppress_greedy_fused (Pallas body
// _nms_kernel). Boxes (B, K, 4) f32 xyxy, each image sorted by descending
// score, valid (B, K) bool -> keep (B, K) bool:
//   hit[j, i] = j < i  &&  valid_j  &&  inter > t * (union + 1e-7)
//   keep_i    = valid_i && no kept j < i with hit[j, i]
// The compare is the TPU kernel's division-free form in its operation order,
// with every multiply and add rounded on its own (__fmul_rn / __fadd_rn), so
// nvcc cannot contract them into FMAs and move a keep-set at the threshold.
//
// What bounds it on the H100: K = 512 candidates per image give K^2/2 box
// pairs of about 10 flop each and K*16 B in plus K^2/8 B of bitmask, both
// small; the cost is the sequential scan, K dependent steps per image, so
// latency bounds it.
//
// Design:
//  * pass 1, grid (K/64 column blocks, K/64 row blocks, B): a CTA stages 64
//    column boxes in shared memory and each of its 64 threads builds the
//    64-bit hit word of one row against them; column blocks left of the row
//    block are all zero (j < i) and are written without work;
//  * pass 2, one warp per image: lane w holds word w of the removed bitset
//    and of the valid bitset in registers (K <= 2048 -> 32 words), so each
//    step j is two shuffles, and only a kept row reads its hit words;
//  * K need not be a multiple of 64: columns and rows past K are masked,
//    which is the same as the TPU kernel's padding with invalid rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 64;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BLK)
nms_hit_kernel(const float* __restrict__ boxes, const bool* __restrict__ valid,
               unsigned long long* __restrict__ hit, int K, int words,
               float t) {
  __shared__ float cb[BLK][4];
  __shared__ float ca[BLK];
  const int b = blockIdx.z, rb = blockIdx.y, cbk = blockIdx.x;
  const float* bx = boxes + (size_t)b * K * 4;
  const int col = cbk * BLK + threadIdx.x;
  if (col < K) {
    const float x1 = bx[col * 4 + 0], y1 = bx[col * 4 + 1];
    const float x2 = bx[col * 4 + 2], y2 = bx[col * 4 + 3];
    cb[threadIdx.x][0] = x1;
    cb[threadIdx.x][1] = y1;
    cb[threadIdx.x][2] = x2;
    cb[threadIdx.x][3] = y2;
    ca[threadIdx.x] = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
  }
  __syncthreads();
  const int row = rb * BLK + threadIdx.x;
  if (row >= K) return;
  unsigned long long bits = 0ull;
  if (cbk >= rb && valid[(size_t)b * K + row]) {
    const float x1 = bx[row * 4 + 0], y1 = bx[row * 4 + 1];
    const float x2 = bx[row * 4 + 2], y2 = bx[row * 4 + 3];
    const float area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    const int i0 = (cbk == rb) ? threadIdx.x + 1 : 0;
    const int i1 = min(BLK, K - cbk * BLK);
    for (int i = i0; i < i1; ++i) {
      const float iw = fmaxf(__fsub_rn(fminf(x2, cb[i][2]), fmaxf(x1, cb[i][0])), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(y2, cb[i][3]), fmaxf(y1, cb[i][1])), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area, ca[i]), inter);
      if (inter > __fmul_rn(t, __fadd_rn(uni, 1e-7f))) bits |= 1ull << i;
    }
  }
  hit[((size_t)b * K + row) * words + cbk] = bits;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const bool* __restrict__ valid,
                const unsigned long long* __restrict__ hit,
                bool* __restrict__ keep, int K, int words) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const bool* vb = valid + (size_t)b * K;
  const unsigned long long* hb = hit + (size_t)b * K * words;
  unsigned long long vbits = 0ull, removed = 0ull, kept = 0ull;
  for (int i = 0; i < BLK; ++i) {
    const int j = lane * BLK + i;
    if (lane < words && j < K && vb[j]) vbits |= 1ull << i;
  }
  for (int j = 0; j < K; ++j) {
    const int wj = j >> 6;
    const unsigned long long r = __shfl_sync(FULL, removed, wj);
    const unsigned long long v = __shfl_sync(FULL, vbits, wj);
    if (((v & ~r) >> (j & 63)) & 1ull) {          // warp-uniform
      if (lane < words) removed |= hb[(size_t)j * words + lane];
      if (lane == wj) kept |= 1ull << (j & 63);
    }
  }
  for (int i = 0; i < BLK; ++i) {
    const int j = lane * BLK + i;
    if (lane < words && j < K) keep[(size_t)b * K + j] = (kept >> i) & 1ull;
  }
}

}  // namespace

// boxes (B, K, 4) f32, valid (B, K) bool, hit scratch (B, K, ceil(K/64))
// 64-bit words, keep (B, K) bool out. Returns the launch status.
extern "C" int yolou_greedy_nms(const void* boxes, const void* valid,
                                void* hit, void* keep, int B, int K,
                                float iou_thres, void* stream) {
  const int words = (K + BLK - 1) / BLK;
  if (B <= 0 || K <= 0 || words > 32 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(words, words, B);
  nms_hit_kernel<<<grid, BLK, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const bool*>(valid),
      static_cast<unsigned long long*>(hit), K, words, iou_thres);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_scan_kernel<<<B, 32, 0, s>>>(
      static_cast<const bool*>(valid),
      static_cast<const unsigned long long*>(hit), static_cast<bool*>(keep),
      K, words);
  return (int)cudaGetLastError();
}

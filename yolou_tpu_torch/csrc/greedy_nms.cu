// Kernel B: greedy NMS keep mask, batched over images, in one launch.
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
// What bounds it on the H100: the work is one IoU test of each kept box
// against every later candidate, some 16 f32 operations each, on 16 B a box
// read once: microseconds of either. What costs is the order: greedy NMS is
// a chain of decisions, and a step that waits on the one before pays a
// barrier.
//
// Design: one CTA of 16 warps per image, no global scratch. The image's
// boxes, their areas and the valid, removed and kept bitsets sit in shared
// memory. The loop goes over windows of 64 rows (one 64-bit word of the
// bitsets) instead of over single rows, so its length is at most K / 64
// whether an image keeps 30 rows or 400:
//  1. one warp finds the next word that holds a candidate (valid and not
//     removed) by a ballot over the words: the window and its members;
//  2. all warps test the members against each other (member p < i against
//     member i), each warp's __ballot_sync giving 32 bits of the hit mask
//     of one member;
//  3. one warp decides the window in row order from those masks in
//     registers: member p is kept iff no kept member before it hits it,
//     which is the greedy rule, since every earlier row outside the window
//     is decided and its hits are already in `removed`;
//  4. all threads test every later row against the window's kept members,
//     and each warp's __ballot_sync of the hits is one 32-bit word ORed
//     into `removed`.
// Rows past K are invalid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 2048;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int WORDS = MAX_K / 32;    // 32-bit words of a bitset
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ u64 word64(const unsigned* bits, int w) {
  return (u64)bits[2 * w] | ((u64)bits[2 * w + 1] << 32);
}

// Does box r (area ra), the earlier row, hit box c (area ca)?
__device__ __forceinline__ bool overlaps(float4 r, float ra, float4 c,
                                         float ca, float t) {
  const float iw = fmaxf(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ra, ca), inter);
  return inter > __fmul_rn(t, __fadd_rn(uni, 1e-7f));
}

__global__ void __launch_bounds__(THREADS)
greedy_nms_kernel(const float* __restrict__ boxes,
                  const bool* __restrict__ valid, bool* __restrict__ keep,
                  int K, float t) {
  __shared__ float4 box[MAX_K];
  __shared__ float area[MAX_K];
  __shared__ unsigned valid_bits[WORDS], removed[WORDS], kept[WORDS];
  __shared__ unsigned hits[128];     // member i: 64-bit mask of its hitters
  __shared__ int s_word;
  __shared__ u64 s_members, s_kept;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* bx = boxes + (size_t)b * K * 4;
  const bool* vb = valid + (size_t)b * K;
  const int words = (K + 63) / 64;   // 64-bit words that hold a row < K

  for (int i = tid; i < 64 * words; i += THREADS) {
    const bool v = i < K && vb[i];
    const unsigned ballot = __ballot_sync(FULL, v);
    if (i < K) {
      const float x1 = bx[4 * i], y1 = bx[4 * i + 1];
      const float x2 = bx[4 * i + 2], y2 = bx[4 * i + 3];
      box[i] = make_float4(x1, y1, x2, y2);
      area[i] = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    }
    if (lane == 0) {
      valid_bits[i >> 5] = ballot;
      removed[i >> 5] = 0u;
      kept[i >> 5] = 0u;
    }
  }
  __syncthreads();

  for (int w0 = 0;;) {
    // 1. the next window with a candidate
    if (warp == 0) {
      const u64 cand = lane >= w0 && lane < words
                           ? word64(valid_bits, lane) & ~word64(removed, lane)
                           : 0ull;
      const unsigned any = __ballot_sync(FULL, cand != 0ull);
      const int w = any ? __ffs(any) - 1 : 0;
      const u64 members = __shfl_sync(FULL, cand, w);
      if (lane == 0) {
        s_word = any ? w : -1;
        s_members = members;
      }
    }
    __syncthreads();
    const int w = s_word;
    if (w < 0) break;                // block-uniform
    const u64 members = s_members;
    const int base = 64 * w;

    // 2. hits among the members: task (i, half) -> bits p = 32 half + lane
    for (int task = warp; task < 128; task += WARPS) {
      const int i = task >> 1, p = 32 * (task & 1) + lane;
      bool hit = false;
      if (p < i && ((members >> i) & (members >> p) & 1ull))
        hit = overlaps(box[base + p], area[base + p], box[base + i],
                       area[base + i], t);
      const unsigned word = __ballot_sync(FULL, hit);
      if (lane == 0) hits[task] = word;
    }
    __syncthreads();

    // 3. the window's greedy decisions, in row order
    if (warp == 0) {
      u64 kmask = 0ull;
#pragma unroll
      for (int p = 0; p < 64; ++p) {
        const u64 h = (u64)hits[2 * p] | ((u64)hits[2 * p + 1] << 32);
        if (((members >> p) & 1ull) && !(h & kmask)) kmask |= 1ull << p;
      }
      if (lane == 0) {
        s_kept = kmask;
        kept[2 * w] = (unsigned)kmask;
        kept[2 * w + 1] = (unsigned)(kmask >> 32);
      }
    }
    __syncthreads();
    const u64 kmask = s_kept;

    // 4. later rows against the window's kept members
    for (int rbase = base + 64; rbase < K; rbase += THREADS) {
      const int i = rbase + tid;
      bool hit = false;
      // a candidate still (this warp's own word of `removed`)
      if (i < K && ((valid_bits[i >> 5] & ~removed[i >> 5]) >> (i & 31) & 1u)) {
        const float4 c = box[i];
        const float ca = area[i];
        for (u64 m = kmask; m && !hit; m &= m - 1) {
          const int p = base + __ffsll((long long)m) - 1;
          hit = overlaps(box[p], area[p], c, ca, t);
        }
      }
      const unsigned word = __ballot_sync(FULL, hit);
      if (lane == 0 && word) removed[(rbase >> 5) + warp] |= word;
    }
    w0 = w + 1;
    __syncthreads();                 // removed complete; s_* read
  }

  for (int i = tid; i < K; i += THREADS)
    keep[(size_t)b * K + i] = (kept[i >> 5] >> (i & 31)) & 1u;
}

}  // namespace

// boxes (B, K, 4) f32, valid (B, K) bool, keep (B, K) bool out; K <= 2048.
// Returns the launch status.
extern "C" int yolou_greedy_nms(const void* boxes, const void* valid,
                                void* keep, int B, int K, float iou_thres,
                                void* stream) {
  if (B <= 0 || K <= 0 || K > MAX_K) return (int)cudaErrorInvalidValue;
  greedy_nms_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const bool*>(valid),
      static_cast<bool*>(keep), K, iou_thres);
  return (int)cudaGetLastError();
}

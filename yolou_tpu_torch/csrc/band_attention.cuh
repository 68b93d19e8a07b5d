// Device functions shared by the band attention kernels (band_attention.cu)
// and the whole-A2C2f kernel (a2c2f.cu): type conversion, warp reductions,
// key/value padding and the per-head attention of a slice of query rows
// against a band's keys and values held in shared memory, whole or (the
// streamed form, f32, which a2c2f.cu's long bands take) a tile of keys at a
// time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace yolou {

constexpr int HD = 32;        // head dim (YOLOv12 heads are 32 wide)
constexpr int WARPS = 8;      // warps per CTA of every kernel that attends
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Padded key columns / value rows [N, Np): finite, masked in `attend`.
// Kt is [HD][ldk] (keys transposed, row stride ldk >= Np), Vs is [Np][HD].
template <typename T>
__device__ __forceinline__ void pad_keys(T* Kt, T* Vs, int N, int Np, int ldk) {
  for (int i = threadIdx.x; i < (Np - N) * HD; i += blockDim.x) {
    const int m = N + i / HD, d = i % HD;
    Kt[d * ldk + m] = from_f<T>(0.f);
    Vs[m * HD + d] = from_f<T>(0.f);
  }
}

// Attention of query rows [q0, q1) of one head (Qs [q1 - q0][HD]) against
// all N keys (Kt [HD][ldk], Vs [ceil32(N)][HD]): warp per pair of query
// rows, online softmax over key tiles of 32. With ROUND_P the unnormalised
// probabilities are rounded to T before p.v (the row sum keeps them in
// f32), as the TPU kernels that take q, k and v do. Row q0 + r, channel d
// of the result goes to o[(row0 + q0 + r) * row_stride + (col0 + d) *
// ch_stride] as TO. Keep the base pointer with the index computed at the
// store, and the loop bound written as q0 + r < q1: when the caller offsets
// the pointer and passes a row count instead, nvcc 12.8 schedules the
// key-tile loop of its caller 10-18 % slower (measured on an H100).
template <typename T, bool ROUND_P, typename TO>
__device__ __forceinline__ void attend(const T* Qs, const T* Kt, const T* Vs,
                                       TO* __restrict__ o, size_t row0,
                                       int col0, int row_stride,
                                       int ch_stride, int N, int ldk, int q0,
                                       int q1, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 2 * warp; q0 + r < q1; r += 2 * WARPS) {
    const bool two = q0 + r + 1 < q1;       // warp-uniform
    float qa[HD], qb[HD];
    const float qna = to_f(Qs[r * HD + lane]);
    const float qnb = two ? to_f(Qs[(r + 1) * HD + lane]) : qna;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qa[d] = __shfl_sync(FULL, qna, d);
      qb[d] = __shfl_sync(FULL, qnb, d);
    }
    float ma = -INFINITY, la = 0.f, acca = 0.f;   // acc: channel lane
    float mb = -INFINITY, lb = 0.f, accb = 0.f;
    for (int m0 = 0; m0 < N; m0 += 32) {
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float kd = to_f(Kt[d * ldk + m0 + lane]);
        sa = fmaf(qa[d], kd, sa);
        sb = fmaf(qb[d], kd, sb);
      }
      const bool valid = m0 + lane < N;
      sa = valid ? sa * scale : -INFINITY;
      sb = valid ? sb * scale : -INFINITY;
      const float na = fmaxf(ma, warp_max(sa));  // finite: key m0 exists
      const float nb = fmaxf(mb, warp_max(sb));
      float pa = expf(sa - na), pb = expf(sb - nb);
      const float ca = expf(ma - na), cb = expf(mb - nb);
      la = la * ca + warp_sum(pa);
      lb = lb * cb + warp_sum(pb);
      if (ROUND_P) {
        pa = to_f(from_f<T>(pa));
        pb = to_f(from_f<T>(pb));
      }
      acca *= ca;
      accb *= cb;
      const T* vt = Vs + m0 * HD + lane;
      if (m0 + 32 <= N) {                   // full tile: unrolled
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float vj = to_f(vt[j * HD]);
          acca = fmaf(__shfl_sync(FULL, pa, j), vj, acca);
          accb = fmaf(__shfl_sync(FULL, pb, j), vj, accb);
        }
      } else {
        for (int j = 0; j < N - m0; ++j) {
          const float vj = to_f(vt[j * HD]);
          acca = fmaf(__shfl_sync(FULL, pa, j), vj, acca);
          accb = fmaf(__shfl_sync(FULL, pb, j), vj, accb);
        }
      }
      ma = na;
      mb = nb;
    }
    const size_t row = row0 + q0 + r;
    o[row * row_stride + (col0 + lane) * ch_stride] = from_f<TO>(acca / la);
    if (two)
      o[(row + 1) * row_stride + (col0 + lane) * ch_stride] =
          from_f<TO>(accb / lb);
  }
}

// The online-softmax state of a warp's pair of query rows a and b in the
// streamed form of `attend`: running maxima, row sums, and the accumulator
// of channel `lane`.
struct PairState {
  float ma, la, acca, mb, lb, accb;
};

__device__ __forceinline__ void pair_init(PairState& s) {
  s.ma = s.mb = -INFINITY;
  s.la = s.lb = s.acca = s.accb = 0.f;
}

// The streamed form of `attend` (f32, probabilities not rounded): a warp's
// pair of query rows (qa, qb: their HD channels, in registers) against the
// keys k0 .. k0 + count - 1 of a band of N (count a multiple of 32 or
// reaching N), held row-major in Kr ([count][HD + 1]: lane j reading key
// j's channel d hits bank (j + d) % 32) and Vr ([count][HD]), in `attend`'s
// steps of 32 keys with its arithmetic; the state carries over to the next
// tile, and row a's result is s.acca / s.la at the end.
__device__ __forceinline__ void attend_pair_tile(const float (&qa)[HD],
                                                 const float (&qb)[HD],
                                                 const float* Kr,
                                                 const float* Vr, int k0,
                                                 int count, int N,
                                                 float scale, PairState& s) {
  const int lane = threadIdx.x & 31;
  for (int m = 0; m < count && k0 + m < N; m += 32) {
    const int m0 = k0 + m;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float kd = Kr[(m + lane) * (HD + 1) + d];
      sa = fmaf(qa[d], kd, sa);
      sb = fmaf(qb[d], kd, sb);
    }
    const bool valid = m0 + lane < N;
    sa = valid ? sa * scale : -INFINITY;
    sb = valid ? sb * scale : -INFINITY;
    const float na = fmaxf(s.ma, warp_max(sa));  // finite: key m0 exists
    const float nb = fmaxf(s.mb, warp_max(sb));
    const float pa = expf(sa - na), pb = expf(sb - nb);
    const float ca = expf(s.ma - na), cb = expf(s.mb - nb);
    s.la = s.la * ca + warp_sum(pa);
    s.lb = s.lb * cb + warp_sum(pb);
    s.acca *= ca;
    s.accb *= cb;
    const float* vt = Vr + m * HD + lane;
    if (m0 + 32 <= N) {                        // full step: unrolled
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float vj = vt[j * HD];
        s.acca = fmaf(__shfl_sync(FULL, pa, j), vj, s.acca);
        s.accb = fmaf(__shfl_sync(FULL, pb, j), vj, s.accb);
      }
    } else {
      for (int j = 0; j < N - m0; ++j) {
        const float vj = vt[j * HD];
        s.acca = fmaf(__shfl_sync(FULL, pa, j), vj, s.acca);
        s.accb = fmaf(__shfl_sync(FULL, pb, j), vj, s.accb);
      }
    }
    s.ma = na;
    s.mb = nb;
  }
}

const float ATTN_SCALE = (float)(1.0 / sqrt((double)HD));  // f32(hd ** -0.5)

}  // namespace yolou

// Multi-head band softmax attention, two entry points over one core.
//
// Kernel A (eval): folded qkv projection + attention. Replaces
// yolou_tpu/ops/pallas_attn.py::area_attention_qkv_fused (Pallas body
// _qkv_attn_kernel). For every band g and head h:
//   qkv = x[g] . w[:, role*C + h*32 + d] + b   (f32 accumulate, rounded to T)
//   o[g, :, h*32 + d] = softmax(q k^T / sqrt(32)) v      (f32 softmax)
// and the value projection v is written out too (it feeds the dw7x7 conv).
//
// Kernel C (training forward): attention over given q, k, v (G, N, C),
// head-major channels. Replaces area_attention_fused (body _fused_kernel)
// and, with one head, area_attention (body _attn_kernel) of the same file.
// Scores and softmax in f32, the unnormalised probabilities rounded to the
// I/O type before p.v, f32 accumulation, normalisation after the product,
// as the TPU kernel does. Its head-mask full-width products feed the TPU's
// matrix unit and are no part of the function; they are not carried over.
// It is the same program as kernel A with the projection stage replaced by
// a load of this CTA's token slice; see the design below.
//
// What bounds it on the H100: at YOLOv12n's shapes (N = 400 tokens, C = 64
// or 128, 2-4 heads) the work is small — about 2*N*C*96 + 4*N*N*32 flop per
// (band, head), 21 MFLOP at N = 400, C = 64 — and there are few (band, head)
// pairs (64 for layer 6 at batch 8, 32 for layer 8), so the kernel is bound
// by latency and by how many SMs it keeps busy, not by HBM bytes (x is read
// once, o and v written once) or by tensor-core rate.
//
// Design (simple and exact first; wgmma/TMA tiling is later work):
//  * one thread-block cluster per (head, band), of S CTAs (S <= 8, about two
//    CTAs per SM over the grid); CTA z owns the token slice
//    [z*R, (z+1)*R): it projects q, k and v for those tokens only, then the
//    CTAs of the cluster copy each other's k and v slices through
//    distributed shared memory, so every CTA holds k and v for all N tokens
//    and q for its own rows — q, k, v never touch HBM, which is the point of
//    the fused TPU kernel, and no projection is computed twice;
//  * projection: one warp per 4 tokens, lane d computes q/k/v channel d (each
//    weight read from shared memory serves the 4 tokens), x is read
//    coalesced and broadcast with shuffles;
//  * attention: one warp per pair of query rows (each key and value read
//    from shared memory serves both), online softmax over key tiles of 32
//    (lane j scores key j of the tile against K^T, conflict-free); the
//    ragged last tile is masked, so any N >= 1 works (N = 25 at 160^2);
//  * in kernel A probabilities stay f32 into the P.V product (the TPU
//    kernel rounds the unnormalised exp to bf16 first; both are the same
//    function within bf16 rounding); kernel C rounds them as the TPU
//    training kernel does, so that its backward (an f32 recompute in plain
//    tensor code, as in the JAX package) sees the forward it had there;
//  * kernel C moves 4*G*N*C elements (q, k, v in, o out) for 4*N*N*32 flop
//    per (band, head): at (32, 400, 64) bf16 that is 6.6 MB and 1.3 GFLOP,
//    about 2 us of HBM time against 1.3 us of tensor-core time, so its bound
//    is bytes; the design reads each q, k, v element from HBM once (the
//    cluster exchange) and is, like kernel A, far from that bound because
//    its products run on the f32 FMA pipes, not the tensor cores.
// Shared memory per CTA: sizeof(T) * (96*C + 32*R + 64*ceil32(N)) bytes for
// R query rows in kernel A, without the 96*C weights in kernel C; the
// wrapper refuses a band whose bound (R = N) passes the 227 KB a block may
// use.

#include <cooperative_groups.h>

#include "band_attention.cuh"

namespace cg = cooperative_groups;
using namespace yolou;

namespace {

constexpr int TOK = 4;        // tokens per warp in the projection
constexpr int MAX_CLUSTER = 8;  // portable thread-block cluster size

// Copy the other CTAs' k and v token slices through distributed shared
// memory, so that this CTA holds k and v for all N tokens. Every CTA of the
// cluster calls it after its own slice is in its Kt / Vs.
template <typename T>
__device__ __forceinline__ void gather_slices(cg::cluster_group& cluster,
                                              T* Kt, T* Vs, int N, int Np,
                                              int R, int S, int rank) {
  cluster.sync();                           // every slice is in place
  for (int r = 0; r < S; ++r) {
    if (r == rank) continue;
    const int m0 = r * R, m1 = min(N, m0 + R), len = m1 - m0;
    if (len <= 0) continue;
    const T* rK = cluster.map_shared_rank(Kt, r);
    const T* rV = cluster.map_shared_rank(Vs, r);
    for (int i = threadIdx.x; i < len * HD; i += blockDim.x) {
      Vs[m0 * HD + i] = rV[m0 * HD + i];
      const int d = i / len, m = m0 + i % len;
      Kt[d * Np + m] = rK[d * Np + m];
    }
  }
  cluster.sync();                           // no CTA reads a peer after this
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
band_attention_qkv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ o,
                          T* __restrict__ v_out, int N, int C, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, g = blockIdx.y;
  const int S = gridDim.z, rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Np = (N + 31) & ~31;
  const int R = (N + S - 1) / S;            // tokens (and query rows) per CTA
  const int q0 = rank * R, q1 = min(N, q0 + R);
  T* Ws = reinterpret_cast<T*>(smem_raw);   // [C][3*HD]: q | k | v columns
  T* Qs = Ws + C * 3 * HD;                  // [R][HD]: this slice's queries
  T* Kt = Qs + R * HD;                      // [HD][Np]  (keys transposed)
  T* Vs = Kt + HD * Np;                     // [Np][HD]

  for (int i = threadIdx.x; i < C * 3 * HD; i += blockDim.x) {
    const int c = i / (3 * HD), j = i % (3 * HD);
    Ws[i] = w[(size_t)c * 3 * C + (j / HD) * C + h * HD + (j % HD)];
  }
  pad_keys(Kt, Vs, N, Np, Np);
  __syncthreads();

  // --- projection of this CTA's tokens: warp per TOK tokens, lane = d -----
  const T* xg = x + (size_t)g * N * C;
  const float bq = bias[h * HD + lane];
  const float bk = bias[C + h * HD + lane];
  const float bv = bias[2 * C + h * HD + lane];
  for (int n0 = q0 + warp * TOK; n0 < q1; n0 += WARPS * TOK) {
    float aq[TOK], ak[TOK], av[TOK];
#pragma unroll
    for (int t = 0; t < TOK; ++t) aq[t] = ak[t] = av[t] = 0.f;
    for (int c0 = 0; c0 < C; c0 += 32) {   // C is a multiple of 32
      float xl[TOK];
#pragma unroll
      for (int t = 0; t < TOK; ++t)
        xl[t] = n0 + t < q1 ? to_f(xg[(size_t)(n0 + t) * C + c0 + lane]) : 0.f;
      for (int cc = 0; cc < 32; ++cc) {
        const T* wr = Ws + (c0 + cc) * 3 * HD;
        const float wq = to_f(wr[lane]), wk = to_f(wr[HD + lane]);
        const float wv = to_f(wr[2 * HD + lane]);
#pragma unroll
        for (int t = 0; t < TOK; ++t) {
          const float xc = __shfl_sync(FULL, xl[t], cc);
          aq[t] = fmaf(xc, wq, aq[t]);
          ak[t] = fmaf(xc, wk, ak[t]);
          av[t] = fmaf(xc, wv, av[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      const int n = n0 + t;
      if (n >= q1) break;                   // warp-uniform
      const T v = from_f<T>(av[t] + bv);
      Kt[lane * Np + n] = from_f<T>(ak[t] + bk);
      Vs[n * HD + lane] = v;
      Qs[(n - q0) * HD + lane] = from_f<T>(aq[t] + bq);
      v_out[((size_t)g * N + n) * C + h * HD + lane] = v;
    }
  }

  gather_slices(cluster, Kt, Vs, N, Np, R, S, rank);
    attend<T, false>(Qs, Kt, Vs, o, (size_t)g * N, h * HD, C, 1, N, Np, q0, q1,
                    scale);
}

// Kernel C: the same cluster layout without the projection. CTA `rank`
// loads q, k and v of its token slice for head h (a warp per token, lane =
// channel, so each global read is one 64 or 128 byte row segment), then the
// slices are exchanged and the rows attended as in kernel A.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
band_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int N, int C,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, g = blockIdx.y;
  const int S = gridDim.z, rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Np = (N + 31) & ~31;
  const int R = (N + S - 1) / S;
  const int q0 = rank * R, q1 = min(N, q0 + R);
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [R][HD]
  T* Kt = Qs + R * HD;                      // [HD][Np]
  T* Vs = Kt + HD * Np;                     // [Np][HD]

  pad_keys(Kt, Vs, N, Np, Np);
  for (int n = q0 + warp; n < q1; n += WARPS) {
    const size_t off = ((size_t)g * N + n) * C + h * HD + lane;
    Qs[(n - q0) * HD + lane] = q[off];
    Kt[lane * Np + n] = k[off];
    Vs[n * HD + lane] = v[off];
  }
  gather_slices(cluster, Kt, Vs, N, Np, R, S, rank);
    attend<T, true>(Qs, Kt, Vs, o, (size_t)g * N, h * HD, C, 1, N, Np, q0, q1,
                    scale);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// CTAs per (head, band): about two per SM over the grid, at most one per 32
// tokens and at most the portable cluster size.
int cluster_splits(int G, int heads, int N) {
  const int Np = (N + 31) & ~31, pairs = G * heads;
  return max(1, min(min((2 * sm_count() + pairs - 1) / pairs, Np / 32),
                    MAX_CLUSTER));
}

// Launch `kernel` on a (heads, G, splits) grid of clusters of `splits` CTAs.
template <typename K, typename... Args>
cudaError_t launch_clusters(K kernel, int G, int heads, int splits,
                            size_t smem, cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads, G, splits);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qkv(const void* x, const void* w, const void* b, void* o,
                       void* v, int G, int N, int C, int heads,
                       cudaStream_t s) {
  const int Np = (N + 31) & ~31;
  const int splits = cluster_splits(G, heads, N);
  const int R = (N + splits - 1) / splits;
  const size_t smem = sizeof(T) * ((size_t)3 * HD * C + (size_t)HD * R +
                                   (size_t)2 * HD * Np);
  return launch_clusters(band_attention_qkv_kernel<T>, G, heads, splits, smem,
                         s, static_cast<const T*>(x),
                         static_cast<const T*>(w),
                         static_cast<const float*>(b), static_cast<T*>(o),
                         static_cast<T*>(v), N, C, ATTN_SCALE);
}

template <typename T>
cudaError_t launch_attn(const void* q, const void* k, const void* v, void* o,
                        int G, int N, int C, int heads, cudaStream_t s) {
  const int Np = (N + 31) & ~31;
  const int splits = cluster_splits(G, heads, N);
  const int R = (N + splits - 1) / splits;
  const size_t smem = sizeof(T) * ((size_t)HD * R + (size_t)2 * HD * Np);
  return launch_clusters(band_attention_kernel<T>, G, heads, splits, smem, s,
                         static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<T*>(o), N, C,
                         ATTN_SCALE);
}

}  // namespace

// x, o, v: (G, N, C) of the I/O type; w: (C, 3C) of the I/O type; b: (3C,)
// f32. dtype 0 = float32, 1 = bfloat16. Returns the launch status.
extern "C" int yolou_band_attention_qkv(const void* x, const void* w,
                                        const void* b, void* o, void* v, int G,
                                        int N, int C, int heads, int dtype,
                                        void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || C != heads * HD || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_qkv<float>(x, w, b, o, v, G, N, C, heads, s);
  if (dtype == 1)
    return (int)launch_qkv<__nv_bfloat16>(x, w, b, o, v, G, N, C, heads, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, o: (G, N, C) of the I/O type, head-major channels, C = heads * 32.
// dtype 0 = float32, 1 = bfloat16. Returns the launch status.
extern "C" int yolou_band_attention(const void* q, const void* k,
                                    const void* v, void* o, int G, int N,
                                    int C, int heads, int dtype,
                                    void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || C != heads * HD || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_attn<float>(q, k, v, o, G, N, C, heads, s);
  if (dtype == 1)
    return (int)launch_attn<__nv_bfloat16>(q, k, v, o, G, N, C, heads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* yolou_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

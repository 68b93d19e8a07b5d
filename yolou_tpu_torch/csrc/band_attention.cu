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
// Its head-mask full-width products feed the TPU's matrix unit and are no
// part of the function; they are not carried over.
//
// Numerics, both kernels and both types: scores, running maximum and row
// sum in f32; the unnormalised probabilities rounded to T before p.v (the
// row sum keeps them unrounded), f32 accumulation, the division by the row
// sum after the product, as the TPU kernels do, there against the full
// row's maximum, here against the online softmax's running one. (In f32 the
// rounding is the identity; in kernel A's f32 SIMT path probabilities stay
// f32.)
//
// What bounds it on the H100: at YOLOv12n's shapes (N = 400 tokens, C = 64
// or 128, 2-4 heads) the work is small: 2*N*C*96 + 4*N*N*32 flop per (band,
// head), 21 MFLOP at N = 400, C = 64, and at (32, 400, 64) bf16 kernel C
// moves 6.6 MB for 1.3 GFLOP, about 2 us of HBM time against 1.3 us of
// tensor-core time. Neither is what the kernel waits on: there are few
// (band, head) pairs (64 for layer 6 at batch 8, 32 for layer 8), so it is
// bound by latency (loads into shared memory, the dependent chain of each
// online-softmax step, the exp unit) and by how many warps it keeps busy.
//
// bf16, the serving and training type, runs on the tensor cores
// (attention_mma.cuh): 8 warps a CTA, a warp per 16-row query tile whose q
// stays in registers as A fragments; mma.sync m16n8k16 for q.k^T, x.w and
// p.v with f32 accumulation, B operands from shared memory by ldmatrix
// (k and v rows with XOR-swizzled 16-byte chunks against bank conflicts);
// the online softmax works on the accumulator fragments, and the score
// fragments become p.v's A operand in registers. Per (head, band) S CTAs of
// `tiles` query tiles, at least one warp a tile. Any N >= 1: keys >= N are
// masked, padded key and value rows are zero, padded query rows are not
// stored.
//  * Kernel A: the S CTAs are one thread-block cluster (S <= 8, so N <=
//    1024), the largest whose clusters the card runs all at once (at layer
//    6, 64 clusters of 4 do not quite fit; the occupancy query says so). A
//    CTA stages its head's (C, 96) weight columns by cp.async,
//    each warp reads its tile of x from global memory into A fragments,
//    projects q, k and v, and writes k and v rows to shared memory; the
//    CTAs then copy each other's k and v rows through distributed shared
//    memory, so every CTA holds k and v for all N tokens. q, k, v never
//    touch HBM, which is the point of the fused TPU kernel, and no
//    projection is computed twice. Shared memory per CTA: 2 * (104 * C +
//    64 * ceil16(N)) bytes.
//  * Kernel C: no cluster, as many CTAs as the card runs at once. Each CTA
//    loads all k and v rows of its (head, band) by cp.async while its warps
//    read their q tiles into registers: a few L2 reads of the band's k and
//    v instead of two cluster barriers and an exchange. Shared memory per
//    CTA: 128 * ceil16(N) bytes.
//
// f32 keeps the SIMT path (band_attention.cuh `attend`; TF32 would not
// hold the f32 tolerances): one cluster per (head, band) whose CTAs each
// project (kernel A) or load (kernel C) q, k, v for a slice of R tokens and
// exchange k and v as above; 8 warps a CTA, a warp per pair of query rows,
// online softmax over key tiles of 32 with lane j scoring key j against
// K^T; the projection a warp per 4 tokens, lane d computing channel d.
// Shared memory per CTA: 4 * (96*C + 32*R + 64*ceil32(N)) bytes in kernel
// A, without the 96*C weights in kernel C.
// The wrapper refuses a band whose shared memory (f32: its bound, R = N)
// passes the 227 KB a block may use.

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <utility>

#include "attention_mma.cuh"
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

// ------------------------------------------------- bf16 on tensor cores

using bf16 = __nv_bfloat16;
constexpr int LDW = 3 * HD + 8;   // row stride of the staged [C][96] weights
// keys per online-softmax step, each the faster on an H100 at the serving
// and training shapes (time_builds, PERF.md)
constexpr int KT_QKV = 32, KT_ATTN = 64;

// Kernel A, bf16. CTA `rank` of the cluster owns query tiles [rank * tiles,
// (rank + 1) * tiles), a warp each. The head's weight columns ([C][96])
// arrive by cp.async; each warp reads the A fragments of its 16 tokens of x
// straight from global memory, projects q, k and v on the tensor cores,
// adds the f32 bias and rounds to bf16; q stays in registers as the A
// fragments of q.k^T, k and v go to Ks / Vs (zero past N), v also to v_out.
// The cluster then exchanges k and v and every warp attends its tile.
__global__ void __launch_bounds__(MMA_WARPS * 32)
band_attention_qkv_mma_kernel(const bf16* __restrict__ x,
                              const bf16* __restrict__ w,
                              const float* __restrict__ bias,
                              bf16* __restrict__ o, bf16* __restrict__ v_out,
                              int N, int C, int tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x, g = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int Np = (N + 15) & ~15;
  const int r0 = 16 * (rank * tiles + warp);     // this warp's first row
  const bool active = warp < tiles && r0 < Np;   // warp-uniform
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);  // [C][LDW]: q | k | v cols
  bf16* Ks = Ws + C * LDW;                       // [Np][32], swizzled
  bf16* Vs = Ks + Np * HD;                       // [Np][32], swizzled

  for (int i = threadIdx.x; i < C * 12; i += blockDim.x) {
    const int c = i / 12, j8 = i % 12;            // 8 columns of role j8 / 4
    cp_async16(Ws + c * LDW + 8 * j8,
               w + (size_t)c * 3 * C + (j8 / 4) * C + h * HD + (j8 % 4) * 8,
               true);
  }
  // x rows r0 + gq and r0 + gq + 8 (zero past N), 32 channels a chunk: the
  // A fragments of two k steps, the first chunk read while the weights
  // arrive, each next one while the current one is multiplied
  const int n_lo = r0 + gq, n_hi = n_lo + 8;
  const uint32_t* x_lo = reinterpret_cast<const uint32_t*>(
      x + ((size_t)g * N + min(n_lo, N - 1)) * C);
  const uint32_t* x_hi = reinterpret_cast<const uint32_t*>(
      x + ((size_t)g * N + min(n_hi, N - 1)) * C);
  auto load_x = [&](uint32_t (&a)[2][4], int c0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {                 // k step e / 4, reg e % 4
      const int col = c0 + 16 * (e >> 2) + 8 * ((e >> 1) & 1) + 2 * t;
      const uint32_t* row = e & 1 ? x_hi : x_lo;
      a[e >> 2][e & 3] = (e & 1 ? n_hi : n_lo) < N ? row[col / 2] : 0u;
    }
  };
  uint32_t a[2][4];
  if (active) load_x(a, 0);
  cp_async_wait_all();
  __syncthreads();

  uint32_t qa[2][4];                              // q: A fragments
  if (active) {
    float acc[12][4];                             // 12 tiles of 8 columns
#pragma unroll
    for (int j = 0; j < 12; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      uint32_t a_next[2][4];
      if (c0 + 32 < C) load_x(a_next, c0 + 32);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const bf16* wrow =
            Ws + (c0 + 16 * kk + (lane & 15)) * LDW + (lane >> 4) * 8;
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          uint32_t b[4];
          ldsm_x4_trans(b, wrow + 16 * jj);
          mma_bf16(acc[2 * jj], a[kk], b[0], b[1]);
          mma_bf16(acc[2 * jj + 1], a[kk], b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kk][e] = a_next[kk][e];
    }
    bf16* vg = v_out + (size_t)g * N * C + h * HD;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int role = j / 4, col = 8 * (j % 4) + 2 * t;
      const float b0 = bias[role * C + h * HD + col];
      const float b1 = bias[role * C + h * HD + col + 1];
      const uint32_t lo = pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
      const uint32_t hi = pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
      if (role == 0) {        // rows gq, gq + 8 of channels 8j..: A fragment
        qa[j / 2][2 * (j % 2)] = lo;
        qa[j / 2][2 * (j % 2) + 1] = hi;
        continue;
      }
      bf16* dst = role == 1 ? Ks : Vs;
      *reinterpret_cast<uint32_t*>(dst + kv_at(n_lo, j % 4) + 2 * t) =
          n_lo < N ? lo : 0u;
      *reinterpret_cast<uint32_t*>(dst + kv_at(n_hi, j % 4) + 2 * t) =
          n_hi < N ? hi : 0u;
      if (role == 2 && n_lo < N)
        *reinterpret_cast<uint32_t*>(vg + (size_t)n_lo * C + col) = lo;
      if (role == 2 && n_hi < N)
        *reinterpret_cast<uint32_t*>(vg + (size_t)n_hi * C + col) = hi;
    }
  }

  gather_rows(cluster, Ks, Vs, Np, 16 * tiles, rank);
  if (active && r0 < N)
    attend_tile_mma<KT_QKV>(
        qa, Ks, Vs, N, Np, scale,
        StoreRowsBF16{o + ((size_t)g * N + r0) * C + h * HD, C,
                      min(16, N - r0)});
}

// Kernel C, bf16: no cluster. Each CTA loads all k and v rows of its
// (head, band) by cp.async (zero past N) while each warp reads the A
// fragments of its 16 query rows straight from q, then every warp attends
// its tile.
__global__ void __launch_bounds__(MMA_WARPS * 32)
band_attention_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int N, int C, int tiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int Np = (N + 15) & ~15;
  const int r0 = 16 * (blockIdx.z * tiles + warp);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [Np][32], swizzled
  bf16* Vs = Ks + Np * HD;                       // [Np][32], swizzled
  const size_t base = (size_t)g * N * C + h * HD;

  for (int i = threadIdx.x; i < Np * 4; i += blockDim.x) {
    const int n = i / 4, c8 = 8 * (i % 4);
    const size_t off = base + (size_t)(n < N ? n : 0) * C + c8;
    cp_async16(Ks + kv_at(n, i % 4), k + off, n < N);
    cp_async16(Vs + kv_at(n, i % 4), v + off, n < N);
  }
  uint32_t qa[2][4];
  const bool active = warp < tiles && r0 < N;    // warp-uniform
  if (active) {
    const uint32_t* qg = reinterpret_cast<const uint32_t*>(q + base);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {             // rows gq, gq + 8; cols +0, +8
        const int n = r0 + gq + 8 * (e & 1);
        const int col = 16 * s + 8 * (e >> 1) + 2 * t;
        qa[s][e] = n < N ? qg[((size_t)n * C + col) / 2] : 0u;
      }
  }
  cp_async_wait_all();
  __syncthreads();
  if (active)
    attend_tile_mma<KT_ATTN>(
        qa, Ks, Vs, N, Np, scale,
        StoreRowsBF16{o + ((size_t)g * N + r0) * C + h * HD, C,
                      min(16, N - r0)});
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

// Lets `kernel` use all the dynamic shared memory a block may have (once).
template <auto kernel>
cudaError_t allow_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  return e;
}

// How many CTAs (cluster 0) or clusters of `cluster` CTAs of the 8-warp
// `kernel` with `smem` bytes of shared memory the card runs at once; the
// answers are kept, since a query costs more host time than a launch.
template <auto kernel>
int resident(size_t smem, int cluster) {
  static std::mutex mu;
  static std::map<std::pair<size_t, int>, int> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(smem, cluster);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int n = 0;
  if (cluster == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, MMA_WARPS * 32, smem) != cudaSuccess)
      n = 0;
    n *= sm_count();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, cluster);
    cfg.blockDim = dim3(MMA_WARPS * 32);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = cluster;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) n = 0;
  }
  known[key] = n;
  return n;
}

// The tensor-core kernels give each 16-row query tile a warp: `tiles` per
// CTA (at most MMA_WARPS), `*splits` CTAs per (head, band).
// Kernel C: as many CTAs as the card runs at once, at least one warp a tile.
int attn_tiles(int pairs, int N, int slots, int* splits) {
  const int T = (N + 15) / 16;
  const int S = max(1, min(T, max((T + MMA_WARPS - 1) / MMA_WARPS,
                                  slots / pairs)));
  const int tiles = (T + S - 1) / S;
  *splits = (T + tiles - 1) / tiles;
  return tiles;
}

// Kernel A: a cluster per (head, band); the largest cluster (at most 8)
// whose clusters the card runs all at once, else the smallest that gives
// every tile a warp (0 where none does: more than 8 * 8 tiles).
template <auto kernel>
int qkv_tiles(size_t smem, int pairs, int N, int* splits) {
  const int T = (N + 15) / 16;
  const int lo = (T + MMA_WARPS - 1) / MMA_WARPS, hi = min(T, MAX_CLUSTER);
  if (lo > hi) return 0;
  int S = lo;
  for (int c = hi; c > lo; --c)
    if (resident<kernel>(smem, c) >= pairs) {
      S = c;
      break;
    }
  const int tiles = (T + S - 1) / S;
  *splits = (T + tiles - 1) / tiles;
  return tiles;
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

// f32: the SIMT kernels.
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

// bf16: the tensor-core kernels.
cudaError_t launch_qkv_mma(const void* x, const void* w, const void* b,
                           void* o, void* v, int G, int N, int C, int heads,
                           cudaStream_t s) {
  constexpr auto kernel = band_attention_qkv_mma_kernel;
  const size_t Np = (N + 15) & ~15;
  const size_t smem = sizeof(bf16) * ((size_t)C * LDW + 2 * Np * HD);
  cudaError_t e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  int splits = 1;
  const int tiles = qkv_tiles<kernel>(smem, G * heads, N, &splits);
  if (tiles == 0) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads, G, splits);
  cfg.blockDim = dim3(MMA_WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                         static_cast<const bf16*>(w),
                         static_cast<const float*>(b), static_cast<bf16*>(o),
                         static_cast<bf16*>(v), N, C, tiles, ATTN_SCALE);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_attn_mma(const void* q, const void* k, const void* v,
                            void* o, int G, int N, int C, int heads,
                            cudaStream_t s) {
  constexpr auto kernel = band_attention_mma_kernel;
  const size_t Np = (N + 15) & ~15;
  const size_t smem = sizeof(bf16) * 2 * Np * HD;
  const cudaError_t e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  int splits = 1;
  const int tiles =
      attn_tiles(G * heads, N, resident<kernel>(smem, 0), &splits);
  kernel<<<dim3(heads, G, splits), MMA_WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), N, C, tiles,
      ATTN_SCALE);
  return cudaGetLastError();
}

}  // namespace

// x, o, v: (G, N, C) of the I/O type; w: (C, 3C) of the I/O type; b: (3C,)
// f32. dtype 0 = float32 (SIMT), 1 = bfloat16 (tensor cores; x, w, o and v
// 16-byte aligned). Returns the launch status.
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
    return (int)launch_qkv_mma(x, w, b, o, v, G, N, C, heads, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, o: (G, N, C) of the I/O type, head-major channels, C = heads * 32.
// dtype 0 = float32 (SIMT), 1 = bfloat16 (tensor cores; q, k, v 16-byte
// aligned). Returns the launch status.
extern "C" int yolou_band_attention(const void* q, const void* k,
                                    const void* v, void* o, int G, int N,
                                    int C, int heads, int dtype,
                                    void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || C != heads * HD || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_attn<float>(q, k, v, o, G, N, C, heads, s);
  if (dtype == 1)
    return (int)launch_attn_mma(q, k, v, o, G, N, C, heads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* yolou_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

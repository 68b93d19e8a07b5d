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
// Two paths. The resident one (bf16 only) holds a head's keys and values
// of the whole band in each CTA's shared memory; the streamed one (bf16 and
// f32, at the end of this file) passes them through in key tiles, so its
// shared memory does not grow with N. The wrapper
// (`kernels/attention.py::attention_plan`) sends a bf16 band to the
// resident path where it fits (227 KB; in kernel A one cluster of 8 CTAs,
// N <= 1024) and was the faster of the two on an H100
// (`tools/attention_routes.py`), every other band, and every f32 band, to
// the streamed path, which was the faster at every f32 band kernel A takes.
//
// bf16, the serving and training type, runs on the tensor cores
// (attention_mma.cuh): 8 warps a CTA, a warp per 16-row query tile whose q
// stays in registers as A fragments; mma.sync m16n8k16 for q.k^T, x.w and
// p.v with f32 accumulation, B operands from shared memory by ldmatrix
// (k and v rows with XOR-swizzled 16-byte chunks against bank conflicts);
// the online softmax works on the accumulator fragments, and the score
// fragments become p.v's A operand in registers. On the resident path, per
// (head, band) S CTAs of `tiles` query tiles, at least one warp a tile. Any
// N >= 1: keys >= N are masked, padded key and value rows are zero, padded
// query rows are not stored.
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
// f32 runs on the SIMT streamed kernels (TF32 would not hold the f32
// tolerances): a warp per pair of query rows, online softmax over steps of
// 32 keys with lane j scoring key j (band_attention.cuh
// `attend_pair_tile`); kernel A's projection a warp per 4 tokens, lane d
// computing channel d.

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

// ------------------------------------------------------ the streamed path
//
// Every f32 band, and the bf16 bands the resident path does not hold or
// was the slower on. A CTA owns a run of query rows of one (head, band) and
// streams the band's keys and values through shared memory in tiles of KB
// keys: two buffers filled by cp.async, tile i + 1 landing while tile i is
// scored. The online softmax state stays in registers across tiles, and
// each tile is attended in steps of KT_QKV / KT_ATTN keys in bf16 (the bf16
// resident path's, with its text, so a row's arithmetic is that path's,
// step for step, at any N) and of 32 keys in f32 (`attend`'s).
// Shared memory: bf16 2 * 2 * KB_MMA * 32 * 2 bytes (+ 80 C for kernel A's
// q weight columns), f32 2 * KB_F32 * 65 * 4 bytes.
//
// Kernel C reads q, k and v from HBM as before. Kernel A needs every key of
// the band before any query attends, so it is two launches: a projection of
// k and v (v into its second output, k into a (G, N, C) scratch the wrapper
// allocates: one more write and read of G * N * C elements), then the
// streamed attention, which projects its own q rows from x (x . Wq + b, in
// bf16 the resident path's products in its order, never written out). What
// bounds it: the same work as the resident path plus those k bytes, and
// each CTA reading its band's k and v from L2 once.

constexpr int KB_MMA = 128;       // keys per streamed tile, bf16
constexpr int KB_F32 = 64;        // keys per streamed tile, f32
constexpr int LDQW = HD + 8;      // row stride of staged q weight columns
constexpr int LDKV = 2 * HD + 8;  // row stride of staged k | v columns
// f32 key tiles are row-major with an odd row stride (`attend_pair_tile`)
constexpr int LDK_F32 = HD + 1;
constexpr int ROWS_F32 = 2 * WARPS;  // query rows of a streamed f32 CTA

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// The A fragments of a warp's 16 rows of x (rows r0 + gq and r0 + gq + 8,
// zero past N), channels c0 .. c0 + 31: two k steps, as kernel A loads them.
struct XRows {
  const uint32_t *lo, *hi;
  int n_lo, n_hi, N, t;
  __device__ __forceinline__ XRows(const bf16* xg, int r0, int N_, int C) {
    const int lane = threadIdx.x & 31;
    n_lo = r0 + (lane >> 2);
    n_hi = n_lo + 8;
    N = N_;
    t = lane & 3;
    lo = reinterpret_cast<const uint32_t*>(xg + (size_t)min(n_lo, N - 1) * C);
    hi = reinterpret_cast<const uint32_t*>(xg + (size_t)min(n_hi, N - 1) * C);
  }
  __device__ __forceinline__ void load(uint32_t (&a)[2][4], int c0) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) {                 // k step e / 4, reg e % 4
      const int col = c0 + 16 * (e >> 2) + 8 * ((e >> 1) & 1) + 2 * t;
      const uint32_t* row = e & 1 ? hi : lo;
      a[e >> 2][e & 3] = (e & 1 ? n_hi : n_lo) < N ? row[col / 2] : 0u;
    }
  }
};

// acc[j] += x . W for J tiles of 8 columns of the staged weights Ws
// ([C][ld], column tiles 0 .. J - 1), the x fragments streamed from global
// memory a chunk of 32 channels ahead: kernel A's projection loop, the same
// products in the same order (the resident kernel keeps its own copy, whose
// schedule the resident times rest on).
template <int J>
__device__ __forceinline__ void project_rows(const XRows& xr, const bf16* Ws,
                                             int ld, int C,
                                             float (&acc)[J][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < J; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t a[2][4];
  xr.load(a, 0);
  for (int c0 = 0; c0 < C; c0 += 32) {
    uint32_t a_next[2][4];
    if (c0 + 32 < C) xr.load(a_next, c0 + 32);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const bf16* wrow =
          Ws + (c0 + 16 * kk + (lane & 15)) * ld + (lane >> 4) * 8;
#pragma unroll
      for (int jj = 0; jj < J / 2; ++jj) {
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
}

// Kernel A's first launch on the streamed path, bf16: k and v of 16 tokens a
// warp for head h, k into the scratch, v into kernel A's second output.
__global__ void __launch_bounds__(MMA_WARPS * 32)
kv_projection_mma_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                         int N, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, g = blockIdx.y;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int r0 = 16 * (blockIdx.z * MMA_WARPS + warp);
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);  // [C][LDKV]: k | v cols
  for (int i = threadIdx.x; i < C * 8; i += blockDim.x) {
    const int c = i / 8, j8 = i % 8;              // 8 columns of role 1 + j8/4
    cp_async16(Ws + c * LDKV + 8 * j8,
               w + (size_t)c * 3 * C + (1 + j8 / 4) * C + h * HD +
                   (j8 % 4) * 8,
               true);
  }
  cp_async_wait_all();
  __syncthreads();
  if (r0 >= N) return;                           // warp-uniform, no barrier
  const XRows xr(x + (size_t)g * N * C, r0, N, C);
  float acc[8][4];
  project_rows<8>(xr, Ws, LDKV, C, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int role = 1 + j / 4, col = 8 * (j % 4) + 2 * t;
    const float b0 = bias[role * C + h * HD + col];
    const float b1 = bias[role * C + h * HD + col + 1];
    bf16* dst = (role == 1 ? k_out : v_out) + (size_t)g * N * C + h * HD + col;
    if (xr.n_lo < N)
      *reinterpret_cast<uint32_t*>(dst + (size_t)xr.n_lo * C) =
          pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
    if (xr.n_hi < N)
      *reinterpret_cast<uint32_t*>(dst + (size_t)xr.n_hi * C) =
          pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
  }
}

// The streamed attention, bf16: a warp per 16-row query tile, MMA_WARPS
// tiles a CTA, all of them attending each key tile of KB_MMA keys in steps
// of KT. PROJECT (kernel A): q = x . Wq + b from `src` = x, the head's q
// weight columns staged by cp.async; else (kernel C) q read from `src`.
template <int KT, bool PROJECT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
band_attention_stream_mma_kernel(const bf16* __restrict__ src,
                                 const bf16* __restrict__ w,
                                 const float* __restrict__ bias,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 bf16* __restrict__ o, int N, int C,
                                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int Np = (N + 15) & ~15;
  const int r0 = 16 * (blockIdx.z * MMA_WARPS + warp);
  const bool active = r0 < N;                    // warp-uniform
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][KB_MMA][32] swizzled
  bf16* Vs = Ks + 2 * KB_MMA * HD;               // [2][KB_MMA][32] swizzled
  bf16* Wq = Vs + 2 * KB_MMA * HD;               // PROJECT: [C][LDQW]
  const size_t base = (size_t)g * N * C + h * HD;

  // key tile i -> buffer i % 2 (zero past N), one cp.async group
  auto stage = [&](int i) {
    const int k0 = i * KB_MMA;
    bf16* kd = Ks + (i & 1) * KB_MMA * HD;
    bf16* vd = Vs + (i & 1) * KB_MMA * HD;
    for (int j = threadIdx.x; j < KB_MMA * 4; j += blockDim.x) {
      const int r = j >> 2, c = j & 3, n = k0 + r;
      const size_t off = base + (size_t)(n < N ? n : 0) * C + 8 * c;
      cp_async16(kd + kv_at(r, c), k + off, n < N);
      cp_async16(vd + kv_at(r, c), v + off, n < N);
    }
    cp_async_commit();
  };

  uint32_t qa[2][4];
  if (PROJECT) {
    for (int i = threadIdx.x; i < C * 4; i += blockDim.x) {
      const int c = i / 4, j8 = i % 4;
      cp_async16(Wq + c * LDQW + 8 * j8,
                 w + (size_t)c * 3 * C + h * HD + 8 * j8, true);
    }
    stage(0);                                    // one group with Wq
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      const XRows xr(src + (size_t)g * N * C, r0, N, C);
      float acc[4][4];
      project_rows<4>(xr, Wq, LDQW, C, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {              // rows gq, gq + 8: A fragment
        const int col = 8 * j + 2 * t;
        const float b0 = bias[h * HD + col], b1 = bias[h * HD + col + 1];
        qa[j / 2][2 * (j % 2)] = pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
        qa[j / 2][2 * (j % 2) + 1] = pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
      }
    }
  } else {
    stage(0);
    if (active) {
      const uint32_t* qg = reinterpret_cast<const uint32_t*>(src + base);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {           // rows gq, gq + 8; cols +0, +8
          const int n = r0 + gq + 8 * (e & 1);
          const int col = 16 * s + 8 * (e >> 1) + 2 * t;
          qa[s][e] = n < N ? qg[((size_t)n * C + col) / 2] : 0u;
        }
    }
  }

  const float sl2 = scale * LOG2E;
  AttnState st;
  attn_init(st);
  const int tiles = (N + KB_MMA - 1) / KB_MMA;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) stage(i + 1);  // into the buffer tile i - 1 used
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                  // tile i landed for every thread
    if (active) {
      const int k0 = i * KB_MMA, k_end = min(KB_MMA, Np - k0);
      attend_keys_mma<KT>(qa, Ks + (i & 1) * KB_MMA * HD,
                          Vs + (i & 1) * KB_MMA * HD, 0, k_end,
                          min(N - k0, k_end), sl2, st);
    }
    __syncthreads();                  // tile i read
  }
  if (active) {
    const float inv_lo = 1.f / quad_sum(st.l_lo);
    const float inv_hi = 1.f / quad_sum(st.l_hi);
    const StoreRowsBF16 store{o + ((size_t)g * N + r0) * C + h * HD, C,
                              min(16, N - r0)};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ch = 8 * u + 2 * t;
      store(gq, ch, st.acc[u][0] * inv_lo, st.acc[u][1] * inv_lo);
      store(gq + 8, ch, st.acc[u][2] * inv_hi, st.acc[u][3] * inv_hi);
    }
  }
}

// Kernel A's first launch, f32: k and v of TOK tokens a warp for head h,
// lane = channel, f32 FMAs over the input channels in order (weights read
// from L2).
__global__ void __launch_bounds__(WARPS * 32)
kv_projection_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ k_out,
                     float* __restrict__ v_out, int N, int C) {
  const int h = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.z * WARPS + warp) * TOK;
  if (n0 >= N) return;                           // warp-uniform, no barrier
  const float* xg = x + (size_t)g * N * C;
  const float bk = bias[C + h * HD + lane];
  const float bv = bias[2 * C + h * HD + lane];
  float ak[TOK], av[TOK];
#pragma unroll
  for (int t = 0; t < TOK; ++t) ak[t] = av[t] = 0.f;
  for (int c0 = 0; c0 < C; c0 += 32) {
    float xl[TOK];
#pragma unroll
    for (int t = 0; t < TOK; ++t)
      xl[t] = n0 + t < N ? xg[(size_t)(n0 + t) * C + c0 + lane] : 0.f;
    for (int cc = 0; cc < 32; ++cc) {
      const float* wr = w + (size_t)(c0 + cc) * 3 * C + h * HD + lane;
      const float wk = wr[C], wv = wr[2 * C];
#pragma unroll
      for (int t = 0; t < TOK; ++t) {
        const float xc = __shfl_sync(FULL, xl[t], cc);
        ak[t] = fmaf(xc, wk, ak[t]);
        av[t] = fmaf(xc, wv, av[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < TOK; ++t) {
    const int n = n0 + t;
    if (n >= N) break;                           // warp-uniform
    const size_t off = ((size_t)g * N + n) * C + h * HD + lane;
    k_out[off] = ak[t] + bk;
    v_out[off] = av[t] + bv;
  }
}

// The streamed attention, f32 (SIMT): a warp per pair of query rows, lane j
// scoring key j of each 32-key step against its row-major key tile, the
// online softmax of `attend` carried across tiles (`attend_pair_tile`).
// PROJECT (kernel A): the warp projects its two q rows from `src` = x as
// `kv_projection_kernel` projects k and v; else (kernel C) reads them from
// `src`.
template <bool PROJECT>
__global__ void __launch_bounds__(WARPS * 32)
band_attention_stream_kernel(const float* __restrict__ src,
                             const float* __restrict__ w,
                             const float* __restrict__ bias,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, int N, int C,
                             float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* Kb = reinterpret_cast<float*>(smem_raw);  // [2][KB_F32][LDK_F32]
  float* Vb = Kb + 2 * KB_F32 * LDK_F32;           // [2][KB_F32][HD]
  const size_t base = (size_t)g * N * C + h * HD;

  // key tile i -> buffer i % 2 (zero past N), 4 bytes a copy (the rows
  // of the key tile are 33 words apart), one cp.async group
  auto stage = [&](int i) {
    const int k0 = i * KB_F32;
    float* kd = Kb + (i & 1) * KB_F32 * LDK_F32;
    float* vd = Vb + (i & 1) * KB_F32 * HD;
    for (int j = threadIdx.x; j < KB_F32 * HD; j += blockDim.x) {
      const int r = j / HD, d = j % HD, n = k0 + r;
      const size_t off = base + (size_t)(n < N ? n : 0) * C + d;
      cp_async4(kd + r * LDK_F32 + d, k + off, n < N);
      cp_async4(vd + r * HD + d, v + off, n < N);
    }
    cp_async_commit();
  };
  stage(0);

  const int r = ROWS_F32 * blockIdx.z + 2 * warp;  // this warp's rows r, r + 1
  const bool active = r < N, two = r + 1 < N;      // warp-uniform
  float qna = 0.f, qnb = 0.f;
  if (active) {
    if (PROJECT) {
      const float* xg = src + (size_t)g * N * C;
      float aq[2] = {0.f, 0.f};
      for (int c0 = 0; c0 < C; c0 += 32) {
        float xl[2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
          xl[t] = r + t < N ? xg[(size_t)(r + t) * C + c0 + lane] : 0.f;
        for (int cc = 0; cc < 32; ++cc) {
          const float wq = w[(size_t)(c0 + cc) * 3 * C + h * HD + lane];
#pragma unroll
          for (int t = 0; t < 2; ++t)
            aq[t] = fmaf(__shfl_sync(FULL, xl[t], cc), wq, aq[t]);
        }
      }
      const float bq = bias[h * HD + lane];
      qna = aq[0] + bq;
      qnb = two ? aq[1] + bq : qna;
    } else {
      qna = src[base + (size_t)r * C + lane];
      qnb = two ? src[base + (size_t)(r + 1) * C + lane] : qna;
    }
  }
  float qa[HD], qb[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qa[d] = __shfl_sync(FULL, qna, d);
    qb[d] = __shfl_sync(FULL, qnb, d);
  }
  PairState st;
  pair_init(st);
  const int tiles = (N + KB_F32 - 1) / KB_F32;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) stage(i + 1);  // into the buffer tile i - 1 used
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                  // tile i landed for every thread
    if (active)
      attend_pair_tile(qa, qb, Kb + (i & 1) * KB_F32 * LDK_F32,
                       Vb + (i & 1) * KB_F32 * HD, i * KB_F32, KB_F32, N,
                       scale, st);
    __syncthreads();                  // tile i read
  }
  if (active) {
    o[base + (size_t)r * C + lane] = st.acca / st.la;
    if (two) o[base + (size_t)(r + 1) * C + lane] = st.accb / st.lb;
  }
}

// Shared memory of the streamed kernels (bytes); attention_plan mirrors it.
size_t stream_mma_smem(int C, bool project) {
  return sizeof(bf16) * (2 * 2 * (size_t)KB_MMA * HD +
                         (project ? (size_t)C * LDQW : 0));
}

constexpr size_t STREAM_F32_SMEM =
    sizeof(float) * 2 * KB_F32 * (LDK_F32 + HD);

cudaError_t launch_qkv_stream(const void* x, const void* w, const void* b,
                              void* o, void* v, void* k, int G, int N, int C,
                              int heads, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    constexpr auto proj = kv_projection_mma_kernel;
    constexpr auto attn = band_attention_stream_mma_kernel<KT_QKV, true>;
    cudaError_t e = allow_smem<proj>();
    if (e == cudaSuccess) e = allow_smem<attn>();
    if (e != cudaSuccess) return e;
    const dim3 grid(heads, G, (N + 16 * MMA_WARPS - 1) / (16 * MMA_WARPS));
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const float* bb = static_cast<const float*>(b);
    bf16* kb = static_cast<bf16*>(k);
    bf16* vb = static_cast<bf16*>(v);
    proj<<<grid, MMA_WARPS * 32, sizeof(bf16) * (size_t)C * LDKV, s>>>(
        xb, wb, bb, kb, vb, N, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    attn<<<grid, MMA_WARPS * 32, stream_mma_smem(C, true), s>>>(
        xb, wb, bb, kb, vb, static_cast<bf16*>(o), N, C, ATTN_SCALE);
    return cudaGetLastError();
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* kf = static_cast<float*>(k);
  float* vf = static_cast<float*>(v);
  kv_projection_kernel<<<dim3(heads, G, (N + WARPS * TOK - 1) / (WARPS * TOK)),
                         WARPS * 32, 0, s>>>(xf, wf, bf, kf, vf, N, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  band_attention_stream_kernel<true>
      <<<dim3(heads, G, (N + ROWS_F32 - 1) / ROWS_F32), WARPS * 32,
         STREAM_F32_SMEM, s>>>(xf, wf, bf, kf, vf, static_cast<float*>(o), N,
                               C, ATTN_SCALE);
  return cudaGetLastError();
}

cudaError_t launch_attn_stream(const void* q, const void* k, const void* v,
                               void* o, int G, int N, int C, int heads,
                               int dtype, cudaStream_t s) {
  if (dtype == 1) {
    constexpr auto attn = band_attention_stream_mma_kernel<KT_ATTN, false>;
    const cudaError_t e = allow_smem<attn>();
    if (e != cudaSuccess) return e;
    attn<<<dim3(heads, G, (N + 16 * MMA_WARPS - 1) / (16 * MMA_WARPS)),
           MMA_WARPS * 32, stream_mma_smem(C, false), s>>>(
        static_cast<const bf16*>(q), nullptr, nullptr,
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), N, C, ATTN_SCALE);
    return cudaGetLastError();
  }
  band_attention_stream_kernel<false>
      <<<dim3(heads, G, (N + ROWS_F32 - 1) / ROWS_F32), WARPS * 32,
         STREAM_F32_SMEM, s>>>(
          static_cast<const float*>(q), nullptr, nullptr,
          static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<float*>(o), N, C, ATTN_SCALE);
  return cudaGetLastError();
}

}  // namespace

// The resident path of kernel A, bfloat16 (dtype 1; x, w, o and v 16-byte
// aligned): x, o, v (G, N, C); w (C, 3C); b (3C,) f32. There is no f32
// resident path (dtype 0 is refused). Returns the launch status.
extern "C" int yolou_band_attention_qkv(const void* x, const void* w,
                                        const void* b, void* o, void* v, int G,
                                        int N, int C, int heads, int dtype,
                                        void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || C != heads * HD || G > 65535 ||
      dtype != 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_qkv_mma(x, w, b, o, v, G, N, C, heads,
                             static_cast<cudaStream_t>(stream));
}

// The resident path of kernel C, bfloat16 (dtype 1; q, k, v 16-byte
// aligned): q, k, v, o (G, N, C), head-major channels, C = heads * 32.
// Returns the launch status.
extern "C" int yolou_band_attention(const void* q, const void* k,
                                    const void* v, void* o, int G, int N,
                                    int C, int heads, int dtype,
                                    void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || C != heads * HD || G > 65535 ||
      dtype != 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_attn_mma(q, k, v, o, G, N, C, heads,
                              static_cast<cudaStream_t>(stream));
}

// The streamed path of kernel A (two launches), dtype 0 = float32 (SIMT) or
// 1 = bfloat16 (tensor cores): as yolou_band_attention_qkv, plus k: a (G,
// N, C) scratch of the I/O type for the projected keys.
extern "C" int yolou_band_attention_qkv_stream(const void* x, const void* w,
                                               const void* b, void* o,
                                               void* v, void* k, int G, int N,
                                               int C, int heads, int dtype,
                                               void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || C != heads * HD || G > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_qkv_stream(x, w, b, o, v, k, G, N, C, heads, dtype,
                                static_cast<cudaStream_t>(stream));
}

// The streamed path of kernel C, dtype 0 = float32 (SIMT) or 1 = bfloat16
// (tensor cores): as yolou_band_attention.
extern "C" int yolou_band_attention_stream(const void* q, const void* k,
                                           const void* v, void* o, int G,
                                           int N, int C, int heads, int dtype,
                                           void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || C != heads * HD || G > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_attn_stream(q, k, v, o, G, N, C, heads, dtype,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* yolou_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

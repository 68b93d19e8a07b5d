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
// What bounds it on the H100: the work is one IoU test of each pair of rows,
// some 16 f32 operations each, on 16 B a box read once: microseconds of
// either. What costs is the order: greedy NMS is a chain of decisions, and
// a step that waits on the one before pays a synchronisation. So the IoU
// tests are taken out of the chain, and the chain runs over bits alone.
//
// Design: one thread-block cluster of N CTAs per image (up to 16, the
// non-portable size, at K <= 512: enough that each warp takes one block of
// phase 1 there; up to 8 past it), no global scratch. The columns (rows as
// candidates) are cut into W = ceil(K / 64) windows of 64, and the windows
// into slabs of at most 8, one slab per owner CTA: S = ceil(W / 8) owners
// (one up to K = 512, four at K = 2048); every CTA holds the image's boxes
// and areas.
//  Phase 1, in parallel and outside any chain: every test of a row j
//  against a column i of its window or a later one, in 32 x 32 blocks
//  spread over all the cluster's warps; a lane tests the block's 32 rows
//  against its column, its bits form one 32-bit word of the column's
//  hitters, and it stores the word into the shared memory of the column's
//  owner (distributed shared memory). So the owner of column i holds, for
//  every window w up to i's own, the 64-bit word hc[i][w] of the rows of w
//  that hit i (at most 135 KB, at K = 2048). Blocks without a valid row or
//  column are zero, untested. Each CTA then arrives on every owner's
//  mbarrier (release at cluster scope).
//  Phase 2, the chain, over bits only: owner s waits on its mbarrier for
//  the N CTAs of phase 1 and the s owners before it, then decides its
//  windows in order, one warp: a window's candidates are its valid columns
//  that no kept row of an earlier window hits (hc[i][w'] & kept[w'] for
//  each earlier window w', ORed into a lane's removed bits as each window
//  is decided: two columns of each window of the slab a lane); its kept
//  set is the fixpoint of keep = cand & ~(rows of keep that hit) over its
//  64 x 64 diagonal word, iterated from keep = cand (a ballot a step; the
//  fixpoint is unique, since hits run from earlier rows to later ones, and
//  it is the greedy set). It writes keep for its columns, sends the kept
//  masks to the later owners and arrives on their mbarriers. The chain is
//  S - 1 hops between CTAs and the windows' fixpoints, with no IoU test
//  and no cluster-wide barrier inside it; one cluster barrier (split
//  around the loads) precedes the first remote store, and each CTA exits
//  once it has every word that others send it.
// Rows past K are invalid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 2048;
constexpr int MAX_CTAS = 16;         // the cluster, at most (non-portable)
constexpr int SLAB = 8;              // windows an owner holds, at most
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

// Does box r (area ra), the earlier row, hit box c (area ca)?
__device__ __forceinline__ bool overlaps(float4 r, float ra, float4 c,
                                         float ca, float t) {
  const float iw = fmaxf(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ra, ca), inter);
  return inter > __fmul_rn(t, __fadd_rn(uni, 1e-7f));
}

// The shape of one image's work: W windows over S owners, at most SW a
// slab, in a cluster of N >= S CTAs (those past S own no window): one
// block of phase 1 a warp, up to 16 CTAs with one owner (small CTAs, four
// an SM), up to the portable 8 with more (an owner CTA fills an SM's shared
// memory, and clusters of 16 such CTAs leave SMs idle); hc rows of CS
// 64-bit words (W made odd: lanes reading the words of consecutive columns
// fall in distinct banks).
struct Shape {
  int K, W, N, S, SW, CS;
  __host__ __device__ explicit Shape(int K_) : K(K_), W((K_ + 63) / 64) {
    const int blocks = 2 * W * (W + 1);          // phase 1's
    S = (W + SLAB - 1) / SLAB;
    SW = (W + S - 1) / S;
    N = max(S, min(S == 1 ? MAX_CTAS : MAX_CTAS / 2,
                   (blocks + WARPS - 1) / WARPS));
    CS = W | 1;
  }
  __host__ __device__ int lo(int s) const { return s < S ? s * W / S : W; }
  __host__ __device__ int owner(int w) const { return ((w + 1) * S - 1) / W; }
  // shared memory: boxes, hc, kept masks, the mbarrier, areas, valid
  // bits; boxes and areas of the 64 W rows (zero past K)
  __host__ __device__ size_t bytes() const {
    return 16 * 64 * (size_t)W + 8 * (size_t)(64 * SW * CS + W + 1) +
           4 * 64 * (size_t)W + 8 * (size_t)W;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `p`'s twin in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer(uint32_t addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n"
               :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, u64 v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;\n"
               :: "r"(addr), "l"(v) : "memory");
}

// One arrival on a peer's mbarrier that releases this thread's prior
// writes (and those ordered before them) at cluster scope.
__device__ __forceinline__ void arrive_peer(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(bar) : "memory");
}

// Waits for the mbarrier's first phase, acquiring at cluster scope; parks
// the thread up to 1 ms a try, and traps (a launch failure the wrapper
// reports) where the phase has not completed after 2 s, so a fault of the
// chain ends the launch instead of hanging the card.
__device__ __forceinline__ void wait_cluster(u64* bar) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%1], "
        "0, %2;\n"
        "selp.u32 %0, 1, 0, P;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(1000000u)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0) start = now;
    else if (now - start > 2000000000ull) __trap();
  }
}

__global__ void __launch_bounds__(THREADS)
greedy_nms_cluster_kernel(const float* __restrict__ boxes,
                          const bool* __restrict__ valid,
                          bool* __restrict__ keep, int K, float t) {
  const Shape sh(K);
  const int W = sh.W, S = sh.S, CS = sh.CS;
  const int rank = blockIdx.x, b = blockIdx.y;   // clusters span x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w_lo = sh.lo(rank), w_hi = sh.lo(rank + 1);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* box = reinterpret_cast<float4*>(smem_raw);           // [64 W]
  u64* hc = reinterpret_cast<u64*>(box + 64 * W);              // [64 SW][CS]
  u64* kept = hc + 64 * sh.SW * CS;                            // [W]
  u64* bar = kept + W;                                         // [1]
  float* area = reinterpret_cast<float*>(bar + 1);             // [64 W]
  unsigned* valid_bits = reinterpret_cast<unsigned*>(area + 64 * W);

  if (tid == 0) {                  // phase 1's CTAs and the earlier owners
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(sh.N + min(rank, S)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)b * K;
  const bool* vb = valid + (size_t)b * K;
  for (int i = tid; i < 64 * W; i += THREADS) {  // a whole warp per trip
    const bool v = i < K && vb[i];
    const unsigned ballot = __ballot_sync(FULL, v);
    const float4 r = i < K ? bx[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    box[i] = r;
    area[i] = __fmul_rn(__fsub_rn(r.z, r.x), __fsub_rn(r.w, r.y));
    if (lane == 0) valid_bits[i >> 5] = ballot;
  }
  __syncthreads();
  // every CTA of the cluster running, its mbarrier initialised
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // Phase 1: blocks (row block rb, column block cb) with rb's window at
  // most cb's: 4 (cw + 1) blocks for column window cw, 2 W (W + 1) in all,
  // taken by the cluster's warps in turn; lane c: column 32 cb + c
  {
    const int total = 2 * W * (W + 1), stride = sh.N * WARPS;
    int cw = 0;
    for (int q = rank * WARPS + warp; q < total; q += stride) {
      while (2 * (cw + 1) * (cw + 2) <= q) ++cw;
      const int rem = q - 2 * cw * (cw + 1), per = 2 * cw + 2;
      const int cb = 2 * cw + rem / per, rb = rem % per;
      const unsigned vrow = valid_bits[rb], vcol = valid_bits[cb];
      unsigned word = 0u;
      if (vrow && vcol && rb <= cb) {            // warp-uniform
        const int i = 32 * cb + lane;
        const float4 c = box[i];
        const float ca = area[i];
#pragma unroll
        for (int j0 = 0; j0 < 32; j0 += 8) {     // 8 rows' loads, then tests
          float4 r[8];
          float ra[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            r[u] = box[32 * rb + j0 + u];
            ra[u] = area[32 * rb + j0 + u];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            word |= (unsigned)overlaps(r[u], ra[u], c, ca, t) << (j0 + u);
        }
        word &= vrow;                            // valid_j
        if (rb == cb) word &= (1u << lane) - 1u;  // j < i
      }
      const int own = sh.owner(cw);
      const unsigned* dst = reinterpret_cast<const unsigned*>(
          hc + (32 * cb + lane - 64 * sh.lo(own)) * CS + (rb >> 1)) +
          (rb & 1);
      st_peer(peer(dst, own), word);
    }
  }
  __syncthreads();                 // the CTA's words stored
  if (tid < S) arrive_peer(peer(bar, tid));

  // Phase 2: the chain, warp 0 of each owner; lane l holds the removed
  // bits of columns l and l + 32 of each of its windows (bits 2 lw, 2 lw + 1)
  if (rank >= S || warp != 0) return;
  wait_cluster(bar);               // every word of phase 1, earlier masks
  unsigned rem = 0u;
  for (int w2 = 0; w2 < w_lo; ++w2) {            // the earlier owners' rows
    const u64 k = kept[w2];
#pragma unroll
    for (int lw = 0; lw < SLAB; ++lw)
      if (w_lo + lw < w_hi) {
        const int lc = 64 * lw + lane;
        rem |= ((hc[lc * CS + w2] & k) != 0 ? 1u : 0u) << 2 * lw;
        rem |= ((hc[(lc + 32) * CS + w2] & k) != 0 ? 2u : 0u) << 2 * lw;
      }
  }
  for (int w = w_lo; w < w_hi; ++w) {
    const int lw = w - w_lo, lc = 64 * lw + lane;  // columns lc, lc + 32
    const bool c_lo =
        (valid_bits[2 * w] >> lane & 1u) && !(rem >> 2 * lw & 1u);
    const bool c_hi =
        (valid_bits[2 * w + 1] >> lane & 1u) && !(rem >> 2 * lw & 2u);
    const u64 h_lo = hc[lc * CS + w], h_hi = hc[(lc + 32) * CS + w];
    u64 km = (u64)__ballot_sync(FULL, c_hi) << 32 | __ballot_sync(FULL, c_lo);
    for (;;) {                                   // warp-uniform
      const u64 next = (u64)__ballot_sync(FULL, c_hi && !(h_hi & km)) << 32 |
                       __ballot_sync(FULL, c_lo && !(h_lo & km));
      if (next == km) break;
      km = next;
    }
#pragma unroll
    for (int l2 = 1; l2 < SLAB; ++l2)            // this slab's later windows
      if (l2 > lw && w_lo + l2 < w_hi) {
        const int c2 = 64 * l2 + lane;
        rem |= ((hc[c2 * CS + w] & km) != 0 ? 1u : 0u) << 2 * l2;
        rem |= ((hc[(c2 + 32) * CS + w] & km) != 0 ? 2u : 0u) << 2 * l2;
      }
    const int i = 64 * w + lane;
    if (i < K) keep[(size_t)b * K + i] = km >> lane & 1ull;
    if (i + 32 < K) keep[(size_t)b * K + i + 32] = km >> (lane + 32) & 1ull;
    if (lane > rank && lane < S) st_peer(peer(&kept[w], lane), km);
  }
  if (lane > rank && lane < S) arrive_peer(peer(bar, lane));
}

}  // namespace

// boxes (B, K, 4) f32, 16-byte aligned; valid (B, K) bool; keep (B, K)
// bool out; K <= 2048. Returns the launch status.
extern "C" int yolou_greedy_nms(const void* boxes, const void* valid,
                                void* keep, int B, int K, float iou_thres,
                                void* stream) {
  if (B <= 0 || K <= 0 || K > MAX_K || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh(K);
  static const cudaError_t allowed = [] {
    cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e == cudaSuccess)            // clusters past the portable 8
      e = cudaFuncSetAttribute(greedy_nms_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    return e;
  }();
  if (allowed != cudaSuccess) return (int)allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.N, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sh.bytes();
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, greedy_nms_cluster_kernel, static_cast<const float*>(boxes),
      static_cast<const bool*>(valid), static_cast<bool*>(keep), K,
      iou_thres);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

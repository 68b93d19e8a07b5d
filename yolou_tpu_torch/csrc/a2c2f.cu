// A whole A2C2f attention block (eval, BatchNorm folded) in one launch.
//
// Replaces yolou_tpu/ops/pallas_a2c2f.py::a2c2f_fused (Pallas body
// _a2c2f_kernel). With T the I/O type (f32 or bf16), every product
// accumulated in f32, N = H*W tokens per image, c_ the block's width and ca
// the attention's (c_, or heads * 32 / 64 where the wrapper padded each head
// with zero channels to a width the kernels are built for):
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
//  * t / ys (B, N, (n_stages+1) c_) and two qkv buffers (B, N, 3ca) are
//    scratch in global memory that the wrapper allocates; qkv is
//    double-buffered because a phase's tiles read k and v of the whole band
//    from one buffer while other CTAs already write the next ABlock's qkv;
//    the scratch is read with plain loads, through L2 (cp.async.cg,
//    ld.global.cg) or by TMA, never the read-only path, ordered by
//    grid.sync() (and, for the TMA reads of the f32 kernel, a proxy fence
//    before it);
//  * the ABlocks' weight pointers are a device array the wrapper fills (10
//    a block, any number of stages), read once per phase;
//  * the 7x7 stencil reads v from the qkv scratch (L1/L2), in f32;
//  * rounding points are those of the listing above; residual adds in f32.
//
// f32, the exact path (`a2c2f_f32_kernel<TM, HD>`, full f32 on the FMA units,
// no TF32): tiles of TM = 64 or 32 tokens, 256 threads. It is bound by the
// FMA rate (yolov12l's layer 8 at batch 8: 43 GFLOP, 0.64 ms at 67 TFLOP/s,
// against a few MB of weights and activations) and kept from it by feeding
// the FMA units from shared memory:
//  * GEMMs on register micro-tiles: thread (ty, tx) of a TM/4 x 1024/TM grid
//    owns 4 tokens x 4 columns of a panel of NP = 4096 / TM columns (64 or
//    128): two 16-byte shared loads feed 16 FMAs, and a warp's activation
//    loads are broadcasts. Both operands stream through a ring of 4 stages
//    of 32 K rows that one thread fills by TMA, three stages ahead: the
//    activation slab [TM][32] as one 2-D box of the x, ys or work scratch
//    (a tensor map each), the weight slab [32][NP] as one bulk copy of the
//    weight the wrapper packed panel-major ([panels][ceil32(K)][NP], zero
//    padded). Each stage's bytes complete its `full` mbarrier, and its 8
//    warps free it through its `empty` one. A CTA's weight traffic thus
//    falls by its token tile (64 or 32 tokens a fetch), and shared memory
//    does not grow with cin, c_, hid or the stage count. The intermediates
//    t1 = t + proj, h and u = o + pe go to a (B N, c_ + hid + ca) f32
//    scratch between the GEMMs.
//  * attention: the streamed f32 band attention's design (band_attention.cu):
//    k and v of 64 keys a tile by TMA from a 3-D map of the qkv scratch
//    (boxes of 32 channels, the 128-byte swizzle, zero past the band) into a
//    ring of two stages; 16 threads a group of 4 query rows, 4 x 4 score
//    micro-tiles (keys t, t+16, t+32, t+48), the online softmax in exp2 with
//    the scale folded in, p.v as a second micro-tile product (4 rows x 4
//    channels a 32-channel block). At TM = 32 the CTA's two halves take the
//    two 64-key tiles of each stage and merge their states at the end.
//  * the 7x7 stencil: 4 channels of 2 consecutive tokens a thread, 16-byte
//    predicated loads shared by the two tokens.
//  * TM: the tile whose grid puts the fewest token rows on the busiest SM
//    (64 on a tie: half the weight traffic), `kernels/a2c2f.py::f32_tile`.
//  Shared memory: the larger of the GEMM ring (4 * 4 * (32 TM + 32 NP)) and
//  the attention's stages, q and probabilities, at most 157 KB (TM 32, hd
//  64) at every shape.
//
// bf16, the serving type (`a2c2f_mma_kernel<TILE, STREAM, HD>`, tensor cores):
// every GEMM operand is a value already rounded to bf16 (x, y0, t, u, h, the
// ys concat), so the activation tiles live in shared memory as bf16, row-major
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
//  * attention (attention_mma.cuh): per head (32 or 64 channels) the band's
//    k and v arrive by cp.async in the swizzled layout of kernels A and C
//    (`kv_at`; the first head's during the stencil, each next one's during
//    the last one's merge; a second buffer, to land them during the attend,
//    cost more in L1 than it hid); the 8
//    warps split the work as (query tile, key part): TILE / 16 query tiles
//    of 16 rows and S = 128 / TILE parts of whole 16-key blocks, each warp
//    an online softmax over its part with q's A fragments read straight
//    from the qkv scratch; the partial states (row maximum, row sum, f32
//    accumulator) are merged in f32 and the f32 o goes with pe into u;
//  * the 7x7 stencil: 8 channels of RUN consecutive tokens a thread,
//    16-byte predicated loads, the RUN tokens sharing each row's loads;
//  * token tile: 16, 32 or 64 tokens, whichever grid takes the fewest waves
//    over the co-resident CTAs (`launch_mma`); heads of 64 at 16 only.
//    Shared memory per CTA: 2 * (3 * 64 * 136 + 2 * hd * ceil16(nb) + TILE *
//    ((c_ + 8) + (ca + 8) + max(ceil16(cin), hid, (n_stages+1) c_, 2 ca) +
//    8)) + 4 * 8 * (32 + 16 hd) bytes, plus 128 bytes of GEMM descriptors
//    (a band too long for that: 16 tokens and the keys and values KB_MMA =
//    256 rows at a time, STREAM). The MLP's width hid
//    is a multiple of 16 (the fold pads it with zero columns of mlp1 and
//    zero rows of mlp2, exact since silu(0) = 0), so h's tile has no stale
//    columns for mlp2 to read.
// The wrapper refuses a bf16 shape whose CTA passes the 227 KB a block may
// use.

#include <cooperative_groups.h>

#include <map>
#include <mutex>

#include "attention_mma.cuh"
#include "band_attention.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace yolou;

namespace {

struct ABlockWeights {
  const void* wqkv; const float* bqkv;
  const float* wpe; const float* bpe;
  const void* wproj; const float* bproj;
  const void* wm1; const float* bm1;
  const void* wm2; const float* bm2;
};

// The ABlocks whose pointers also ride in the parameter block, for the bf16
// kernel's fast path (up to 4 stages, every yolov12 graph's): read from
// there with a uniform index they take no thread's registers, which that
// kernel, at its register limit, needs (read from the device array or
// shared memory instead, it spilled and lost 6-10 % on an H100).
constexpr int INLINE_BLOCKS = 8;

struct Params {
  const void* x; void* out; void* ys; void* qkv0; void* qkv1;
  float* work;                  // f32: the t1 | h | u scratch, per token
  const void* wcv1; const float* bcv1;
  const void* wcv2; const float* bcv2;
  const ABlockWeights* blk;     // device array of 2 * n_stages ABlocks
  ABlockWeights inl[INLINE_BLOCKS];  // the first ones again, by value
  int B, H, W, cin, c_, ca, c2, hid, n_stages, area, heads;
  float scale;                  // f32(hd ** -0.5) of the true head width
  // f32: tensor maps of x, ys, the work scratch and the two qkv buffers
  CUtensorMap x_map, ys_map, work_map, kv_map[2];
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

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

// ------------------------------------------------- f32 on register tiles

constexpr int F32_THREADS = 256;
constexpr int KS_F32 = 32;         // K rows of a GEMM stage
constexpr int STAGES = 4;          // GEMM ring
constexpr int KB_ATT = 64;         // keys of an attention tile (a group's)
constexpr int ATT_STAGES = 2;      // attention ring
constexpr int LDP_ATT = 76;        // probability rows (floats), as kernel C
constexpr int RUN_F32 = 2;         // tokens a thread of the stencil takes

// The f32 kernel's shapes at token tile TM and head width HD_ (floats).
// GEMM: thread (ty, tx) of a TY x TX grid owns 4 rows x 4 columns of a
// panel of NP columns; a stage holds the activation slab [TM][32] (one TMA
// box) and the weight slab [32][NP] (one bulk copy of the packed weight).
// Attention: a stage holds, per key group, k and v of 64 keys as HD_ / 32
// boxes of [64][32] (128-byte swizzle), then q [TM][HD_ + 4] and each
// group's probabilities [TM][LDP_ATT].
template <int TM, int HD_>
struct F32Layout {
  static constexpr int TY = TM / 4, TX = F32_THREADS / TY, NP = 4 * TX;
  static constexpr int A_SLAB = TM * KS_F32, W_SLAB = KS_F32 * NP;
  static constexpr int STAGE = A_SLAB + W_SLAB;
  static constexpr int GEMM = STAGES * STAGE;
  static constexpr int NG = 64 / TM;           // key groups: 1 or 2
  static constexpr int KV_TILE = KB_ATT * HD_;  // one group's k (or v)
  static constexpr int KV_STAGE = 2 * NG * KV_TILE;
  static constexpr int LDQ = HD_ + 4;
  static constexpr int ATT =
      ATT_STAGES * KV_STAGE + TM * LDQ + NG * TM * LDP_ATT;
  static constexpr int FLOATS = GEMM > ATT ? GEMM : ATT;
  // 1024 bytes of slack for the swizzled tiles' alignment, the barriers
  static constexpr size_t BYTES = 1024 + sizeof(float) * (size_t)FLOATS +
                                  8 * (2 * STAGES + ATT_STAGES);
};

// The GEMM ring's state: stages issued so far over all GEMMs (stage s uses
// slot s % STAGES; its barriers complete for the (s / STAGES)-th time).
struct Ring {
  float* smem;
  uint64_t* full;      // [STAGES]: the stage's bytes landed
  uint64_t* empty;     // [STAGES]: its 8 warps are done with it
  int used;
};

// acc = A . W for the TM rows of a tile and the N columns of W, panel by
// panel, both operands through the ring: A a TMA box of the map `amap`
// at column a_col + k, row a_row (rows past the tile's `rows` are other
// tokens' and never stored; columns past K never read); W packed by the
// wrapper as [panels][ceil32(K)][NP] (zero past K and N), a stage's slab one
// contiguous bulk copy. One thread issues every copy, STAGES - 1 stages
// ahead; the warps free a stage through its `empty` barrier. At each
// panel's end epi(row, col, float4 of columns col .. col + 3) for the
// thread's rows < rows and columns < N (N a multiple of 4).
template <int TM, int HD_, typename Epi>
__device__ __forceinline__ void gemm_f32(Ring& ring, const CUtensorMap* amap,
                                         int a_col, int a_row, int rows,
                                         const float* Wp, int K, int N,
                                         Epi epi) {
  using L = F32Layout<TM, HD_>;
  const int tid = threadIdx.x;
  const int ty = tid / L::TX, tx = tid % L::TX;
  const int nk = (K + KS_F32 - 1) / KS_F32, Kp = nk * KS_F32;
  const int total = nk * ((N + L::NP - 1) / L::NP);
  const int base = ring.used;
  // the threads' global writes that A reads (the last epilogue's) and
  // their shared-memory writes to the region (q, p) ordered before TMA
  fence_proxy_async_global();
  fence_proxy_async();
  __syncthreads();

  auto issue = [&](int j) {          // thread 0: stage j into its slot
    const int s = base + j, slot = s % STAGES;
    if (s >= STAGES) mbar_wait(&ring.empty[slot], ((s / STAGES) - 1) & 1);
    float* As = ring.smem + slot * L::STAGE;
    const int p = j / nk, k0 = (j - p * nk) * KS_F32;
    mbar_expect_tx(&ring.full[slot], L::STAGE * sizeof(float));
    tma_load_2d(As, amap, &ring.full[slot], a_col + k0, a_row);
    bulk_load(As + L::A_SLAB, Wp + ((size_t)p * Kp + k0) * L::NP,
              L::W_SLAB * sizeof(float), &ring.full[slot]);
  };
  if (tid == 0)
    for (int j = 0; j < min(STAGES - 1, total); ++j) issue(j);
  float acc[4][4];
  for (int j = 0; j < total; ++j) {
    const int p = j / nk, kb = j - p * nk;
    if (kb == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    if (tid == 0 && j + STAGES - 1 < total) issue(j + STAGES - 1);
    const int s = base + j, slot = s % STAGES;
    mbar_wait(&ring.full[slot], (s / STAGES) & 1);
    const float* As = ring.smem + slot * L::STAGE + 4 * ty * KS_F32;
    const float* Ws = ring.smem + slot * L::STAGE + L::A_SLAB + 4 * tx;
    auto step = [&](int kk) {        // 4 K rows: 8 loads of 4, 64 FMAs
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + i * KS_F32 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 w =
            *reinterpret_cast<const float4*>(Ws + (kk + u) * L::NP);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = lane_of(a[i], u);
          acc[i][0] = fmaf(av, w.x, acc[i][0]);
          acc[i][1] = fmaf(av, w.y, acc[i][1]);
          acc[i][2] = fmaf(av, w.z, acc[i][2]);
          acc[i][3] = fmaf(av, w.w, acc[i][3]);
        }
      }
    };
    const int kmax = min(KS_F32, K - kb * KS_F32);
    if (kmax == KS_F32) {
#pragma unroll
      for (int kk = 0; kk < KS_F32; kk += 4) step(kk);
    } else {
      for (int kk = 0; kk < kmax; kk += 4) step(kk);
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&ring.empty[slot]);
    if (kb == nk - 1) {
      const int col = p * L::NP + 4 * tx;
      if (col < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * ty + i < rows)
            epi(4 * ty + i, col,
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
  }
  __syncthreads();                   // every stage read, the stores made
  ring.used = base + total;
}

// f32 loads and stores of a tile's own scratch rows through L2
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  __stcg(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ float4 silu4(float4 v, float4 b) {
  return make_float4(silu(v.x + b.x), silu(v.y + b.y), silu(v.z + b.z),
                     silu(v.w + b.w));
}
__device__ __forceinline__ float4 add4(float4 v, float4 b) {
  return make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
}
__device__ __forceinline__ float4 bias4(const float* b, int col) {
  return *reinterpret_cast<const float4*>(b + col);
}

// The attention of a tile's `rows` query rows (token q0 of band bg, whose
// first token is band0) for head h against the band's nb keys, o to u (row
// stride ldu). Groups of 16 threads own 4 query rows; at TM = 32 the CTA's
// two halves take the two 64-key tiles of each stage and merge at the end.
// k and v arrive by TMA from the qkv scratch (`kv_map`: (3ca, nb, bands)
// boxes of 32 channels x 64 keys, zero past the band), one stage ahead.
template <int TM, int HD_>
__device__ __forceinline__ void attend_f32(float* smem, uint64_t* kv_full,
                                           int& kv_used,
                                           const CUtensorMap* kv_map,
                                           const float* cur, int QS, int ca,
                                           int bg, int q0, size_t band0,
                                           int rows, int nb, int h, float sl2,
                                           float* u, int ldu) {
  using L = F32Layout<TM, HD_>;
  constexpr int NG = L::NG, CB = HD_ / 32, LDQ = L::LDQ;
  constexpr int KEYS = NG * KB_ATT;              // keys of a stage
  const int tid = threadIdx.x;
  const int grp = tid / (4 * TM);                // key group
  const int ltid = tid - grp * 4 * TM;
  const int rg = ltid >> 4, t = ltid & 15, half = t >> 3, cq = t & 7;
  float* Qs = smem + ATT_STAGES * L::KV_STAGE;   // [TM][LDQ]
  float* Ps = Qs + TM * LDQ;                     // [NG][TM][LDP_ATT]
  const int iters = (nb + KEYS - 1) / KEYS;

  auto issue = [&](int i) {          // thread 0: keys i KEYS .. of k and v
    const int slot = (kv_used + i) % ATT_STAGES;
    float* st = smem + slot * L::KV_STAGE;
    mbar_expect_tx(&kv_full[slot], L::KV_STAGE * sizeof(float));
    for (int g = 0; g < NG; ++g)
      for (int r = 0; r < 2; ++r)                // k, v
        for (int cb = 0; cb < CB; ++cb)
          tma_load_3d(st + (2 * g + r) * L::KV_TILE + cb * KB_ATT * 32,
                      kv_map, &kv_full[slot], (1 + r) * ca + h * HD_ + 32 * cb,
                      i * KEYS + g * KB_ATT, bg);
  };

  // the region's last readers done and their writes ordered before TMA
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) issue(0);
  // q rows of this tile (zero past rows), through L2
  const float* qg = cur + (band0 + q0) * QS + h * HD_;
  for (int i = tid; i < TM * (HD_ / 4); i += F32_THREADS) {
    const int r = i / (HD_ / 4), c = 4 * (i % (HD_ / 4));
    const float4 v = r < rows ? ld4(qg + (size_t)r * QS + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(Qs + r * LDQ + c) = v;
  }
  float m[4], l[4], acc[4][4 * CB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e) acc[i][e] = 0.f;
  }
  float* Pg = Ps + (grp * TM + 4 * rg) * LDP_ATT;  // the group's own rows
  for (int i = 0; i < iters; ++i) {
    const int slot = (kv_used + i) % ATT_STAGES;
    mbar_wait(&kv_full[slot], ((kv_used + i) / ATT_STAGES) & 1);
    __syncthreads();                 // q written; stage i - 1 free
    if (tid == 0 && i + 1 < iters) issue(i + 1);
    const int k0 = i * KEYS + grp * KB_ATT;      // this group's keys
    if (k0 >= nb) continue;                      // group-uniform
    const float* Kt = smem + slot * L::KV_STAGE + 2 * grp * L::KV_TILE;
    const float* Vt = Kt + L::KV_TILE;
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) s[a][0] = s[a][1] = s[a][2] = s[a][3] = 0.f;
#pragma unroll
    for (int cc = 0; cc < HD_ / 4; ++cc) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(Qs + (4 * rg + a) * LDQ +
                                                 4 * cc);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        kv[w] = *reinterpret_cast<const float4*>(
            Kt + f32_at<HD_>(t + 16 * w, cc, KB_ATT));
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          s[a][w] = fmaf(qv[a].x, kv[w].x, s[a][w]);
          s[a][w] = fmaf(qv[a].y, kv[w].y, s[a][w]);
          s[a][w] = fmaf(qv[a].z, kv[w].z, s[a][w]);
          s[a][w] = fmaf(qv[a].w, kv[w].w, s[a][w]);
        }
    }
    if (k0 + KB_ATT > nb) {                      // group-uniform
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (k0 + t + 16 * w >= nb)
#pragma unroll
          for (int a = 0; a < 4; ++a) s[a][w] = -INFINITY;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int d = 1; d < 16; d <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, d));
      mx = fmaxf(mx, m[a]);                      // finite: key k0 exists
      const float c = exp2f((m[a] - mx) * sl2), nbias = -mx * sl2;
      m[a] = mx;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        s[a][w] = exp2f(fmaf(s[a][w], sl2, nbias));
        sum += s[a][w];
      }
      l[a] = l[a] * c + sum;
#pragma unroll
      for (int e = 0; e < 4 * CB; ++e) acc[a][e] *= c;
    }
    __syncwarp();                                // the last tile's P read
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        Pg[a * LDP_ATT + t + 16 * w + (w >= 2 ? 4 : 0)] = s[a][w];
    __syncwarp();
#pragma unroll 2
    for (int jj = 0; jj < 32; jj += 4) {
      float4 pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pv[a] = *reinterpret_cast<const float4*>(Pg + a * LDP_ATT +
                                                 36 * half + jj);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int b = 0; b < CB; ++b) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vt + f32_at<HD_>(32 * half + jj + w, cq + 8 * b, KB_ATT));
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float pw = lane_of(pv[a], w);
            float* ac = acc[a] + 4 * b;
            ac[0] = fmaf(pw, vv.x, ac[0]);
            ac[1] = fmaf(pw, vv.y, ac[1]);
            ac[2] = fmaf(pw, vv.z, ac[2]);
            ac[3] = fmaf(pw, vv.w, ac[3]);
          }
        }
      }
    }
  }
  kv_used += iters;
  // row sums over the group, the two key halves of a thread pair added
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) l[a] += __shfl_xor_sync(FULL, l[a], d);
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e)
      acc[a][e] += __shfl_xor_sync(FULL, acc[a][e], 8);
  }
  float* mg = Ps;                                // NG = 2: group 1's state
  if (NG == 2) {
    __syncthreads();                             // every P read
    if (grp == 1) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* row = mg + (4 * rg + a) * (HD_ + 2);
        if (t == 0) {
          row[0] = m[a];
          row[1] = l[a];
        }
        if ((a >> 1) == half)
#pragma unroll
          for (int b = 0; b < CB; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              row[2 + 32 * b + 4 * cq + e] = acc[a][4 * b + e];
      }
    }
    __syncthreads();
  }
  if (grp == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * rg + a;
      if ((a >> 1) != half || r >= rows) continue;
      float c0 = 1.f, c1 = 0.f, den = l[a];
      const float* row = mg + r * (HD_ + 2);
      if (NG == 2) {
        const float M = fmaxf(m[a], row[0]);
        c0 = exp2f((m[a] - M) * sl2);            // a group that saw no key
        c1 = exp2f((row[0] - M) * sl2);          // has m = -inf: factor 0
        den = l[a] * c0 + row[1] * c1;
      }
      const float inv = 1.f / den;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = acc[a][4 * b + e] * c0;
          if (NG == 2) o[e] += row[2 + 32 * b + 4 * cq + e] * c1;
          o[e] *= inv;
        }
        st4(u + (size_t)r * ldu + h * HD_ + 32 * b + 4 * cq,
            make_float4(o[0], o[1], o[2], o[3]));
      }
    }
  }
  __syncthreads();                               // q, P and the stages free
}

// u += dw7x7(v) + bpe for a tile's rows: 4 channels of RUN_F32
// consecutive tokens a thread, the tokens sharing each image row's 16-byte
// loads of v (the previous phase's scratch, through L1) where they lie in
// one image row (else one token at a time); taps in the reference's order.
template <int L>
__device__ __forceinline__ void dw7x7_f32(const float* v, int QS,
                                          const float* w, int ca, int H,
                                          int W, int y, int x0,
                                          float4 (&acc)[L]) {
#pragma unroll
  for (int di = 0; di < 7; ++di) {
    const int yy = y + di - 3;
    const bool row_ok = yy >= 0 && yy < H;
    float4 raw[L + 6];
#pragma unroll
    for (int j = 0; j < L + 6; ++j) {
      const int xj = x0 + j - 3;
      raw[j] = row_ok && xj >= 0 && xj < W
                   ? *reinterpret_cast<const float4*>(
                         v + (size_t)(yy * W + xj) * QS)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int dj = 0; dj < 7; ++dj) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(w + (di * 7 + dj) * ca);
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float4 r = raw[t + dj];
        acc[t].x = fmaf(r.x, w4.x, acc[t].x);
        acc[t].y = fmaf(r.y, w4.y, acc[t].y);
        acc[t].z = fmaf(r.z, w4.z, acc[t].z);
        acc[t].w = fmaf(r.w, w4.w, acc[t].w);
      }
    }
  }
}

// The f32 kernel (above): phase 0 (cv1, the first qkv), then per ABlock the
// attention head by head, the stencil, proj, the MLP and the next qkv (or
// cv2), a tile of TM tokens of one band at a time. The maps: x, ys and the
// work scratch (boxes of 32 columns x TM rows) and the two qkv buffers
// (`kv`); GEMM weights packed (`gemm_f32`).
template <int TM, int HD_>
__global__ void __launch_bounds__(F32_THREADS, 1)
a2c2f_f32_kernel(const __grid_constant__ Params p) {
  using L = F32Layout<TM, HD_>;
  extern __shared__ unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  float* smem = reinterpret_cast<float*>(align1024(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::FLOATS);
  const int tid = threadIdx.x;
  const int H = p.H, W = p.W, N = H * W, c_ = p.c_, c2 = p.c2;
  const int ca = p.ca, hid = p.hid;
  const int nb = N / p.area;
  const int tiles_per_band = (nb + TM - 1) / TM;
  const int total = p.B * p.area * tiles_per_band;
  const int YS = (p.n_stages + 1) * c_, QS = 3 * ca;
  const int WK = c_ + hid + ca;                  // the work scratch's row
  const int n_blocks = 2 * p.n_stages;
  float* out = static_cast<float*>(p.out);
  float* ys = static_cast<float*>(p.ys);
  float* const qkv0 = static_cast<float*>(p.qkv0);
  float* const qkv1 = static_cast<float*>(p.qkv1);
  const float sl2 = p.scale * LOG2E;

  Ring ring = {smem, bars, bars + STAGES, 0};
  uint64_t* kv_full = bars + 2 * STAGES;
  int kv_used = 0;
  // this phase's ABlock and the next one's (its qkv), read from shared
  // memory where used rather than held in registers
  __shared__ ABlockWeights wbs[2];
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], F32_THREADS / 32);
    }
    for (int i = 0; i < ATT_STAGES; ++i) mbar_init(&kv_full[i], 1);
    mbar_init_fence();
    wbs[0] = p.blk[0];
  }
  __syncthreads();

  // ---- phase 0: y0 = silu(x.Wcv1 + b), the first ABlock's qkv ------------
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int q0 = (tile % tiles_per_band) * TM;
    const int bg = tile / tiles_per_band;                // image * area + band
    const size_t tok0 = (size_t)bg * nb + q0;            // global token index
    const int rows = min(TM, nb - q0);
    float* yt = ys + tok0 * YS;
    gemm_f32<TM, HD_>(ring, &p.x_map, 0, (int)tok0, rows,
                      static_cast<const float*>(p.wcv1), p.cin, c_,
                      [&](int r, int col, float4 v) {
      st4(yt + (size_t)r * YS + col, silu4(v, bias4(p.bcv1, col)));
    });
    const ABlockWeights& b0 = wbs[0];
    float* qt = qkv0 + tok0 * QS;
    gemm_f32<TM, HD_>(ring, &p.ys_map, 0, (int)tok0, rows,
                      static_cast<const float*>(b0.wqkv), c_, QS,
                      [&](int r, int col, float4 v) {
      st4(qt + (size_t)r * QS + col, add4(v, bias4(b0.bqkv, col)));
    });
  }
  fence_proxy_async_global();        // qkv is read by TMA in the next phase
  grid.sync();

  // ---- one phase per ABlock ----------------------------------------------
  for (int a = 0; a < n_blocks; ++a) {
    const bool last = a == n_blocks - 1;
    if (tid == 0) {
      wbs[0] = p.blk[a];
      if (!last) wbs[1] = p.blk[a + 1];
    }
    __syncthreads();
    const ABlockWeights& wb = wbs[0];
    const float* cur = (a & 1) ? qkv1 : qkv0;
    float* const nxt = (a & 1) ? qkv0 : qkv1;
    const CUtensorMap* kv_map = &p.kv_map[a & 1];
    const int slot_out = a / 2 + 1, slot_in = slot_out - 1 + (a & 1);
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int q0 = (tile % tiles_per_band) * TM;
      const int bg = tile / tiles_per_band;
      const int band = bg % p.area;
      const size_t band0 = (size_t)bg * nb;              // band's first token
      const size_t img0 = band0 - (size_t)band * nb;     // image's first token
      const size_t tok0 = band0 + q0;
      const int rows = min(TM, nb - q0);
      float* t1 = p.work + tok0 * WK;                    // [rows][c_]
      float* ht = t1 + c_;                               // [rows][hid]
      float* u = ht + hid;                               // [rows][ca]
      float* yt = ys + tok0 * YS;

      // o, head by head, into u
      for (int h = 0; h < p.heads; ++h)
        attend_f32<TM, HD_>(smem, kv_full, kv_used, kv_map, cur, QS, ca, bg,
                            q0, band0, rows, nb, h, sl2, u, WK);
      // u = o + dw7x7(v) + bpe (f32: the rounding is the identity)
      const int C4 = ca / 4, runs = (rows + RUN_F32 - 1) / RUN_F32;
      for (int i = tid; i < runs * C4; i += F32_THREADS) {
        const int r0s = RUN_F32 * (i / C4), c = 4 * (i % C4);
        const int len = min(RUN_F32, rows - r0s);
        const int n0 = band * nb + q0 + r0s, y = n0 / W, x0 = n0 % W;
        const float* v = cur + img0 * QS + 2 * ca + c;
        const float* w = wb.wpe + c;
        const float4 bp = bias4(wb.bpe, c);
        float4 acc[RUN_F32];
        if (x0 + len <= W) {
#pragma unroll
          for (int t = 0; t < RUN_F32; ++t)
            acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
          dw7x7_f32<RUN_F32>(v, QS, w, ca, H, W, y, x0, acc);
        } else {
          for (int t = 0; t < len; ++t) {
            float4 one[1] = {make_float4(0.f, 0.f, 0.f, 0.f)};
            dw7x7_f32<1>(v, QS, w, ca, H, W, (n0 + t) / W, (n0 + t) % W, one);
            acc[t] = one[0];
          }
        }
        for (int t = 0; t < len; ++t) {
          float* up = u + (size_t)(r0s + t) * WK + c;
          st4(up, add4(ld4(up), add4(acc[t], bp)));
        }
      }
      // t1 = t + (u.Wproj + b)
      gemm_f32<TM, HD_>(ring, &p.work_map, c_ + hid, (int)tok0, rows,
                        static_cast<const float*>(wb.wproj), ca, c_,
                        [&](int r, int col, float4 v) {
        const float4 t = ld4(yt + (size_t)r * YS + slot_in * c_ + col);
        st4(t1 + (size_t)r * WK + col, add4(t, add4(v, bias4(wb.bproj, col))));
      });
      // h = silu(t1.Wm1 + b)
      gemm_f32<TM, HD_>(ring, &p.work_map, 0, (int)tok0, rows,
                        static_cast<const float*>(wb.wm1), c_, hid,
                        [&](int r, int col, float4 v) {
        st4(ht + (size_t)r * WK + col, silu4(v, bias4(wb.bm1, col)));
      });
      // t = t1 + (h.Wm2 + b), kept in ys for the next ABlock and for cv2
      gemm_f32<TM, HD_>(ring, &p.work_map, c_, (int)tok0, rows,
                        static_cast<const float*>(wb.wm2), hid, c_,
                        [&](int r, int col, float4 v) {
        const float4 t = ld4(t1 + (size_t)r * WK + col);
        st4(yt + (size_t)r * YS + slot_out * c_ + col,
            add4(t, add4(v, bias4(wb.bm2, col))));
      });
      if (!last) {
        const ABlockWeights& nw = wbs[1];
        float* qt = nxt + tok0 * QS;
        gemm_f32<TM, HD_>(ring, &p.ys_map, slot_out * c_, (int)tok0, rows,
                          static_cast<const float*>(nw.wqkv), c_, QS,
                          [&](int r, int col, float4 v) {
          st4(qt + (size_t)r * QS + col, add4(v, bias4(nw.bqkv, col)));
        });
      } else {
        // out = silu(concat(y0, z1..zn).Wcv2 + b)
        float* ot = out + tok0 * c2;
        gemm_f32<TM, HD_>(ring, &p.ys_map, 0, (int)tok0, rows,
                          static_cast<const float*>(p.wcv2), YS, c2,
                          [&](int r, int col, float4 v) {
          st4(ot + (size_t)r * c2 + col, silu4(v, bias4(p.bcv2, col)));
        });
      }
    }
    if (!last) {
      fence_proxy_async_global();
      grid.sync();
    }
    __syncthreads();                 // wbs read before the next phase's
  }
}

// CTAs of a2c2f_f32_kernel<TM, HD_> an SM runs at once (0 on error).
template <int TM, int HD_>
int f32_per_sm() {
  static const int n = [] {
    constexpr auto kernel = a2c2f_f32_kernel<TM, HD_>;
    int k = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)F32Layout<TM, HD_>::BYTES) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &k, kernel, F32_THREADS, F32Layout<TM, HD_>::BYTES) !=
            cudaSuccess)
      k = 0;
    return k;
  }();
  return n;
}

// The grid must be co-resident for grid.sync(): no more CTAs than the SMs
// hold at once, never a smaller tile to make it fit. The maps are encoded
// here: x, ys and the work scratch in boxes of 32 columns x TM rows, the
// two qkv buffers as (3ca, nb, bands) in boxes of 32 channels x 64 keys.
template <int TM, int HD_>
cudaError_t launch_f32_tile(Params& p, cudaStream_t s,
                            const DeviceInfo& info) {
  const int nb = p.H * p.W / p.area;
  const long tokens = (long)p.B * p.H * p.W;
  const int YS = (p.n_stages + 1) * p.c_, WK = p.c_ + p.hid + p.ca;
  cudaError_t e = matrix_map(&p.x_map, p.x, tokens, p.cin, p.cin, TM);
  if (e == cudaSuccess) e = matrix_map(&p.ys_map, p.ys, tokens, YS, YS, TM);
  if (e == cudaSuccess)
    e = matrix_map(&p.work_map, p.work, tokens, WK, WK, TM);
  for (int i = 0; i < 2 && e == cudaSuccess; ++i)
    e = band_map(&p.kv_map[i], i ? p.qkv1 : p.qkv0, p.B * p.area, nb,
                 3 * p.ca, KB_ATT, true);
  if (e != cudaSuccess) return e;
  const int per_sm = f32_per_sm<TM, HD_>();
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long total = (long long)p.B * p.area * ((nb + TM - 1) / TM);
  const long long resident = (long long)per_sm * info.sms;
  const int blocks = (int)(total < resident ? total : resident);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)a2c2f_f32_kernel<TM, HD_>,
                                  dim3(blocks), dim3(F32_THREADS), args,
                                  F32Layout<TM, HD_>::BYTES, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// f32 at the wrapper's token tile (`kernels/a2c2f.py::f32_tile`): every
// width a multiple of 4, every pointer 16-byte aligned and the GEMM
// weights packed (the wrapper pads and packs).
cudaError_t launch_f32(Params& p, int tile, cudaStream_t s,
                       const DeviceInfo& info) {
  if (p.cin % 4 || p.c_ % 4 || p.hid % 4 || p.c2 % 4)
    return cudaErrorInvalidValue;
  const bool wide = p.ca == 64 * p.heads;
  if (tile == 64)
    return wide ? launch_f32_tile<64, 64>(p, s, info)
                : launch_f32_tile<64, 32>(p, s, info);
  if (tile == 32)
    return wide ? launch_f32_tile<32, 64>(p, s, info)
                : launch_f32_tile<32, 32>(p, s, info);
  return cudaErrorInvalidValue;
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
constexpr int KB_MMA = 256;            // keys a tile of the streamed layout
constexpr int MAX_GEMMS = 4;           // GEMMs one tile runs in a phase

__host__ __device__ inline int pad16(int k) { return (k + 15) & ~15; }
// row stride of an activation tile of K columns: 16 bytes past a multiple
// of 32, so the 8 rows of one ldmatrix phase fall in 8 bank groups
__host__ __device__ inline int tile_ld(int k) { return pad16(k) + 8; }

__host__ __device__ inline int big_cols(int cin, int hid, int c_,
                                        int n_stages) {
  const int a = pad16(hid), b = (n_stages + 1) * c_, m = a > b ? a : b;
  return pad16(cin) > m ? pad16(cin) : m;
}

// The `big` tile's row stride: x, h, the ys concat, or the f32 positional
// term of ca channels (2 ca bf16 wide), whichever is widest.
__host__ __device__ inline int big_ld(int cin, int hid, int c_, int ca,
                                      int n_stages) {
  const int b = big_cols(cin, hid, c_, n_stages);
  return tile_ld(b > 2 * ca ? b : 2 * ca);
}

// Dynamic shared memory of the bf16 kernel at token tile TILE and head
// width hd (bytes): the weight ring, one head's keys and values of a band,
// the attention partials, the t (c_ wide) and u (ca wide) tiles and the
// `big` tile.
__host__ __device__ inline size_t mma_smem_bytes(int TILE, bool stream,
                                                 int cin, int hid, int c_,
                                                 int ca, int hd, int n_stages,
                                                 int nb) {
  const size_t kv_rows = stream ? KB_MMA : pad16(nb);
  return sizeof(bf16) *
             ((size_t)RING * SLAB + 2 * kv_rows * hd +
              (size_t)TILE * (tile_ld(c_) + tile_ld(ca) +
                              big_ld(cin, hid, c_, ca, n_stages))) +
         sizeof(float) * (size_t)MMA_WARPS * part_floats(hd);
}

// One GEMM of a phase: weight (K, N) row-major, streamed through the ring
// as stages of KS rows x NP columns, panel by panel (nk stages a panel).
// vec: the rows are whole 16-byte chunks, copied by cp.async.
struct GemmDesc {
  const bf16* w;
  const float* b;         // the f32 bias, handed to the epilogue
  int K, N, nk, total, vec;
};

__device__ __forceinline__ GemmDesc gemm_desc(const void* w, const float* b,
                                              int K, int N) {
  GemmDesc d;
  d.w = static_cast<const bf16*>(w);
  d.b = b;
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
// of each panel epi(row, col, v0, v1, two, b) gets the f32 sums of columns
// col and, if `two`, col + 1 (col < N) of every row of the tile, and the
// GEMM's bias b (read from its descriptor here, not held by the caller).
template <int TILE, typename Epi>
__device__ __forceinline__ void gemm_mma(WeightStream& ws, bf16* ring,
                                         const bf16* A, int lda, Epi epi) {
  constexpr int MT = TILE / 16;
  const int gi = ws.cg++;
  const GemmDesc d = ws.d[gi];
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
      // the bias read here, after this stage's barrier, so that no register
      // holds it through the GEMM (the kernel is at its register limit)
      const float* bias = ws.d[gi].b;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n_w + 8 * j + 2 * t;
        if (col >= N) continue;
        const bool two = col + 1 < N;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          epi(16 * m + g, col, acc[m][j][0], acc[m][j][1], two, bias);
          epi(16 * m + g + 8, col, acc[m][j][2], acc[m][j][3], two, bias);
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

// The bf16 kernel: the phases, tiles and rounding points of the f32 kernel,
// with tiles of TILE tokens (TILE / 16 query tiles) whose activations are bf16
// in shared memory (every GEMM operand is a value already rounded to bf16),
// every GEMM on the tensor cores, and the attention of each head (HD_
// channels) split over the 8 warps: query tile warp % QT, key part warp /
// QT of S = 8 / QT. STREAM: the band's keys and values pass through Ks / Vs
// KB_MMA at a time (for bands whose whole keys and values would pass a
// block), each warp attending the part of its key range that a tile holds,
// its state carried from tile to tile. GENERIC: the attention's width ca is
// the wrapper's (heads padded) and the ABlocks' pointers come from the
// device array; else (the fast path) ca is c_, known here to be so, and the
// pointers come from the parameter block.
template <int TILE, bool STREAM = false, int HD_ = 32, bool GENERIC = false>
__global__ void __launch_bounds__(MMA_WARPS * 32)
a2c2f_mma_kernel(const Params p) {
  constexpr int QT = TILE / 16, S = MMA_WARPS / QT;
  constexpr int PARTS = part_floats(HD_), CH = HD_ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ GemmDesc descs[MAX_GEMMS];
  // GENERIC: this phase's pe taps and bias (the GEMMs' weights and biases
  // are in descs), read from shared memory where used
  __shared__ const float* pe_taps[2];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = p.H, W = p.W, N = H * W, cin = p.cin, c_ = p.c_, c2 = p.c2;
  const int ca = GENERIC ? p.ca : c_;        // the attention's width
  const int nb = N / p.area, Np = pad16(nb);
  const int tiles_per_band = (nb + TILE - 1) / TILE;
  const int total = p.B * p.area * tiles_per_band;
  const int YS = (p.n_stages + 1) * c_, QS = 3 * ca;
  const int n_blocks = 2 * p.n_stages;
  const int ldt = tile_ld(c_), ldu = GENERIC ? tile_ld(ca) : ldt;
  // big_ld(cin, p.hid, c_, ca, n_stages) (2 c_ <= (n_stages + 1) c_), in
  // the form whose schedule keeps the time the kernel had before the MLP
  // width was a parameter: written directly, nvcc's allocation cost layer 8
  // 5 % on an H100 (tools/time_builds.py, PERF.md)
  const int ldb =
      GENERIC ? tile_ld(max(max(big_cols(cin, 2 * c_, c_, p.n_stages),
                                pad16(p.hid)), 2 * ca))
              : tile_ld(max(big_cols(cin, 2 * c_, c_, p.n_stages),
                            pad16(p.hid)));

  const int KV = STREAM ? KB_MMA : Np;                 // key rows held
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);      // [RING][KS][LDS]
  bf16* Ks = ring + RING * SLAB;                       // [KV][HD] swizzled
  bf16* Vs = Ks + KV * HD_;                            // [KV][HD] swizzled
  float* parts = reinterpret_cast<float*>(Vs + KV * HD_);  // [8][PARTS]
  bf16* tT = reinterpret_cast<bf16*>(parts + MMA_WARPS * PARTS);
  bf16* uT = tT + TILE * ldt;                            // [TILE][ldu]
  bf16* big = uT + TILE * ldu;                           // [TILE][ldb]
  float* pe = reinterpret_cast<float*>(big);           // [TILE][ca] f32

  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* out = static_cast<bf16*>(p.out);
  bf16* ys = static_cast<bf16*>(p.ys);                 // scratch: plain loads
  bf16* const qkv0 = static_cast<bf16*>(p.qkv0);
  bf16* const qkv1 = static_cast<bf16*>(p.qkv1);
  const float sl2 = p.scale * LOG2E;
  WeightStream ws;

  // ---- phase 0: y0 = silu(x.Wcv1 + b), the first ABlock's qkv ------------
  if (tid == 0) {
    const ABlockWeights b0 = GENERIC ? p.blk[0] : p.inl[0];
    descs[0] = gemm_desc(p.wcv1, p.bcv1, cin, c_);
    descs[1] = gemm_desc(b0.wqkv, b0.bqkv, c_, QS);
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
      gemm_mma<TILE>(ws, ring, big, ldb,
                   [&](int row, int col, float v0, float v1, bool two,
                       const float* b) {
        const float y0 = silu(v0 + p.bcv1[col]);
        const float y1 = two ? silu(v1 + p.bcv1[col + 1]) : 0.f;
        store2(tT + row * ldt + col, y0, y1, two, true);
        if (row < rows) store2(ys + (tok0 + row) * YS + col, y0, y1, two, true);
      });
    }
    {
      gemm_mma<TILE>(ws, ring, tT, ldt,
                   [&](int row, int col, float v0, float v1, bool two,
                       const float* b) {
        const float* bq = GENERIC ? b : p.inl[0].bqkv;
        if (row < rows)
          store2(qkv0 + (tok0 + row) * QS + col, v0 + bq[col],
                 two ? v1 + bq[col + 1] : 0.f, two, true);
      });
    }
    __syncthreads();
  }
  grid.sync();

  // ---- one phase per ABlock ----------------------------------------------
  for (int a = 0; a < n_blocks; ++a) {
    const bf16* cur = (a & 1) ? qkv1 : qkv0;
    bf16* const nxt = (a & 1) ? qkv0 : qkv1;
    const bool last = a == n_blocks - 1;
    const int slot_out = a / 2 + 1, slot_in = slot_out - 1 + (a & 1);
    // the fast path's ABlock, from the parameter block (uniform, no
    // registers held); GENERIC reads the device array below
    const ABlockWeights wb = GENERIC ? ABlockWeights{} : p.inl[a];
    if (tid == 0) {
      const ABlockWeights w = GENERIC ? p.blk[a] : wb;
      pe_taps[0] = w.wpe;
      pe_taps[1] = w.bpe;
      descs[0] = gemm_desc(w.wproj, w.bproj, ca, c_);
      descs[1] = gemm_desc(w.wm1, w.bm1, c_, p.hid);
      descs[2] = gemm_desc(w.wm2, w.bm2, p.hid, c_);
      if (last) {
        descs[3] = gemm_desc(p.wcv2, p.bcv2, YS, c2);
      } else {
        const ABlockWeights nw = GENERIC ? p.blk[a + 1] : p.inl[a + 1];
        descs[3] = gemm_desc(nw.wqkv, nw.bqkv, c_, QS);
      }
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
        for (int i = tid; i < Np * CH; i += blockDim.x) {
          const int n = i / CH, c = i % CH;
          const bf16* row = cur + (band0 + (n < nb ? n : 0)) * QS + h * HD_ +
                            8 * c;
          cp_async16(Ks + kv_at<HD_>(n, c), row + ca, n < nb);
          cp_async16(Vs + kv_at<HD_>(n, c), row + 2 * ca, n < nb);
        }
        cp_async_commit();
      };
      // STREAM: keys t0 .. t0 + KV - 1 of head h (zero past nb), the same
      // swizzle (t0 is a multiple of 8); one commit group
      auto stage_keys = [&](int h, int t0) {
        for (int i = tid; i < KV * CH; i += blockDim.x) {
          const int r = i / CH, c = i % CH, n = t0 + r;
          const bf16* row = cur + (band0 + (n < nb ? n : 0)) * QS + h * HD_ +
                            8 * c;
          cp_async16(Ks + kv_at<HD_>(r, c), row + ca, n < nb);
          cp_async16(Vs + kv_at<HD_>(r, c), row + 2 * ca, n < nb);
        }
        cp_async_commit();
      };
      stream_start(ws, descs, MAX_GEMMS, ring);          // lands meanwhile
      if constexpr (STREAM) stage_keys(0, 0);            // this one too
      else stage_kv(0);
      load_rows<TILE>(tT, ldt, ys + tok0 * YS + slot_in * c_, YS, c_, rows);

      // pe = dw7x7(v) + bpe, f32, SIMT: a thread takes 8 channels of RUN
      // consecutive tokens, which share each row's RUN + 6 loads where they
      // lie in one image row (else one token at a time)
      const int C8 = ca / 8, runs = (rows + RUN - 1) / RUN;
      for (int i = tid; i < runs * C8; i += blockDim.x) {
        const int r0s = RUN * (i / C8), c = 8 * (i % C8);
        const int len = min(RUN, rows - r0s);
        const int n0 = band * nb + q0 + r0s, y = n0 / W, x0 = n0 % W;
        const bf16* v = cur + img0 * QS + 2 * ca + c;
        const float* w = (GENERIC ? pe_taps[0] : wb.wpe) + c;
        const float* bpe = GENERIC ? pe_taps[1] : wb.bpe;
        if (x0 + len <= W) {
          float acc[RUN][8] = {};
          dw7x7_run<RUN>(v, QS, w, ca, H, W, y, x0, acc);
#pragma unroll
          for (int t = 0; t < RUN; ++t)
            if (t < len)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                pe[(r0s + t) * ca + c + e] = acc[t][e] + bpe[c + e];
        } else {
          for (int t = 0; t < len; ++t) {
            float acc[1][8] = {};
            dw7x7_run<1>(v, QS, w, ca, H, W, (n0 + t) / W, (n0 + t) % W, acc);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              pe[(r0s + t) * ca + c + e] = acc[0][e] + bpe[c + e];
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
        uint32_t qa[HD_ / 16][4];
        if (r0 < rows) {
          const uint32_t* qg =
              reinterpret_cast<const uint32_t*>(cur + tok0 * QS + h * HD_);
#pragma unroll
          for (int s = 0; s < HD_ / 16; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) {   // rows g, g + 8; cols +0, +8
              const int r = r0 + g + 8 * (e & 1);
              const int col = 16 * s + 8 * (e >> 1) + 2 * t4;
              qa[s][e] = r < rows ? qg[((size_t)r * QS + col) / 2] : 0u;
            }
        }
        if constexpr (STREAM) {
          AttnState<HD_> st;
          attn_init(st);
          for (int t0 = 0; t0 < Np; t0 += KV) {
            if (t0 > 0) stage_keys(h, t0);
            cp_async_wait<0>();
            __syncthreads();           // keys t0.. landed for every thread
            const int b = max(kb, t0), e = min(ke, t0 + KV);
            if (r0 < rows && b < e)    // warp-uniform
              attend_keys_mma<KT_A2, HD_>(qa, Ks, Vs, b - t0, e - t0,
                                          min(nb, e) - t0, sl2, st);
            __syncthreads();           // the tile read
          }
          if (r0 < rows) store_partial(st, parts + warp * PARTS);
          __syncthreads();             // the partials written
          if (h + 1 < p.heads) stage_keys(h + 1, 0);  // lands during the merge
        } else {
          cp_async_wait<0>();
          __syncthreads();             // head h's k/v landed for every thread
          if (r0 < rows) {             // warp-uniform
            AttnState<HD_> st;
            attn_init(st);
            if (kb < ke)
              attend_keys_mma<KT_A2, HD_>(qa, Ks, Vs, kb, ke, min(nb, ke),
                                          sl2, st);
            store_partial(st, parts + warp * PARTS);
          }
          __syncthreads();             // k/v read, the partials written
          if (h + 1 < p.heads) stage_kv(h + 1);   // lands during the merge
        }
        for (int i = tid; i < TILE * HD_; i += blockDim.x) {
          const int r = i / HD_, c = i % HD_;
          float u = 0.f;
          if (r < rows)
            u = merge_partials<HD_>(parts + (r / 16) * PARTS, QT * PARTS, S,
                                    r % 16, c) +
                pe[r * ca + h * HD_ + c];
          uT[r * ldu + h * HD_ + c] = __float2bfloat16_rn(u);
        }
      }

      // t = (t + u.Wproj + b) -> T
      gemm_mma<TILE>(ws, ring, uT, ldu,
                   [&](int row, int col, float v0, float v1, bool two,
                       const float* b) {
        bf16* tp = tT + row * ldt + col;
        const float* bp = GENERIC ? b : wb.bproj;
        const float t0 = __bfloat162float(tp[0]) + (v0 + bp[col]);
        const float t1 =
            two ? __bfloat162float(tp[1]) + (v1 + bp[col + 1]) : 0.f;
        store2(tp, t0, t1, two, true);
      });
      // h = silu(t.Wm1 + b) -> T
      gemm_mma<TILE>(ws, ring, tT, ldt,
                   [&](int row, int col, float v0, float v1, bool two,
                       const float* b) {
        const float* bm = GENERIC ? b : wb.bm1;
        store2(big + row * ldb + col, silu(v0 + bm[col]),
               two ? silu(v1 + bm[col + 1]) : 0.f, two, true);
      });
      // t = (t + h.Wm2 + b) -> T, kept for the next ABlock and for cv2
      gemm_mma<TILE>(ws, ring, big, ldb,
                   [&](int row, int col, float v0, float v1, bool two,
                       const float* b) {
        bf16* tp = tT + row * ldt + col;
        const float* bm = GENERIC ? b : wb.bm2;
        const float t0 =
            round_bf16(__bfloat162float(tp[0]) + (v0 + bm[col]));
        const float t1 =
            two ? round_bf16(__bfloat162float(tp[1]) + (v1 + bm[col + 1]))
                : 0.f;
        store2(tp, t0, t1, two, true);
        if (row < rows)
          store2(ys + (tok0 + row) * YS + slot_out * c_ + col, t0, t1, two,
                 true);
      });
      if (!last) {
        gemm_mma<TILE>(ws, ring, tT, ldt,
                     [&](int row, int col, float v0, float v1, bool two,
                       const float* b) {
          const float* bq = GENERIC ? b : p.inl[a + 1].bqkv;
          if (row < rows)
            store2(nxt + (tok0 + row) * QS + col, v0 + bq[col],
                   two ? v1 + bq[col + 1] : 0.f, two, true);
        });
      } else {
        // out = silu(concat(y0, z1..zn).Wcv2 + b) -> T
        __syncthreads();              // h read, this tile's ys written
        load_rows<TILE>(big, ldb, ys + tok0 * YS, YS, YS, rows);
        const bool pair = c2 % 2 == 0;
        gemm_mma<TILE>(ws, ring, big, ldb,
                     [&](int row, int col, float v0, float v1, bool two,
                       const float* b) {
          if (row < rows)
            store2(out + (tok0 + row) * c2 + col, silu(v0 + p.bcv2[col]),
                   two ? silu(v1 + p.bcv2[col + 1]) : 0.f, two, pair);
        });
      }
      __syncthreads();
    }
    if (!last) grid.sync();
  }
}

// a block's 227 KB less the static GEMM descriptors and pe pointers
constexpr size_t SMEM_LIMIT =
    227 * 1024 - sizeof(GemmDesc) * MAX_GEMMS - sizeof(const float*) * 2;

// Lets a2c2f_mma_kernel<TILE, STREAM, HD_, GENERIC> use all of SMEM_LIMIT
// (once).
template <int TILE, bool STREAM, int HD_, bool GENERIC>
cudaError_t allow_mma_smem() {
  static const cudaError_t e =
      cudaFuncSetAttribute(a2c2f_mma_kernel<TILE, STREAM, HD_, GENERIC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_LIMIT);
  return e;
}

// CTAs of a2c2f_mma_kernel<TILE, STREAM, HD_, GENERIC> an SM runs at once
// with `smem` bytes (0 where none or on error); kept, since a query costs
// more host time than a launch.
template <int TILE, bool STREAM, int HD_, bool GENERIC>
int mma_per_sm(size_t smem) {
  static std::mutex mu;
  static std::map<size_t, int> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(smem);
  if (it != known.end()) return it->second;
  int n = 0;
  if (allow_mma_smem<TILE, STREAM, HD_, GENERIC>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, a2c2f_mma_kernel<TILE, STREAM, HD_, GENERIC>, MMA_WARPS * 32,
          smem) != cudaSuccess)
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
template <int TILE, bool STREAM = false, int HD_ = 32, bool GENERIC = false>
void consider(const Params& p, const DeviceInfo& info, Plan& best) {
  const int nb = p.H * p.W / p.area;
  const size_t smem = mma_smem_bytes(TILE, STREAM, p.cin, p.hid, p.c_, p.ca,
                                     HD_, p.n_stages, nb);
  if (smem > SMEM_LIMIT) return;
  const long long resident =
      (long long)mma_per_sm<TILE, STREAM, HD_, GENERIC>(smem) * info.sms;
  if (resident < 1) return;
  const long long tiles = (long long)p.B * p.area * ((nb + TILE - 1) / TILE);
  const long long waves = (tiles + resident - 1) / resident;
  if (best.tile == 0 || waves < best.waves)
    best = {TILE, smem, resident, waves};
}

// The grid must be co-resident for grid.sync(): no more CTAs than the
// plan's resident count.
template <int TILE, bool STREAM = false, int HD_ = 32, bool GENERIC = false>
cudaError_t launch_mma_tile(Params& p, cudaStream_t s, const Plan& plan) {
  const int nb = p.H * p.W / p.area;
  const long long total = (long long)p.B * p.area * ((nb + TILE - 1) / TILE);
  const int blocks = (int)(total < plan.resident ? total : plan.resident);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)a2c2f_mma_kernel<TILE, STREAM, HD_, GENERIC>, dim3(blocks),
      dim3(MMA_WARPS * 32), args, plan.smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The token tile of 16, 32 or 64 whose grid takes the fewest waves (the
// smaller tile on a tie), else (a band too long for any) 16 streamed. On an
// H100 at batch 8 that is 64 for layer 6 (224 tiles, 2 waves, against 4 of
// 32-token tiles) and 32 for layer 8 (104 tiles, 1 wave). Padded heads,
// heads 64 wide and more stages than the parameter block holds (shapes no
// yolov12 module builds) take the general form at the 16-token tile,
// resident or streamed.
template <int HD_>
cudaError_t launch_mma_generic(Params& p, cudaStream_t s,
                               const DeviceInfo& info) {
  Plan plan = {};
  consider<16, false, HD_, true>(p, info, plan);
  if (plan.tile) return launch_mma_tile<16, false, HD_, true>(p, s, plan);
  consider<16, true, HD_, true>(p, info, plan);
  if (plan.tile == 0) return cudaErrorCooperativeLaunchTooLarge;
  return launch_mma_tile<16, true, HD_, true>(p, s, plan);
}

cudaError_t launch_mma(Params& p, cudaStream_t s, const DeviceInfo& info) {
  if (p.ca == 64 * p.heads) return launch_mma_generic<64>(p, s, info);
  if (p.ca != p.c_ || 2 * p.n_stages > INLINE_BLOCKS)
    return launch_mma_generic<32>(p, s, info);
  Plan plan = {};
  consider<16>(p, info, plan);
  consider<32>(p, info, plan);
  consider<64>(p, info, plan);
  switch (plan.tile) {
    case 16: return launch_mma_tile<16>(p, s, plan);
    case 32: return launch_mma_tile<32>(p, s, plan);
    case 64: return launch_mma_tile<64>(p, s, plan);
  }
  // no layout holds the band's keys and values: stream them
  consider<16, true>(p, info, plan);
  if (plan.tile == 0) return cudaErrorCooperativeLaunchTooLarge;
  return launch_mma_tile<16, true>(p, s, plan);
}

cudaError_t launch(Params& p, int dtype, int tile, cudaStream_t s) {
  DeviceInfo info;
  cudaError_t e = device_info(&info);
  if (e != cudaSuccess) return e;
  if (!info.cooperative) return cudaErrorNotSupported;
  return dtype == 0 ? launch_f32(p, tile, s, info) : launch_mma(p, s, info);
}

}  // namespace

// x: (B, H, W, cin), out: (B, H, W, c2) of the I/O type, channels last.
// weights: host array of 4 + 20 * n_stages device pointers in the order
// [cv1_w, cv1_b] + per ABlock [qkv_w, qkv_b, pe_w (7,7,ca), pe_b, proj_w,
// proj_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b] + [cv2_w, cv2_b]; GEMM weights
// (cin_i, cout_i) of the I/O type (qkv (c_, 3ca), proj (ca, c_)), biases and
// pe_w f32; the MLP's hidden width hid (mlp1_w (c_, hid), mlp2_w (hid, c_);
// bf16: a multiple of 16). ys: scratch of B*H*W*(n_stages+1)*c_ elements,
// qkv: scratch of 2*B*H*W*3*ca elements of the I/O type. dtype 0 = float32,
// 1 = bfloat16. blocks: a device copy of the 20 * n_stages ABlock pointers
// (weights[2 .. 2 + 20 n_stages)); ca: the attention's width, heads * 32
// or heads * 64; scale: the softmax's (the true head width ** -0.5); f32
// only: work, scratch of B*H*W*(c_+hid+ca) floats, and tile, the token
// tile (64 or 32), with cin, c_, hid and c2 multiples of 4 and every
// pointer 16-byte aligned. Returns the launch status.
extern "C" int yolou_a2c2f(const void* x, const void* const* weights,
                           int n_weights, void* out, void* ys, void* qkv,
                           int B, int H, int W, int cin, int c_, int c2,
                           int hid, int n_stages, int area, int heads,
                           int dtype, const void* blocks, void* work, int ca,
                           float scale, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || c2 <= 0 || heads <= 0 ||
      area <= 0 || (ca != heads * 32 && ca != heads * 64) || c_ <= 0 ||
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
  for (int a = 0; a < 2 * n_stages && a < INLINE_BLOCKS; ++a) {
    const void* const* w = weights + 2 + 10 * a;
    ABlockWeights& k = p.inl[a];
    k.wqkv = w[0]; k.bqkv = static_cast<const float*>(w[1]);
    k.wpe = static_cast<const float*>(w[2]);
    k.bpe = static_cast<const float*>(w[3]);
    k.wproj = w[4]; k.bproj = static_cast<const float*>(w[5]);
    k.wm1 = w[6]; k.bm1 = static_cast<const float*>(w[7]);
    k.wm2 = w[8]; k.bm2 = static_cast<const float*>(w[9]);
  }
  p.wcv2 = weights[n_weights - 2];
  p.bcv2 = static_cast<const float*>(weights[n_weights - 1]);
  p.B = B; p.H = H; p.W = W; p.cin = cin; p.c_ = c_; p.ca = ca; p.c2 = c2;
  p.hid = hid; p.n_stages = n_stages; p.area = area; p.heads = heads;
  p.scale = scale;
  return (int)launch(p, dtype, tile, static_cast<cudaStream_t>(stream));
}

// Kernels A and C at bands of 64 tokens or fewer: the multi-head band
// attention of whole bands in one launch, both types; kernel A (`PROJECT`)
// also its folded qkv projection. Replaces, for those bands,
// yolou_tpu/ops/pallas_attn.py::area_attention_qkv_fused (Pallas body
// _qkv_attn_kernel), area_attention_fused (body _fused_kernel) and
// area_attention (body _attn_kernel, one head); the longer bands run
// band_attention.cu's streamed path. For every band g and head h of hd = 32
// or 64 channels (other widths arrive padded, with the true scale):
//   qkv = x[g] . w[:, role*C + h*hd + d] + b    (kernel A: f32 sums,
//                                                rounded to T)
//   e   = exp(q k^T * scale - the full row's maximum)            (f32)
//   o   = (e -> T) v / sum(e)                    (f32 sum of unrounded e)
// and kernel A writes v out too (it feeds the dw7x7 conv). All of a row's
// keys are in the tile, so the softmax is one pass against the full row's
// maximum, in the order of _fused_kernel and _qkv_attn_kernel, with no
// online rescaling.
//
// Packing. A tile is 64 rows of P = 64 / N whole bands (2 at N = 25, 4 at
// N = 16, 1 from 33 to 64): one TMA box of a 3-D map (C, N, G) spans the
// P bands (bands past G read zero), so the wgmma m64 shape and the f32
// micro-tiles hold short bands with little padding (a streamed CTA pads 25
// tokens to a 64-row block and a 64- or 128-key tile). Scores between two
// bands of a tile are masked (a key counts for a row only inside the row's
// band); rows past P N are zero (kernel A's x, kernel C's k and v), and
// no row past P N or past band G is stored.
//
// A CTA per (tile, head). Kernel A: x's 32-channel slabs and the head's q,
// k and v weight columns ((C, 3 hd) of the (C, 3C) weight) stream through a
// ring of up to 4 stages by TMA (all of them in flight at once where C <=
// 128; at larger C, thread 0 refills a stage once the product that read it
// is done), so no C is refused; q, k and s never touch HBM, and there is
// no scratch and no second launch. Kernel C: q, k and v of the head arrive
// by one TMA box each (bf16: hd channels, the head's swizzle; f32: a box a
// 32-channel block, the 128-byte swizzle: the layouts `kv_at`, `f32_at` and
// the wgmma descriptors read), all three issued at once on one mbarrier.
// While they fly, the rows past P N of the k and v tiles, which no box
// writes, are zeroed, once a CTA: a masked key gives p = 0, but 0 times
// stale shared memory can be NaN.
//
// bf16 (`band_attention_short_wgmma_kernel<HD_, PROJECT>`, one warpgroup):
// kernel A projects q, k and v by wgmma (m64n{hd}k16, x K-major, the weight
// columns MN-major, both from shared memory, f32 accumulation), adds the
// bias and rounds to bf16: q stays in registers as the A fragments of S =
// q k^T (m64n64k16, k K-major from shared memory), k and v go to shared
// memory as hopper.cuh's head-wide tiles, v also to the second output.
// Kernel C takes S from its q and k tiles (m64n64k16, both K-major from
// shared memory). The softmax runs on S's accumulator; the probabilities,
// rounded to bf16 in registers, are the A operand of O = P V
// (m64n{hd}k16, v MN-major). What bounds it: at (64, 25, 64) h2 the whole
// call is 0.6 MB and 17 MFLOP, a few microseconds of HBM or tensor cores at
// most; it waits on latency (the TMA loads, the dependent wgmma groups,
// the exp chain), so it keeps a CTA small (128 threads, 25-83 KB) and
// launches once.
//
// f32 (`band_attention_short_f32_kernel<R, HD_, PROJECT>`, tiles of R = 64
// rows, or 32 (`kernels/attention.py::short_rows`): twice the CTAs at the
// same padding; 4 R threads): full f32 on the FMA units, no TF32. Kernel
// A's projection on register micro-tiles: thread (ty, tx) of R / 4 x 16
// owns 4 rows x hd / 16 columns of each of q, k and v, each output one
// chain of FMAs over the channels in order, x from the 128-byte swizzled
// slab (broadcast loads), the weight columns likewise; q, k and v then go
// to shared memory over the ring's space (kernel C's arrive there by TMA).
// The attention is the streamed f32 kernel's micro-tiles without the online
// steps: 16 threads a group of 4 rows, a thread's 4 x R / 16 scores against
// keys t, t + 16, ..., the row maximum and sum by shuffles within the
// group, p.v as a second micro-tile product over half the keys a thread.
// What bounds it: the FMA rate, (kernel A's 2 * R * 3 hd * C +) 4 * R * R *
// hd flop a CTA, far below a microsecond of the card's 67 TFLOP/s at these
// grids; it waits on the issue of those FMAs on the few SMs a small grid
// fills, and on latency, and keeps to one launch.

#include <type_traits>

#include "band_attention.cuh"
#include "hopper.cuh"

using namespace yolou;

namespace {

using bf16 = __nv_bfloat16;

constexpr int SHORT_ROWS = 64;     // rows of a tile: P = 64 / N whole bands
constexpr int SHORT_KC = 32;       // channels of a ring stage (x's slab)
constexpr int SHORT_STAGES = 4;    // the ring, at most
constexpr int LDP_SHORT = 76;      // f32 probability rows (floats), as LDP

// The ring's stages at width C: one a 32-channel slab, at most 4.
__host__ __device__ constexpr int short_stages(int C) {
  return C / SHORT_KC < SHORT_STAGES ? C / SHORT_KC : SHORT_STAGES;
}

// Rows [lo, lo + N) of a tile: the band of row r.
__device__ __forceinline__ int band_start(int r, int N) { return r / N * N; }

// A tile of R rows (64; the f32 kernel also 32): the ring's slots, x's
// slab [R][32] then the head's weight columns, three roles of [32][hd]
// (bf16) or three x hd / 32 boxes of [32][32] (f32), all as TMA writes them
// (swizzled, each box on a 1024-byte boundary); a q, k or v tile [R][hd].
template <int R, int HD_>
struct ShortLayout {
  static constexpr int XS = R * SHORT_KC;                 // elements
  static constexpr int WROLE = SHORT_KC * HD_;            // a role's
  static constexpr int STAGE = XS + 3 * WROLE;
  static constexpr int HEADT = R * HD_;
};

// The bf16 kernel (above). PROJECT (kernel A): a_map x ((C, N, G), boxes
// of 32 channels x N tokens x P bands, 64-byte swizzle), b_map the (C, 3C)
// weight (boxes of HD_ columns x 32 rows), c_map not read. Else (kernel
// C): a_map, b_map, c_map q, k, v ((C, N, G), boxes of HD_ channels x N
// tokens x P bands, the head's swizzle); bias and v_out not read. c_map
// comes last: the other parameters sit where a two-map signature puts
// them.
// PAD (kernel C only): heads of hd channels, padded to HD_ by the boxes of
// `head_map`s (q, k, v: (G, N, heads hd), C = heads hd); o's stores are
// cut to the head's hd channels. The kernels below call this body.
template <int HD_, bool PROJECT, bool PAD>
__device__ __forceinline__ void short_wgmma(
    const CUtensorMap& a_map, const CUtensorMap& b_map,
    const float* __restrict__ bias, bf16* __restrict__ o,
    bf16* __restrict__ v_out, int G, int N, int C, int P, float sl2,
    const CUtensorMap& c_map, int hd) {
  static_assert(!(PAD && PROJECT), "kernel A pads its operands");
  using L = ShortLayout<SHORT_ROWS, HD_>;
  extern __shared__ unsigned char smem_raw[];
  const int stages = short_stages(C), chunks = C / SHORT_KC;
  // kernel A: the ring, then the k and v tiles; kernel C: q, k, v tiles
  bf16* ring = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* Ks = ring + (PROJECT ? stages * L::STAGE : L::HEADT);  // [64][HD_]
  bf16* Vs = Ks + L::HEADT;                              // [64][HD_]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + L::HEADT);
  const int h = blockIdx.x, g0 = blockIdx.y * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r_lo = 16 * warp + gq, r_hi = r_lo + 8;     // this thread's rows
  const int packed = P * N;                              // rows in the box
  const int real = min(P, G - g0) * N;                   // rows stored

  uint32_t qa[HD_ / 16][4];          // kernel A: q as S's A fragments
  if constexpr (PROJECT) {
    auto issue = [&](int c) {          // thread 0: x's slab c and its weights
      bf16* st = ring + (c % stages) * L::STAGE;
      uint64_t* bar = &full[c % stages];
      mbar_expect_tx(bar, (packed * SHORT_KC + 3 * L::WROLE) * sizeof(bf16));
      tma_load_3d(st, &a_map, bar, SHORT_KC * c, 0, g0);
#pragma unroll
      for (int role = 0; role < 3; ++role)
        tma_load_2d(st + L::XS + role * L::WROLE, &b_map, bar,
                    role * C + h * HD_, SHORT_KC * c);
    };
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) mbar_init(&full[i], 1);
      mbar_init_fence();
    }
    // rows past P N of every slab are never loaded: zero, so k and v there
    // are the bias alone (finite, masked, never stored)
    for (int i = tid; i < stages * (SHORT_ROWS - packed) * 4; i += 128) {
      const int st = i / ((SHORT_ROWS - packed) * 4);
      const int rc = i % ((SHORT_ROWS - packed) * 4);
      *reinterpret_cast<uint4*>(ring + st * L::STAGE +
                                (packed + rc / 4) * SHORT_KC + 8 * (rc % 4)) =
          make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_prefetch(&a_map);
      tma_prefetch(&b_map);
      for (int c = 0; c < stages; ++c) issue(c);
    }

    // ---- q, k, v = x . W + b on wgmma, chunk by chunk through the ring
    float q[HD_ / 2], k[HD_ / 2], v[HD_ / 2];
#pragma unroll
    for (int e = 0; e < HD_ / 2; ++e) q[e] = k[e] = v[e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const bf16* st = ring + (c % stages) * L::STAGE;
      mbar_wait(&full[c % stages], (c / stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SHORT_KC / 16; ++kk) {
        const uint64_t da = smem_desc(st + 16 * kk);
        const int acc = c > 0 || kk > 0;
        const bf16* wk = st + L::XS + 16 * kk * HD_;
        wgmma_proj<HD_>(q, da, head_desc<HD_>(wk), acc);
        wgmma_proj<HD_>(k, da, head_desc<HD_>(wk + L::WROLE), acc);
        wgmma_proj<HD_>(v, da, head_desc<HD_>(wk + 2 * L::WROLE), acc);
      }
      // each chunk's products done within its iteration: a wgmma group left
      // open across the loop's back edge makes ptxas serialize them (C7515)
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < HD_ / 2; ++e) {
        reg_fence(q[e]);
        reg_fence(k[e]);
        reg_fence(v[e]);
      }
      if (c + stages < chunks) {       // block-uniform: refill this stage
        __syncthreads();               // every thread's product read it
        if (tid == 0) issue(c + stages);
      }
    }

    // bias, rounded to bf16: q as the A fragments of S (k step j / 2), k and
    // v into their tiles, v also out for the real rows
    bf16* vg = v_out + (size_t)g0 * N * C + h * HD_ + 2 * t;
#pragma unroll
    for (int j = 0; j < HD_ / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float* bq = bias + h * HD_ + col;
      qa[j / 2][2 * (j % 2)] =
          pack_bf16(q[4 * j] + bq[0], q[4 * j + 1] + bq[1]);
      qa[j / 2][2 * (j % 2) + 1] =
          pack_bf16(q[4 * j + 2] + bq[0], q[4 * j + 3] + bq[1]);
      const float* bk = bq + C;
      *reinterpret_cast<uint32_t*>(Ks + kv_at<HD_>(r_lo, j) + 2 * t) =
          pack_bf16(k[4 * j] + bk[0], k[4 * j + 1] + bk[1]);
      *reinterpret_cast<uint32_t*>(Ks + kv_at<HD_>(r_hi, j) + 2 * t) =
          pack_bf16(k[4 * j + 2] + bk[0], k[4 * j + 3] + bk[1]);
      const float* bv = bq + 2 * C;
      const uint32_t v_lo = pack_bf16(v[4 * j] + bv[0], v[4 * j + 1] + bv[1]);
      const uint32_t v_hi =
          pack_bf16(v[4 * j + 2] + bv[0], v[4 * j + 3] + bv[1]);
      *reinterpret_cast<uint32_t*>(Vs + kv_at<HD_>(r_lo, j) + 2 * t) = v_lo;
      *reinterpret_cast<uint32_t*>(Vs + kv_at<HD_>(r_hi, j) + 2 * t) = v_hi;
      if (r_lo < real)
        *reinterpret_cast<uint32_t*>(vg + (size_t)r_lo * C + 8 * j) = v_lo;
      if (r_hi < real)
        *reinterpret_cast<uint32_t*>(vg + (size_t)r_hi * C + 8 * j) = v_hi;
    }
    fence_proxy_async();
    __syncthreads();                   // the k and v tiles written
  } else {
    // q, k and v of the P bands, a box each, all three in flight on one
    // barrier; meanwhile the rows past P N of k and v are zeroed (rows the
    // boxes never write: contiguous, as the swizzle moves 16-byte chunks
    // within a row only); q's rows there only feed rows never stored
    if (tid == 0) {
      mbar_init(full, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(full, 3 * packed * HD_ * sizeof(bf16));
      tma_load_head<PAD>(ring, &a_map, full, h, HD_, 0, 0, g0);
      tma_load_head<PAD>(Ks, &b_map, full, h, HD_, 0, 0, g0);
      tma_load_head<PAD>(Vs, &c_map, full, h, HD_, 0, 0, g0);
    }
    for (int i = packed * HD_ / 8 + tid; i < L::HEADT / 8; i += 128) {
      *reinterpret_cast<uint4*>(Ks + 8 * i) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vs + 8 * i) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
    __syncthreads();
    mbar_wait(full, 0);
  }

  // ---- S = q k^T over the tile's 64 keys (keys 8 j + 2 t + e of rows
  // r_lo / r_hi at s[4 j + e] / s[4 j + 2 + e])
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD_ / 16; ++kk) {
    if constexpr (PROJECT)
      wgmma_64x64_rs_k(s, qa[kk], head_desc<HD_>(Ks) + 2 * kk, kk > 0);
    else
      wgmma_64x64_ss_k(s, head_desc<HD_>(ring) + 2 * kk,
                       head_desc<HD_>(Ks) + 2 * kk, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 32; ++e) reg_fence(s[e]);

  // one pass against the full row's maximum: a key counts only inside the
  // row's band (its own key is there, so the maximum is finite)
  const int lo0 = band_start(r_lo, N), lo1 = band_start(r_hi, N);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = 8 * j + 2 * t + e;
      if (key < lo0 || key >= lo0 + N) s[4 * j + e] = -INFINITY;
      if (key < lo1 || key >= lo1 + N) s[4 * j + 2 + e] = -INFINITY;
    }
  const float m_lo = quad_max(row_reduce<true, 0, 8>(s));
  const float m_hi = quad_max(row_reduce<true, 2, 8>(s));
  const float nb_lo = -m_lo * sl2, nb_hi = -m_hi * sl2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, nb_lo));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sl2, nb_hi));
    }
  const float l_lo = quad_sum(row_reduce<false, 0, 8>(s));
  const float l_hi = quad_sum(row_reduce<false, 2, 8>(s));

  // ---- O = P V: the probabilities rounded to bf16 as A fragments, 4 steps
  // of 16 keys
  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  float oacc[HD_ / 2];
#pragma unroll
  for (int e = 0; e < HD_ / 2; ++e) oacc[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<HD_>(oacc, p[kk], head_desc<HD_>(Vs + kk * 16 * HD_));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < HD_ / 2; ++e) reg_fence(oacc[e]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(p[kk][e]);

  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  bf16* og = o + (size_t)g0 * N * C + (PAD ? h * hd : h * HD_) + 2 * t;
#pragma unroll
  for (int j = 0; j < HD_ / 8; ++j) {
    if (PAD && 8 * j >= hd) break;     // channels past the head (hd % 8 == 0)
    if (r_lo < real)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r_lo * C + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j] * inv_lo,
                                oacc[4 * j + 1] * inv_lo);
    if (r_hi < real)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r_hi * C + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv_hi,
                                oacc[4 * j + 3] * inv_hi);
  }
}

template <int HD_, bool PROJECT>
__global__ void __launch_bounds__(128)
band_attention_short_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                                  const __grid_constant__ CUtensorMap b_map,
                                  const float* __restrict__ bias,
                                  bf16* __restrict__ o,
                                  bf16* __restrict__ v_out, int G, int N,
                                  int C, int P, float sl2,
                                  const __grid_constant__ CUtensorMap c_map) {
  short_wgmma<HD_, PROJECT, false>(a_map, b_map, bias, o, v_out, G, N, C, P,
                                   sl2, c_map, HD_);
}

// Kernel C at heads of hd channels padded to HD_ inside the kernel (`PAD`
// above): q, k, v by `head_map`s, o (G, N, C = heads hd).
template <int HD_>
__global__ void __launch_bounds__(128)
band_attention_short_padded_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int G,
    int N, int C, int P, float sl2, int hd) {
  short_wgmma<HD_, false, true>(q_map, k_map, nullptr, o, nullptr, G, N, C,
                                P, sl2, v_map, hd);
}

// The f32 kernel (above) at tiles of R = 64 or 32 rows (P = R / N bands),
// 4 R threads. PROJECT (kernel A): a_map x ((C, N, G), boxes of 32
// channels x N tokens x P bands, 128-byte swizzle), b_map the (C, 3C)
// weight (boxes of 32 columns x 32 rows, 128-byte swizzle), c_map not read.
// Else (kernel C): a_map, b_map, c_map q, k, v (boxes of 32 channels x N
// tokens x P bands, 128-byte swizzle: `f32_at`'s blocks); bias and v_out
// not read; c_map last, as the bf16 kernel's.
// PAD as the bf16 body's: kernel C at heads of hd channels padded to HD_.
template <int R, int HD_, bool PROJECT, bool PAD>
__device__ __forceinline__ void short_f32(
    const CUtensorMap& a_map, const CUtensorMap& b_map,
    const float* __restrict__ bias, float* __restrict__ o,
    float* __restrict__ v_out, int G, int N, int C, int P, float sl2,
    const CUtensorMap& c_map, int hd) {
  static_assert(!(PAD && PROJECT), "kernel A pads its operands");
  using L = ShortLayout<R, HD_>;
  constexpr int CB = HD_ / 32;       // 32-channel blocks of a head
  constexpr int CW = HD_ / 16;       // columns of a role a projecting thread
  constexpr int U = R / 16;          // keys a thread scores: t + 16 u
  constexpr int PH = R / 2 + 4;      // a key half's offset in a P row
  constexpr int ATTN = 3 * L::HEADT + R * LDP_SHORT;
  extern __shared__ unsigned char smem_raw[];
  const int stages = short_stages(C), chunks = C / SHORT_KC;
  float* ring = reinterpret_cast<float*>(align1024(smem_raw));
  // q, k, v [R][HD_] (f32_at's layout) and the probabilities
  // [R][LDP_SHORT]; kernel A's over its ring
  float* Qs = ring;
  float* Ks = Qs + L::HEADT;
  float* Vs = Ks + L::HEADT;
  float* Ps = Vs + L::HEADT;
  const int region = PROJECT ? max(stages * L::STAGE, ATTN) : ATTN;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + region);
  const int h = blockIdx.x, g0 = blockIdx.y * P;
  const int tid = threadIdx.x;
  const int packed = P * N, real = min(P, G - g0) * N;

  if constexpr (PROJECT) {
    auto issue = [&](int c) {          // thread 0: x's slab c and its weights
      float* st = ring + (c % stages) * L::STAGE;
      uint64_t* bar = &full[c % stages];
      mbar_expect_tx(bar, (packed * SHORT_KC + 3 * L::WROLE) * sizeof(float));
      tma_load_3d(st, &a_map, bar, SHORT_KC * c, 0, g0);
#pragma unroll
      for (int role = 0; role < 3; ++role)
#pragma unroll
        for (int b = 0; b < CB; ++b)
          tma_load_2d(st + L::XS + role * L::WROLE + b * SHORT_KC * 32, &b_map,
                      bar, role * C + h * HD_ + 32 * b, SHORT_KC * c);
    };
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) mbar_init(&full[i], 1);
      mbar_init_fence();
    }
    for (int i = tid; i < stages * (R - packed) * 8; i += 4 * R) {
      const int st = i / ((R - packed) * 8);   // rows past P N: zero (bf16's)
      const int rc = i % ((R - packed) * 8);
      *reinterpret_cast<float4*>(ring + st * L::STAGE +
                                 (packed + rc / 8) * SHORT_KC + 4 * (rc % 8)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_prefetch(&a_map);
      tma_prefetch(&b_map);
      for (int c = 0; c < stages; ++c) issue(c);
    }

    // ---- q, k, v on micro-tiles: rows 4 ty + i, columns CW tx .. + CW - 1
    // of each role
    const int ty = tid >> 4, tx = tid & 15;
    float acc[3][4][CW];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[r][i][e] = 0.f;
    // the thread's columns in a role's boxes: box CW tx / 32, 16-byte chunk
    // (CW tx % 32) / 4, CW / 2 floats into it at HD_ 32 (a float2)
    const int wbox = (CW * tx) >> 5, wchunk = ((CW * tx) & 31) >> 2;
    const int woff = (CW * tx) & 3;
    for (int c = 0; c < chunks; ++c) {
      const float* st = ring + (c % stages) * L::STAGE;
      mbar_wait(&full[c % stages], (c / stages) & 1);
      const float* Wb = st + L::XS + wbox * SHORT_KC * 32;
#pragma unroll 2
      for (int kc = 0; kc < SHORT_KC / 4; ++kc) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              st + f32_at<32>(4 * ty + i, kc, R));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kr = 4 * kc + u;
          const int at = kr * 32 + ((wchunk ^ (kr & 7)) << 2) + woff;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            float wv[CW];
            if constexpr (CW == 4) {
              const float4 w4 =
                  *reinterpret_cast<const float4*>(Wb + r * L::WROLE + at);
              wv[0] = w4.x;
              wv[1] = w4.y;
              wv[2] = w4.z;
              wv[3] = w4.w;
            } else {
              const float2 w2 =
                  *reinterpret_cast<const float2*>(Wb + r * L::WROLE + at);
              wv[0] = w2.x;
              wv[1] = w2.y;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xv = lane_of(a[i], u);
#pragma unroll
              for (int e = 0; e < CW; ++e)
                acc[r][i][e] = fmaf(xv, wv[e], acc[r][i][e]);
            }
          }
        }
      }
      if (c + stages < chunks) {       // block-uniform: refill this stage
        __syncthreads();               // every thread read it
        if (tid == 0) issue(c + stages);
      }
    }
    __syncthreads();                   // every stage read: q, k, v go over it

    // bias; q, k, v into their tiles, v out for the real rows
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* br = bias + r * C + h * HD_ + CW * tx;
      float* tile = r == 0 ? Qs : r == 1 ? Ks : Vs;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * ty + i;
        float val[CW];
#pragma unroll
        for (int e = 0; e < CW; ++e) val[e] = acc[r][i][e] + br[e];
        // f32_at's chunk of columns CW tx ..: chunk CW tx / 4, float woff
        float* dst = tile + f32_at<HD_>(row, (CW * tx) >> 2, R) + woff;
        float* vo = v_out + ((size_t)g0 * N + row) * C + h * HD_ + CW * tx;
        if constexpr (CW == 4) {
          const float4 v4 = make_float4(val[0], val[1], val[2], val[3]);
          *reinterpret_cast<float4*>(dst) = v4;
          if (r == 2 && row < real) *reinterpret_cast<float4*>(vo) = v4;
        } else {
          const float2 v2 = make_float2(val[0], val[1]);
          *reinterpret_cast<float2*>(dst) = v2;
          if (r == 2 && row < real) *reinterpret_cast<float2*>(vo) = v2;
        }
      }
    }
    __syncthreads();
  } else {
    // q, k and v of the P bands, a box a 32-channel block, all in flight on
    // one barrier; meanwhile the rows past P N of k's and v's blocks are
    // zeroed (q's there only feed rows never stored)
    if (tid == 0) {
      mbar_init(full, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(full, 3 * packed * HD_ * sizeof(float));
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        tma_load_head<PAD>(Qs + b * R * 32, &a_map, full, h, HD_, 32 * b, 0,
                           g0);
        tma_load_head<PAD>(Ks + b * R * 32, &b_map, full, h, HD_, 32 * b, 0,
                           g0);
        tma_load_head<PAD>(Vs + b * R * 32, &c_map, full, h, HD_, 32 * b, 0,
                           g0);
      }
    }
    for (int i = tid; i < 2 * CB * (R - packed) * 8; i += 4 * R) {
      const int blk = i / ((R - packed) * 8);      // k's blocks, then v's
      const int rc = i % ((R - packed) * 8);
      *reinterpret_cast<float4*>(Ks + blk * R * 32 +
                                 (packed + rc / 8) * 32 + 4 * (rc % 8)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    mbar_wait(full, 0);
  }

  // ---- attention: a group of 16 threads owns rows 4 rg .. 4 rg + 3; for
  // the scores thread t takes keys t + 16 u, for p.v keys R / 2 half ..
  // and channels 4 cq .. 4 cq + 3 of each 32-channel block
  const int rg = tid >> 4, t = tid & 15, half = t >> 3, cq = t & 7;
  float s[4][U];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < U; ++u) s[a][u] = 0.f;
#pragma unroll
  for (int cc = 0; cc < HD_ / 4; ++cc) {
    float4 qv[4], kv[U];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      qv[a] = *reinterpret_cast<const float4*>(
          Qs + f32_at<HD_>(4 * rg + a, cc, R));
#pragma unroll
    for (int u = 0; u < U; ++u)
      kv[u] = *reinterpret_cast<const float4*>(
          Ks + f32_at<HD_>(t + 16 * u, cc, R));
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[a][u] = fmaf(qv[a].x, kv[u].x, s[a][u]);
        s[a][u] = fmaf(qv[a].y, kv[u].y, s[a][u]);
        s[a][u] = fmaf(qv[a].z, kv[u].z, s[a][u]);
        s[a][u] = fmaf(qv[a].w, kv[u].w, s[a][u]);
      }
  }
  // one pass against the full row's maximum (the row's own key is in its
  // band), probabilities exp2(s sl2 - m sl2), this thread's part of the sum
  float l[4];
  float* Pg = Ps + 4 * rg * LDP_SHORT;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int lo = band_start(4 * rg + a, N);
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + 16 * u < lo || t + 16 * u >= lo + N) s[a][u] = -INFINITY;
      mx = fmaxf(mx, s[a][u]);
    }
#pragma unroll
    for (int d = 1; d < 16; d <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, d));
    const float nb = -mx * sl2;
    l[a] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[a][u] = exp2f(fmaf(s[a][u], sl2, nb));
      l[a] += s[a][u];
      Pg[a * LDP_SHORT + t + 16 * u + (u >= U / 2 ? 4 : 0)] = s[a][u];
    }
  }
  __syncwarp();
  // O = P V over this thread's R / 2 keys, 4 at a time
  float oacc[4][4 * CB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e) oacc[a][e] = 0.f;
#pragma unroll 2
  for (int jj = 0; jj < R / 2; jj += 4) {
    float4 pv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      pv[a] = *reinterpret_cast<const float4*>(Pg + a * LDP_SHORT +
                                               PH * half + jj);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vs + f32_at<HD_>(R / 2 * half + jj + u, cq + 8 * b, R));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pp = lane_of(pv[a], u);
          float* ac = oacc[a] + 4 * b;
          ac[0] = fmaf(pp, vv.x, ac[0]);
          ac[1] = fmaf(pp, vv.y, ac[1]);
          ac[2] = fmaf(pp, vv.z, ac[2]);
          ac[3] = fmaf(pp, vv.w, ac[3]);
        }
      }
    }
  }
  // the row sums over the group, the two key halves added, rows 2 half and
  // 2 half + 1 of the group stored by this thread
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) l[a] += __shfl_xor_sync(FULL, l[a], d);
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e)
      oacc[a][e] += __shfl_xor_sync(FULL, oacc[a][e], 8);
  }
  float* og = o + (size_t)g0 * N * C + (PAD ? h * hd : h * HD_) + 4 * cq;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = 4 * rg + a;
    if ((a >> 1) == half && row < real) {
      const float inv = 1.f / l[a];
#pragma unroll
      for (int b = 0; b < CB; ++b)
        if (!PAD || 32 * b + 4 * cq < hd)   // the head's channels (hd % 4 == 0)
          *reinterpret_cast<float4*>(og + (size_t)row * C + 32 * b) =
              make_float4(oacc[a][4 * b] * inv, oacc[a][4 * b + 1] * inv,
                          oacc[a][4 * b + 2] * inv, oacc[a][4 * b + 3] * inv);
    }
  }
}

template <int R, int HD_, bool PROJECT>
__global__ void __launch_bounds__(4 * R)
band_attention_short_f32_kernel(const __grid_constant__ CUtensorMap a_map,
                                const __grid_constant__ CUtensorMap b_map,
                                const float* __restrict__ bias,
                                float* __restrict__ o,
                                float* __restrict__ v_out, int G, int N,
                                int C, int P, float sl2,
                                const __grid_constant__ CUtensorMap c_map) {
  short_f32<R, HD_, PROJECT, false>(a_map, b_map, bias, o, v_out, G, N, C, P,
                                    sl2, c_map, HD_);
}

// Kernel C at heads of hd channels padded to HD_ inside the kernel.
template <int R, int HD_>
__global__ void __launch_bounds__(4 * R)
band_attention_short_padded_f32_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, float* __restrict__ o, int G,
    int N, int C, int P, float sl2, int hd) {
  short_f32<R, HD_, false, true>(q_map, k_map, nullptr, o, nullptr, G, N, C,
                                 P, sl2, v_map, hd);
}

// Dynamic shared memory of the short kernels at width C, head width hd and
// tile rows R, kernel A (`project`) or C (bytes, with 1024 of slack for
// the tiles' alignment); `kernels/attention.py::short_smem_bytes` mirrors
// it.
size_t short_smem(int C, int hd, bool f32, int R, bool project) {
  const size_t stage = R * SHORT_KC + 3 * (size_t)SHORT_KC * hd;
  const size_t head = (size_t)R * hd;
  const int bars = project ? short_stages(C) : 1;
  // kernel A's ring, kernel C's q tile
  const size_t lead = project ? bars * stage : head;
  if (!f32) return 1024 + sizeof(bf16) * (lead + 2 * head) + 8 * bars;
  const size_t attn = 3 * head + R * LDP_SHORT;
  return 1024 + sizeof(float) * (project && lead > attn ? lead : attn) +
         8 * bars;
}

template <int HD_, bool F32, int R, bool PROJECT>
constexpr auto short_kernel() {
  if constexpr (F32) return band_attention_short_f32_kernel<R, HD_, PROJECT>;
  else return band_attention_short_wgmma_kernel<HD_, PROJECT>;
}

// bf16: R = 64, a warpgroup; f32: R = 64 or 32, 4 R threads. PROJECT: a =
// x, b = w (c not read); else a, b, c = q, k, v (bias and v not read).
template <int HD_, bool F32, int R, bool PROJECT>
cudaError_t launch_short(const void* a, const void* b, const void* c,
                         const void* bias, void* o, void* v, int G, int N,
                         int C, int heads, float scale, cudaStream_t s) {
  using T = std::conditional_t<F32, float, bf16>;
  constexpr auto kernel = short_kernel<HD_, F32, R, PROJECT>();
  if (N > R) return cudaErrorInvalidValue;
  const int P = R / N;
  // kernel C's boxes: the head (bf16) or a 32-channel block (f32)
  const int cols = PROJECT || F32 ? SHORT_KC : HD_;
  CUtensorMap am, bm, cm;
  cudaError_t e = band_map(&am, a, G, N, C, N, F32, cols, P);
  if (e == cudaSuccess)
    e = PROJECT ? weight_map(&bm, b, C, F32, F32 ? 32 : HD_)
                : band_map(&bm, b, G, N, C, N, F32, cols, P);
  if (e == cudaSuccess) {
    if (PROJECT) cm = bm;
    else e = band_map(&cm, c, G, N, C, N, F32, cols, P);
  }
  if (e == cudaSuccess) e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  kernel<<<dim3(heads, (G + P - 1) / P), F32 ? 4 * R : 128,
           short_smem(C, HD_, F32, R, PROJECT), s>>>(
      am, bm, static_cast<const float*>(bias), static_cast<T*>(o),
      static_cast<T*>(v), G, N, C, P, scale * LOG2E, cm);
  return cudaGetLastError();
}

// Either kernel (PROJECT) in either type at heads of 64 (`wide`) or 32
// channels, tiles of `rows` (bf16 64; f32 64 or 32).
template <bool PROJECT>
cudaError_t launch_short_at(bool wide, int dtype, int rows, const void* a,
                            const void* b, const void* c, const void* bias,
                            void* o, void* v, int G, int N, int C, int heads,
                            float scale, cudaStream_t s) {
  if (dtype == 1)
    return wide ? launch_short<64, false, 64, PROJECT>(a, b, c, bias, o, v, G,
                                                       N, C, heads, scale, s)
                : launch_short<32, false, 64, PROJECT>(a, b, c, bias, o, v, G,
                                                       N, C, heads, scale, s);
  if (rows != 64 && rows != 32) return cudaErrorInvalidValue;
  if (wide)
    return rows == 64 ? launch_short<64, true, 64, PROJECT>(
                            a, b, c, bias, o, v, G, N, C, heads, scale, s)
                      : launch_short<64, true, 32, PROJECT>(
                            a, b, c, bias, o, v, G, N, C, heads, scale, s);
  return rows == 64 ? launch_short<32, true, 64, PROJECT>(
                          a, b, c, bias, o, v, G, N, C, heads, scale, s)
                    : launch_short<32, true, 32, PROJECT>(
                          a, b, c, bias, o, v, G, N, C, heads, scale, s);
}

// What both entries refuse: G, N or heads out of range, heads neither 32
// nor 64 wide, another type, bf16 tiles other than 64 rows.
bool short_ok(int G, int N, int C, int heads, int dtype, int rows) {
  return G > 0 && N > 0 && N <= rows && heads > 0 && G <= 65535 &&
         (C == 32 * heads || C == 64 * heads) && (dtype == 0 || dtype == 1) &&
         (dtype == 0 || rows == SHORT_ROWS);
}

// Kernel C at heads of hd channels padded to HD_ (32 or 64) inside the
// kernel: q, k, v by `head_map`s, boxes of HD_ channels (bf16) or 32 (f32)
// x N tokens x P bands, the kernel widths' swizzles; one launch.
template <int HD_, bool F32, int R>
cudaError_t launch_short_padded(const void* q, const void* k, const void* v,
                                void* o, int G, int N, int heads, int hd,
                                float scale, cudaStream_t s) {
  using T = std::conditional_t<F32, float, bf16>;
  if (N > R) return cudaErrorInvalidValue;
  const int P = R / N, cols = F32 ? 32 : HD_;
  CUtensorMap qm, km, vm;
  cudaError_t e = head_map(&qm, q, G, N, heads, hd, N, F32, cols, P);
  if (e == cudaSuccess) e = head_map(&km, k, G, N, heads, hd, N, F32, cols, P);
  if (e == cudaSuccess) e = head_map(&vm, v, G, N, heads, hd, N, F32, cols, P);
  if (e != cudaSuccess) return e;
  const dim3 grid(heads, (G + P - 1) / P);
  const size_t smem = short_smem(heads * hd, HD_, F32, R, false);
  if constexpr (F32) {
    constexpr auto kernel = band_attention_short_padded_f32_kernel<R, HD_>;
    e = allow_smem<kernel>();
    if (e != cudaSuccess) return e;
    kernel<<<grid, 4 * R, smem, s>>>(qm, km, vm, static_cast<T*>(o), G, N,
                                     heads * hd, P, scale * LOG2E, hd);
  } else {
    constexpr auto kernel = band_attention_short_padded_wgmma_kernel<HD_>;
    e = allow_smem<kernel>();
    if (e != cudaSuccess) return e;
    kernel<<<grid, 128, smem, s>>>(qm, km, vm, static_cast<T*>(o), G, N,
                                   heads * hd, P, scale * LOG2E, hd);
  }
  return cudaGetLastError();
}

// One box of `cols` channels at (col0, head) x N tokens of band g, by a
// `head_map`, copied from shared memory to dst as it landed (swizzled).
__global__ void __launch_bounds__(128)
tma_head_box_kernel(const __grid_constant__ CUtensorMap map,
                    unsigned char* __restrict__ dst, int bytes, int col0,
                    int head, int g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* box = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(box + bytes);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, bytes);
    tma_load_4d(box, &map, bar, col0, head, 0, g);
  }
  mbar_wait(bar, 0);
  for (int i = threadIdx.x; i < bytes / 16; i += 128)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(box)[i];
}

}  // namespace

// Kernel A at bands of N <= rows tokens in one launch, dtype 0 = float32
// (FMA micro-tiles, tiles of rows = 64 or 32) or 1 = bfloat16 (wgmma, rows
// 64): x, o, v (G, N, C) with heads 32 or 64 wide; w (C, 3C); b (3C,) f32;
// scale the softmax's. Every tensor 16-byte aligned (TMA). A tensor map
// that cannot be encoded fails the call before the launch. Returns the
// launch status.
extern "C" int yolou_band_attention_qkv_short(const void* x, const void* w,
                                              const void* b, void* o,
                                              void* v, int G, int N, int C,
                                              int heads, int dtype, int rows,
                                              float scale, void* stream) {
  if (!short_ok(G, N, C, heads, dtype, rows))
    return (int)cudaErrorInvalidValue;
  return (int)launch_short_at<true>(C == 64 * heads, dtype, rows, x, w,
                                    nullptr, b, o, v, G, N, C, heads, scale,
                                    static_cast<cudaStream_t>(stream));
}

// Kernel C at bands of N <= rows tokens in one launch, dtype and rows as
// above: q, k, v, o (G, N, C), head-major channels, heads 32 or 64 wide;
// scale the softmax's. Every tensor 16-byte aligned (TMA). A tensor map
// that cannot be encoded fails the call before the launch. Returns the
// launch status.
extern "C" int yolou_band_attention_short(const void* q, const void* k,
                                          const void* v, void* o, int G,
                                          int N, int C, int heads, int dtype,
                                          int rows, float scale,
                                          void* stream) {
  if (!short_ok(G, N, C, heads, dtype, rows))
    return (int)cudaErrorInvalidValue;
  return (int)launch_short_at<false>(C == 64 * heads, dtype, rows, q, k, v,
                                     nullptr, o, nullptr, G, N, C, heads,
                                     scale, static_cast<cudaStream_t>(stream));
}

// Kernel C at bands of N <= rows tokens in one launch at heads of hd
// channels that no kernel is built for, padded inside the kernel (TMA fills
// the channels past hd with zeros; no copy of q, k or v): q, k, v, o (G, N,
// heads hd), dtype and rows as `yolou_band_attention_short`'s; hd neither
// 32 nor 64, at most 64, rows of a multiple of 16 bytes (bf16 hd % 8 == 0,
// f32 hd % 4 == 0). Every tensor 16-byte aligned (TMA). Returns the launch
// status.
extern "C" int yolou_band_attention_short_padded(const void* q, const void* k,
                                                 const void* v, void* o,
                                                 int G, int N, int heads,
                                                 int hd, int dtype, int rows,
                                                 float scale, void* stream) {
  if (!pads_in_kernel(hd, dtype == 0) || hd > 64 ||
      !short_ok(G, N, 32 * heads, heads, dtype, rows))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 32;
  if (dtype == 1)
    return (int)(wide ? launch_short_padded<64, false, 64>(
                            q, k, v, o, G, N, heads, hd, scale, s)
                      : launch_short_padded<32, false, 64>(
                            q, k, v, o, G, N, heads, hd, scale, s));
  if (wide)
    return (int)(rows == 64 ? launch_short_padded<64, true, 64>(
                                  q, k, v, o, G, N, heads, hd, scale, s)
                            : launch_short_padded<64, true, 32>(
                                  q, k, v, o, G, N, heads, hd, scale, s));
  return (int)(rows == 64 ? launch_short_padded<32, true, 64>(
                                q, k, v, o, G, N, heads, hd, scale, s)
                          : launch_short_padded<32, true, 32>(
                                q, k, v, o, G, N, heads, hd, scale, s));
}

// The head map's zero fill, for the card tests: one box of `cols` channels
// at (col0, head) x N tokens of band g of a (G, N, heads hd) tensor of
// dtype 0 = float32 or 1 = bfloat16, written to dst (N cols elements) as it
// landed in shared memory (its swizzle). N <= 256, the box's rows 64 or 128
// bytes. Returns the launch status.
extern "C" int yolou_tma_head_box(const void* src, void* dst, int G, int N,
                                  int heads, int hd, int dtype, int cols,
                                  int col0, int head, int g, void* stream) {
  const int elt = dtype == 0 ? 4 : 2, bytes = N * cols * elt;
  if (G <= 0 || N <= 0 || N > 256 || heads <= 0 || hd <= 0 ||
      (dtype != 0 && dtype != 1) || (cols * elt != 64 && cols * elt != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = head_map(&map, src, G, N, heads, hd, N, dtype == 0, cols);
  if (e == cudaSuccess) e = allow_smem<tma_head_box_kernel>();
  if (e != cudaSuccess) return (int)e;
  tma_head_box_kernel<<<1, 128, 1024 + bytes + 8,
                        static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<unsigned char*>(dst), bytes, col0, head, g);
  return (int)cudaGetLastError();
}

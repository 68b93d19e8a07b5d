// The whole-A2C2f kernel in f32 (a2c2f.cuh: what it computes, the data
// flow it shares with the bf16 kernel, the C entry).
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
//    Heads wider than 64 (HD = BLOCKED, `attend_f32_blocked`): a (head,
//    64-channel output block) pair at a time, the scores summed over the
//    head's 64-channel blocks, q's block riding in each stage with k's.
//  * the 7x7 stencil: 4 channels of 2 consecutive tokens a thread, 16-byte
//    predicated loads shared by the two tokens.
//  * TM: the tile whose grid puts the fewest token rows on the busiest SM
//    (64 on a tie: half the weight traffic), `kernels/a2c2f.py::f32_tile`.
//  Shared memory: the larger of the GEMM ring (4 * 4 * (32 TM + 32 NP)) and
//  the attention's stages, q and probabilities, at most 157 KB (TM 32, hd
//  64) at every shape.

#include "a2c2f.cuh"
#include "gemm_f32.cuh"

namespace cg = cooperative_groups;
using namespace yolou;
using namespace yolou::a2c2f;

namespace {

// ------------------------------------------------- f32 on register tiles

constexpr int F32_THREADS = GEMM_THREADS;
constexpr int STAGES = GEMM_STAGES;  // GEMM ring
constexpr int KB_ATT = 64;         // keys of an attention tile (a group's)
constexpr int ATT_STAGES = 2;      // attention ring
constexpr int LDP_ATT = 76;        // probability rows (floats), as kernel C
constexpr int RUN_F32 = 2;         // tokens a thread of the stencil takes

// The f32 kernel's shapes at token tile TM and head width HD_ (floats).
// GEMM (gemm_f32.cuh, `GemmTile`): thread (ty, tx) of a TY x TX grid owns
// 4 rows x 4 columns of a panel of NP columns; a stage holds the activation
// slab [TM][32] (one TMA box) and the weight slab [32][NP] (one bulk copy of
// the packed weight). Attention: a stage holds, per key group, k and v of
// 64 keys as HD_ / 32 boxes of [64][32] (128-byte swizzle), then q [TM][HD_
// + 4] and each group's probabilities [TM][LDP_ATT]. The blocked form
// (HD_ = BLOCKED, heads wider than 64): a stage holds the groups' k and v
// tiles of one 64-channel block and q's block [TM][64] (two boxes), no q
// tile of its own.
template <int TM, int HD_>
struct F32Layout : GemmTile<TM> {
  static constexpr int NG = 64 / TM;           // key groups: 1 or 2
  static constexpr int HB = HD_ == BLOCKED ? 64 : HD_;   // a tile's channels
  static constexpr int KV_TILE = KB_ATT * HB;  // one group's k (or v)
  static constexpr int Q_TILE = HD_ == BLOCKED ? TM * HB : 0;   // in a stage
  static constexpr int KV_STAGE = 2 * NG * KV_TILE + Q_TILE;
  static constexpr int LDQ = HB + 4;
  static constexpr int ATT = ATT_STAGES * KV_STAGE +
                             (HD_ == BLOCKED ? 0 : TM * LDQ) +
                             NG * TM * LDP_ATT;
  static constexpr int FLOATS =
      GemmTile<TM>::GEMM > ATT ? GemmTile<TM>::GEMM : ATT;
  // 1024 bytes of slack for the swizzled tiles' alignment, the barriers
  static constexpr size_t BYTES = 1024 + sizeof(float) * (size_t)FLOATS +
                                  8 * (2 * STAGES + ATT_STAGES);
};

// acc = A . W through the ring (`gemm_f32_stream`) with W packed by the
// wrapper as [panels][ceil32(K)][NP] (zero past K and N), a stage's slab
// one contiguous bulk copy.
template <int TM, int HD_, typename Epi>
__device__ __forceinline__ void gemm_f32(Ring& ring, const CUtensorMap* amap,
                                         int a_col, int a_row, int rows,
                                         const float* Wp, int K, int N,
                                         Epi epi) {
  using L = GemmTile<TM>;
  const int Kp = (K + KS_F32 - 1) / KS_F32 * KS_F32;
  gemm_f32_stream<TM>(
      ring, amap, a_col, a_row, rows,
      [=](float* dst, uint64_t* bar, int p, int k0) {
        bulk_load(dst, Wp + ((size_t)p * Kp + k0) * L::NP,
                  L::W_SLAB * sizeof(float), bar);
      },
      K, N, epi);
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

// The blocked form of `attend_f32` (heads of hdp channels, a multiple of
// 64): the attention of the tile's rows for output block ob (64 channels)
// of head h. The ring's unit is, per key tile, one of the head's 64-channel
// blocks j: the key groups' k block and q's block of the tile's rows (q_map:
// (3ca, nb, bands) boxes of 32 channels x TM rows, zero past the band), v's
// block ob riding with the last; the scores add over the units and the
// online softmax and p.v follow the last, as `attend_f32`'s (64 channels).
template <int TM>
__device__ __forceinline__ void attend_f32_blocked(
    float* smem, uint64_t* kv_full, int& kv_used, const CUtensorMap* kv_map,
    const CUtensorMap* q_map, int ca, int hdp, int bg, int q0, int rows,
    int nb, int h, int ob, float sl2, float* u, int ldu) {
  using L = F32Layout<TM, BLOCKED>;
  constexpr int NG = L::NG, CB = L::HB / 32, HB = L::HB;
  constexpr int KEYS = NG * KB_ATT;              // keys of a stage
  const int tid = threadIdx.x;
  const int grp = tid / (4 * TM);                // key group
  const int ltid = tid - grp * 4 * TM;
  const int rg = ltid >> 4, t = ltid & 15, half = t >> 3, cq = t & 7;
  float* Ps = smem + ATT_STAGES * L::KV_STAGE;   // [NG][TM][LDP_ATT]
  const int nbk = hdp / HB, c0 = h * hdp;
  const int units = (nb + KEYS - 1) / KEYS * nbk;

  auto issue = [&](int n) {          // thread 0: unit n, key tile n / nbk
    const int slot = (kv_used + n) % ATT_STAGES, j = n % nbk;
    const bool last = j == nbk - 1;
    float* st = smem + slot * L::KV_STAGE;
    mbar_expect_tx(&kv_full[slot],
                   (NG * (last ? 2 : 1) * L::KV_TILE + L::Q_TILE) *
                       sizeof(float));
    for (int g = 0; g < NG; ++g)
      for (int cb = 0; cb < CB; ++cb) {
        const int key = n / nbk * KEYS + g * KB_ATT;
        tma_load_3d(st + 2 * g * L::KV_TILE + cb * KB_ATT * 32, kv_map,
                    &kv_full[slot], ca + c0 + HB * j + 32 * cb, key, bg);
        if (last)
          tma_load_3d(st + (2 * g + 1) * L::KV_TILE + cb * KB_ATT * 32,
                      kv_map, &kv_full[slot],
                      2 * ca + c0 + HB * ob + 32 * cb, key, bg);
      }
    for (int cb = 0; cb < CB; ++cb)
      tma_load_3d(st + 2 * NG * L::KV_TILE + cb * TM * 32, q_map,
                  &kv_full[slot], c0 + HB * j + 32 * cb, q0, bg);
  };

  // the region's last readers done and their writes ordered before TMA
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) issue(0);
  float m[4], l[4], acc[4][4 * CB], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e) acc[i][e] = 0.f;
  }
  float* Pg = Ps + (grp * TM + 4 * rg) * LDP_ATT;  // the group's own rows
  for (int n = 0; n < units; ++n) {
    const int slot = (kv_used + n) % ATT_STAGES;
    mbar_wait(&kv_full[slot], ((kv_used + n) / ATT_STAGES) & 1);
    __syncthreads();                 // stage n - 1 free
    if (tid == 0 && n + 1 < units) issue(n + 1);
    const int j = n % nbk;
    const int k0 = n / nbk * KEYS + grp * KB_ATT;  // this group's keys
    if (k0 >= nb) continue;                      // group-uniform
    const float* Kt = smem + slot * L::KV_STAGE + 2 * grp * L::KV_TILE;
    const float* Vt = Kt + L::KV_TILE;
    const float* Qt = smem + slot * L::KV_STAGE + 2 * NG * L::KV_TILE;
    if (j == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a][0] = s[a][1] = s[a][2] = s[a][3] = 0.f;
    }
    f32_block_scores<TM>(s, Qt, Kt, rg, t);
    if (j < nbk - 1) continue;                   // the head's next block
    f32_softmax_pv<LDP_ATT>(s, m, l, acc, Pg, Vt, k0, nb, t, sl2);
  }
  kv_used += units;
  // row sums over the group, the two key halves of a thread pair added
  f32_group_sums(l, acc);
  float* mg = Ps;                                // NG = 2: group 1's state
  if (NG == 2) {
    __syncthreads();                             // every P read
    if (grp == 1) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* row = mg + (4 * rg + a) * (HB + 2);
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
      float c0s = 1.f, c1 = 0.f, den = l[a];
      const float* row = mg + r * (HB + 2);
      if (NG == 2) {
        const float M = fmaxf(m[a], row[0]);
        c0s = exp2f((m[a] - M) * sl2);           // a group that saw no key
        c1 = exp2f((row[0] - M) * sl2);          // has m = -inf: factor 0
        den = l[a] * c0s + row[1] * c1;
      }
      const float inv = 1.f / den;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = acc[a][4 * b + e] * c0s;
          if (NG == 2) o[e] += row[2 + 32 * b + 4 * cq + e] * c1;
          o[e] *= inv;
        }
        st4(u + (size_t)r * ldu + c0 + HB * ob + 32 * b + 4 * cq,
            make_float4(o[0], o[1], o[2], o[3]));
      }
    }
  }
  __syncthreads();                               // P and the stages free
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

  Ring ring = gemm_ring(smem, bars);
  uint64_t* kv_full = bars + 2 * STAGES;
  int kv_used = 0;
  // this phase's ABlock and the next one's (its qkv), read from shared
  // memory where used rather than held in registers
  __shared__ ABlockWeights wbs[2];
  if (tid == 0) {
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

      // o, head by head (wider heads a 64-channel block at a time), into u
      if constexpr (HD_ == BLOCKED) {
        const int hdp = ca / p.heads;
        for (int h = 0; h < p.heads; ++h)
          for (int ob = 0; ob < hdp / 64; ++ob)
            attend_f32_blocked<TM>(smem, kv_full, kv_used, kv_map,
                                   &p.q_map[a & 1], ca, hdp, bg, q0, rows,
                                   nb, h, ob, sl2, u, WK);
      } else {
        for (int h = 0; h < p.heads; ++h)
          attend_f32<TM, HD_>(smem, kv_full, kv_used, kv_map, cur, QS, ca,
                              bg, q0, band0, rows, nb, h, sl2, u, WK);
      }
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
// two qkv buffers as (3ca, nb, bands) in boxes of 32 channels x 64 keys
// (and, for the blocked form's q, x TM rows).
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
  for (int i = 0; i < 2 && e == cudaSuccess; ++i) {
    e = band_map(&p.kv_map[i], i ? p.qkv1 : p.qkv0, p.B * p.area, nb,
                 3 * p.ca, KB_ATT, true);
    if (e == cudaSuccess && HD_ == BLOCKED)
      e = band_map(&p.q_map[i], i ? p.qkv1 : p.qkv0, p.B * p.area, nb,
                   3 * p.ca, TM, true);
  }
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

}  // namespace

namespace yolou {
namespace a2c2f {

// f32 at the wrapper's token tile (`kernels/a2c2f.py::f32_tile`): every
// width a multiple of 4, every pointer 16-byte aligned and the GEMM
// weights packed (the wrapper pads and packs).
cudaError_t launch_f32(Params& p, int tile, cudaStream_t s,
                       const DeviceInfo& info) {
  if (p.cin % 4 || p.c_ % 4 || p.hid % 4 || p.c2 % 4)
    return cudaErrorInvalidValue;
  const int hd = p.ca / p.heads;
  if (tile == 64)
    return hd > 64    ? launch_f32_tile<64, BLOCKED>(p, s, info)
           : hd == 64 ? launch_f32_tile<64, 64>(p, s, info)
                      : launch_f32_tile<64, 32>(p, s, info);
  if (tile == 32)
    return hd > 64    ? launch_f32_tile<32, BLOCKED>(p, s, info)
           : hd == 64 ? launch_f32_tile<32, 64>(p, s, info)
                      : launch_f32_tile<32, 32>(p, s, info);
  return cudaErrorInvalidValue;
}

}  // namespace a2c2f
}  // namespace yolou

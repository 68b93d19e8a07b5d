// The whole-A2C2f kernel in bf16, warp-specialised for Hopper (a2c2f.cuh:
// what it computes, the data flow it shares with the f32 kernel, the C
// entry, defined at the end of this file).
//
// `a2c2f_wgmma_kernel<HD, L2>` (heads of HD = 32 or 64 channels, or
// BLOCKED: wider heads in 64-channel blocks, below): a CTA of
// three warpgroups owns a tile of TM = 64 or 32 tokens of one band (the
// wrapper's `f32_tile` rule: the fewest token rows on the busiest SM, 64 on
// a tie; a sweep of both tiles backs it, PERF.md) and
// runs every GEMM and the attention on wgmma with 64-row tiles, the rows past
// TM computed and never stored. Every operand a GEMM reads is a value already
// rounded to bf16 (x, y0, t, u, h, the ys concat), so the activations live
// in shared memory as bf16 at no loss of accuracy.
//  * The producer warpgroup (setmaxnreg asks 40 registers a thread for it,
//    232 for the two consumers; ptxas reports one of the two ignored,
//    C7507, and allocates 167-168 a thread, PERF.md): its thread 0
//    issues every copy, by TMA, in the order
//    the consumers use them: the GEMMs' weight stages (one bulk copy each of
//    a [128 columns][64 K] slab of the weight the wrapper packed K-major and
//    128-byte swizzled, `kernels/a2c2f.py::pack_bf16_weight`) into a ring of
//    2-4 stages with full and empty mbarriers, the first stages of an
//    ABlock's GEMMs before its attention (after the stencil's first v rows
//    and t) so that they land meanwhile; x and the ys concat as 64 x 64
//    boxes riding with cv1's and cv2's stages; t, the residual stream, as
//    boxes of its ys slot (zero past c_); per 64-channel block the stencil's
//    v rows; per head q (a [64][HD] box) and k and v in tiles of 128 keys
//    (boxes of a 3-D map of the qkv scratch that stop at the band's edge)
//    into the k/v ring of the consumer warpgroup that takes the head, two
//    stages a ring, the two rings filled in turns. A CTA holds one tile's
//    data at a time, so the next tile's t, v, q and k/v wait for the last
//    one's end (its `tile_done`); its weight stages do not.
//  * GEMMs: the first consumer warpgroup issues wgmma m64n128k16 with both
//    operands from shared memory in the 128-byte-swizzled K-major layout
//    (`sw_at`), whole 64-column K blocks (zeros past K in both operands),
//    f32 accumulators in registers, staged per 128-column panel in shared
//    memory; both consumer warpgroups then run the epilogue in one loop
//    (bias, SiLU, the f32 residual read from the t tile, the bf16 stores to
//    the t or h tile, followed by a proxy fence, and to ys, qkv or out in
//    global memory, a row's columns by consecutive threads, 8 rows' loads
//    issued before their stores). The GEMMs of a phase are a list in shared
//    memory, each with its epilogue's description, walked by one loop: one
//    copy of the code.
//  * Attention: the streamed bf16 core of band_attention.cu, a head a
//    consumer warpgroup, the two heads of a 64-channel block at once: S = q
//    k^T on wgmma, the online softmax on the accumulator in exp2 with the
//    true scale folded in, the probabilities rounded to bf16 in registers as
//    the A operand of O += P V (v MN-major), the product of tile i - 1
//    issued with tile i's scores, f32 o. Every band length streams. Heads
//    wider than 64 (`attend_blocked`): the first consumer warpgroup attends
//    each (head, 64-channel output block) pair, its scores summed over the
//    head's blocks, a unit of the k/v ring a key tile's k block with q's
//    block (v's riding with the last), in the memory of a head of 64; each
//    block recomputes the head's softmax.
//  * The 7x7 stencil from shared memory: per block of 64 channels the v
//    rows of the tile's tokens +- 3 image rows + 3 tokens (boxes of a map
//    of the qkv scratch by image, zero outside it), a thread of both
//    consumer warpgroups 8 channels of 2 consecutive tokens sharing each tap
//    row's 16-byte loads; pe in f32 into a [64][72] f32 tile, added to o in
//    the attention's epilogue, (o + pe) rounded once into u. Those rows are
//    6 W + 70 of them, so for images too wide for a block (`plan`) the
//    kernel's L2 form (`a2c2f_wgmma_kernel<HD, true>`) reads the stencil's
//    taps from the qkv scratch through L2 instead, the same loop on global
//    addresses. A form of its own, since that code in the staged kernel
//    took registers from the rest (1-4 % slower, PERF.md).
// What bounds it: latency, not the tensor cores or bytes. A CTA is one an
// SM (its shared memory), so each SM sub-partition runs one or two of the
// warps that compute; the second consumer warpgroup (the attention's two
// heads at once, half of each epilogue and stencil) is what hides part of
// it (PERF.md).
// Shared memory (`layout`, mirrored by `kernels/a2c2f.py::bf16_layout`):
// the weight ring (16 KB a stage), the t and u tiles (8 KB a 64-column
// block), and one region holding in turn the attention's buffers (q tiles,
// the k/v rings, the stencil's v rows, pe) and the GEMMs' (the h tile or the
// x / ys boxes of cv1 and cv2, then the accumulator's staging); then the
// mbarriers. It does not grow with cin or the stage count; the v rows grow
// with the image's width, and are left out where they would not fit. The h
// tile grows with the MLP's width (up64(hid) x 64 bf16): where no layout
// with it fits (`plan`: wide MLPs, mlp_ratio 3 and up at c_ 216-256), h
// lives in global memory instead (the `work` scratch the wrapper then
// allocates, (tokens, hid) bf16): mlp1's epilogue stores the tile's rows
// there (silu, rounded to bf16: the same rounding point), and mlp2 reads
// them back as 64 x 64 boxes riding with its weight stages, as cv2 reads
// the ys concat, after the same proxy fence and barrier (`ys_ready`).

#include <map>
#include <mutex>

#include "a2c2f.cuh"

namespace cg = cooperative_groups;
using namespace yolou;
using namespace yolou::a2c2f;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 384;       // a producer and two consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
constexpr int REGS_PRODUCER = 40;  // setmaxnreg of the producer warpgroup
constexpr int REGS_CONSUMER = 232; // and of the consumers
constexpr int ROWS = 64;           // rows of every wgmma tile
constexpr int KBLK = 64;           // columns of a 128-byte-swizzled block
constexpr int PANEL = 128;         // output columns of a GEMM panel
constexpr int W_STAGE = PANEL * KBLK;    // elements of a weight stage
constexpr int A_BLOCK = ROWS * KBLK;     // elements of an activation block
constexpr int MAX_RING = 4;        // weight ring stages at most
constexpr int KV_KEYS = 128;       // keys a k/v tile
constexpr int PE_LD = 72;          // floats a row of the positional term
constexpr int STAGE_LD = 136;      // floats a row of a staged accumulator
constexpr int VB_MAX = 256;        // tokens a stencil box at most
constexpr int CBLK = 64;           // channels a stencil block
constexpr int CONSUMERS = 1;       // named barrier of the consumer warpgroups
constexpr int TURN = 2;            // and the two of their turns (2, 3)
constexpr int KV_STAGES = 2;       // a k/v ring's stages (one ring a head)
constexpr int N_BARS = 2 * MAX_RING + 4 * KV_STAGES + 4 * 2 + 5;
// a block's 227 KB less 1 KB for the static shared memory (the phase's
// GEMMs)
constexpr int SMEM_LIMIT = 227 * 1024 - 1024;

// Heads of 32 take a k/v ring and two q slots per consumer warpgroup (two
// heads at once), heads of 64 one ring and two slots (the first warpgroup):
// 64 KB of k/v and 16 KB of q either way. Heads wider than 64 (BLOCKED)
// lay out as heads of 64: a ring stage of their blocked form holds a 64-
// channel k block, v's and, in the stage's q slot, q's.
__host__ __device__ constexpr int kv_rings(int hd) { return hd == 64 ? 1 : 2; }
__host__ __device__ inline int up64(int k) { return (k + 63) & ~63; }

// Byte offsets of the shared-memory regions (from a 1024-byte boundary).
// hid: the MLP's width held as the h tile, 0 where h lives in global
// memory.
struct Layout {
  int t, u, big, q, kv, v, pe, stage, bars, bytes;
};

__host__ __device__ inline Layout layout(int c_, int ca, int hid, int hd,
                                         int ring, int vrows) {
  hd = hd == 32 ? 32 : 64;                      // wider heads: blocks of 64
  Layout L;
  L.t = ring * W_STAGE * 2;
  L.u = L.t + up64(c_) * ROWS * 2;
  L.big = L.u + up64(ca) * ROWS * 2;
  L.q = L.big;                                  // rings x 2 x [64][hd]
  L.kv = L.q + kv_rings(hd) * 2 * ROWS * hd * 2;   // rings x stages x (k | v)
  L.v = L.kv + kv_rings(hd) * KV_STAGES * 2 * KV_KEYS * hd * 2;
  L.pe = L.v + vrows * CBLK * 2;                     // [64][PE_LD] f32
  const int attention = L.pe + ROWS * PE_LD * 4 - L.big;
  // the GEMMs' accumulator staging, past h and the x / ys boxes
  const int h = up64(hid) * ROWS * 2, boxes = ring * A_BLOCK * 2;
  L.stage = L.big + (h > boxes ? h : boxes);
  const int gemms = L.stage + ROWS * STAGE_LD * 4 - L.big;
  L.bars = L.big + (attention > gemms ? attention : gemms);
  L.bytes = L.bars + 8 * N_BARS + 1024;
  return L;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// mbar_wait that sleeps while it waits and traps (a launch failure the
// wrapper reports) where a barrier has not completed after 5 s: a fault of
// the producer's schedule ends the launch instead of hanging the card. The
// suspend-time hint lets try_wait park the thread until the phase completes
// (up to 10 ms a try) instead of spinning.
__device__ __forceinline__ void mwait(uint64_t* bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, P;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity), "r"(10000000u)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) start = now;
    else if (now - start > 5000000000ull) __trap();
  }
}

// Element offset of row r, column c of a 64-row tile of 64-column blocks in
// the 128-byte swizzle (TMA's and the wgmma descriptor's layout): block c /
// 64, then 128-byte rows whose 16-byte chunk k sits at k ^ (r % 8).
__device__ __forceinline__ int sw_at(int r, int c) {
  return (c >> 6) * A_BLOCK + r * KBLK + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

// Where a GEMM's A operand comes from: a tile in shared memory, or boxes
// of x, of the ys concat or of h in global memory (the wide MLP form) that
// ride with each weight stage; the last two read rows this tile stored.
enum Src { A_T, A_U, A_H, A_X, A_YS, A_HG };
__device__ __forceinline__ bool reads_stored_rows(int src) {
  return src >= A_YS;
}

// One GEMM of a phase and its epilogue: out = (silu)((t +) A.W + b) ->
// bf16 into the t or h tile (columns past N zero) and / or global rows
// dst + token * ld (columns < N, rows of the tile).
struct Gemm {
  const bf16* w;          // packed (`pack_bf16_weight`)
  const float* b;
  int K, N, src;
  int silu, residual;     // SiLU after; t added (in f32) before
  bf16* tile;             // the t or h tile, or none
  bf16* dst;              // global rows (qkv, a ys slot, out), or none
  int ld;
};

// Output panels of N columns, 128 wide.
__device__ __forceinline__ int panels(int N) { return (N + PANEL - 1) / PANEL; }
__device__ __forceinline__ int stages(const Gemm& g) {
  return panels(g.N) * (up64(g.K) / KBLK);
}

// A position in a phase's weight stream: GEMM g, panel p, K block kb.
struct Cursor {
  int g, p, kb;
  __device__ __forceinline__ void next(const Gemm* gl) {
    if (++kb == up64(gl[g].K) / KBLK) {
      kb = 0;
      if (++p == panels(gl[g].N)) {
        p = 0;
        ++g;
      }
    }
  }
};

// A ring slot and the parity of its current use.
struct Slot {
  int i, phase;
  __device__ __forceinline__ void next(int n) {
    if (++i == n) {
      i = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void consumer_sync() {
  bar_sync(CONSUMERS, CONSUMER_THREADS);
}

// The consumer's shared state: buffers, barriers and ring positions (the
// producer keeps its own copy of the positions).
struct Bufs {
  bf16 *ring, *t, *u, *big, *q, *kv, *v;
  float *pe, *stage;
  uint64_t *w_full, *w_empty, *kv_full, *kv_empty, *q_full, *q_empty;
  uint64_t *v_full, *v_empty, *t_full, *ys_ready, *tile_done;
};

struct Pos {
  Slot w;                 // weight ring
  int kv, q, v, t, ys;    // k/v tiles and q tiles of this warpgroup's ring,
                          // v blocks, t reloads, cv2s
};

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// SiLU for the bf16 kernel, whose outputs round to bf16: the fast exp and
// division differ from expf and / by a few f32 ulps.
__device__ __forceinline__ float silu_bf(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// One GEMM of the tile (A: a tile in shared memory, or boxes riding with
// the weight stages): per 128-column panel the K blocks' wgmma on the
// ring's next stages (whole 64-column blocks: K past the GEMM's is zero in
// both operands), the f32 accumulator staged in shared memory (`stage`,
// [64][STAGE_LD]), then the epilogue `g` describes in one loop over the
// tile's rows and column pairs: consecutive threads on consecutive columns,
// so the global stores of a row coalesce.
__device__ __forceinline__ void gemm(const Gemm& gs, const bf16* A,
                                     const Bufs& b, Pos& pos, int ring,
                                     size_t tok0, int rows, int cw, int ct) {
  const Gemm g = gs;                             // in registers
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int r = 16 * warp + (lane >> 2);
  const int nkb = up64(g.K) / KBLK;
  const int N = g.N, N64 = up64(g.N);
  const bool boxes = g.src >= A_X;
  for (int p = 0; p < panels(N); ++p) {
   if (cw == 0) {                                // the first warpgroup's
    float acc[PANEL / 2];
#pragma unroll
    for (int e = 0; e < PANEL / 2; ++e) acc[e] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      const int slot = pos.w.i;
      mwait(&b.w_full[slot], pos.w.phase);
      const bf16* a = boxes ? b.big + slot * A_BLOCK : A + kb * A_BLOCK;
      const uint64_t da = smem_desc_sw128(a);
      const uint64_t db = smem_desc_sw128(b.ring + slot * W_STAGE);
      wgmma_fence();                             // K past the GEMM's: zeros
      wgmma_64x128_ss(acc, da, db, kb > 0);
#pragma unroll
      for (int kk = 1; kk < KBLK / 16; ++kk)
        wgmma_64x128_ss(acc, da + 2 * kk, db + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < PANEL / 2; ++e) reg_fence(acc[e]);
      if (tid == 0) mbar_arrive(&b.w_empty[slot]);
      pos.w.next(ring);
    }
    consumer_sync();                             // the last panel's read
    // fragments: rows r and r + 8, columns 8 j + 2 (lane % 4), + 1
#pragma unroll
    for (int j = 0; j < PANEL / 8; ++j) {
      float* s = b.stage + r * STAGE_LD + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(s) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(s + 8 * STAGE_LD) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
   } else {
    consumer_sync();
   }
    consumer_sync();
    // both warpgroups: a thread's column pair is fixed, its rows every
    // fourth one, 8 at a time: their loads issued together, then the stores
    const int c = 2 * (ct & (PANEL / 2 - 1)), col = p * PANEL + c;
    if (col < N64) {
      const float2 bias =
          col < N ? __ldg(reinterpret_cast<const float2*>(g.b + col))
                  : make_float2(0.f, 0.f);
      for (int r0 = ct / (PANEL / 2); r0 < rows; r0 += 32) {
        float2 v[8];
        uint32_t t0[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int row = min(r0 + 4 * k, ROWS - 1);
          v[k] = *reinterpret_cast<const float2*>(b.stage + row * STAGE_LD +
                                                  c);
          t0[k] = g.residual ? *reinterpret_cast<const uint32_t*>(
                                   b.t + sw_at(row, col))
                             : 0u;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {            // no exit: 8 chains at once
          const int row = r0 + 4 * k;
          float v0 = v[k].x + bias.x, v1 = v[k].y + bias.y;
          if (g.residual) {
            const float2 r = unpack(t0[k]);
            v0 = r.x + v0;
            v1 = r.y + v1;
          }
          if (g.silu) {
            v0 = silu_bf(v0);
            v1 = silu_bf(v1);
          }
          const uint32_t y = col < N ? pack_bf16(v0, v1) : 0u;
          if (g.dst != nullptr && col < N && row < rows)
            *reinterpret_cast<uint32_t*>(g.dst + (tok0 + row) * g.ld + col) =
                y;
          if (g.tile != nullptr && row < rows)
            *reinterpret_cast<uint32_t*>(g.tile + sw_at(row, col)) = y;
        }
      }
    }
  }
}

// The 7x7 depthwise taps of RUN consecutive tokens of one image row (image
// row y, columns x0 .. x0 + RUN - 1), 8 channels (16-byte chunk `chunk` of
// the v rows' 64-channel block, channel c of the taps): acc[t][e] += v(yy,
// xj)[e] * w(di, dj)[e] in the reference's tap order, zero outside the
// image. vb: the block's v rows in shared memory, row k = image token
// tok_start + k; or (L2) the image's v at the thread's 8 channels in the
// qkv scratch, token k at vb + k ld, read past L1 (other CTAs wrote it
// before the grid barrier), tok_start 0.
template <int RUN, bool L2>
__device__ __forceinline__ void taps(const bf16* vb, int tok_start, int ld,
                                     const float* w, int ca, int H, int W,
                                     int y, int x0, int chunk,
                                     float (&acc)[RUN][8]) {
#pragma unroll 1
  for (int di = 0; di < 7; ++di) {
    const int yy = y + di - 3;
    if (yy < 0 || yy >= H) continue;
    const int row0 = yy * W + x0 - 3 - tok_start;
    float v[RUN + 6][8];                         // each tap column once
#pragma unroll
    for (int j = 0; j < RUN + 6; ++j) {
      const int xj = x0 + j - 3, r = row0 + j;
      const uint4* src =
          L2 ? reinterpret_cast<const uint4*>(vb + (long long)r * ld)
             : reinterpret_cast<const uint4*>(vb + r * CBLK +
                                              ((chunk ^ (r & 7)) << 3));
      const uint4 raw = xj >= 0 && xj < W
                            ? (L2 ? __ldcg(src) : *src)
                            : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t* v2 = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack(v2[e]);
        v[j][2 * e] = f.x;
        v[j][2 * e + 1] = f.y;
      }
    }
#pragma unroll
    for (int dj = 0; dj < 7; ++dj) {
      const float4* w4 =
          reinterpret_cast<const float4*>(w + (di * 7 + dj) * ca);
      const float4 wa = __ldg(w4), wc = __ldg(w4 + 1);
      const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int t = 0; t < RUN; ++t)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[t][e] = fmaf(v[t + dj][e], w8[e], acc[t][e]);
    }
  }
}

// pe = dw7x7(v) + bpe for the tile's rows and one 64-channel block (cb0 ..
// cb0 + 63, those < ca) into pe ([64][PE_LD] f32): a thread of the two
// consumer warpgroups takes 8 channels of RUN consecutive tokens (one pass
// over 64 rows), which share each tap row's loads where they lie in one
// image row (else one token at a time). v: the block's staged rows from
// image token tok_start on, or (L2) the image's v at channel cb0 in the
// qkv scratch, ld elements a token.
constexpr int RUN = 2;

template <bool L2>
__device__ __forceinline__ void stencil(const bf16* v, int tok_start, int ld,
                                        const float* w, const float* bpe,
                                        int ca, int cb0, int H, int W,
                                        int n_lo, int rows, float* pe) {
  const int tid = threadIdx.x - 128, chunk = tid & 7;   // of both
  const int c = cb0 + 8 * chunk;
  const float* wc = w + c;
  const bf16* vb = L2 ? v + 8 * chunk : v;
  const float4 ba = __ldg(reinterpret_cast<const float4*>(bpe + min(c, ca - 8)));
  const float4 bb =
      __ldg(reinterpret_cast<const float4*>(bpe + min(c, ca - 8) + 4));
#pragma unroll 1
  for (int r0 = RUN * (tid >> 3); r0 < (c < ca ? rows : 0); r0 += RUN * 32) {
    const int n0 = n_lo + r0, y = n0 / W, x0 = n0 % W;
    float acc[RUN][8];
#pragma unroll
    for (int t = 0; t < RUN; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[t][e] = 0.f;
    if (x0 + RUN <= W) {
      taps<RUN, L2>(vb, tok_start, ld, wc, ca, H, W, y, x0, chunk, acc);
    } else {
#pragma unroll
      for (int t = 0; t < RUN; ++t) {
        float one[1][8] = {};
        taps<1, L2>(vb, tok_start, ld, wc, ca, H, W, (n0 + t) / W,
                    (n0 + t) % W, chunk, one);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[t][e] = one[0][e];
      }
    }
#pragma unroll
    for (int t = 0; t < RUN; ++t) {
      float4* dst =
          reinterpret_cast<float4*>(pe + (r0 + t) * PE_LD + 8 * chunk);
      dst[0] = make_float4(acc[t][0] + ba.x, acc[t][1] + ba.y,
                           acc[t][2] + ba.z, acc[t][3] + ba.w);
      dst[1] = make_float4(acc[t][4] + bb.x, acc[t][5] + bb.y,
                           acc[t][6] + bb.z, acc[t][7] + bb.w);
    }
  }
}

// The attention of head h for the tile's 64 query rows (q: the producer's
// next q tile; k and v: its next key tiles of 128, zero past the band) on
// wgmma, then u[:, h HD .. h HD + HD) = ((o + pe) -> bf16), pe read at
// column pe_col of the positional term's tile.
// `pair`: both consumer warpgroups attend (a head each) and take turns
// issuing their products (named barriers TURN and TURN + 1, warpgroup 0
// first), so that one's softmax runs under the other's wgmma.
template <int HD_>
__device__ __forceinline__ void attend(const Bufs& b, Pos& pos, int h,
                                       int nb, int rows, float sl2,
                                       int pe_col, int ring_, bool pair) {
  constexpr int KVS = KV_STAGES;
  constexpr int TILE = KV_KEYS * HD_;            // elements of a k or v tile
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r_lo = 16 * warp + gq;               // rows r_lo, r_lo + 8
  const int qs = pos.q & 1;
  bf16* const kvb = b.kv + ring_ * KVS * 2 * TILE;
  uint64_t* const kv_full = b.kv_full + ring_ * KVS;
  uint64_t* const kv_empty = b.kv_empty + ring_ * KVS;
  mwait(&b.q_full[2 * ring_ + qs], (pos.q >> 1) & 1);
  const uint64_t dq = head_desc<HD_>(b.q + (2 * ring_ + qs) * ROWS * HD_);
  const int tiles = (nb + KV_KEYS - 1) / KV_KEYS;

  // s: the 64 x 128 scores (row r_lo / r_lo + 8, keys 8 j + 2 t + e at
  // s[4 j + e] / s[4 j + 2 + e]); p: the last tile's probabilities as A
  // fragments of 8 steps of 16 keys; oacc: O (channels 8 j + 2 t + e)
  float s[64], oacc[HD_ / 2];
  uint32_t p[8][4];
#pragma unroll
  for (int e = 0; e < HD_ / 2; ++e) oacc[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) p[kk][0] = p[kk][1] = p[kk][2] = p[kk][3] = 0u;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  if (pair && ring_ == 1) bar_arrive(TURN, CONSUMER_THREADS);
  for (int i = 0; i < tiles; ++i) {
    const int st = (pos.kv + i) % KVS;
    mwait(&kv_full[st], ((pos.kv + i) / KVS) & 1);
    if (pair) bar_sync(TURN + ring_, CONSUMER_THREADS);   // this one's turn
    wgmma_fence();
    const bf16* Kt = kvb + st * 2 * TILE;
    const uint64_t dk = head_desc<HD_>(Kt);
    wgmma_64x128_ss(s, dq, dk, 0);               // channels 0-15
#pragma unroll
    for (int kk = 1; kk < HD_ / 16; ++kk)        // 16 more: 32 bytes on
      wgmma_64x128_ss(s, dq + 2 * kk, dk + 2 * kk, 1);
    wgmma_commit();
    {                                            // O += P V of tile i - 1
      // (at i = 0, p = 0 against tile 0's landed v: adds zeros)
      const bf16* Vt =
          kvb + ((pos.kv + i - (i > 0)) % KVS) * 2 * TILE + TILE;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<HD_>(oacc, p[kk], head_desc<HD_>(Vt + kk * 16 * HD_));
      wgmma_commit();
      if (pair && !(ring_ == 1 && i == tiles - 1))
        bar_arrive(TURN + 1 - ring_, CONSUMER_THREADS);   // the other's
      wgmma_wait<1>();
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) reg_fence(s[e]);
    const int k0 = i * KV_KEYS;                  // keys past the band:
#pragma unroll                                   // selects, no branch
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool past = k0 + 8 * j + 2 * t + e >= nb;
        s[4 * j + e] = past ? -INFINITY : s[4 * j + e];
        s[4 * j + 2 + e] = past ? -INFINITY : s[4 * j + 2 + e];
      }
    const float2 c = online_softmax(s, sl2, m_lo, m_hi, l_lo, l_hi);
    wgmma_wait<0>();                             // P V of tile i - 1 done
#pragma unroll
    for (int e = 0; e < HD_ / 2; ++e) reg_fence(oacc[e]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(p[kk][e]);
    if (tid == 0 && i > 0) mbar_arrive(&kv_empty[(pos.kv + i - 1) % KVS]);
    rescale_and_pack<HD_>(oacc, p, s, c);
  }
  wgmma_fence();                                 // O += P V of the last tile
  const bf16* Vt = kvb + ((pos.kv + tiles - 1) % KVS) * 2 * TILE + TILE;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv<HD_>(oacc, p[kk], head_desc<HD_>(Vt + kk * 16 * HD_));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < HD_ / 2; ++e) reg_fence(oacc[e]);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(p[kk][e]);
  if (tid == 0) {
    mbar_arrive(&kv_empty[(pos.kv + tiles - 1) % KVS]);
    mbar_arrive(&b.q_empty[2 * ring_ + qs]);
  }
  pos.kv += tiles;
  ++pos.q;
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
#pragma unroll
  for (int j = 0; j < HD_ / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 pl =
        *reinterpret_cast<const float2*>(b.pe + r_lo * PE_LD + pe_col + col);
    const float2 ph = *reinterpret_cast<const float2*>(
        b.pe + (r_lo + 8) * PE_LD + pe_col + col);
    *reinterpret_cast<uint32_t*>(b.u + sw_at(r_lo, h * HD_ + col)) =
        pack_bf16(oacc[4 * j] * inv_lo + pl.x, oacc[4 * j + 1] * inv_lo + pl.y);
    *reinterpret_cast<uint32_t*>(b.u + sw_at(r_lo + 8, h * HD_ + col)) =
        pack_bf16(oacc[4 * j + 2] * inv_hi + ph.x,
                  oacc[4 * j + 3] * inv_hi + ph.y);
  }
}

// The blocked form of `attend` (heads wider than 64, the first consumer
// warpgroup alone): output block sb of u (64 channels of one head, whose
// nbk 64-channel blocks the producer streams). Each unit of the k/v ring is
// one of the head's blocks j of a key tile: its k block, q's block in the
// stage's q slot and, with the last block, v's block sb. S = sum_j q_j
// k_j^T, each unit's products waited before its stage is freed (no wgmma
// group open across a loop's back edge), then `attend`'s online softmax
// and O += P V, waited too; u[:, 64 sb ..) = ((o + pe) -> bf16), pe at
// column 0 of the positional term's tile.
__device__ __forceinline__ void attend_blocked(const Bufs& b, Pos& pos,
                                               int sb, int nbk, int nb,
                                               float sl2) {
  constexpr int KVS = KV_STAGES;
  constexpr int TILE = KV_KEYS * CBLK;           // elements of a k or v tile
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r_lo = 16 * warp + (lane >> 2);      // rows r_lo, r_lo + 8
  const int tiles = (nb + KV_KEYS - 1) / KV_KEYS;
  float s[64], oacc[CBLK / 2];
  uint32_t p[8][4];
#pragma unroll
  for (int e = 0; e < CBLK / 2; ++e) oacc[e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for (int i = 0; i < tiles; ++i) {
    int st = 0;
    for (int j = 0; j < nbk; ++j) {              // S = sum_j q_j k_j^T
      st = pos.kv % KVS;
      mwait(&b.kv_full[st], (pos.kv / KVS) & 1);
      wgmma_block_scores(s, smem_desc_sw128(b.q + st * ROWS * CBLK),
                         smem_desc_sw128(b.kv + st * 2 * TILE), j);
      if (j < nbk - 1) {                         // the last one holds v
        if (tid == 0) mbar_arrive(&b.kv_empty[st]);
        ++pos.kv;
      }
    }
    mask_keys_past(s, i * KV_KEYS, nb, t);       // keys past the band
    const float2 c = online_softmax(s, sl2, m_lo, m_hi, l_lo, l_hi);
    rescale_and_pack<CBLK>(oacc, p, s, c);
    wgmma_block_pv(oacc, p, b.kv + st * 2 * TILE + TILE);   // O += P V
    if (tid == 0) mbar_arrive(&b.kv_empty[st]);
    ++pos.kv;
  }
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
#pragma unroll
  for (int j = 0; j < CBLK / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 pl = *reinterpret_cast<const float2*>(b.pe + r_lo * PE_LD +
                                                       col);
    const float2 ph =
        *reinterpret_cast<const float2*>(b.pe + (r_lo + 8) * PE_LD + col);
    *reinterpret_cast<uint32_t*>(b.u + sw_at(r_lo, CBLK * sb + col)) =
        pack_bf16(oacc[4 * j] * inv_lo + pl.x, oacc[4 * j + 1] * inv_lo + pl.y);
    *reinterpret_cast<uint32_t*>(b.u + sw_at(r_lo + 8, CBLK * sb + col)) =
        pack_bf16(oacc[4 * j + 2] * inv_hi + ph.x,
                  oacc[4 * j + 3] * inv_hi + ph.y);
  }
}

// The tile a CTA works on in a phase.
struct Tile {
  int q0, bg, rows;       // first query row in the band, band, rows < TM
  size_t tok0;            // global token index of row 0
};

template <int HD_, bool L2>
__global__ void __launch_bounds__(THREADS, 1)
a2c2f_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int KVS = KV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Gemm gl[4];                         // this phase's GEMMs
  __shared__ const float* pe_taps[2];            // its 7x7 taps and bias
  cg::grid_group grid = cg::this_grid();
  unsigned char* base = align1024(smem_raw);
  const int H = p.H, W = p.W, N = H * W, c_ = p.c_, ca = p.ca;
  const int nb = N / p.area, TM = p.tile, ring = p.ring;
  const int tiles_per_band = (nb + TM - 1) / TM;
  const int total = p.B * p.area * tiles_per_band;
  const int YS = (p.n_stages + 1) * c_, QS = 3 * ca;
  const int n_blocks = 2 * p.n_stages;
  const int nsb = (ca + CBLK - 1) / CBLK;        // stencil blocks
  const float sl2 = p.scale * LOG2E;
  // h in global memory where the wrapper gave the scratch (read from the
  // parameters where needed: a pointer kept live costs the consumers
  // registers)
  const Layout L = layout(c_, ca, p.work ? 0 : p.hid, HD_, ring,
                          p.vb * p.nvb);
  Bufs b;
  b.ring = reinterpret_cast<bf16*>(base);
  b.t = reinterpret_cast<bf16*>(base + L.t);
  b.u = reinterpret_cast<bf16*>(base + L.u);
  b.big = reinterpret_cast<bf16*>(base + L.big);
  b.q = reinterpret_cast<bf16*>(base + L.q);
  b.kv = reinterpret_cast<bf16*>(base + L.kv);
  b.v = reinterpret_cast<bf16*>(base + L.v);
  b.pe = reinterpret_cast<float*>(base + L.pe);
  b.stage = reinterpret_cast<float*>(base + L.stage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  b.w_full = bars;
  b.w_empty = bars + MAX_RING;
  b.kv_full = bars + 2 * MAX_RING;              // [ring][stage]
  b.kv_empty = b.kv_full + 2 * KVS;
  b.q_full = b.kv_empty + 2 * KVS;               // [ring][slot]
  b.q_empty = b.q_full + 4;
  b.v_full = b.q_empty + 4;
  b.v_empty = b.v_full + 1;
  b.t_full = b.v_empty + 1;
  b.ys_ready = b.t_full + 1;
  b.tile_done = b.ys_ready + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < N_BARS; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  // u's columns past ca (64 - ca % 64 of them) are read as zeros by the
  // wgmma of whole 64-column blocks and never written
  for (int i = threadIdx.x; i < up64(ca) * ROWS / 8; i += THREADS)
    reinterpret_cast<uint4*>(b.u)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();

  // warpgroup-uniform in a form the compiler sees (a broadcast)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  const bool producer = wg == 0;
  const int ctid = threadIdx.x - 128;            // consumer thread, 0..255
  const int cw = wg - 1;                         // consumer warpgroup
  if (producer) regs_release<REGS_PRODUCER>();
  else regs_claim<REGS_CONSUMER>();
  bf16* const ys = static_cast<bf16*>(p.ys);
  bf16* const out = static_cast<bf16*>(p.out);
  Pos pos = {{0, 0}, 0, 0, 0, 0, 0};
  int done = 0;                                  // tiles finished before
  int w_issued = 0;                              // producer: weight stages
  int pq[2] = {0, 0}, pkv[2] = {0, 0};           // producer: q, k/v a ring

  for (int phase = 0; phase <= n_blocks; ++phase) {
    const int a = phase - 1;                     // the ABlock (phase > 0)
    const bool last = phase == n_blocks;
    const int slot_out = phase == 0 ? 0 : a / 2 + 1;
    const int slot_in = phase == 0 ? 0 : slot_out - 1 + (a & 1);
    if (threadIdx.x == 0) {
      bf16* const nxt = static_cast<bf16*>(
          phase == 0 || !(a & 1) ? p.qkv1 : p.qkv0);
      if (phase == 0) {
        const ABlockWeights b0 = p.blk[0];
        // y0 = silu(x.Wcv1 + b) -> t, ys slot 0; the first ABlock's qkv
        gl[0] = {static_cast<const bf16*>(p.wcv1), p.bcv1, p.cin, c_, A_X,
                 1, 0, b.t, ys, YS};
        gl[1] = {static_cast<const bf16*>(b0.wqkv), b0.bqkv, c_, QS, A_T,
                 0, 0, nullptr, static_cast<bf16*>(p.qkv0), QS};
      } else {
        const ABlockWeights w = p.blk[a];
        bf16* const hg = reinterpret_cast<bf16*>(p.work);
        pe_taps[0] = w.wpe;
        pe_taps[1] = w.bpe;
        // t = t + u.Wproj + b; h = silu(t.Wm1 + b); t = t + h.Wm2 + b,
        // kept in ys for the next ABlock and cv2; h in its tile or in
        // global memory
        gl[0] = {static_cast<const bf16*>(w.wproj), w.bproj, ca, c_, A_U,
                 0, 1, b.t, nullptr, 0};
        gl[1] = {static_cast<const bf16*>(w.wm1), w.bm1, c_, p.hid, A_T,
                 1, 0, hg ? nullptr : b.big, hg, p.hid};
        gl[2] = {static_cast<const bf16*>(w.wm2), w.bm2, p.hid, c_,
                 hg ? A_HG : A_H, 0, 1, b.t, ys + slot_out * c_, YS};
        if (last) {             // out = silu(concat(y0, z1..zn).Wcv2 + b)
          gl[3] = {static_cast<const bf16*>(p.wcv2), p.bcv2, YS, p.c2, A_YS,
                   1, 0, nullptr, out, p.c2};
        } else {                // the next ABlock's qkv
          const ABlockWeights nw = p.blk[a + 1];
          gl[3] = {static_cast<const bf16*>(nw.wqkv), nw.bqkv, c_, QS, A_T,
                   0, 0, nullptr, nxt, QS};
        }
      }
    }
    __syncthreads();
    const int n_gemms = phase == 0 ? 2 : 4;
    const int cur = phase == 0 ? 0 : a & 1;      // the qkv buffer read

    for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++done) {
      Tile tl;
      tl.q0 = (tile % tiles_per_band) * TM;
      tl.bg = tile / tiles_per_band;
      tl.rows = min(TM, nb - tl.q0);
      tl.tok0 = (size_t)tl.bg * nb + tl.q0;
      const int band = tl.bg % p.area, img = tl.bg / p.area;
      const int n_lo = band * nb + tl.q0;        // image token of row 0
      const int tok_start = n_lo - 3 * W - 3;    // of the v rows' row 0
      if (producer) {
        if (threadIdx.x != 0) continue;
        // ---------------------------------------------- producer thread
        Cursor c = {0, 0, 0};
        auto issue = [&]() {                     // the stage at c, then on
          const Gemm& g = gl[c.g];
          const int slot = pos.w.i;
          const int nkb = up64(g.K) / KBLK;
          const bool boxes = g.src >= A_X;
          if (w_issued++ >= ring)                // its last use consumed
            mwait(&b.w_empty[slot], pos.w.phase ^ 1);
          mbar_expect_tx(&b.w_full[slot],
                         (W_STAGE + (boxes ? A_BLOCK : 0)) * 2);
          bulk_load(b.ring + slot * W_STAGE,
                    g.w + (size_t)(c.p * nkb + c.kb) * W_STAGE, W_STAGE * 2,
                    &b.w_full[slot]);
          if (boxes)
            tma_load_3d(b.big + slot * A_BLOCK,
                        g.src == A_X    ? &p.x_map
                        : g.src == A_YS ? &p.ys_map
                                        : &p.work_map,
                        &b.w_full[slot], KBLK * c.kb, (int)tl.tok0, 0);
          pos.w.next(ring);
          c.next(gl);
        };
        if (phase == 0) {
          while (c.g < n_gemms) issue();
          continue;
        }
        // the last tile's t, v, q, k/v and boxes are done with
        if (done > 0) mwait(b.tile_done, (done - 1) & 1);
        auto issue_v = [&](int sb) {             // the stencil's v rows
          if (pos.v > 0) mwait(b.v_empty, (pos.v - 1) & 1);
          mbar_expect_tx(b.v_full, p.nvb * p.vb * CBLK * 2);
          for (int i = 0; i < p.nvb; ++i)
            tma_load_3d(b.v + i * p.vb * CBLK, &p.v_map[cur], b.v_full,
                        2 * ca + CBLK * sb, tok_start + i * p.vb, img);
          ++pos.v;
        };
        if (!L2) issue_v(0);                     // needed first
        const int nkc = up64(c_) / KBLK;
        mbar_expect_tx(b.t_full, nkc * A_BLOCK * 2);
        for (int kb = 0; kb < nkc; ++kb)
          tma_load_3d(b.t + kb * A_BLOCK, &p.slot_map, b.t_full, KBLK * kb,
                      slot_in, (int)tl.tok0);
        ++pos.t;
        // the first weight stages, to land during the attention (never
        // those of a GEMM whose boxes wait for rows this tile stores, ys or
        // h, or after it)
        int before = 0;
        for (int g = 0; g < n_gemms && !reads_stored_rows(gl[g].src); ++g)
          before += stages(gl[g]);
        for (int i = 0; i < min(ring, before); ++i) issue();
        const int n_keys = (nb + KV_KEYS - 1) / KV_KEYS;
        for (int sb = 0; sb < nsb; ++sb) {
          if (sb > 0 && !L2) issue_v(sb);
          if constexpr (HD_ == BLOCKED) {
            // output block sb of a head of nbk blocks (its first channel
            // c0): per key tile the head's blocks j, each a unit of ring 0
            // (k's block, q's in the stage's q slot), v's block sb riding
            // with the last
            const int nbk = ca / p.heads / CBLK;
            const int c0 = CBLK * (sb - sb % nbk);
            for (int i = 0; i < n_keys; ++i)
              for (int j = 0; j < nbk; ++j) {
                const int st = pkv[0] % KVS;
                const bool last = j == nbk - 1;
                uint64_t* full = &b.kv_full[st];
                if (pkv[0] >= KVS)
                  mwait(&b.kv_empty[st], ((pkv[0] / KVS) - 1) & 1);
                bf16* kt = b.kv + st * 2 * KV_KEYS * CBLK;
                mbar_expect_tx(full,
                               ((last ? 2 : 1) * KV_KEYS + ROWS) * CBLK * 2);
                tma_load_3d(kt, &p.kv_map[cur], full, ca + c0 + CBLK * j,
                            i * KV_KEYS, tl.bg);
                if (last)
                  tma_load_3d(kt + KV_KEYS * CBLK, &p.kv_map[cur], full,
                              2 * ca + CBLK * sb, i * KV_KEYS, tl.bg);
                tma_load_3d(b.q + st * ROWS * CBLK, &p.q_map[cur], full,
                            c0 + CBLK * j, tl.q0, tl.bg);
                ++pkv[0];
              }
          } else {
            // the block's heads (two of 32 or one of 64), head j to
            // consumer warpgroup j: its q slots and its k/v ring, the two
            // rings filled in turns
            const int h0 = sb * CBLK / HD_;
            const int nh = min(p.heads, (sb + 1) * CBLK / HD_) - h0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j >= nh) break;
              const int qs = pq[j] & 1;
              if (pq[j] >= 2)
                mwait(&b.q_empty[2 * j + qs], ((pq[j] >> 1) - 1) & 1);
              mbar_expect_tx(&b.q_full[2 * j + qs], ROWS * HD_ * 2);
              tma_load_3d(b.q + (2 * j + qs) * ROWS * HD_, &p.q_map[cur],
                          &b.q_full[2 * j + qs], (h0 + j) * HD_, tl.q0, tl.bg);
              ++pq[j];
            }
            for (int i = 0; i < n_keys; ++i) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (j >= nh) break;
                const int st = pkv[j] % KVS;
                uint64_t* full = &b.kv_full[j * KVS + st];
                if (pkv[j] >= KVS)
                  mwait(&b.kv_empty[j * KVS + st], ((pkv[j] / KVS) - 1) & 1);
                bf16* kt = b.kv + (j * KVS + st) * 2 * KV_KEYS * HD_;
                mbar_expect_tx(full, 2 * KV_KEYS * HD_ * 2);
                tma_load_3d(kt, &p.kv_map[cur], full, ca + (h0 + j) * HD_,
                            i * KV_KEYS, tl.bg);
                tma_load_3d(kt + KV_KEYS * HD_, &p.kv_map[cur], full,
                            2 * ca + (h0 + j) * HD_, i * KV_KEYS, tl.bg);
                ++pkv[j];
              }
            }
          }
        }
        while (c.g < n_gemms) {
          if (reads_stored_rows(gl[c.g].src) && c.p == 0 && c.kb == 0) {
            mwait(b.ys_ready, pos.ys & 1);   // this tile's ys / h stored
            ++pos.ys;
          }
          issue();
        }
        continue;
      }

      // ------------------------------------------------ consumer warpgroup
      const int rows = tl.rows;
      if (phase > 0) {
        // attention and the stencil, a block of 64 channels at a time:
        // u = (o + pe) -> bf16
        for (int sb = 0; sb < nsb; ++sb) {
          if constexpr (L2) {                    // v read through L2
            const bf16* v = static_cast<const bf16*>(cur ? p.qkv1 : p.qkv0) +
                            (size_t)img * N * QS + 2 * ca + CBLK * sb;
            stencil<true>(v, 0, QS, pe_taps[0], pe_taps[1], ca, CBLK * sb, H,
                          W, n_lo, rows, b.pe);
          } else {                               // or its rows staged
            mwait(b.v_full, pos.v & 1);
            ++pos.v;
            stencil<false>(b.v, tok_start, 0, pe_taps[0], pe_taps[1], ca,
                           CBLK * sb, H, W, n_lo, rows, b.pe);
          }
          consumer_sync();                       // pe written, v rows read
          if (!L2 && ctid == 0) mbar_arrive(b.v_empty);
          if constexpr (HD_ == BLOCKED) {        // one block of a head
            if (cw == 0) attend_blocked(b, pos, sb, ca / p.heads / CBLK, nb,
                                        sl2);
          } else {
            // the block's heads: head h0 + cw on warpgroup cw
            const int h = sb * CBLK / HD_ + cw;
            const int nh =
                min(p.heads, (sb + 1) * CBLK / HD_) - sb * CBLK / HD_;
            if (cw < nh)
              attend<HD_>(b, pos, h, nb, rows, sl2, h * HD_ - CBLK * sb, cw,
                          nh == 2);
          }
          consumer_sync();                       // pe read
        }
        fence_proxy_async();                     // u, for the wgmma
        mwait(b.t_full, pos.t & 1);              // t of this tile
        ++pos.t;
      }
      for (int g = 0; g < n_gemms; ++g) {
        const Gemm& gm = gl[g];
        if (reads_stored_rows(gm.src)) {
          // the concat (or h) is read by TMA once this tile's last ys slot
          // (or h) is stored (and the tile before is done with)
          fence_proxy_async_global();
          fence_proxy_async();
          consumer_sync();
          if (ctid == 0) mbar_arrive(b.ys_ready);
        } else {
          consumer_sync();                       // A's tile written
        }
        gemm(gm, gm.src == A_T ? b.t : gm.src == A_U ? b.u : b.big, b, pos,
             ring, tl.tok0, rows, cw, ctid);
        fence_proxy_async();                     // the tile, for the next
      }
      consumer_sync();
      if (ctid == 0) mbar_arrive(b.tile_done);   // before TMA reuses them
    }
    if (!last) {
      if (!producer) fence_proxy_async_global();  // qkv, ys read by TMA next
      grid.sync();
    }
  }
}

// Dynamic shared memory of the bf16 kernel, its stencil boxes, and where h
// lives.
struct Plan {
  Layout L;
  int ring, vb, nvb;
  bool h_global;
};

// The v rows of a tile (64 tokens +- 3 image rows and 3 tokens, 6 W + 70
// of them) as nvb boxes of vb rows (a multiple of 8, at most 256), and the
// largest weight ring (4 stages down to 2) that fits a block with them;
// where no ring does (wide images), no v rows (nvb 0: the kernel's L2
// form) and the largest ring that fits without; where neither fits with
// the h tile (wide MLPs), the same again with h in global memory.
bool plan(const Params& p, Plan* out) {
  const int need = ROWS + 6 * p.W + 6;
  const int nvb = (need + VB_MAX - 1) / VB_MAX;
  const int vb = ((need + nvb - 1) / nvb + 7) & ~7;
  const int hd = p.ca / p.heads;
  for (int h_tile = 1; h_tile >= 0; --h_tile)
    for (int staged = 1; staged >= 0; --staged)
      for (int ring = MAX_RING; ring >= 2; --ring) {
        const Layout L = layout(p.c_, p.ca, h_tile * p.hid, hd, ring,
                                staged * vb * nvb);
        if (L.bytes <= SMEM_LIMIT) {
          *out = {L, ring, staged * vb, staged * nvb, h_tile == 0};
          return true;
        }
      }
  return false;
}

// A 3-D map of ys by slot: (c_, slots, tokens), boxes of 64 columns of one
// slot x 64 tokens in the 128-byte swizzle, zero past c_ (t's box).
cudaError_t slot_map(CUtensorMap* map, void* ys, long tokens, int c_,
                     int slots) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)c_, (cuuint64_t)slots,
                              (cuuint64_t)tokens};
  const cuuint64_t strides[2] = {(cuuint64_t)c_ * 2,
                                 (cuuint64_t)slots * c_ * 2};
  const cuuint32_t box[3] = {KBLK, 1, ROWS};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ys, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// CTAs of a2c2f_wgmma_kernel<HD_, L2> an SM runs at once with `smem` bytes
// (0 where none or on error); kept, since a query costs more host time than
// a launch.
template <int HD_, bool L2>
int per_sm(int smem) {
  static std::mutex mu;
  static std::map<int, int> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(smem);
  if (it != known.end()) return it->second;
  constexpr auto kernel = a2c2f_wgmma_kernel<HD_, L2>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_LIMIT) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                    smem) != cudaSuccess)
    n = 0;
  known[smem] = n;
  return n;
}

// setmaxnreg moves registers from the producer warpgroup to the consumers;
// a claim the releases do not cover waits forever, so the launch is refused
// unless ptxas' count at entry lies between the two (one CTA an SM: the
// claims then fit the SM's 64 K registers).
template <auto kernel>
cudaError_t check_registers() {
  static const cudaError_t checked = [] {
    cudaFuncAttributes a;
    if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess)
      return cudaErrorInvalidDeviceFunction;
    return a.numRegs >= REGS_PRODUCER && a.numRegs <= REGS_CONSUMER &&
                   128 * REGS_PRODUCER + CONSUMER_THREADS * REGS_CONSUMER <=
                       65536
               ? cudaSuccess
               : cudaErrorInvalidConfiguration;
  }();
  return checked;
}

// The grid must be co-resident for grid.sync(): no more CTAs than the SMs
// hold at once.
template <int HD_, bool L2>
cudaError_t launch_hd(Params& p, int smem, const DeviceInfo& info,
                      cudaStream_t s) {
  const cudaError_t r = check_registers<a2c2f_wgmma_kernel<HD_, L2>>();
  if (r != cudaSuccess) return r;
  const int k = per_sm<HD_, L2>(smem);
  if (k < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int nb = p.H * p.W / p.area;
  const long long total =
      (long long)p.B * p.area * ((nb + p.tile - 1) / p.tile);
  const long long resident = (long long)k * info.sms;
  const int blocks = (int)(total < resident ? total : resident);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)a2c2f_wgmma_kernel<HD_, L2>, dim3(blocks), dim3(THREADS),
      args, smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

namespace yolou {
namespace a2c2f {

// bf16 at the wrapper's token tile (64 or 32): cin, c_ and c2 multiples of
// 8 and hid of 16 (the wrapper pads), every GEMM weight packed by
// `kernels/a2c2f.py::pack_bf16_weight`, every pointer 16-byte aligned;
// p.work the (tokens, hid) bf16 scratch of h where the plan keeps h in
// global memory (`bf16_plan`'s h_tile False), else not read.
cudaError_t launch_bf16(Params& p, int tile, cudaStream_t s,
                        const DeviceInfo& info) {
  if ((tile != 64 && tile != 32) || p.cin % 8 || p.c_ % 8 || p.hid % 16 ||
      p.c2 % 8)
    return cudaErrorInvalidValue;
  Plan pl;
  if (!plan(p, &pl) || (pl.h_global && p.work == nullptr))
    return cudaErrorInvalidValue;
  if (!pl.h_global) p.work = nullptr;            // the kernel's h tile
  p.tile = tile;
  p.ring = pl.ring;
  p.vb = pl.vb;
  p.nvb = pl.nvb;
  const int hd = p.ca / p.heads, nb = p.H * p.W / p.area;
  const int box = hd > 64 ? CBLK : hd;          // q's and k/v's boxes
  const long tokens = (long)p.B * p.H * p.W;
  const int YS = (p.n_stages + 1) * p.c_;
  cudaError_t e = band_map(&p.x_map, p.x, 1, tokens, p.cin, ROWS, false, KBLK);
  if (e == cudaSuccess)
    e = band_map(&p.ys_map, p.ys, 1, tokens, YS, ROWS, false, KBLK);
  if (e == cudaSuccess)
    e = slot_map(&p.slot_map, p.ys, tokens, p.c_, p.n_stages + 1);
  if (e == cudaSuccess && pl.h_global)           // h's boxes, as x's
    e = band_map(&p.work_map, p.work, 1, tokens, p.hid, ROWS, false, KBLK);
  for (int i = 0; i < 2 && e == cudaSuccess; ++i) {
    void* qkv = i ? p.qkv1 : p.qkv0;
    e = band_map(&p.q_map[i], qkv, p.B * p.area, nb, 3 * p.ca, ROWS, false,
                 box);
    if (e == cudaSuccess)
      e = band_map(&p.kv_map[i], qkv, p.B * p.area, nb, 3 * p.ca, KV_KEYS,
                   false, box);
    if (e == cudaSuccess && pl.nvb)
      e = band_map(&p.v_map[i], qkv, p.B, p.H * p.W, 3 * p.ca, pl.vb, false,
                   CBLK);
  }
  if (e != cudaSuccess) return e;
  if (pl.nvb == 0)                               // the v rows through L2
    return hd > 64    ? launch_hd<BLOCKED, true>(p, pl.L.bytes, info, s)
           : hd == 64 ? launch_hd<64, true>(p, pl.L.bytes, info, s)
                      : launch_hd<32, true>(p, pl.L.bytes, info, s);
  return hd > 64    ? launch_hd<BLOCKED, false>(p, pl.L.bytes, info, s)
         : hd == 64 ? launch_hd<64, false>(p, pl.L.bytes, info, s)
                    : launch_hd<32, false>(p, pl.L.bytes, info, s);
}

}  // namespace a2c2f
}  // namespace yolou

// x: (B, H, W, cin), out: (B, H, W, c2) of the I/O type, channels last.
// weights: host array of 4 + 20 * n_stages device pointers in the order
// [cv1_w, cv1_b] + per ABlock [qkv_w, qkv_b, pe_w (7,7,ca), pe_b, proj_w,
// proj_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b] + [cv2_w, cv2_b]; GEMM weights
// (cin_i, cout_i) of the I/O type (qkv (c_, 3ca), proj (ca, c_)), biases and
// pe_w f32; the MLP's hidden width hid (mlp1_w (c_, hid), mlp2_w (hid, c_)).
// ys: scratch of B*H*W*(n_stages+1)*c_ elements, qkv: scratch of
// 2*B*H*W*3*ca elements of the I/O type. dtype 0 = float32, 1 = bfloat16.
// blocks: a device copy of the 20 * n_stages ABlock pointers (weights[2 ..
// 2 + 20 n_stages)); ca: the attention's width, heads * 32 or heads * 64;
// scale: the softmax's (the true head width ** -0.5); tile: the token tile
// (64 or 32). f32: work, scratch of B*H*W*(c_+hid+ca) floats, with cin, c_,
// hid and c2 multiples of 4 and the GEMM weights packed panel-major; bf16:
// cin, c_ and c2 multiples of 8, hid of 16, the GEMM weights packed by
// `pack_bf16_weight`. Every pointer 16-byte aligned. Returns the launch
// status.
extern "C" int yolou_a2c2f(const void* x, const void* const* weights,
                           int n_weights, void* out, void* ys, void* qkv,
                           int B, int H, int W, int cin, int c_, int c2,
                           int hid, int n_stages, int area, int heads,
                           int dtype, const void* blocks, void* work, int ca,
                           float scale, int tile, void* stream) {
  return entry(x, weights, n_weights, out, ys, qkv, B, H, W, cin, c_, c2, hid,
               n_stages, area, heads, dtype, blocks, work, ca, scale, tile,
               stream);
}

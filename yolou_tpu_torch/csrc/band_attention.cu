// Multi-head band softmax attention, two entry points over one core.
//
// Kernel A (eval): folded qkv projection + attention. Replaces
// yolou_tpu/ops/pallas_attn.py::area_attention_qkv_fused (Pallas body
// _qkv_attn_kernel). For every band g and head h of hd = 32 or 64 channels
// (or a multiple of 64, kernel C's blocked form, below):
//   qkv = x[g] . w[:, role*C + h*hd + d] + b   (f32 accumulate, rounded to T)
//   o[g, :, h*hd + d] = softmax(q k^T * scale) v          (f32 softmax)
// and the value projection v is written out too (it feeds the dw7x7 conv).
// scale is the caller's: hd ** -0.5, or the true width's where the wrapper
// padded narrower heads with zero channels (`kernels/attention.py`).
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
// rounding is the identity.)
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
// This file holds the streamed path, which passes a band's keys and values
// through shared memory in key tiles (TMA; FMA micro-tiles in f32, wgmma
// in bf16), so its shared memory does not grow with N. It takes every band
// of more than 64 tokens, in both kernels and both types; the bands of 64
// tokens or fewer take the short path, one launch over tiles of whole
// bands (band_attention_short.cu). The wrapper
// (`kernels/attention.py::attention_plan`) chooses by N alone. Kernel A's
// first launch here projects k and v of every head in one GEMM over the
// flattened tokens: bf16 on wgmma from TMA-fed shared memory
// (`kv_projection_wgmma_kernel`), f32 on register micro-tiles fed by TMA
// (`kv_projection_f32_kernel`, gemm_f32.cuh). Where the q-projecting
// attention kernel would not fit a block (it keeps the head's (C, hd) q
// weight columns, and in bf16 the CTA's (rows, C) x tile, in shared
// memory: wide C), kernel A takes its wide form instead: the same GEMM
// projects q too, into a (G, N, C) scratch, and kernel C's streamed
// attention reads q, k and v (`yolou_band_attention_qkv_wide`). The GEMMs
// ring over C, so neither launch's shared memory grows with it; q is
// rounded to the I/O type where the plain version rounds it. Heads of 32
// and of 64 have one form of each streamed kernel each (heads of 64: f32
// 32 query rows a CTA, bf16 one consumer warpgroup, tiles of two 32-channel
// boxes (f32) or 128-byte rows on the 128-byte swizzle (bf16, four k steps
// of q k^T, m64n64 products for p.v and the q projection)). Heads wider
// than 64, which the wrapper pads with zero channels to a multiple of 64,
// take kernel C's blocked form (`band_attention_blocked_wgmma_kernel`,
// `band_attention_blocked_kernel`): a CTA a (head, 64-channel output block,
// query tile), the scores summed over the head's 64-channel blocks, the
// shared memory the same at every width; kernel A reaches it through its
// wide form, at any N.

#include "band_attention.cuh"
#include "gemm_f32.cuh"
#include "hopper.cuh"

using namespace yolou;

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ the streamed path
//
// A CTA owns a block of query rows of one (head, band) and streams the
// band's keys and values through a ring of shared-memory stages, loaded by
// the Tensor Memory Accelerator (hopper.cuh): one thread issues a box of 32
// channels x KB keys of a 3-D map over (C, N, G) for each of k and v, and
// the box's transaction bytes complete a `full` mbarrier; the readers free
// the stage through an `empty` one. Keys past N arrive as zeros (the box
// stops at the band's edge) and are masked to -inf. The online softmax runs
// per key tile in log2 units, exp2(s * sl2 - m * sl2) with sl2 = scale *
// log2(e) folded into one FMA, the running maximum m in raw units.
//
// Kernel C reads q, k and v from HBM. Kernel A needs every key of the band
// before any query attends, so it is two launches: a projection of k and v
// (v into its second output, k into a (G, N, C) scratch the wrapper
// allocates: one more write and read of G * N * C elements), then the
// streamed attention, which projects its own q rows from x (x . Wq + b,
// never written out).
//
// f32 (`band_attention_stream_kernel<R, PROJECT>`): full f32 on the FMA
// units (TF32 would not hold the f32 tolerances). What bounds it is the FMA
// rate, 4 N^2 * 32 operations a (band, head) at 67 TFLOP/s, and what keeps
// it below that is shared memory: one f32 FMA a score channel needs a word
// of q and a word of k. So a CTA of R = 64, 32 or 16 query rows
// (`kernels/attention.py::stream_rows` picks by the grid and the width,
// timed on an H100) runs 4 R threads, 16 a group of 4 rows, and each thread
// scores a 4 x 4 register micro-tile (its rows against keys t, t + 16, t +
// 32, t + 48 of the 64-key tile) from 16-byte loads: 16 FMAs for 8 words of
// q and k over each 4 channels. The tiles take TMA's 128-byte swizzle, so
// the 16 keys a load reads fall in distinct banks two by two. The row
// maximum is reduced by shuffles among a group's 16 threads (the row sum at
// the end); the group writes its probabilities to its own rows of shared
// memory and multiplies them by v as a second micro-tile product: 4 rows x 4
// channels x 32 keys a thread, the two halves of the keys summed at the end.
// K and v arrive in a ring of two 64-key stages. With PROJECT the CTA first
// projects its q rows from x into the q tile: the head's (C, 32) q weight
// columns by TMA into shared memory, x read from global memory a step ahead,
// a row and 8 channels a thread in f32 FMAs over the input channels in two
// interleaved chains.
//
// bf16 (`band_attention_stream_wgmma_kernel<NC, PROJECT>`):
// FlashAttention-3's shape at head width 32. A producer warpgroup, which
// gives most of its registers to the consumers (setmaxnreg), has one thread
// issue the TMA loads: q (or x and the head's q weight columns), then k and
// v tiles of 128 keys (64-byte rows, 64-byte swizzle) into a ring of three
// stages. NC consumer warpgroups own 64 query rows each (two, one CTA an SM,
// where kernel A's q weight columns are wide or the grid is deep; else one,
// two CTAs an SM: `stream_rows`) and issue wgmma: S = q k^T (m64n128k16, two
// k steps of 16 channels, both operands from shared memory), the online
// softmax on the accumulator, the probabilities rounded to bf16 in registers
// as the A operand of O += P V (m64n32k16, v MN-major: the transpose bit).
// The product of tile i - 1's P with its v is issued with tile i's scores,
// so the softmax of tile i runs while it multiplies; the two consumer
// warpgroups take turns issuing (two named barriers), so one's softmax also
// overlaps the other's products. What bounds it is the exp unit: one exp a
// score against 128 tensor-core operations, about twice the tensor-core time
// at 3.9e12 exp/s against 989 TFLOP/s. With PROJECT, q = x . Wq + b by wgmma
// (m64n32k16 over C / 16 steps) from the TMA-loaded x rows, rounded to bf16
// into the q tile before the key loop.

constexpr int KB_F32 = 64;        // keys a streamed tile, f32
constexpr int STAGES_F32 = 2;     // its ring
// the f32 probabilities: a row of 64 keys, keys 32-63 four floats on (so
// the four 16-byte reads of a warp's p.v step fall in distinct banks), rows
// 76 floats apart (the two row groups of a warp 16 banks apart)
constexpr int LDP = 76;
constexpr int KB_MMA = 128;       // keys a streamed tile, bf16
constexpr int STAGES_MMA = 3;     // its ring
constexpr int WG_ROWS = 64;       // query rows of a consumer warpgroup
constexpr int REGS_PRODUCER = 40;  // setmaxnreg of the producer warpgroup

// Kernel A's first launch on the streamed path, bf16: k | v = x . w[:, C:3C]
// + b[C:3C] for every head in one grid, a GEMM over the (G N)-token x
// 2C-column output (the bf16 twin of `kv_projection_f32_kernel` below);
// in the wide form (`Q`) q | k | v = x . w + b, 3C columns: a
// CTA of one warpgroup per tile of KVB_TM tokens (tiles cross band
// boundaries) and panel of 64 KVB_NB columns. Thread 0 issues every TMA load
// into a ring of up to KVB_STAGES stages over C: x's slab of 64 channels by
// one box of `x_map` ((G N, C), 128-byte rows, 128-byte swizzle: the K-major
// A operand) and the weight's k | v columns by KVB_NB boxes of `w_map` ((C,
// 3C), 64 rows x 64 columns, 128-byte swizzle: MN-major B operands, the
// layout the q-projecting wgmma attention reads its weight in), so the next
// stage lands while this one multiplies. Products on wgmma m64n64k16, f32
// accumulators, four k steps a stage; channels and columns past C and 3C
// read zero. The epilogue adds the f32 bias, rounds once to bf16, stages
// the tile in shared memory and writes 16-byte chunks, q (wide form) and k
// into the scratches and v into kernel A's second output, (G, N, C)
// head-major as w's columns are. What bounds it: the bytes (x read, k and
// v written: 6 G N C), about 1.5 us at yolov12n's layer 6 at 640^2, batch
// 8, against 4 G N C^2 flop at 989 TFLOP/s, a tenth of that; so the tiles
// are small and many (64 tokens x 64 columns, KVB_NB = 1: 400 CTAs there,
// several an SM, their loads in flight together; on an H100 the faster at
// seven of the eight bands timed against panels of 128 and 256 columns,
// `tools/time_builds.py`), and every byte of HBM moves once, x's slab a
// panel from L2.
constexpr int KVB_TM = 64;        // tokens a CTA (the wgmma's rows)
constexpr int KVB_KS = 64;        // channels a ring stage (one 128-byte box)
constexpr int KVB_STAGES = 4;     // ring stages at most
constexpr int KVB_NB = 1;         // 64-column weight boxes a panel

// The output of the projection's column c (of k | v, or with `Q` of q | k
// | v, role-major) at channel c % C of token row 0. q comes last among the
// kernels' parameters: the k / v form does not read it.
template <bool Q, typename T>
__device__ __forceinline__ T* role_out(T* q, T* k, T* v, int c, int C) {
  if (Q) {
    if (c < C) return q + c;
    c -= C;
  }
  return c < C ? k + c : v + (c - C);
}

template <bool Q>
__global__ void __launch_bounds__(128)
kv_projection_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           const float* __restrict__ bias,
                           bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                           int tokens, int C, int stages,
                           bf16* __restrict__ q_out) {
  constexpr int NB = KVB_NB;
  constexpr int XT = KVB_TM * KVB_KS;            // elements of an x box
  constexpr int WT = KVB_KS * 64;                // of a weight box
  constexpr int ST = XT + NB * WT;               // of a stage
  constexpr int LDO = 64 * NB + 8;   // staged rows: 16 bytes past 128 NB
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* Os = ring + stages * ST;                 // [KVB_TM][LDO] the tile
  uint64_t* full = reinterpret_cast<uint64_t*>(Os + KVB_TM * LDO);
  const int tok0 = blockIdx.x * KVB_TM, col0 = blockIdx.y * 64 * NB;
  const int first = Q ? 0 : C, cols = 3 * C - first;   // of w's columns
  const int ksteps = (C + KVB_KS - 1) / KVB_KS;
  const int tid = threadIdx.x;

  auto issue = [&](int i) {                      // stage i (thread 0)
    const int s = i % stages;
    bf16* st = ring + s * ST;
    mbar_expect_tx(&full[s], ST * sizeof(bf16));
    tma_load_2d(st, &x_map, &full[s], i * KVB_KS, tok0);
    for (int j = 0; j < NB; ++j)
      tma_load_2d(st + XT + j * WT, &w_map, &full[s], first + col0 + 64 * j,
                  i * KVB_KS);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(stages, ksteps); ++i) issue(i);

  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  for (int i = 0; i < ksteps; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const bf16* st = ring + s * ST;
    const uint64_t dx = smem_desc_sw128(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KVB_KS / 16; ++kk)     // 16 channels: 32 bytes on
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_64x64_ss(acc[j], dx + 2 * kk,
                       smem_desc_sw128(st + XT + j * WT + kk * 16 * 64), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(acc[j][e]);
    if (i + stages < ksteps) {                   // slot s read by every warp
      __syncthreads();
      if (tid == 0) issue(i + stages);
    }
  }

  // + f32 bias, one rounding to bf16 (rows r_lo and r_lo + 8, columns
  // 8 jj + 2 t + e of box j), staged; then 16-byte chunks to k or v
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int r_lo = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * j + 8 * jj + 2 * t, c = col0 + col;
      const float b0 = c < cols ? bias[first + c] : 0.f;
      const float b1 = c < cols ? bias[first + c + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(Os + r_lo * LDO + col) =
          pack_bf16(acc[j][4 * jj] + b0, acc[j][4 * jj + 1] + b1);
      *reinterpret_cast<uint32_t*>(Os + (r_lo + 8) * LDO + col) =
          pack_bf16(acc[j][4 * jj + 2] + b0, acc[j][4 * jj + 3] + b1);
    }
  __syncthreads();
  for (int q = tid; q < KVB_TM * 8 * NB; q += 128) {
    const int r = q / (8 * NB), ch = q % (8 * NB);
    const int tok = tok0 + r, c = col0 + 8 * ch;
    if (tok < tokens && c < cols)
      *reinterpret_cast<uint4*>(role_out<Q>(q_out, k_out, v_out, c, C) +
                                (size_t)tok * C) =
          *reinterpret_cast<const uint4*>(Os + r * LDO + 8 * ch);
  }
}

// Kernel A's first launch, f32: k | v = x . w[:, C:3C] + b[C:3C] (the wide
// form, `Q`: q | k | v = x . w + b) for every head in one grid, a
// GEMM over the (G N)-token x 2C-column (3C) output on
// gemm_f32.cuh's register micro-tiles (full f32, each output one chain of
// FMAs over the channels in order): a CTA per tile of KV_TM tokens and
// panel of NP columns, x's slab by a TMA box of `x_map` ((G N, C), boxes of
// 32 channels x KV_TM tokens), the weight's by one box of `w_map` ((C, 3C),
// boxes of NP columns x 32 rows), both through the 4-stage ring; k into
// the scratch (q too in the wide form), v into kernel A's second output,
// (G, N, C) head-major as w's columns are. What bounds it: 4 G N C^2 flop
// at 67 TFLOP/s, about equal to its bytes (x read, k and v written) at
// 3.35 TB/s at C = 64-128; a CTA reads its weight slab once for 64 tokens
// (the SIMT kernel before it read each weight once for 4).
constexpr int KV_TM = 64;

template <bool Q>
__global__ void __launch_bounds__(GEMM_THREADS)
kv_projection_f32_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const float* __restrict__ bias,
                         float* __restrict__ k_out, float* __restrict__ v_out,
                         int tokens, int C, float* __restrict__ q_out) {
  using L = GemmTile<KV_TM>;
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(align1024(smem_raw));
  Ring ring = gemm_ring(smem, reinterpret_cast<uint64_t*>(smem + L::GEMM));
  if (threadIdx.x == 0) mbar_init_fence();
  __syncthreads();
  const int tok0 = blockIdx.x * KV_TM, col0 = blockIdx.y * L::NP;
  const int first = Q ? 0 : C;                   // of w's columns
  gemm_f32_stream<KV_TM>(
      ring, &x_map, 0, tok0, min(KV_TM, tokens - tok0),
      [&](float* dst, uint64_t* bar, int, int k0) {
        tma_load_2d(dst, &w_map, bar, first + col0, k0);
      },
      C, min(L::NP, 3 * C - first - col0), [&](int r, int col, float4 v) {
        const int c = col0 + col;                // of the projected ones
        const float4 b = *reinterpret_cast<const float4*>(bias + first + c);
        float* dst = role_out<Q>(q_out, k_out, v_out, c, C) +
                     (size_t)(tok0 + r) * C;
        *reinterpret_cast<float4*>(dst) =
            make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
      });
}

// The streamed attention, f32: R query rows a CTA (4 R threads), k and v
// tiles of 64 keys by TMA, 4 x 4 register micro-tiles (above), heads of HD_
// channels (at 64 a thread's p.v micro-tile is 4 rows x 8 channels). PROJECT
// (kernel A): q = x . Wq + b projected here from x, the head's q weight
// columns by TMA (w_map); else (kernel C) q arrives by TMA (q_map, boxes
// of R rows) and w_map is not read.
// PAD (kernel C only): heads of hd channels padded to HD_ by the boxes of
// `head_map`s of q, k and v (G, N, C = heads hd), o's stores cut to the
// head's channels. The kernels below call this body.
template <int R, bool PROJECT, int HD_, bool PAD>
__device__ __forceinline__ void attend_stream_f32(
    const CUtensorMap& q_map, const CUtensorMap& k_map,
    const CUtensorMap& v_map, const CUtensorMap& w_map,
    const float* __restrict__ x, const float* __restrict__ bias,
    float* __restrict__ o, int N, int C, float sl2, int hd) {
  static_assert(!(PAD && PROJECT), "kernel A pads its operands");
  constexpr int TILE = KB_F32 * HD_;              // floats of a k or v tile
  constexpr int CB = HD_ / 32;                    // 32-channel blocks a head
  extern __shared__ unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(align1024(smem_raw));  // [2][64][HD]
  float* Vs = Ks + STAGES_F32 * TILE;                         // [2][64][HD]
  float* Qs = Vs + STAGES_F32 * TILE;                         // [R][HD]
  float* Ws = Qs + R * HD_;                   // PROJECT: [C][HD] q columns
  float* Ps = Ws + (PROJECT ? C * HD_ : 0);                   // [R][LDP]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ps + R * LDP);
  uint64_t* empty = full + STAGES_F32;
  uint64_t* q_full = empty + STAGES_F32;
  const int h = blockIdx.x, g = blockIdx.y, row0 = blockIdx.z * R;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tiles = (N + KB_F32 - 1) / KB_F32;

  // key tile j -> stage j % 2, its bytes counted on full[j % 2]
  auto load = [&](int j) {
    const int st = j % STAGES_F32;
    mbar_expect_tx(&full[st], 2 * TILE * sizeof(float));
    for (int cb = 0; cb < CB; ++cb) {
      tma_load_head<PAD>(Ks + st * TILE + cb * KB_F32 * 32, &k_map,
                         &full[st], h, HD_, 32 * cb, j * KB_F32, g);
      tma_load_head<PAD>(Vs + st * TILE + cb * KB_F32 * 32, &v_map,
                         &full[st], h, HD_, 32 * cb, j * KB_F32, g);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < STAGES_F32; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * R / 32);         // a warp each
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    if (PROJECT) {
      mbar_expect_tx(q_full, C * HD_ * sizeof(float));
      for (int hb = 0; hb < CB; ++hb)
        for (int cb = 0; cb < C / 32; ++cb)
          tma_load_2d(Ws + hb * C * 32 + cb * 32 * 32, &w_map, q_full,
                      h * HD_ + 32 * hb, cb * 32);
    } else {
      mbar_expect_tx(q_full, R * HD_ * sizeof(float));
      for (int hb = 0; hb < CB; ++hb)
        tma_load_head<PAD>(Qs + hb * R * 32, &q_map, q_full, h, HD_, 32 * hb,
                           row0, g);
    }
    for (int j = 0; j < min(STAGES_F32, tiles); ++j) load(j);
  }
  if (PROJECT) {
    // row r, channels 8 cb .. 8 cb + 7 a thread (8 CB of them: chunks
    // 2 CB cb ..), the weights from shared memory and x from global memory a
    // step of 8 input channels ahead, in two interleaved halves of 4 (two
    // chains of FMAs, added at the end); rows past N project row N - 1
    // (finite, never stored)
    constexpr int CW = 2 * CB;                    // chunks of 4 a thread
    const int r = tid >> 2, cb = tid & 3;
    const float4* xr = reinterpret_cast<const float4*>(
        x + ((size_t)g * N + min(row0 + r, N - 1)) * C);
    float acc[2][4 * CW];
#pragma unroll
    for (int e = 0; e < 4 * CW; ++e) acc[0][e] = acc[1][e] = 0.f;
    float4 xv[2] = {xr[0], xr[1]};
    mbar_wait(q_full, 0);
    for (int c = 0; c < C; c += 8) {
      float4 xn[2];
      if (c + 8 < C) {
        xn[0] = xr[c / 4 + 2];
        xn[1] = xr[c / 4 + 3];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int cr = c + 4 * hh + u;
          const float xu = lane_of(xv[hh], u);
          float* a = acc[hh];
#pragma unroll
          for (int k = 0; k < CW; ++k) {
            const float4 wk = *reinterpret_cast<const float4*>(
                Ws + f32_at<HD_>(cr, CW * cb + k, C));
            a[4 * k] = fmaf(xu, wk.x, a[4 * k]);
            a[4 * k + 1] = fmaf(xu, wk.y, a[4 * k + 1]);
            a[4 * k + 2] = fmaf(xu, wk.z, a[4 * k + 2]);
            a[4 * k + 3] = fmaf(xu, wk.w, a[4 * k + 3]);
          }
        }
      }
      xv[0] = xn[0];
      xv[1] = xn[1];
    }
    const float* bq = bias + h * HD_ + 4 * CW * cb;
#pragma unroll
    for (int k = 0; k < CW; ++k)
      *reinterpret_cast<float4*>(Qs + f32_at<HD_>(r, CW * cb + k, R)) =
          make_float4(
          acc[0][4 * k] + acc[1][4 * k] + bq[4 * k],
          acc[0][4 * k + 1] + acc[1][4 * k + 1] + bq[4 * k + 1],
          acc[0][4 * k + 2] + acc[1][4 * k + 2] + bq[4 * k + 2],
          acc[0][4 * k + 3] + acc[1][4 * k + 3] + bq[4 * k + 3]);
    __syncthreads();
  } else {
    mbar_wait(q_full, 0);
  }

  // a group of 16 threads (half a warp) owns rows 4 rg .. 4 rg + 3; for
  // the scores thread t takes keys t + 16 u, for p.v keys 32 half .. + 31
  // and channels 4 cq .. 4 cq + 3
  const int rg = tid >> 4, t = tid & 15, half = t >> 3, cq = t & 7;
  float m[4], l[4], acc[4][4 * CB];             // channels 4 cq + 32 b + e
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e) acc[i][e] = 0.f;
  }
  float* Pg = Ps + 4 * rg * LDP;
  for (int i = 0; i < tiles; ++i) {
    const int st = i % STAGES_F32;
    // tile i + 1 into the stage tile i - 1 used, once every warp freed it
    if (tid == 0 && i >= 1 && i + STAGES_F32 - 1 < tiles) {
      const int j = i + STAGES_F32 - 1;
      mbar_wait(&empty[j % STAGES_F32], (j / STAGES_F32 - 1) & 1);
      load(j);
    }
    mbar_wait(&full[st], (i / STAGES_F32) & 1);
    const float* Kt = Ks + st * TILE;
    const float* Vt = Vs + st * TILE;

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      s[a][0] = s[a][1] = s[a][2] = s[a][3] = 0.f;
#pragma unroll
    for (int cc = 0; cc < HD_ / 4; ++cc) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(
            Qs + f32_at<HD_>(4 * rg + a, cc, R));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kv[u] = *reinterpret_cast<const float4*>(
            Kt + f32_at<HD_>(t + 16 * u, cc, KB_F32));
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[a][u] = fmaf(qv[a].x, kv[u].x, s[a][u]);
          s[a][u] = fmaf(qv[a].y, kv[u].y, s[a][u]);
          s[a][u] = fmaf(qv[a].z, kv[u].z, s[a][u]);
          s[a][u] = fmaf(qv[a].w, kv[u].w, s[a][u]);
        }
    }
    const int k0 = i * KB_F32;
    if (k0 + KB_F32 > N) {                       // block-uniform
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k0 + t + 16 * u >= N)
#pragma unroll
          for (int a = 0; a < 4; ++a) s[a][u] = -INFINITY;
    }
    // online softmax: the row maximum over the group's 16 threads (finite:
    // key k0 exists), probabilities exp2(s sl2 - m sl2), this thread's part
    // of the row sums, the accumulator rescaled
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int d = 1; d < 16; d <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, d));
      mx = fmaxf(mx, m[a]);
      const float c = exp2f((m[a] - mx) * sl2), nb = -mx * sl2;
      m[a] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[a][u] = exp2f(fmaf(s[a][u], sl2, nb));
        sum += s[a][u];
      }
      l[a] = l[a] * c + sum;
#pragma unroll
      for (int e = 0; e < 4 * CB; ++e) acc[a][e] *= c;
    }
    __syncwarp();                                // the last tile's P read
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        Pg[a * LDP + t + 16 * u + (u >= 2 ? 4 : 0)] = s[a][u];
    __syncwarp();
    // O += P V over this thread's 32 keys, 4 at a time
#pragma unroll 2
    for (int jj = 0; jj < 32; jj += 4) {
      float4 pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pv[a] = *reinterpret_cast<const float4*>(Pg + a * LDP + 36 * half + jj);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int b = 0; b < CB; ++b) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vt + f32_at<HD_>(32 * half + jj + u, cq + 8 * b, KB_F32));
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = lane_of(pv[a], u);
            float* ac = acc[a] + 4 * b;
            ac[0] = fmaf(p, vv.x, ac[0]);
            ac[1] = fmaf(p, vv.y, ac[1]);
            ac[2] = fmaf(p, vv.z, ac[2]);
            ac[3] = fmaf(p, vv.w, ac[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);      // this warp is done with it
  }
  // the row sums over the group, the two key halves added, rows 2 half and
  // 2 half + 1 of the group stored by this thread
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) l[a] += __shfl_xor_sync(FULL, l[a], d);
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e)
      acc[a][e] += __shfl_xor_sync(FULL, acc[a][e], 8);
  }
  float* og = o + (size_t)g * N * C + (PAD ? h * hd : h * HD_) + 4 * cq;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = row0 + 4 * rg + a;
    if ((a >> 1) == half && n < N) {
      const float inv = 1.f / l[a];
#pragma unroll
      for (int b = 0; b < CB; ++b)
        if (!PAD || 32 * b + 4 * cq < hd)   // the head's channels (hd % 4 == 0)
          *reinterpret_cast<float4*>(og + (size_t)n * C + 32 * b) =
              make_float4(acc[a][4 * b] * inv, acc[a][4 * b + 1] * inv,
                          acc[a][4 * b + 2] * inv, acc[a][4 * b + 3] * inv);
    }
  }
}

template <int R, bool PROJECT, int HD_>
__global__ void __launch_bounds__(4 * R)
band_attention_stream_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap w_map,
                             const float* __restrict__ x,
                             const float* __restrict__ bias,
                             float* __restrict__ o, int N, int C,
                             float sl2) {
  attend_stream_f32<R, PROJECT, HD_, false>(q_map, k_map, v_map, w_map, x,
                                            bias, o, N, C, sl2, HD_);
}

// Kernel C at heads of hd channels padded to HD_ inside the kernel.
template <int R, int HD_>
__global__ void __launch_bounds__(4 * R)
band_attention_stream_padded_kernel(const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap k_map,
                                    const __grid_constant__ CUtensorMap v_map,
                                    float* __restrict__ o, int N, int C,
                                    float sl2, int hd) {
  attend_stream_f32<R, false, HD_, true>(q_map, k_map, v_map, q_map, nullptr,
                                         nullptr, o, N, C, sl2, hd);
}

// The streamed attention, bf16: a producer warpgroup (its thread 0 issues
// every TMA load) and NC consumer warpgroups of 64 query rows on wgmma
// (above), heads of HD_ channels (at 64: rows of 128 bytes, the 128-byte
// swizzle, four k steps of q k^T and m64n64 products for p.v and the q
// projection). PROJECT (kernel A): src_map is x and w_map the (C, 3C)
// weight; else (kernel C) src_map is q and w_map is not read.
// PAD as the f32 body's: kernel C at heads of hd channels padded to HD_.
template <int NC, bool PROJECT, int HD_, bool PAD>
__device__ __forceinline__ void attend_stream_wgmma(
    const CUtensorMap& src_map, const CUtensorMap& k_map,
    const CUtensorMap& v_map, const CUtensorMap& w_map,
    const float* __restrict__ bias, bf16* __restrict__ o, int N, int C,
    float sl2, int hd) {
  static_assert(!(PAD && PROJECT), "kernel A pads its operands");
  constexpr int TILE = KB_MMA * HD_;              // elements of a k or v tile
  constexpr int QT = WG_ROWS * HD_;               // of a warpgroup's q tile
  constexpr int XT = WG_ROWS * 32;                // of a box of x
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1024(smem_raw));  // [3][128][HD]
  bf16* Vs = Ks + STAGES_MMA * TILE;                        // [3][128][HD]
  bf16* Qs = Vs + STAGES_MMA * TILE;                        // [NC][64][HD]
  bf16* Ws = Qs + NC * QT;                     // PROJECT: [C][HD] q columns
  bf16* Xs = Ws + (PROJECT ? C * HD_ : 0);     // PROJECT: [NC][C/32][64][32]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(Xs + (PROJECT ? NC * WG_ROWS * C : 0));
  uint64_t* empty = full + STAGES_MMA;
  uint64_t* q_full = empty + STAGES_MMA;
  const int h = blockIdx.x, g = blockIdx.y;
  const int row0 = blockIdx.z * NC * WG_ROWS;
  const int tiles = (N + KB_MMA - 1) / KB_MMA;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES_MMA; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NC);                 // a warpgroup each
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer warpgroup
    regs_release<REGS_PRODUCER>();
    if (threadIdx.x == 0) {
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      if (PROJECT) {
        const int blocks = C / 32;
        mbar_expect_tx(q_full, (C * HD_ + NC * WG_ROWS * C) * sizeof(bf16));
        for (int cb = 0; cb < blocks; ++cb)
          tma_load_2d(Ws + cb * 32 * HD_, &w_map, q_full, h * HD_, cb * 32);
        for (int c = 0; c < NC; ++c)
          for (int cb = 0; cb < blocks; ++cb)
            tma_load_3d(Xs + (c * blocks + cb) * XT, &src_map, q_full,
                        cb * 32, row0 + c * WG_ROWS, g);
      } else {
        mbar_expect_tx(q_full, NC * QT * sizeof(bf16));
        for (int c = 0; c < NC; ++c)
          tma_load_head<PAD>(Qs + c * QT, &src_map, q_full, h, HD_, 0,
                             row0 + c * WG_ROWS, g);
      }
      for (int i = 0; i < tiles; ++i) {
        const int st = i % STAGES_MMA;
        if (i >= STAGES_MMA)                     // every consumer freed it
          mbar_wait(&empty[st], (i / STAGES_MMA - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE * sizeof(bf16));
        tma_load_head<PAD>(Ks + st * TILE, &k_map, &full[st], h, HD_, 0,
                           i * KB_MMA, g);
        tma_load_head<PAD>(Vs + st * TILE, &v_map, &full[st], h, HD_, 0,
                           i * KB_MMA, g);
      }
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  regs_claim<NC == 1 ? 216 : 232>();
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r_lo = 16 * warp + gq;               // rows r_lo, r_lo + 8
  bf16* Qw = Qs + wg * QT;
  mbar_wait(q_full, 0);
  if (PROJECT) {
    // q = x . Wq + b: f32 accumulation, f32 bias, rounded to bf16 into the
    // warpgroup's q tile (64-byte swizzle, as TMA writes it)
    const bf16* Xw = Xs + wg * (C / 32) * XT;
    float q[HD_ / 2];
#pragma unroll
    for (int e = 0; e < HD_ / 2; ++e) q[e] = 0.f;
    wgmma_fence();
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_proj<HD_>(q, smem_desc(Xw + (kk >> 1) * XT + (kk & 1) * 16),
                      head_desc<HD_>(Ws + kk * 16 * HD_), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < HD_ / 2; ++e) reg_fence(q[e]);
#pragma unroll
    for (int j = 0; j < HD_ / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float b0 = bias[h * HD_ + col], b1 = bias[h * HD_ + col + 1];
      *reinterpret_cast<uint32_t*>(Qw + kv_at<HD_>(r_lo, j) + 2 * t) =
          pack_bf16(q[4 * j] + b0, q[4 * j + 1] + b1);
      *reinterpret_cast<uint32_t*>(Qw + kv_at<HD_>(r_lo + 8, j) + 2 * t) =
          pack_bf16(q[4 * j + 2] + b0, q[4 * j + 3] + b1);
    }
    fence_proxy_async();
    bar_sync(3 + wg, 128);                       // the whole tile written
  }

  // s: the 64 x 128 scores (row r_lo / r_lo + 8, keys 8 j + 2 t + e at
  // s[4 j + e] / s[4 j + 2 + e]); p: the last tile's probabilities as A
  // fragments of 8 steps of 16 keys; oacc: O (channels 8 j + 2 t + e)
  float s[64], oacc[HD_ / 2];
  uint32_t p[8][4];
#pragma unroll
  for (int e = 0; e < HD_ / 2; ++e) oacc[e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const uint64_t dq = head_desc<HD_>(Qw);
  if (NC == 2 && wg == 1) bar_arrive(1, 256);    // warpgroup 0 goes first
  for (int i = 0; i < tiles; ++i) {
    const int st = i % STAGES_MMA;
    mbar_wait(&full[st], (i / STAGES_MMA) & 1);
    if (NC == 2) bar_sync(1 + wg, 256);          // this warpgroup's turn
    wgmma_fence();
    const uint64_t dk = head_desc<HD_>(Ks + st * TILE);
    wgmma_64x128_ss(s, dq, dk, 0);               // channels 0-15
#pragma unroll
    for (int kk = 1; kk < HD_ / 16; ++kk)        // 16 more: 32 bytes on
      wgmma_64x128_ss(s, dq + 2 * kk, dk + 2 * kk, 1);
    wgmma_commit();
    if (i > 0) {                                 // O += P V of tile i - 1
      const bf16* Vt = Vs + ((i - 1) % STAGES_MMA) * TILE;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<HD_>(oacc, p[kk], head_desc<HD_>(Vt + kk * 16 * HD_));
      wgmma_commit();
    }
    if (NC == 2 && !(wg == 1 && i == tiles - 1))
      bar_arrive(2 - wg, 256);                   // the other's turn
    if (i > 0) wgmma_wait<1>();
    else wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) reg_fence(s[e]);

    const int k0 = i * KB_MMA;
    if (k0 + KB_MMA > N) {                       // keys past N
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * t + e >= N)
            s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
    }
    const float2 c = online_softmax(s, sl2, m_lo, m_hi, l_lo, l_hi);
    if (i > 0) {                                 // P V of tile i - 1 done
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < HD_ / 2; ++e) reg_fence(oacc[e]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(p[kk][e]);
      if (tid == 0) mbar_arrive(&empty[(i - 1) % STAGES_MMA]);
    }
    rescale_and_pack<HD_>(oacc, p, s, c);
  }
  wgmma_fence();                                 // O += P V of the last tile
  const bf16* Vt = Vs + ((tiles - 1) % STAGES_MMA) * TILE;
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

  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  const int n_lo = row0 + wg * WG_ROWS + r_lo, n_hi = n_lo + 8;
  bf16* og = o + (size_t)g * N * C + (PAD ? h * hd : h * HD_) + 2 * t;
#pragma unroll
  for (int j = 0; j < HD_ / 8; ++j) {
    if (PAD && 8 * j >= hd) break;     // channels past the head (hd % 8 == 0)
    if (n_lo < N)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)n_lo * C + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j] * inv_lo,
                                oacc[4 * j + 1] * inv_lo);
    if (n_hi < N)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)n_hi * C + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv_hi,
                                oacc[4 * j + 3] * inv_hi);
  }
}

template <int NC, bool PROJECT, int HD_>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
band_attention_stream_wgmma_kernel(
    const __grid_constant__ CUtensorMap src_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ bias, bf16* __restrict__ o, int N, int C,
    float sl2) {
  attend_stream_wgmma<NC, PROJECT, HD_, false>(src_map, k_map, v_map, w_map,
                                               bias, o, N, C, sl2, HD_);
}

// Kernel C at heads of hd channels padded to HD_ inside the kernel.
template <int NC, int HD_>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
band_attention_stream_padded_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int N,
    int C, float sl2, int hd) {
  attend_stream_wgmma<NC, false, HD_, true>(q_map, k_map, v_map, q_map,
                                            nullptr, o, N, C, sl2, hd);
}

// ------------------------------------------------- heads wider than 64
//
// The blocked form of the streamed attention (kernel C, and kernel A's
// wide form after its projection) for heads of hdp = 64 j channels, j >= 2
// (the wrapper pads a head of any width past 64 to the next multiple of 64
// with zero channels). A CTA owns one (head, 64-channel output block, query
// tile): the grid's first axis is heads * hdp / 64. Its scores q k^T
// accumulate over the head's hdp / 64 channel blocks, a longer K loop into
// the same f32 accumulators, so the numerics are the streamed kernels'; v
// and o touch only the CTA's 64 channels, in the 64-wide form's o
// accumulators and p.v products. The ring's unit is one key tile's 64-channel
// k block with q's block of the CTA's query rows (q is not kept resident),
// and each key tile's v block has a ring of its own: the shared memory is
// the same at every hdp. Each output block recomputes the head's softmax,
// so the score work is hdp / 64 times the head's. What bounds it: as the
// streamed kernels, latency, here also each unit's products, waited before
// its stage is freed, and the recomputed scores; no yolov12 graph builds
// such heads, so it is kept simple. A kernel of its own: a runtime branch
// on the width in the 32- and 64-wide forms would cost them registers and
// time.
constexpr int BLK = 64;            // channels of a block
constexpr int UNITS_MMA = 3;       // bf16: the ring of q and k blocks
constexpr int V_STAGES = 2;        // both types: the ring of v blocks

// bf16: a producer warpgroup whose thread 0 issues every TMA box (a unit's
// q block, 64 rows, and k block, 128 keys, then each key tile's v block;
// 128-byte rows, the 128-byte swizzle) and one consumer warpgroup of 64
// query rows: per unit S += q_j k_j^T (m64n128k16, four k steps), waited
// before the unit's stage is freed (no wgmma group is left open across a
// loop's back edge, which ptxas would serialise), then the online softmax
// and O += P V (m64n64k16) on the tile's v block, waited too.
// PAD: heads of hd channels padded to hdp by the boxes of `head_map`s of q,
// k and v (G, N, C = heads hd), o's stores cut to the head's channels.
template <bool PAD>
__device__ __forceinline__ void blocked_wgmma(
    const CUtensorMap& q_map, const CUtensorMap& k_map,
    const CUtensorMap& v_map, bf16* __restrict__ o, int N, int C, int hdp,
    float sl2, int hd) {
  constexpr int QB = WG_ROWS * BLK;               // elements of q's block
  constexpr int KT = KB_MMA * BLK;                // of k's or v's
  constexpr int UNIT = QB + KT;
  extern __shared__ unsigned char smem_raw[];
  bf16* Us = reinterpret_cast<bf16*>(align1024(smem_raw));  // [3][q | k]
  bf16* Vs = Us + UNITS_MMA * UNIT;                          // [2][128][64]
  uint64_t* u_full = reinterpret_cast<uint64_t*>(Vs + V_STAGES * KT);
  uint64_t* u_empty = u_full + UNITS_MMA;
  uint64_t* v_full = u_empty + UNITS_MMA;
  uint64_t* v_empty = v_full + V_STAGES;
  const int nbk = hdp / BLK;                      // the head's blocks
  const int hh = blockIdx.x / nbk;                // the head
  const int c0 = hh * hdp;                        // its first channel
  const int ob = blockIdx.x % nbk, g = blockIdx.y;
  const int row0 = blockIdx.z * WG_ROWS;
  const int tiles = (N + KB_MMA - 1) / KB_MMA;

  if (threadIdx.x == 0) {
    for (int st = 0; st < UNITS_MMA; ++st) {
      mbar_init(&u_full[st], 1);
      mbar_init(&u_empty[st], 1);
    }
    for (int st = 0; st < V_STAGES; ++st) {
      mbar_init(&v_full[st], 1);
      mbar_init(&v_empty[st], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------ producer warpgroup
    regs_release<REGS_PRODUCER>();
    if (threadIdx.x == 0) {
      for (int i = 0, u = 0; i < tiles; ++i) {
        for (int j = 0; j < nbk; ++j, ++u) {
          const int st = u % UNITS_MMA;
          if (u >= UNITS_MMA)                    // the consumer freed it
            mbar_wait(&u_empty[st], (u / UNITS_MMA - 1) & 1);
          bf16* dst = Us + st * UNIT;
          mbar_expect_tx(&u_full[st], UNIT * sizeof(bf16));
          tma_load_head<PAD>(dst, &q_map, &u_full[st], hh, hdp, BLK * j,
                             row0, g);
          tma_load_head<PAD>(dst + QB, &k_map, &u_full[st], hh, hdp,
                             BLK * j, i * KB_MMA, g);
        }
        const int vs = i % V_STAGES;
        if (i >= V_STAGES) mbar_wait(&v_empty[vs], (i / V_STAGES - 1) & 1);
        mbar_expect_tx(&v_full[vs], KT * sizeof(bf16));
        tma_load_head<PAD>(Vs + vs * KT, &v_map, &v_full[vs], hh, hdp,
                           BLK * ob, i * KB_MMA, g);
      }
    }
    return;
  }

  // --------------------------------------------------- consumer warpgroup
  regs_claim<216>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int r_lo = 16 * warp + (lane >> 2);      // rows r_lo, r_lo + 8
  // s: the 64 x 128 scores (as the streamed kernel's); p: the tile's
  // probabilities as A fragments; oacc: O of the block's 64 channels
  float s[64], oacc[BLK / 2];
  uint32_t p[8][4];
#pragma unroll
  for (int e = 0; e < BLK / 2; ++e) oacc[e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for (int i = 0, u = 0; i < tiles; ++i) {
    for (int j = 0; j < nbk; ++j, ++u) {         // S = sum_j q_j k_j^T
      const int st = u % UNITS_MMA;
      mbar_wait(&u_full[st], (u / UNITS_MMA) & 1);
      wgmma_block_scores(s, smem_desc_sw128(Us + st * UNIT),
                         smem_desc_sw128(Us + st * UNIT + QB), j);
      if (tid == 0) mbar_arrive(&u_empty[st]);
    }
    const int k0 = i * KB_MMA;
    if (k0 + KB_MMA > N) mask_keys_past(s, k0, N, t);
    const float2 c = online_softmax(s, sl2, m_lo, m_hi, l_lo, l_hi);
    rescale_and_pack<BLK>(oacc, p, s, c);
    const int vs = i % V_STAGES;
    mbar_wait(&v_full[vs], (i / V_STAGES) & 1);
    wgmma_block_pv(oacc, p, Vs + vs * KT);       // O += P V of this tile
    if (tid == 0) mbar_arrive(&v_empty[vs]);
  }

  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
  const int n_lo = row0 + r_lo, n_hi = n_lo + 8;
  bf16* og = o + (size_t)g * N * C + (PAD ? hh * hd : c0) + BLK * ob + 2 * t;
#pragma unroll
  for (int j = 0; j < BLK / 8; ++j) {
    if (PAD && BLK * ob + 8 * j >= hd) break;    // past the head (hd % 8 == 0)
    if (n_lo < N)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)n_lo * C + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j] * inv_lo,
                                oacc[4 * j + 1] * inv_lo);
    if (n_hi < N)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)n_hi * C + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2] * inv_hi,
                                oacc[4 * j + 3] * inv_hi);
  }
}

__global__ void __launch_bounds__(256, 2)
band_attention_blocked_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap k_map,
                                    const __grid_constant__ CUtensorMap v_map,
                                    bf16* __restrict__ o, int N, int C,
                                    int hdp, float sl2) {
  blocked_wgmma<false>(q_map, k_map, v_map, o, N, C, hdp, sl2, hdp);
}

// Kernel C at heads of hd channels padded to hdp inside the kernel.
__global__ void __launch_bounds__(256, 2)
band_attention_blocked_padded_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int N,
    int C, int hdp, float sl2, int hd) {
  blocked_wgmma<true>(q_map, k_map, v_map, o, N, C, hdp, sl2, hd);
}

// f32 (`band_attention_cluster_kernel<PAD>`): a thread-block cluster of cs
// CTAs a (head, query tile of R = 32 rows, band), one CTA a 64-channel block
// of the head (`cluster_shape`: cs = hdp / 64 up to 16, the non-portable
// cluster size, checked by cudaOccupancyMaxActiveClusters past the portable
// 8). Each CTA keeps its q block resident (loaded once) and streams its k
// block of each 64-key tile through a ring of K_STAGES; for each key tile
// it scores its block (4 x 4 a thread, f32 FMAs over the block's 64
// channels in order), writes the partial scores to its shared memory, and
// after a cluster barrier sums the cluster's partials over distributed
// shared memory in rank order, so every CTA holds the same scores, bit for
// bit, and runs the same online softmax; then p.v on its own v block (a
// ring of CV_STAGES) into its 64 output channels. The head's scores are
// computed once, split over its blocks. The barrier's wait runs a tile
// behind its arrival (the next tile's scores fill the gap), and the
// partials are double-buffered (below); a last wait keeps each CTA alive
// until the others have read it. Past 16
// blocks (heads wider than 1024 channels) the head's blocks are split into
// `groups` clusters of cs CTAs, each CTA scoring blocks rank, rank + cs,
// ... (its q blocks all resident) and writing output block group cs +
// rank (none past the head): the score work is then `groups` times the
// head's. What bounds it: the FMA rate (4 N^2 hdp flop a (band, head) at
// 67 TFLOP/s), shared memory's reads of the micro-tiles, and the barrier a
// key tile.
constexpr int BLOCKED_F32_ROWS = 32;   // query rows of an f32 CTA
constexpr int CLUSTER_MAX = 16;        // CTAs of a cluster, at most
constexpr int K_STAGES = 2;            // the f32 ring of k blocks
constexpr int CV_STAGES = 2;           // and of v blocks

// (cs, groups) of a head of nbk 64-channel blocks: groups clusters of cs
// CTAs, as few clusters as CLUSTER_MAX allows, as even as can be;
// `kernels/attention.py::cluster_shape` mirrors it.
__host__ __device__ constexpr int cluster_groups(int nbk) {
  return (nbk + CLUSTER_MAX - 1) / CLUSTER_MAX;
}

__host__ __device__ constexpr int cluster_size(int nbk) {
  return (nbk + cluster_groups(nbk) - 1) / cluster_groups(nbk);
}

template <bool PAD>
__global__ void __launch_bounds__(4 * BLOCKED_F32_ROWS)
band_attention_cluster_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              float* __restrict__ o, int N, int C, int hdp,
                              int hd, float sl2) {
  constexpr int R = BLOCKED_F32_ROWS;
  constexpr int KT = KB_F32 * BLK;                // floats of a k or v block
  constexpr int QB = R * BLK;                     // of a q block
  constexpr int PART = R * KB_F32;                // of a tile's partial scores
  constexpr int CB = BLK / 32;                    // 32-channel boxes a block
  extern __shared__ unsigned char smem_raw[];
  const int nbk = hdp / BLK, cs = cluster_size(nbk);
  const int groups = cluster_groups(nbk);
  const int rank = blockIdx.x % cs, cl = blockIdx.x / cs;  // clusters span x
  const int hh = cl / groups;                     // the head
  const int ob = cl % groups * cs + rank;         // the output block
  const bool writes = ob < nbk;                   // none past the head
  const int own = (nbk - rank + cs - 1) / cs;     // blocks rank + cs jj
  float* Qs = reinterpret_cast<float*>(align1024(smem_raw));  // [own][R][64]
  float* Ks = Qs + groups * QB;                   // [K_STAGES][64][64]
  float* Vs = Ks + K_STAGES * KT;                 // [CV_STAGES][64][64]
  float* Part = Vs + CV_STAGES * KT;              // [2][4][R * 4] float4s
  float* Ps = Part + 2 * PART;                    // [R][LDP]
  uint64_t* k_full = reinterpret_cast<uint64_t*>(Ps + R * LDP);
  uint64_t* k_empty = k_full + K_STAGES;
  uint64_t* v_full = k_empty + K_STAGES;
  uint64_t* v_empty = v_full + CV_STAGES;
  uint64_t* q_full = v_empty + CV_STAGES;
  const int g = blockIdx.y, row0 = blockIdx.z * R;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tiles = (N + KB_F32 - 1) / KB_F32, units = tiles * own;

  // unit u: key tile u / own of block rank + cs (u % own) -> stage u % 2
  auto load_k = [&](int u) {
    const int st = u % K_STAGES, ch = BLK * (rank + cs * (u % own));
    mbar_expect_tx(&k_full[st], KT * sizeof(float));
    for (int cb = 0; cb < CB; ++cb)
      tma_load_head<PAD>(Ks + st * KT + cb * KB_F32 * 32, &k_map, &k_full[st],
                         hh, hdp, ch + 32 * cb, u / own * KB_F32, g);
  };
  auto load_v = [&](int i) {                     // key tile i -> stage i % 2
    const int st = i % CV_STAGES;
    mbar_expect_tx(&v_full[st], KT * sizeof(float));
    for (int cb = 0; cb < CB; ++cb)
      tma_load_head<PAD>(Vs + st * KT + cb * KB_F32 * 32, &v_map, &v_full[st],
                         hh, hdp, BLK * ob + 32 * cb, i * KB_F32, g);
  };
  if (tid == 0) {
    for (int st = 0; st < K_STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&k_empty[st], 4 * R / 32);      // a warp each
    }
    for (int st = 0; st < CV_STAGES; ++st) {
      mbar_init(&v_full[st], 1);
      mbar_init(&v_empty[st], 4 * R / 32);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_full, own * QB * sizeof(float));
    for (int jj = 0; jj < own; ++jj)
      for (int cb = 0; cb < CB; ++cb)
        tma_load_head<PAD>(Qs + jj * QB + cb * R * 32, &q_map, q_full, hh, hdp,
                           BLK * (rank + cs * jj) + 32 * cb, row0, g);
    for (int u = 0; u < min(K_STAGES, units); ++u) load_k(u);
    if (writes)
      for (int i = 0; i < min(CV_STAGES, tiles); ++i) load_v(i);
  }

  // a group of 16 threads (half a warp) owns rows 4 rg .. 4 rg + 3: the
  // streamed kernel's micro-tiles at 64 channels
  const int rg = tid >> 4, t = tid & 15, half = t >> 3, cq = t & 7;
  float m[4], l[4], acc[4][4 * CB], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * CB; ++e) acc[i][e] = 0.f;
  }
  float* Pg = Ps + 4 * rg * LDP;
  int u = 0;                                      // the k ring's next unit
  // sc = this CTA's partial scores of the next key tile, over its blocks
  auto score = [&](float (&sc)[4][4]) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      sc[a][0] = sc[a][1] = sc[a][2] = sc[a][3] = 0.f;
    for (int jj = 0; jj < own; ++jj, ++u) {
      const int st = u % K_STAGES;
      // unit u + 1 into the stage unit u - 1 used, once every warp freed it
      if (tid == 0 && u >= 1 && u + 1 < units) {
        mbar_wait(&k_empty[(u + 1) % K_STAGES], ((u + 1) / K_STAGES - 1) & 1);
        load_k(u + 1);
      }
      mbar_wait(&k_full[st], (u / K_STAGES) & 1);
      f32_block_scores<R>(sc, Qs + jj * QB, Ks + st * KT, rg, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[st]);  // this warp is done with it
    }
  };
  // key tile i's partial scores into buffer i % 2
  auto publish = [&](int i, const float (&sc)[4][4]) {
    float4* part = reinterpret_cast<float4*>(Part + (i & 1) * PART);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      part[a * 4 * R + tid] =
          make_float4(sc[a][0], sc[a][1], sc[a][2], sc[a][3]);
  };
  // One cluster barrier a key tile, its wait a tile behind its arrival:
  // tile i + 1's partial scores are computed while the others reach tile
  // i's. Arrival i + 1 follows this CTA's reads of tile i's partials, so
  // once wait i is passed every CTA has read tile i - 1's, whose buffer
  // tile i + 1's partials then take.
  float sn[4][4];
  mbar_wait(q_full, 0);
  score(sn);
  publish(0, sn);
  cluster_arrive();
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) score(sn);
    cluster_wait();
    // tile i's scores: the cluster's partials summed in rank order (every
    // CTA the same sum)
    const float4* part =
        reinterpret_cast<const float4*>(Part + (i & 1) * PART) + tid;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float4 sum = ld_cluster_f4(cluster_addr(part + a * 4 * R, 0));
      for (int r = 1; r < cs; ++r) {
        const float4 p = ld_cluster_f4(cluster_addr(part + a * 4 * R, r));
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      s[a][0] = sum.x;
      s[a][1] = sum.y;
      s[a][2] = sum.z;
      s[a][3] = sum.w;
    }
    if (i + 1 < tiles) publish(i + 1, sn);
    cluster_arrive();
    if (writes) {
      // v of tile i + 1 into the stage tile i - 1 used
      if (tid == 0 && i >= 1 && i + 1 < tiles) {
        mbar_wait(&v_empty[(i + 1) % CV_STAGES],
                  ((i + 1) / CV_STAGES - 1) & 1);
        load_v(i + 1);
      }
      const int vs = i % CV_STAGES;
      mbar_wait(&v_full[vs], (i / CV_STAGES) & 1);
      f32_softmax_pv<LDP>(s, m, l, acc, Pg, Vs + vs * KT, i * KB_F32, N, t,
                          sl2);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[vs]);
    }
  }
  if (writes) {
    // the row sums over the group, the two key halves added, rows 2 half
    // and 2 half + 1 of the group stored by this thread
    f32_group_sums(l, acc);
    float* og = o + (size_t)g * N * C + (PAD ? hh * hd : hh * hdp) +
                BLK * ob + 4 * cq;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = row0 + 4 * rg + a;
      if ((a >> 1) == half && n < N) {
        const float inv = 1.f / l[a];
#pragma unroll
        for (int b = 0; b < CB; ++b)
          if (!PAD || BLK * ob + 32 * b + 4 * cq < hd)   // hd % 4 == 0
            *reinterpret_cast<float4*>(og + (size_t)n * C + 32 * b) =
                make_float4(acc[a][4 * b] * inv, acc[a][4 * b + 1] * inv,
                            acc[a][4 * b + 2] * inv, acc[a][4 * b + 3] * inv);
      }
    }
  }
  cluster_wait();       // the others' last reads of this CTA's partials
}

// Shared memory of the streamed kernels at head width hd (bytes, with 1024
// of slack for the tiles' alignment); `kernels/attention.py::
// stream_smem_bytes` mirrors it.
size_t stream_f32_smem(int C, int R, bool project, int hd) {
  return 1024 + sizeof(float) * (2 * (size_t)STAGES_F32 * KB_F32 * hd +
                                 (size_t)R * (hd + LDP) +
                                 (project ? (size_t)C * hd : 0)) +
         8 * (2 * STAGES_F32 + 1);
}

// The f32 k/v projection's: the GEMM ring and its barriers.
size_t kv_projection_f32_smem() {
  return 1024 + sizeof(float) * (size_t)GemmTile<KV_TM>::GEMM +
         8 * 2 * GEMM_STAGES;
}

size_t stream_wgmma_smem(int C, int NC, bool project, int hd) {
  return 1024 +
         sizeof(bf16) * (2 * (size_t)STAGES_MMA * KB_MMA * hd +
                         (size_t)NC * WG_ROWS * hd +
                         (project ? (size_t)C * hd + (size_t)NC * WG_ROWS * C
                                  : 0)) +
         8 * (2 * STAGES_MMA + 1);
}

// The blocked form's: bf16 three units of a q and a k block and two v
// blocks, a full and an empty barrier a stage; f32 (the cluster form, at
// head width hdp) the resident q blocks of `cluster_groups`, the rings of k
// and v blocks, two buffers of partial scores and the probabilities, a
// full and an empty barrier a stage and q's.
size_t blocked_smem(int dtype, int hdp) {
  if (dtype == 1)
    return 1024 +
           sizeof(bf16) * ((size_t)UNITS_MMA * (WG_ROWS + KB_MMA) * BLK +
                           (size_t)V_STAGES * KB_MMA * BLK) +
           8 * 2 * (UNITS_MMA + V_STAGES);
  return 1024 +
         sizeof(float) *
             ((size_t)cluster_groups(hdp / BLK) * BLOCKED_F32_ROWS * BLK +
              (size_t)(K_STAGES + CV_STAGES) * KB_F32 * BLK +
              2 * (size_t)BLOCKED_F32_ROWS * KB_F32 +
              (size_t)BLOCKED_F32_ROWS * LDP) +
         8 * (2 * (K_STAGES + CV_STAGES) + 1);
}

// setmaxnreg moves registers between the warpgroups of a CTA: each
// consumer claims `claim` a thread from the count it started with, the
// producer releases down to `release`. A claim that neither the releases
// nor the SM's free registers cover waits forever, so the launch is
// refused unless the kernel's count at entry (ptxas') makes every CTA the
// SM can hold by registers whole.
template <auto kernel>
cudaError_t check_reallocation(int consumers, int claim) {
  static const cudaError_t checked = [=] {
    cudaFuncAttributes a;
    if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess)
      return cudaErrorInvalidDeviceFunction;
    const int threads = 128 * (consumers + 1), regs = a.numRegs;
    if (regs > claim || regs < REGS_PRODUCER)
      return cudaErrorInvalidConfiguration;
    const int ctas = 65536 / (threads * regs);
    const int need = consumers * 128 * (claim - regs) -
                     128 * (regs - REGS_PRODUCER);
    return ctas * need <= 65536 - ctas * threads * regs
               ? cudaSuccess
               : cudaErrorInvalidConfiguration;
  }();
  return checked;
}

template <int R, bool PROJECT, int HD_>
cudaError_t launch_stream_f32(const float* src, const float* w,
                              const float* b, const float* k, const float* v,
                              float* o, int G, int N, int C, int heads,
                              float scale, cudaStream_t s) {
  constexpr auto kernel = band_attention_stream_kernel<R, PROJECT, HD_>;
  const size_t smem = stream_f32_smem(C, R, PROJECT, HD_);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // PROJECT reads x directly and q_map is not read; else w_map is not
  CUtensorMap qm, km, vm, wm;
  cudaError_t e = band_map(&km, k, G, N, C, KB_F32, true);
  if (e == cudaSuccess) e = band_map(&vm, v, G, N, C, KB_F32, true);
  if (e == cudaSuccess) {
    if (PROJECT) {
      qm = km;
      e = weight_map(&wm, w, C, true);
    } else {
      wm = km;
      e = band_map(&qm, src, G, N, C, R, true);
    }
  }
  if (e == cudaSuccess) e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  kernel<<<dim3(heads, G, (N + R - 1) / R), 4 * R, smem, s>>>(
      qm, km, vm, wm, src, b, o, N, C, scale * LOG2E);
  return cudaGetLastError();
}

// Heads 32 wide at 64, 32 or 16 query rows a CTA; 64 wide at 32.
template <bool PROJECT>
cudaError_t stream_f32(int rows, const float* src, const float* w,
                       const float* b, const float* k, const float* v,
                       float* o, int G, int N, int C, int heads, float scale,
                       cudaStream_t s) {
  if (C / heads == 64)
    return rows == 32 ? launch_stream_f32<32, PROJECT, 64>(
                            src, w, b, k, v, o, G, N, C, heads, scale, s)
                      : cudaErrorInvalidValue;
  switch (rows) {
    case 64:
      return launch_stream_f32<64, PROJECT, 32>(src, w, b, k, v, o, G, N, C,
                                                heads, scale, s);
    case 32:
      return launch_stream_f32<32, PROJECT, 32>(src, w, b, k, v, o, G, N, C,
                                                heads, scale, s);
    case 16:
      return launch_stream_f32<16, PROJECT, 32>(src, w, b, k, v, o, G, N, C,
                                                heads, scale, s);
  }
  return cudaErrorInvalidValue;
}

template <int NC, bool PROJECT, int HD_>
cudaError_t launch_stream_wgmma(const bf16* src, const bf16* w,
                                const float* b, const bf16* k, const bf16* v,
                                bf16* o, int G, int N, int C, int heads,
                                float scale, cudaStream_t s) {
  constexpr auto kernel = band_attention_stream_wgmma_kernel<NC, PROJECT, HD_>;
  const size_t smem = stream_wgmma_smem(C, NC, PROJECT, HD_);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  CUtensorMap sm, km, vm, wm;
  cudaError_t e = band_map(&km, k, G, N, C, KB_MMA, false, HD_);
  if (e == cudaSuccess) e = band_map(&vm, v, G, N, C, KB_MMA, false, HD_);
  // x arrives in boxes of 32 channels, q in boxes of the head
  if (e == cudaSuccess)
    e = band_map(&sm, src, G, N, C, WG_ROWS, false, PROJECT ? 32 : HD_);
  if (e == cudaSuccess) {
    if (PROJECT) e = weight_map(&wm, w, C, false, HD_);
    else wm = km;                                // not read
  }
  if (e == cudaSuccess) e = allow_smem<kernel>();
  if (e == cudaSuccess)
    e = check_reallocation<kernel>(NC, NC == 1 ? 216 : 232);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(heads, G, (N + NC * WG_ROWS - 1) / (NC * WG_ROWS)),
           128 * (NC + 1), smem, s>>>(sm, km, vm, wm, b, o, N, C,
                                      scale * LOG2E);
  return cudaGetLastError();
}

// Heads 32 wide at 128 or 64 query rows a CTA; 64 wide at 64.
template <bool PROJECT>
cudaError_t stream_wgmma(int rows, const bf16* src, const bf16* w,
                         const float* b, const bf16* k, const bf16* v,
                         bf16* o, int G, int N, int C, int heads, float scale,
                         cudaStream_t s) {
  if (C / heads == 64)
    return rows == WG_ROWS ? launch_stream_wgmma<1, PROJECT, 64>(
                                 src, w, b, k, v, o, G, N, C, heads, scale, s)
                           : cudaErrorInvalidValue;
  if (rows == 2 * WG_ROWS)
    return launch_stream_wgmma<2, PROJECT, 32>(src, w, b, k, v, o, G, N, C,
                                               heads, scale, s);
  if (rows == WG_ROWS)
    return launch_stream_wgmma<1, PROJECT, 32>(src, w, b, k, v, o, G, N, C,
                                               heads, scale, s);
  return cudaErrorInvalidValue;
}

// Kernel C's streamed path at heads of hd channels, no kernel width below
// 64, padded to HD_ inside the kernel: q, k and v by `head_map`s.
template <int R, int HD_>
cudaError_t launch_stream_padded_f32(const void* q, const void* k,
                                     const void* v, void* o, int G, int N,
                                     int heads, int hd, float scale,
                                     cudaStream_t s) {
  constexpr auto kernel = band_attention_stream_padded_kernel<R, HD_>;
  CUtensorMap qm, km, vm;
  cudaError_t e = head_map(&qm, q, G, N, heads, hd, R, true, 32);
  if (e == cudaSuccess) e = head_map(&km, k, G, N, heads, hd, KB_F32, true, 32);
  if (e == cudaSuccess) e = head_map(&vm, v, G, N, heads, hd, KB_F32, true, 32);
  if (e == cudaSuccess) e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  kernel<<<dim3(heads, G, (N + R - 1) / R), 4 * R,
           stream_f32_smem(heads * hd, R, false, HD_), s>>>(
      qm, km, vm, static_cast<float*>(o), N, heads * hd, scale * LOG2E, hd);
  return cudaGetLastError();
}

template <int NC, int HD_>
cudaError_t launch_stream_padded_wgmma(const void* q, const void* k,
                                       const void* v, void* o, int G, int N,
                                       int heads, int hd, float scale,
                                       cudaStream_t s) {
  constexpr auto kernel = band_attention_stream_padded_wgmma_kernel<NC, HD_>;
  CUtensorMap qm, km, vm;
  cudaError_t e = head_map(&qm, q, G, N, heads, hd, WG_ROWS, false, HD_);
  if (e == cudaSuccess)
    e = head_map(&km, k, G, N, heads, hd, KB_MMA, false, HD_);
  if (e == cudaSuccess)
    e = head_map(&vm, v, G, N, heads, hd, KB_MMA, false, HD_);
  if (e == cudaSuccess) e = allow_smem<kernel>();
  if (e == cudaSuccess)
    e = check_reallocation<kernel>(NC, NC == 1 ? 216 : 232);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(heads, G, (N + NC * WG_ROWS - 1) / (NC * WG_ROWS)),
           128 * (NC + 1), stream_wgmma_smem(heads * hd, NC, false, HD_),
           s>>>(qm, km, vm, static_cast<bf16*>(o), N, heads * hd,
                scale * LOG2E, hd);
  return cudaGetLastError();
}

// Lets `kernel` run in clusters past the portable 8 CTAs (once).
template <auto kernel>
cudaError_t allow_wide_clusters() {
  static const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// The f32 cluster form: clusters of cs CTAs (`cluster_size`) along x, a
// (head, output group) each; one past 8 CTAs only where the card can hold
// such a cluster (cudaOccupancyMaxActiveClusters).
template <bool PAD>
cudaError_t launch_cluster(const CUtensorMap& qm, const CUtensorMap& km,
                           const CUtensorMap& vm, float* o, int G, int N,
                           int heads, int hd, int hdp, float scale,
                           cudaStream_t s) {
  constexpr auto kernel = band_attention_cluster_kernel<PAD>;
  const int nbk = hdp / BLK, cs = cluster_size(nbk);
  const size_t smem = blocked_smem(0, hdp);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<kernel>();
  if (e == cudaSuccess) e = allow_wide_clusters<kernel>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads * cluster_groups(nbk) * cs, G,
                     (N + BLOCKED_F32_ROWS - 1) / BLOCKED_F32_ROWS);
  cfg.blockDim = dim3(4 * BLOCKED_F32_ROWS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cs > 8) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, qm, km, vm, o, N, heads * hd, hdp, hd,
                         scale * LOG2E);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The blocked form at heads of hd channels, held as hdp = `padded_width(hd)`
// (a multiple of 64 past 64): a CTA of `rows` query rows, bf16 64, f32 32,
// for each (head, 64-channel block). The maps take boxes of 64 channels
// (bf16) or 32 (f32) of q's rows and of k's and v's key tiles: `band_map`s
// of (G, N, C) where hd is hdp, else `head_map`s of (G, N, heads hd), which
// pad each head to hdp inside the kernel.
cudaError_t launch_blocked(const void* q, const void* k, const void* v,
                           void* o, int G, int N, int heads, int hd,
                           int dtype, int rows, float scale, cudaStream_t s) {
  const bool bf = dtype == 1;
  if (rows != (bf ? WG_ROWS : BLOCKED_F32_ROWS)) return cudaErrorInvalidValue;
  const int keys = bf ? KB_MMA : KB_F32, cols = bf ? BLK : 32;
  const int hdp = padded_width(hd), C = heads * hd;
  const bool pad = hd != hdp;
  CUtensorMap qm, km, vm;
  cudaError_t e;
  if (pad) {
    e = head_map(&qm, q, G, N, heads, hd, rows, !bf, cols);
    if (e == cudaSuccess)
      e = head_map(&km, k, G, N, heads, hd, keys, !bf, cols);
    if (e == cudaSuccess)
      e = head_map(&vm, v, G, N, heads, hd, keys, !bf, cols);
  } else {
    e = band_map(&qm, q, G, N, C, rows, !bf, cols);
    if (e == cudaSuccess) e = band_map(&km, k, G, N, C, keys, !bf, cols);
    if (e == cudaSuccess) e = band_map(&vm, v, G, N, C, keys, !bf, cols);
  }
  if (e != cudaSuccess) return e;
  if (!bf) {
    float* out = static_cast<float*>(o);
    return pad ? launch_cluster<true>(qm, km, vm, out, G, N, heads, hd, hdp,
                                      scale, s)
               : launch_cluster<false>(qm, km, vm, out, G, N, heads, hd, hdp,
                                       scale, s);
  }
  const dim3 grid(heads * (hdp / BLK), G, (N + rows - 1) / rows);
  const size_t smem = blocked_smem(dtype, hdp);
  bf16* out = static_cast<bf16*>(o);
  if (pad) {
    constexpr auto kernel = band_attention_blocked_padded_wgmma_kernel;
    e = allow_smem<kernel>();
    if (e == cudaSuccess) e = check_reallocation<kernel>(1, 216);
    if (e != cudaSuccess) return e;
    kernel<<<grid, 256, smem, s>>>(qm, km, vm, out, N, C, hdp, scale * LOG2E,
                                   hd);
  } else {
    constexpr auto kernel = band_attention_blocked_wgmma_kernel;
    e = allow_smem<kernel>();
    if (e == cudaSuccess) e = check_reallocation<kernel>(1, 216);
    if (e != cudaSuccess) return e;
    kernel<<<grid, 256, smem, s>>>(qm, km, vm, out, N, C, hdp, scale * LOG2E);
  }
  return cudaGetLastError();
}

// The query rows a streamed CTA may take: f32 64, 32 or 16; bf16 64 or 128
// (one or two consumer warpgroups).
bool stream_rows_valid(int dtype, int rows) {
  return dtype == 1 ? rows == WG_ROWS || rows == 2 * WG_ROWS
                    : rows == 64 || rows == 32 || rows == 16;
}

// The bf16 projection's shared memory: the ring, the staged tile and the
// ring's barriers (bytes, with 1024 of slack for the alignment).
size_t kv_projection_bf16_smem(int stages, int nb) {
  return 1024 +
         sizeof(bf16) * ((size_t)stages * KVB_KS * (KVB_TM + 64 * nb) +
                         (size_t)KVB_TM * (64 * nb + 8)) +
         8 * (size_t)stages;
}

template <bool Q>
cudaError_t launch_kv_projection_bf16(const void* x, const void* w,
                                      const void* b, void* q, void* k,
                                      void* v, int tokens, int C,
                                      cudaStream_t s) {
  constexpr auto proj = kv_projection_wgmma_kernel<Q>;
  constexpr int NB = KVB_NB;
  const int stages = min((C + KVB_KS - 1) / KVB_KS, KVB_STAGES);
  const int cols = Q ? 3 * C : 2 * C;           // q | k | v, or k | v
  CUtensorMap xm, wm;
  cudaError_t e = matrix_map(&xm, x, tokens, C, C, KVB_TM, KVB_KS, true);
  if (e == cudaSuccess) e = matrix_map(&wm, w, C, 3 * C, 3 * C, KVB_KS, 64,
                                       true);
  if (e == cudaSuccess) e = allow_smem<proj>();
  if (e != cudaSuccess) return e;
  proj<<<dim3((tokens + KVB_TM - 1) / KVB_TM,
              (cols + 64 * NB - 1) / (64 * NB)),
         128, kv_projection_bf16_smem(stages, NB), s>>>(
      xm, wm, static_cast<const float*>(b), static_cast<bf16*>(k),
      static_cast<bf16*>(v), tokens, C, stages, static_cast<bf16*>(q));
  return cudaGetLastError();
}

template <bool Q>
cudaError_t launch_kv_projection_f32(const void* x, const void* w,
                                     const void* b, void* q, void* k,
                                     void* v, int tokens, int C,
                                     cudaStream_t s) {
  using L = GemmTile<KV_TM>;
  constexpr auto proj = kv_projection_f32_kernel<Q>;
  const int cols = Q ? 3 * C : 2 * C;           // q | k | v, or k | v
  CUtensorMap xm, wm;
  cudaError_t e = matrix_map(&xm, x, tokens, C, C, KV_TM);
  if (e == cudaSuccess) e = matrix_map(&wm, w, C, 3 * C, 3 * C, KS_F32,
                                       L::NP);
  if (e == cudaSuccess) e = allow_smem<proj>();
  if (e != cudaSuccess) return e;
  proj<<<dim3((tokens + KV_TM - 1) / KV_TM, (cols + L::NP - 1) / L::NP),
         GEMM_THREADS, kv_projection_f32_smem(), s>>>(
      xm, wm, static_cast<const float*>(b), static_cast<float*>(k),
      static_cast<float*>(v), tokens, C, static_cast<float*>(q));
  return cudaGetLastError();
}

// Kernel A's first launch on the streamed path: k and v of every head, and
// q too where q is given (the wide form: each kernel's `Q` form, so the
// k / v form carries no code of q's).
cudaError_t project(const void* x, const void* w, const void* b, void* q,
                    void* k, void* v, int G, int N, int C, int dtype,
                    cudaStream_t s) {
  const int tokens = G * N;
  if (dtype == 1)
    return q == nullptr
               ? launch_kv_projection_bf16<false>(x, w, b, q, k, v, tokens,
                                                  C, s)
               : launch_kv_projection_bf16<true>(x, w, b, q, k, v, tokens,
                                                 C, s);
  return q == nullptr
             ? launch_kv_projection_f32<false>(x, w, b, q, k, v, tokens, C,
                                               s)
             : launch_kv_projection_f32<true>(x, w, b, q, k, v, tokens, C,
                                              s);
}

cudaError_t launch_qkv_stream(const void* x, const void* w, const void* b,
                              void* o, void* v, void* k, int G, int N, int C,
                              int heads, int dtype, int rows, float scale,
                              cudaStream_t s) {
  if (!stream_rows_valid(dtype, rows)) return cudaErrorInvalidValue;
  const int hd = C / heads;
  if (dtype == 1 &&
      stream_wgmma_smem(C, rows / WG_ROWS, true, hd) > 227 * 1024)
    return cudaErrorInvalidValue;
  const cudaError_t e = project(x, w, b, nullptr, k, v, G, N, C, dtype, s);
  if (e != cudaSuccess) return e;
  if (dtype == 1)
    return stream_wgmma<true>(
        rows, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const float*>(b), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), G, N, C, heads,
        scale, s);
  return stream_f32<true>(
      rows, static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), G, N, C, heads,
      scale, s);
}

cudaError_t launch_attn_stream(const void* q, const void* k, const void* v,
                               void* o, int G, int N, int C, int heads,
                               int dtype, int rows, float scale,
                               cudaStream_t s) {
  if (!stream_rows_valid(dtype, rows)) return cudaErrorInvalidValue;
  if (C / heads > 64)
    return launch_blocked(q, k, v, o, G, N, heads, C / heads, dtype, rows,
                          scale, s);
  if (dtype == 1)
    return stream_wgmma<false>(
        rows, static_cast<const bf16*>(q), nullptr, nullptr,
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), G, N, C, heads, scale, s);
  return stream_f32<false>(
      rows, static_cast<const float*>(q), nullptr, nullptr,
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), G, N, C, heads, scale, s);
}

// Kernel C at heads of hd channels padded inside the kernel, at `rows`
// query rows a CTA: those of the kernel width's own forms (padded to 32:
// f32 64, 32 or 16, bf16 128 or 64; to 64: f32 32, bf16 64; past 64 the
// blocked form's, f32 32, bf16 64).
cudaError_t launch_attn_stream_padded(const void* q, const void* k,
                                      const void* v, void* o, int G, int N,
                                      int heads, int hd, int dtype, int rows,
                                      float scale, cudaStream_t s) {
  if (!stream_rows_valid(dtype, rows)) return cudaErrorInvalidValue;
  const int hdp = padded_width(hd);
  if (hdp > 64)
    return launch_blocked(q, k, v, o, G, N, heads, hd, dtype, rows, scale, s);
  if (dtype == 1) {
    if (hdp == 64)
      return rows == WG_ROWS ? launch_stream_padded_wgmma<1, 64>(
                                   q, k, v, o, G, N, heads, hd, scale, s)
                             : cudaErrorInvalidValue;
    return rows == WG_ROWS ? launch_stream_padded_wgmma<1, 32>(
                                 q, k, v, o, G, N, heads, hd, scale, s)
                           : launch_stream_padded_wgmma<2, 32>(
                                 q, k, v, o, G, N, heads, hd, scale, s);
  }
  if (hdp == 64)
    return rows == 32 ? launch_stream_padded_f32<32, 64>(
                            q, k, v, o, G, N, heads, hd, scale, s)
                      : cudaErrorInvalidValue;
  switch (rows) {
    case 64:
      return launch_stream_padded_f32<64, 32>(q, k, v, o, G, N, heads, hd,
                                              scale, s);
    case 32:
      return launch_stream_padded_f32<32, 32>(q, k, v, o, G, N, heads, hd,
                                              scale, s);
  }
  return launch_stream_padded_f32<16, 32>(q, k, v, o, G, N, heads, hd, scale,
                                          s);
}

// Kernel A's wide form: q, k and v of every head by the projection launch
// (q and k into the scratches), then kernel C's streamed attention over
// them at its `rows` (the blocked form for heads past 64). The rows are
// checked before the first launch.
cudaError_t launch_qkv_wide(const void* x, const void* w, const void* b,
                            void* o, void* v, void* k, void* q, int G, int N,
                            int C, int heads, int dtype, int rows,
                            float scale, cudaStream_t s) {
  const bool one_form = C / heads >= 64;         // one row count each
  if (!stream_rows_valid(dtype, rows) ||
      (one_form && rows != (dtype == 1 ? WG_ROWS : BLOCKED_F32_ROWS)))
    return cudaErrorInvalidValue;
  const cudaError_t e = project(x, w, b, q, k, v, G, N, C, dtype, s);
  if (e != cudaSuccess) return e;
  return launch_attn_stream(q, k, v, o, G, N, C, heads, dtype, rows, scale,
                            s);
}

// Heads 32 or 64 wide (the q-projecting kernels); with `blocked` also
// any multiple of 64 (kernel C and kernel A's wide form).
bool head_ok(int C, int heads, bool blocked = false) {
  return heads > 0 && C % heads == 0 &&
         (C / heads == 32 || C / heads == 64 ||
          (blocked && C / heads % 64 == 0));
}

}  // namespace

// The streamed path of kernel A (two launches), dtype 0 = float32 (FMA
// micro-tiles) or 1 = bfloat16 (wgmma): x, o, v (G, N, C), heads 32 or 64
// wide; w (C, 3C); b (3C,) f32; scale the softmax's; k a (G, N, C) scratch
// of the I/O type for the projected keys; rows the query rows of a CTA
// (heads of 32: f32 64, 32 or 16, bf16 128 or 64; heads of 64: f32 32,
// bf16 64). Every tensor 16-byte aligned (TMA). A tensor map that cannot be
// encoded fails the call before any launch. Returns the launch status.
extern "C" int yolou_band_attention_qkv_stream(const void* x, const void* w,
                                               const void* b, void* o,
                                               void* v, void* k, int G, int N,
                                               int C, int heads, int dtype,
                                               int rows, float scale,
                                               void* stream) {
  if (G <= 0 || N <= 0 || !head_ok(C, heads) || G > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_qkv_stream(x, w, b, o, v, k, G, N, C, heads, dtype,
                                rows, scale,
                                static_cast<cudaStream_t>(stream));
}

// Kernel A's wide form (two launches: q, k and v projected, then kernel C's
// streamed attention, or its blocked form at heads past 64), any C: the
// arguments of the streamed path's entry and q, a (G, N, C) scratch of the
// I/O type for the projected queries; heads 32 wide or a multiple of 64;
// rows as kernel C's (heads of 32: f32 64, 32 or 16, bf16 128 or 64; heads
// of 64 and wider: f32 32, bf16 64).
extern "C" int yolou_band_attention_qkv_wide(const void* x, const void* w,
                                             const void* b, void* o, void* v,
                                             void* k, void* q, int G, int N,
                                             int C, int heads, int dtype,
                                             int rows, float scale,
                                             void* stream) {
  if (G <= 0 || N <= 0 || !head_ok(C, heads, true) || G > 65535 ||
      (dtype != 0 && dtype != 1) || q == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_qkv_wide(x, w, b, o, v, k, q, G, N, C, heads, dtype,
                              rows, scale,
                              static_cast<cudaStream_t>(stream));
}

// The streamed path of kernel C, dtype 0 = float32 (FMA micro-tiles) or
// 1 = bfloat16 (wgmma): q, k, v, o (G, N, C), head-major channels, heads
// 32 or 64 wide or a multiple of 64 (the blocked form), and rows (as the
// wide form's).
extern "C" int yolou_band_attention_stream(const void* q, const void* k,
                                           const void* v, void* o, int G,
                                           int N, int C, int heads, int dtype,
                                           int rows, float scale,
                                           void* stream) {
  if (G <= 0 || N <= 0 || !head_ok(C, heads, true) || G > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_attn_stream(q, k, v, o, G, N, C, heads, dtype, rows,
                                 scale, static_cast<cudaStream_t>(stream));
}

// Kernel C's streamed path (the blocked form past 64 channels) at heads of
// hd channels that no kernel is built for, padded inside the kernel (TMA
// fills the channels past hd with zeros; no copy of q, k or v): q, k, v, o
// (G, N, heads hd), hd neither 32, 64 nor a multiple of 64, rows of a
// multiple of 16 bytes (bf16 hd % 8 == 0, f32 hd % 4 == 0); dtype as the
// streamed entry's, rows as `launch_attn_stream_padded`'s. Every tensor
// 16-byte aligned (TMA). Returns the launch status.
extern "C" int yolou_band_attention_stream_padded(const void* q,
                                                  const void* k,
                                                  const void* v, void* o,
                                                  int G, int N, int heads,
                                                  int hd, int dtype, int rows,
                                                  float scale, void* stream) {
  if (G <= 0 || N <= 0 || heads <= 0 || G > 65535 ||
      (dtype != 0 && dtype != 1) || !pads_in_kernel(hd, dtype == 0))
    return (int)cudaErrorInvalidValue;
  return (int)launch_attn_stream_padded(q, k, v, o, G, N, heads, hd, dtype,
                                        rows, scale,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* yolou_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

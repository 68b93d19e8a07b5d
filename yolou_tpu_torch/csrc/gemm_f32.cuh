// The f32 GEMM stream on register micro-tiles, full f32 on the FMA units (no
// TF32): the whole-A2C2f f32 kernel's GEMMs (a2c2f_f32.cu) and kernel A's
// f32 k/v projection (band_attention.cu, `kv_projection_f32_kernel`).
//
// A CTA of 256 threads computes a tile of TM rows (64 or 32) of A . W: thread
// (ty, tx) of a TM/4 x 1024/TM grid owns 4 rows x 4 columns of a panel of NP
// = 4096 / TM columns (64 or 128), so two 16-byte shared loads feed 16 FMAs
// and a warp's loads of A are broadcasts. Both operands stream through a
// ring of 4 stages of 32 K rows that one thread fills three stages ahead:
// the A slab [TM][32] as one 2-D TMA box (`matrix_map`), the W slab [32][NP]
// as the caller's copy (a bulk copy of a weight packed panel-major, or one
// TMA box of NP columns). Each stage's bytes complete its `full` mbarrier,
// and its 8 warps free it through its `empty` one. Each output is one chain
// of FMAs over the K rows in order.
#pragma once

#include "hopper.cuh"

namespace yolou {

constexpr int GEMM_THREADS = 256;
constexpr int KS_F32 = 32;         // K rows of a GEMM stage
constexpr int GEMM_STAGES = 4;     // the ring

// The tile of TM rows (floats): the thread grid, the panel's columns, the
// two slabs of a stage, the ring.
template <int TM>
struct GemmTile {
  static constexpr int TY = TM / 4, TX = GEMM_THREADS / TY, NP = 4 * TX;
  static constexpr int A_SLAB = TM * KS_F32, W_SLAB = KS_F32 * NP;
  static constexpr int STAGE = A_SLAB + W_SLAB;
  static constexpr int GEMM = GEMM_STAGES * STAGE;
};

// The ring's state: stages issued so far over all GEMMs (stage s uses slot
// s % GEMM_STAGES; its barriers complete for the (s / GEMM_STAGES)-th time).
struct Ring {
  float* smem;
  uint64_t* full;      // [GEMM_STAGES]: the stage's bytes landed
  uint64_t* empty;     // [GEMM_STAGES]: its 8 warps are done with it
  int used;
};

// acc = A . W for the TM rows of a tile and the N columns of W, panel by
// panel, both operands through the ring: A a TMA box of the map `amap` at
// column a_col + k, row a_row (rows past the tile's `rows` are never
// stored; columns past K never read); load_w(dst, bar, panel, k0), called by
// thread 0, copies the W slab of K rows k0 .. k0 + 31 of that panel (W_SLAB
// floats, zero past K and N) to dst and reports its bytes to bar. At each
// panel's end epi(row, col, float4 of columns col .. col + 3) for the
// thread's rows < rows and columns < N (N a multiple of 4).
template <int TM, typename LoadW, typename Epi>
__device__ __forceinline__ void gemm_f32_stream(Ring& ring,
                                                const CUtensorMap* amap,
                                                int a_col, int a_row,
                                                int rows, LoadW load_w,
                                                int K, int N, Epi epi) {
  using L = GemmTile<TM>;
  const int tid = threadIdx.x;
  const int ty = tid / L::TX, tx = tid % L::TX;
  const int nk = (K + KS_F32 - 1) / KS_F32;
  const int total = nk * ((N + L::NP - 1) / L::NP);
  const int base = ring.used;
  // the threads' global writes that A reads (the last epilogue's) and
  // their shared-memory writes to the region ordered before TMA
  fence_proxy_async_global();
  fence_proxy_async();
  __syncthreads();

  auto issue = [&](int j) {          // thread 0: stage j into its slot
    const int s = base + j, slot = s % GEMM_STAGES;
    if (s >= GEMM_STAGES)
      mbar_wait(&ring.empty[slot], ((s / GEMM_STAGES) - 1) & 1);
    float* As = ring.smem + slot * L::STAGE;
    const int p = j / nk, k0 = (j - p * nk) * KS_F32;
    mbar_expect_tx(&ring.full[slot], L::STAGE * sizeof(float));
    tma_load_2d(As, amap, &ring.full[slot], a_col + k0, a_row);
    load_w(As + L::A_SLAB, &ring.full[slot], p, k0);
  };
  if (tid == 0)
    for (int j = 0; j < min(GEMM_STAGES - 1, total); ++j) issue(j);
  float acc[4][4];
  for (int j = 0; j < total; ++j) {
    const int p = j / nk, kb = j - p * nk;
    if (kb == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    if (tid == 0 && j + GEMM_STAGES - 1 < total) issue(j + GEMM_STAGES - 1);
    const int s = base + j, slot = s % GEMM_STAGES;
    mbar_wait(&ring.full[slot], (s / GEMM_STAGES) & 1);
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

// The ring's barriers at `bars` (2 * GEMM_STAGES of them), initialised by
// thread 0 (an mbar_init_fence and a __syncthreads follow).
__device__ __forceinline__ Ring gemm_ring(float* smem, uint64_t* bars) {
  if (threadIdx.x == 0)
    for (int i = 0; i < GEMM_STAGES; ++i) {
      mbar_init(&bars[i], 1);
      mbar_init(&bars[GEMM_STAGES + i], GEMM_THREADS / 32);
    }
  return Ring{smem, bars, bars + GEMM_STAGES, 0};
}

}  // namespace yolou

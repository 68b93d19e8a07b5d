// Tensor-core building blocks of the resident bf16 band attention kernels
// (band_attention.cu): warp-level mma.sync m16n8k16 (bf16 in, f32
// accumulate), ldmatrix loads of its operands from shared memory, cp.async
// copies, the attention of one 16-row query tile against a band's keys and
// values (with a store policy for the normalised f32 result), and the
// exchange of key/value rows between the CTAs of a cluster; also the
// helpers the wgmma kernels share (`kv_at`, `pack_bf16`, the quad
// reductions, LOG2E).
//
// Shared-memory layout of one head's key or value rows: [rows][32] bf16, 64
// bytes a row, whose four 16-byte chunks are stored XOR-swizzled (`kv_at`):
// chunk c of row r sits at position c ^ ((r / 2) % 4), so the 8 rows that
// one ldmatrix phase reads at one logical chunk fall in 8 distinct 16-byte
// bank groups (unswizzled, the 64-byte stride gives 4-way conflicts) and no
// padding is spent.
//
// The m16n8k16 fragment maps (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..],
//                         a[2] = A[g][2t+8..],     a[3] = A[g+8][2t+8..];
//   B (16x8, k x n):      b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..][g];
//   C (16x8, f32):        c[0..1] = C[g][2t..],    c[2..3] = C[g+8][2t..].
// ldmatrix.x4 gives lane l element pair [l/4][2(l%4)..] of the four 8x8
// matrices whose rows lanes 0-7, 8-15, 16-23 and 24-31 address (.trans:
// pair [2(l%4)..][l/4]).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_attention.cuh"

namespace yolou {

// Element offset of channel 8 * chunk (+ 0..7) of key/value row `row` of a
// head W channels wide: at 32 (64-byte rows) chunk c at c ^ ((row / 2) %
// 4), at 64 (128-byte rows, TMA's 128-byte swizzle) at c ^ (row % 8); the
// 8 rows one ldmatrix phase reads fall in 8 distinct bank groups either way.
template <int W = HD>
__device__ __forceinline__ int kv_at(int row, int chunk) {
  if constexpr (W == 64) return row * 64 + ((chunk ^ (row & 7)) << 3);
  else return row * HD + ((chunk ^ ((row >> 1) & 3)) << 3);
}

constexpr int MMA_WARPS = 8;     // warps per CTA of the tensor-core kernels
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without a trip through registers; with
// `valid` false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c += a . b for one 16x8 tile, k = 16.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed, the first in the low half (the
// lower column index of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// cp.async groups: close the copies issued so far into one group; wait
// until at most `PENDING` of the most recent groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Store policy of kernels A and C: row r < rows of the normalised output as
// bf16 to o + r * ldo.
struct StoreRowsBF16 {
  __nv_bfloat16* o;
  int ldo, rows;
  __device__ __forceinline__ void operator()(int r, int ch, float v0,
                                             float v1) const {
    if (r < rows)
      *reinterpret_cast<__nv_bfloat162*>(o + r * ldo + ch) =
          __floats2bfloat162_rn(v0, v1);
  }
};

// One warp: softmax(q k^T * scale) v for 16 query rows, given as the A
// fragments qa of their channels 0-15 and 16-31, against keys Ks and values
// Vs ([Np][32] swizzled, Np = N rounded up to 16, rows [N, Np) zero); row
// r, channels ch and ch + 1 of the f32 result go to store(r, ch, v0, v1)
// (kernels A and C: `StoreRowsBF16`). Online softmax over steps of KT
// keys (32 or 64), all in f32 except the probabilities: the unnormalised
// exp against the running row maximum is rounded to bf16 for the
// tensor-core P.V product (the row sum keeps it unrounded) and the product
// is divided by the row sum at the end, as the TPU kernel `_fused_kernel`
// does against its full-row maximum. The score fragments of two adjacent
// 8-key tiles are the A fragment of one 16-key step of P.V, so the
// probabilities never leave registers.
template <int KT, typename Store>
__device__ __forceinline__ void attend_tile_mma(
    const uint32_t (&qa)[2][4], const __nv_bfloat16* Ks,
    const __nv_bfloat16* Vs, int N, int Np, float scale, Store store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * LOG2E;          // exp(x * scale) = exp2(x * sl2)
  float acc[4][4];                          // O: 4 tiles of 8 channels
#pragma unroll
  for (int u = 0; u < 4; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY; // running max of rows g, g + 8
  float l_lo = 0.f, l_hi = 0.f;             // this thread's part of the sums
  // this lane's ldmatrix row addresses relative to the step's first key:
  // the swizzle depends on bits 1-2 of the row only, which steps of 8 keys
  // keep
  const int k_off = kv_at(lane & 7, lane >> 3);
  const int v_off[2] = {kv_at(lane & 15, lane >> 4),
                        kv_at(lane & 15, 2 + (lane >> 4))};

  for (int k0 = 0; k0 < Np; k0 += KT) {
    float s[KT / 8][4];                     // S = Q K^T: tiles of 8 keys
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if (k0 + 8 * j < Np) {                // warp-uniform
        uint32_t b[4];
        ldsm_x4(b, Ks + (k0 + 8 * j) * HD + k_off);
        mma_bf16(s[j], qa[0], b[0], b[1]);
        mma_bf16(s[j], qa[1], b[2], b[3]);
      }
    }
    // scale (in log2 units), mask keys >= N, running max: k0 < N, so every
    // row has a finite maximum from the first step on
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + 8 * j + 2 * t + e < N;
        s[j][e] = valid ? s[j][e] * sl2 : -INFINITY;
        s[j][2 + e] = valid ? s[j][2 + e] * sl2 : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float c_lo = exp2f(m_lo - mx_lo), c_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mx_lo);
        s[j][2 + e] = exp2f(s[j][2 + e] - mx_hi);
        sum_lo += s[j][e];
        sum_hi += s[j][2 + e];
      }
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[u][0] *= c_lo;
      acc[u][1] *= c_lo;
      acc[u][2] *= c_hi;
      acc[u][3] *= c_hi;
    }
    // O += P V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if (k0 + 16 * kk < Np) {              // warp-uniform
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int h = 0; h < 2; ++h) {       // channels 16h .. 16h + 15
          uint32_t b[4];
          ldsm_x4_trans(b, Vs + (k0 + 16 * kk) * HD + v_off[h]);
          mma_bf16(acc[2 * h], pa, b[0], b[1]);
          mma_bf16(acc[2 * h + 1], pa, b[2], b[3]);
        }
      }
    }
  }
  const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ch = 8 * u + 2 * t;
    store(g, ch, acc[u][0] * inv_lo, acc[u][1] * inv_lo);
    store(g + 8, ch, acc[u][2] * inv_hi, acc[u][3] * inv_hi);
  }
}

// Copy rows [r * R, min(Np, (r + 1) * R)) of Ks and Vs from every other CTA
// r of the cluster through distributed shared memory, 16 bytes at a time
// (the layout is the same in every CTA), GATHER loads in flight a thread.
// Every CTA calls it after its own rows are in place.
constexpr int GATHER = 8;

__device__ __forceinline__ void gather_rows(
    cooperative_groups::cluster_group& cluster, __nv_bfloat16* Ks,
    __nv_bfloat16* Vs, int Np, int R, int rank) {
  cluster.sync();                           // every slice is in place
  const int total = Np * 8;                 // (row, K or V, 16-byte chunk)
  for (int i0 = threadIdx.x; i0 < total; i0 += GATHER * blockDim.x) {
    uint4 val[GATHER];
    __nv_bfloat16* dst[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = i0 + u * blockDim.x, row = i >> 3, peer = row / R;
      dst[u] = nullptr;
      if (i < total && peer != rank) {
        __nv_bfloat16* local = ((i >> 2) & 1 ? Vs : Ks) + kv_at(row, i & 3);
        val[u] = *reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(local, peer));
        dst[u] = local;
      }
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u)
      if (dst[u]) *reinterpret_cast<uint4*>(dst[u]) = val[u];
  }
  cluster.sync();                           // no CTA reads a peer after this
}

}  // namespace yolou

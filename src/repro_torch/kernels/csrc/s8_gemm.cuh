// Tiled int8 x int8 -> int32 GEMM on Hopper tensor cores (mma.sync
// m16n8k32 s8), shared by quant_matmul.cu (int8 weights) and
// packed_w4_matmul.cu (two int4 weights per int8 word).
//
// Design: one 64x64 output tile per block, the whole K loop inside the
// block (the TPU kernel's sequential K grid axis does not carry over to
// blocks that run in no order), 4 warps in a 2x2 grid each owning a
// 32x32 sub-tile = 2 (m16) x 4 (n8) mma accumulators.  Per 256-deep K
// step the block stages x[64, 256] row-major and w transposed to [n][k]
// in shared memory, so both mma fragments are single 32-bit loads of four
// consecutive k; rows are padded to 272 bytes, which makes those fragment
// loads bank-conflict free (row stride 68 words = 4 mod 32: 8 groups x 4
// threads hit 32 distinct banks).  The K step is deep because at decode
// (M = batch) a launch has few blocks and each waits out one round of
// global-load latency per step: fewer, larger steps keep more bytes in
// flight per round trip.
//
// Ragged M, N and K are masked in the kernel.  The K tail of x is staged
// as zeros, so whatever the weight tile holds there contributes exactly
// 0 -- the weight side is never relied on for masking (a zero packed
// int4 word would decode to -8; see packed_w4_matmul.cu).
//
// Epilogue: acc (int32) and/or f = ((float)acc * x_scale[m]) * w_scale[n]
// in that order, each product rounded to nearest (no add, so nothing can
// contract into an FMA): bit-identical to the plain PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace s8gemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 256;
constexpr int LDS = BK + 16;     // padded shared-memory row, bytes
constexpr int THREADS = 128;
static_assert(BM * BK / 16 % THREADS == 0 && BK * BN / 16 % THREADS == 0,
              "tiles must split evenly into 16-byte chunks per thread");
static_assert(BK % 32 == 0 && (LDS / 4) % 32 == 4,
              "mma k-steps of 32; padded rows keep fragment loads "
              "conflict free");

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage x[m0:m0+BM, k0:k0+BK] into As[m][k]; zeros outside [M, K).
// vec: K % 16 == 0 and x 16-byte aligned, so whole 16-byte chunks load
// as one vector.
__device__ __forceinline__ void load_x_tile(int8_t* As, const int8_t* x,
                                            int M, int K, int m0, int k0,
                                            bool vec) {
  constexpr int CHUNKS = BM * BK / 16;             // 16-byte chunks
#pragma unroll
  for (int it = 0; it < CHUNKS / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
    const int gr = m0 + r, gk = k0 + kc;
    alignas(16) int8_t v[16] = {};
    if (gr < M) {
      if (vec && gk + 16 <= K) {
        *reinterpret_cast<int4*>(v) =
            *reinterpret_cast<const int4*>(x + (size_t)gr * K + gk);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gk + j < K) v[j] = x[(size_t)gr * K + gk + j];
      }
    }
    *reinterpret_cast<int4*>(As + r * LDS + kc) =
        *reinterpret_cast<const int4*>(v);
  }
}

// The block's 64x64 tile: C[m0:, n0:] = x[m0:, :] @ W[:, n0:], with the
// weight tile staged by LoadW::load(Bs, w, K, N, n0, k0, vec_w) into
// Bs[n][k] (int8 values).
template <class LoadW>
__device__ __forceinline__ void gemm_tile(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ xs, const float* __restrict__ ws,
    int32_t* __restrict__ acc_out, float* __restrict__ f_out, int M, int K,
    int N, bool vec_x, bool vec_w) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;           // mma group / thread
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_x_tile(As, x, M, K, m0, k0, vec_x);
    LoadW::load(Bs, w, K, N, n0, k0, vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A fragment (row-major 16x32): rows g / g+8, k = t*4.. and +16
        const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B fragment (column-major 32x8): column g, k = t*4.. and +16
        const int8_t* q = Bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(q);
        b[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // C fragment: c0,c1 at row g, c2,c3 at row g+8; columns t*2, t*2+1
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (row < M && col < N) {
          const size_t o = (size_t)row * N + col;
          if (acc_out) acc_out[o] = acc[i][j][r];
          if (f_out)
            f_out[o] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][r]),
                                           xs[row]),
                                 ws[col]);
        }
      }
}

inline dim3 grid_for(int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
}

}  // namespace s8gemm

// Tiled int8 x int8 -> int32 GEMM on Hopper tensor cores (mma.sync
// m16n8k32 s8) for the prefill rows of a quantized matmul, M > 16.
// quant_matmul.cu instantiates it with int8 weights (the loader
// s8small::LoadW8Word, entry repro_quant_matmul); the 64x64 tile of
// s8_gemm.cuh stays behind packed_w4_matmul.cu and behind the second
// entry repro_quant_matmul_tile64, which only chip_smoke.py's timing and
// the card-only tests call.
//
// Replaces, for M > 16, the TPU kernel
// repro/kernels/quant_matmul.py::quant_matmul_acc (body _qmm_kernel,
// pallas_call at :52).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1,979 TOP/s dense int8): bytes.
// At prefill (M = B*S = 1024) a launch reads x (M*K), the weights (K*N)
// and the scales, and writes the f32 output (4*M*N): 0.98 / 0.44 / 2.32
// / 1.44 us for (K, N) = 576x576 / 576x192 / 576x1536 / 1536x576, where
// the 2*M*K*N operations take 0.34 / 0.11 / 0.92 / 0.92 us.  The f32
// output is most of the bytes (6.29 of the 7.77 MB at 576x1536).
//
// What held the 64x64 tile of s8_gemm.cuh back, and what this one does:
// 1. Its transposing weight store wrote each staged byte alone, with a
//    4-way bank conflict on every store.  Here nothing is transposed in
//    shared memory: the weights are staged raw, [k][n] as they lie in
//    device memory, and transposed in registers as the mma fragments are
//    read.  The mma's column order within a warp's 32 columns is free, so
//    fragment column g of n8 tile c is the real column 4g + c: thread
//    (g, t) reads one 32-bit word (columns 4g..4g+3) of each of 4
//    consecutive k rows and one 4x4 __byte_perm transpose (the small-M
//    kernel's, LoadW::columns) yields its B fragments for all 4 n8 tiles.
//    The C fragments then hold 8 consecutive real columns per thread.
// 2. Nothing was in flight while the tensor cores worked (load, barrier,
//    mma, barrier per step, one buffer).  Here x and the weights both go
//    through cp.async.cg 16-byte copies into a ring of STAGES shared
//    buffers: STAGES - 1 steps are in flight while one is multiplied,
//    with one __syncthreads per step.  A block has 8 warps in two K
//    groups: group kg runs the k32 substep kk = 32 kg of every step on
//    the 2x2 grid of 32x32 warp tiles, so two warps share each scheduler
//    and each runs half a step's chain (with one warp per scheduler a
//    step cost ~0.32 us, whatever the ring depth; two brought ~0.26).  Each
//    thread issues one 16-byte copy of x and one of w per step from a
//    running pointer; the vector and byte paths are template parameters,
//    and the step loop is unrolled by STAGES so every shared-memory
//    address is a register plus an immediate.  At the end each group
//    hands the other the sums of one m16 row block through shared memory
//    (int32, exact) and writes the other half of the tile.
// 3. BK = 256 did not divide K = 576 (the last step 75% zeros).  BK = 64
//    divides 576 and 1536.  The K tail is staged as zeros on both sides.
// 4. The grid did not fill the 132 SMs.  The block tile stays 64x64
//    (warp tiles of 32x32, two K groups); the grid is linear over the
//    tiles, cdiv(M, 64) * cdiv(N, 64) blocks -- 144 / 48 / 384 / 144 at
//    the four prefill shapes -- and a block holds 32 KB of shared
//    memory, so several share an SM.  Measured (scripts/tile_sweep.py):
//    an SM copies one block-step (8 KB) per ~0.26 us whether it runs one
//    block or three, so a launch takes ~3.6 us plus the most block-steps
//    any SM runs; spreading the steps of 48 or 144 tiles over more SMs
//    by split-K across a cluster cost more than it balanced.
// 5. The epilogue stored single floats.  Each thread's 8 consecutive
//    columns leave as two 16-byte stores per row (int4 / float4) when
//    N % 4 == 0.
//
// Shared memory: each stage holds the x tile [BM][BK] and the weight tile
// [BK][BN], 64-byte rows, two rows per 128-byte line of the 32 banks.
// The 16-byte chunk c (0..3) of row r sits at line r >> 1, chunk
// ((r & 1) << 2 | c) ^ ((r >> 1) & 3) ^ (((r >> 3) & 1) << 2) of the line
// (swz below): a bijection per line, so 8 lanes that stage one line's 8
// chunks hit 32 distinct banks, and so do the fragment reads -- the A
// words of 8 consecutive rows, one chunk, and the B words of rows 4t + j
// (t = 0..3) at columns 4g (two chunks).
//
// Ragged M, N and K are masked in the kernel: bytes of rows >= M (x),
// >= K (w) or columns past K (x) / N (w) are staged as zeros (cp.async's
// source size 0, or the byte path), and only m < M, n < N are written.
// The vector path of x needs K % 16 == 0 and a 16-byte aligned x, that of
// w N % 16 == 0 and a 16-byte aligned w (the wrapper chooses them; else
// each chunk is gathered byte by byte).  The outputs are the wrapper's
// fresh allocations, 16-byte aligned; with N % 4 == 0 they are written
// 16 bytes at a time.
//
// Sums are int32 and exact while K * 2^14 < 2^31.  Epilogue as
// s8_gemm.cuh: acc (int32) and/or f = ((float)acc * x_scale[m]) *
// w_scale[n], each product rounded to nearest: bit-identical to the
// plain PyTorch version.
//
// A weight loader here is LoadW::columns, which turns the stored bits of
// 4 k rows (r[j]: row k+j, one 32-bit word) into 4 column words of int8
// values (byte j = row k+j): s8small::LoadW8Word transposes.  A packed
// int4 loader would stage N/2 bytes per row and read 2 bytes per row.
//
// The constants below are read by tests/test_torch_tile.py, whose numpy
// emulation of this kernel runs on the CPU against the plain version:
// keep each a literal (STAGES that of S8TILE_STAGES's default, which
// scripts/tile_sweep.py overrides with -D to time other ring depths).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_small_m.cuh"

#ifndef S8TILE_STAGES
#define S8TILE_STAGES 4
#endif

namespace s8tile {

constexpr int BM = 64;            // rows of x per block
constexpr int BN = 64;            // output columns per block
constexpr int BK = 64;            // k per step
constexpr int STAGES = S8TILE_STAGES;  // shared-memory ring depth
constexpr int KGROUPS = 2;        // warp groups, one k32 substep each
constexpr int THREADS = 256;      // KGROUPS x 2 x 2 warps of 32 x 32
constexpr int ROW_BYTES = 64;     // a staged row: BK bytes of x, BN of w
constexpr int LINE_BYTES = 128;   // two staged rows per line of 32 banks
constexpr int CHUNK = 16;         // bytes per cp.async copy

constexpr int TILE_BYTES = 64 * ROW_BYTES;     // [BM][BK] or [BK][BN]
constexpr int STAGE_BYTES = 2 * TILE_BYTES;    // x tile, then w tile
constexpr int CHUNKS_PER_ROW = ROW_BYTES / CHUNK;
static_assert(BM == 64 && BN == 64 && BK == 64 && ROW_BYTES == BK &&
                  ROW_BYTES == BN,
              "64-byte staged rows of x and w; 64 rows per tile");
static_assert(THREADS == 32 * 4 * KGROUPS && KGROUPS * 32 == BK &&
                  TILE_BYTES / CHUNK == THREADS,
              "one k32 substep per group; one chunk per tile per thread");
static_assert(STAGES >= 2 && STAGES * STAGE_BYTES <= 48 * 1024 &&
                  2 * 4 * 4 * 32 * 16 <= STAGES * STAGE_BYTES,
              "static shared memory; the hand-over reuses the ring");

// Byte offset of 16-byte chunk c of staged row r within a tile.
__device__ __forceinline__ int swz(int r, int c) {
  const int chunk = (((r & 1) << 2) | c) ^ ((r >> 1) & 3) ^
                    (((r >> 3) & 1) << 2);
  return (r >> 1) * LINE_BYTES + chunk * CHUNK;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage the 16 bytes at p, of which the first n (0..16) are live, into
// dst; zeros for the rest.  VEC: n is 0 or 16 and p 16-byte aligned (a
// copy of size 0 reads nothing: base stands in for p).
template <bool VEC>
__device__ __forceinline__ void stage_chunk(int8_t* dst, const int8_t* p,
                                            const int8_t* base, int n) {
  if (VEC) {
    cp_async16(dst, n ? p : base, n);
  } else {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = s8small::load_bytes(p + 4 * q, n - 4 * q);
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ int clamp16(int n) { return max(0, min(16, n)); }

// The block's 64x64 tile: C[m0:, n0:] = x[m0:, :] @ W[:, n0:].
// VX / VW: the vector paths of x (K % 16 == 0, x 16-byte aligned) and w
// (N % 16 == 0, w 16-byte aligned).
template <class LoadW, bool VX, bool VW>
__device__ __forceinline__ void gemm_tile(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ xs, const float* __restrict__ ws,
    int32_t* __restrict__ acc_out, float* __restrict__ f_out, int M, int K,
    int N) {
  __shared__ __align__(128) int8_t smem[STAGES * STAGE_BYTES];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;           // mma group / thread
  const int kg = warp >> 2, wq = warp & 3;         // K group, warp tile
  const int wm = (wq >> 1) * 32, wn = (wq & 1) * 32, kk = 32 * kg;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = static_cast<int>(blockIdx.x / tiles_n) * BM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * BN;
  const int steps = (K + BK - 1) / BK;

  // this thread's copies: chunk c of row r of the x tile and of the w
  // tile, from running pointers at the next step to issue (k_next)
  const int r = threadIdx.x / CHUNKS_PER_ROW, c = threadIdx.x % CHUNKS_PER_ROW;
  const int dst = swz(r, c);
  const bool x_row = m0 + r < M;
  const int w_cols = clamp16(N - n0 - c * CHUNK);
  const int8_t* px = x + (x_row ? static_cast<size_t>(m0 + r) * K : 0) +
                     c * CHUNK;
  const int8_t* pw = w + static_cast<size_t>(r) * N + n0 + c * CHUNK;
  const size_t w_step = static_cast<size_t>(BK) * N;
  int k_next = 0;
  auto issue = [&](int8_t* stage) {
    stage_chunk<VX>(stage + dst, px, x,
                    x_row ? clamp16(K - k_next - c * CHUNK) : 0);
    stage_chunk<VW>(stage + TILE_BYTES + dst, pw, w,
                    k_next + r < K ? w_cols : 0);
    px += BK;
    pw += w_step;
    k_next += BK;
  };

  // fragment offsets in a stage: A rows g / g+8 at k = kk + 4t (and +16);
  // B rows kk + 16h + 4t + j at real columns wn + 4g..
  int a_off[2][4], b_off[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ra = wm + i * 16 + g, ca = kk / CHUNK;
    a_off[i][0] = swz(ra, ca) + 4 * t;
    a_off[i][1] = swz(ra + 8, ca) + 4 * t;
    a_off[i][2] = swz(ra, ca + 1) + 4 * t;
    a_off[i][3] = swz(ra + 8, ca + 1) + 4 * t;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b_off[h][j] = TILE_BYTES + swz(kk + 16 * h + 4 * t + j,
                                     (wn >> 4) + (g >> 2)) + 4 * (g & 3);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(smem + s * STAGE_BYTES);
    cp_async_commit();
  }
  // unrolled by STAGES: step s0 + u reads stage u, and the copies it
  // issues (step s0 + u + STAGES - 1) go to stage (u + STAGES - 1) % STAGES
  for (int s0 = 0; s0 < steps; s0 += STAGES) {
#pragma unroll
    for (int u = 0; u < STAGES; ++u) {
      if (s0 + u >= steps) break;
      cp_async_wait<STAGES - 2>();   // this thread's copies of the step
      __syncthreads();               // everyone's; the last step is read
      if (s0 + u + STAGES - 1 < steps)
        issue(smem + (u + STAGES - 1) % STAGES * STAGE_BYTES);
      cp_async_commit();

      const int8_t* st = smem + u * STAGE_BYTES;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] = lds32(st + a_off[i][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t rows[4], cols[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) rows[j] = lds32(st + b_off[h][j]);
        LoadW::columns(rows, cols);
#pragma unroll
        for (int n = 0; n < 4; ++n) b[n][h] = cols[n];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_s8(acc[i][n], a[i], b[n]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free

  // hand-over: group kg keeps m16 row block i = kg and sends the other
  // (int4 of c0..c3 per n8 tile; lanes consecutive, conflict free)
  // (selects, not acc[kg]: a register array indexed by a value the
  // compiler cannot fold would live in local memory)
  int4* red = reinterpret_cast<int4*>(smem);
  int keep[4][4], send[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      keep[n][e] = kg ? acc[1][n][e] : acc[0][n][e];
      send[n][e] = kg ? acc[0][n][e] : acc[1][n][e];
    }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    red[((((1 - kg) * 4 + wq) * 4) + n) * 32 + lane] =
        make_int4(send[n][0], send[n][1], send[n][2], send[n][3]);
  __syncthreads();
  int sum[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int4 o = red[(((kg * 4 + wq) * 4) + n) * 32 + lane];
    sum[n][0] = keep[n][0] + o.x;
    sum[n][1] = keep[n][1] + o.y;
    sum[n][2] = keep[n][2] + o.z;
    sum[n][3] = keep[n][3] + o.w;
  }

  // C fragment of n8 tile n: e = 0,1 at row g, e = 2,3 at row g+8;
  // fragment columns 2t, 2t+1 are real columns wn + 8t + n and
  // wn + 8t + 4 + n
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wm + kg * 16 + g + 8 * h;
    if (row >= M) continue;
    const float xsr = f_out ? xs[row] : 0.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + wn + 8 * t + 4 * q;
      if (col >= N) continue;
      const size_t o = static_cast<size_t>(row) * N + col;
      int v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) v[n] = sum[n][2 * h + q];
      if (vec_out) {
        if (acc_out)
          *reinterpret_cast<int4*>(acc_out + o) =
              make_int4(v[0], v[1], v[2], v[3]);
        if (f_out) {
          float f[4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
            f[n] = __fmul_rn(__fmul_rn(__int2float_rn(v[n]), xsr),
                             ws[col + n]);
          *reinterpret_cast<float4*>(f_out + o) =
              make_float4(f[0], f[1], f[2], f[3]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (col + n < N) {
            if (acc_out) acc_out[o + n] = v[n];
            if (f_out)
              f_out[o + n] = __fmul_rn(
                  __fmul_rn(__int2float_rn(v[n]), xsr), ws[col + n]);
          }
      }
    }
  }
}

// One block per 64x64 output tile, linear over the tiles (row-major).
inline dim3 grid_for(int M, int N) {
  return dim3(static_cast<unsigned>(((M + BM - 1) / BM) *
                                    ((N + BN - 1) / BN)));
}

}  // namespace s8tile

// Tiled int8 x int8 -> int32 GEMM on Hopper tensor cores (mma.sync
// m16n8k32 s8) for the prefill rows of a quantized matmul, M > 16.
// Two weight loaders instantiate it through launch_tile<W>:
// quant_matmul.cu with int8 weights (TileW8, entry repro_quant_matmul)
// and packed_w4_matmul.cu with packed int4 weights (TileW4, entry
// repro_packed_w4_matmul; that file's note gives the packed bound and
// what the loader does).
//
// Replaces, for M > 16, the TPU kernels
// repro/kernels/quant_matmul.py::quant_matmul_acc (body _qmm_kernel,
// pallas_call at :52) and repro/kernels/packed_matmul.py::
// packed_w4_matmul_acc (body _pmm_kernel, pallas_call at :61).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1,979 TOP/s dense int8), int8
// weights: bytes.  At prefill (M = B*S = 1024) a launch reads x (M*K),
// the weights (K*N) and the scales, and writes the f32 output
// (4*M*N): 0.98 / 0.44 / 2.32 / 1.44 us for (K, N) = 576x576 / 576x192
// / 576x1536 / 1536x576, where the 2*M*K*N operations take 0.34 / 0.11
// / 0.92 / 0.92 us.  The f32 output is most of the bytes (6.29 of the
// 7.77 MB at 576x1536).
//
// What held the first 64x64 tile back (one 256-deep K step per barrier,
// the weights transposed into shared memory), and what this one does:
// 1. Its transposing weight store wrote each staged byte alone, with a
//    4-way bank conflict on every store.  Here nothing is transposed in
//    shared memory: the weights are staged raw, [k][n] as they lie in
//    device memory, and transposed in registers as the mma fragments are
//    read.  The mma's column order within a warp's 32 columns is free, so
//    fragment column g of n8 tile c is the real column 4g + c: thread
//    (g, t) reads one 32-bit word (columns 4g..4g+3) of each of 4
//    consecutive k rows and one 4x4 __byte_perm transpose (the small-M
//    kernel's, W::columns) yields its B fragments for all 4 n8 tiles.
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
//    thread issues one 16-byte copy of x and (int8 weights; packed, the
//    first half of the threads) one of w per step from a running
//    pointer; the vector and byte paths are template parameters, and the
//    step loop is unrolled by STAGES so every shared-memory address is a
//    register plus an immediate.  At the end each group hands the other
//    the sums of one m16 row block through shared memory (int32) and
//    writes the other half of the tile.
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
// Shared memory: each stage holds the x tile [BM][BK] (64-byte rows)
// and the weight tile [BK][...] (a staged k row: W::ROW bytes, 64
// of int8 or 32 of packed int4), the rows swizzled in 16-byte chunks
// over the 128-byte lines of the 32 banks.  64-byte rows (x, TileW8):
// chunk c (0..3) of row r sits at line r >> 1, chunk
// ((r & 1) << 2 | c) ^ ((r >> 1) & 3) ^ (((r >> 3) & 1) << 2) of the line
// (swz); 32-byte rows (TileW4): chunk c (0..1) of row r at line r >> 2,
// chunk ((r & 3) << 1 | c) ^ (((r >> 2) & 3) << 1) (swz4).  Each is a
// bijection per line, so 8 lanes that stage one line's 8 chunks hit 32
// distinct banks, and so do the fragment reads -- the A words of 8
// consecutive rows, one chunk; the B words of rows 4t + j (t = 0..3) at
// columns 4g: int8, two chunks of each row; packed, the half-words of
// one chunk of each row, and rows 4 apart lie on consecutive lines,
// where swz4's term ((r >> 2) & 3) << 1 sends them to 4 distinct chunks.
//
// Ragged M, N and K are masked in the kernel: bytes of rows >= M (x),
// >= K (w) or columns past K (x) / N (w) are staged as zeros (cp.async's
// source size 0, or the byte path), and only m < M, n < N are written.
// A zero packed byte decodes to (-8, 0), not (0, 0), and that is safe:
// in rows >= K the x tile holds zeros at the same k, and columns >= N
// are never stored.  The vector path of x needs K % 16 == 0 and a
// 16-byte aligned x, that of w a stored row of a multiple of 16 bytes
// (N % 16 == 0 int8, N % 32 == 0 packed) and a 16-byte aligned w (the
// wrapper chooses them; else each chunk is gathered byte by byte).  The
// outputs are the wrapper's fresh allocations, 16-byte aligned; with
// N % 4 == 0 they are written 16 bytes at a time.
//
// Sums are int32 modulo 2^32, as the reference's accumulator is: the mma
// accumulates with wrap-around, and the hand-over adds in uint32_t
// (wrap_add), where a C++ signed add could overflow into undefined
// behaviour; exact while K * 2^14 < 2^31.  Epilogue: acc (int32)
// and/or f = ((float)acc * x_scale[m]) * w_scale[n], each product
// rounded to nearest (no add, so nothing contracts into an FMA):
// bit-identical to the plain PyTorch version.
//
// Expert-stacked weights: as the small-M kernel (s8_small_m.cuh's note),
// one launch takes E experts, expert e on blockIdx.y = e, from its base
// offsets (s8small::ExpertStrides, size_t); the tile inside an expert is
// the 2-D tile unchanged.  The vector paths hold per expert: K % 16 == 0
// puts every expert's x at a multiple of 16 bytes, a stored w row of a
// multiple of 16 bytes every expert's w, and N % 4 == 0 every expert's
// outputs.
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
constexpr int ROW_BYTES = 64;     // a staged row of x (BK) or int8 w (BN)
constexpr int W4_ROW_BYTES = 32;  // a staged row of packed w (BN / 2)
constexpr int LINE_BYTES = 128;   // one line of the 32 banks
constexpr int CHUNK = 16;         // bytes per cp.async copy

constexpr int TILE_BYTES = 64 * ROW_BYTES;     // [BM][BK] x tile
constexpr int RED_BYTES = 16384;  // the hand-over: 2 x 4 x 4 x 32 int4
static_assert(BM == 64 && BN == 64 && BK == 64 && ROW_BYTES == BK &&
                  ROW_BYTES == BN && 2 * W4_ROW_BYTES == BN,
              "64-byte staged rows of x and int8 w, 32 of packed w");
static_assert(THREADS == 32 * 4 * KGROUPS && KGROUPS * 32 == BK &&
                  TILE_BYTES / CHUNK == THREADS &&
                  RED_BYTES == 2 * 4 * 4 * 32 * 16,
              "one k32 substep per group; one x chunk per thread");

// Byte offset of 16-byte chunk c (0..3) of staged 64-byte row r.
__device__ __forceinline__ int swz(int r, int c) {
  const int chunk = (((r & 1) << 2) | c) ^ ((r >> 1) & 3) ^
                    (((r >> 3) & 1) << 2);
  return (r >> 1) * LINE_BYTES + chunk * CHUNK;
}

// Byte offset of 16-byte chunk c (0..1) of staged 32-byte row r.
__device__ __forceinline__ int swz4(int r, int c) {
  const int chunk = (((r & 3) << 1) | c) ^ (((r >> 2) & 3) << 1);
  return (r >> 2) * LINE_BYTES + chunk * CHUNK;
}

// a + b modulo 2^32: the add in uint32_t, back through the
// two's-complement reading (defined for every bit pattern)
__device__ __forceinline__ int wrap_add(int a, int b) {
  const uint32_t u = static_cast<uint32_t>(a) + static_cast<uint32_t>(b);
  return u <= 0x7FFFFFFFu ? static_cast<int>(u) : -static_cast<int>(~u) - 1;
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

// A weight loader of the tile: the staged k row (ROW bytes, stored
// COLS_PER_BYTE columns per byte), its swizzle (chunk), the byte offset of
// the fragment word of columns col..col+3 (col % 4 == 0) of k row r
// (frag), the word read there (read: the 4 columns' stored bits in its
// low bytes) and columns(), which turns the words of 4 k rows (r[j]: row
// k+j) into 4 column words of int8 values (byte j = row k+j): the small-M
// kernel's loaders' own.
struct TileW8 : s8small::LoadW8Word {    // int8 weights, transposed
  static constexpr int COLS_PER_BYTE = 1;
  static constexpr int ROW = ROW_BYTES;
  __device__ __forceinline__ static int chunk(int r, int c) {
    return swz(r, c);
  }
  __device__ __forceinline__ static int frag(int r, int col) {
    return swz(r, col >> 4) + (col & 15);
  }
  __device__ __forceinline__ static uint32_t read(const int8_t* p) {
    return lds32(p);
  }
};

struct TileW4 : s8small::LoadW4Word {    // packed int4: 2 bytes per word
  static constexpr int COLS_PER_BYTE = 2;
  static constexpr int ROW = W4_ROW_BYTES;
  __device__ __forceinline__ static int chunk(int r, int c) {
    return swz4(r, c);
  }
  __device__ __forceinline__ static int frag(int r, int col) {
    return swz4(r, col >> 5) + ((col & 31) >> 1);
  }
  __device__ __forceinline__ static uint32_t read(const int8_t* p) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
};

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

// The block's 64x64 tile: C[m0:, n0:] = x[m0:, :] @ W[:, n0:], the weight
// tile staged and read by the loader W (TileW8 / TileW4).  VX / VW: the
// vector paths of x (K % 16 == 0, x 16-byte aligned) and w (a stored row
// of a multiple of 16 bytes, w 16-byte aligned).
template <class W, bool VX, bool VW>
__device__ __forceinline__ void gemm_tile(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ xs, const float* __restrict__ ws,
    int32_t* __restrict__ acc_out, float* __restrict__ f_out, int M, int K,
    int N) {
  constexpr int W_TILE = BK * W::ROW;            // [BK][W::ROW] w tile
  constexpr int STAGE_BYTES = TILE_BYTES + W_TILE;
  constexpr int W_CHUNKS_PER_ROW = W::ROW / CHUNK;
  constexpr int W_COPIES = W_TILE / CHUNK;       // threads that copy w
  constexpr int RING = STAGES * STAGE_BYTES;
  static_assert(W_COPIES <= THREADS && W_COPIES % 32 == 0 && STAGES >= 2 &&
                    RING <= 48 * 1024,
                "whole warps copy w; static shared memory");
  // the hand-over reuses the ring
  __shared__ __align__(128) int8_t smem[RING > RED_BYTES ? RING : RED_BYTES];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;           // mma group / thread
  const int kg = warp >> 2, wq = warp & 3;         // K group, warp tile
  const int wm = (wq >> 1) * 32, wn = (wq & 1) * 32, kk = 32 * kg;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = static_cast<int>(blockIdx.x / tiles_n) * BM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * BN;
  const int steps = (K + BK - 1) / BK;

  // this thread's copies from running pointers at the next step to issue
  // (k_next): chunk c of row r of the x tile, and (threads < W_COPIES)
  // chunk cw of k row rw of the w tile, whose stored rows are NB bytes
  constexpr int CHUNKS_PER_ROW = ROW_BYTES / CHUNK;
  const int r = threadIdx.x / CHUNKS_PER_ROW, c = threadIdx.x % CHUNKS_PER_ROW;
  const int dst = swz(r, c);
  const bool x_row = m0 + r < M;
  const int8_t* px = x + (x_row ? static_cast<size_t>(m0 + r) * K : 0) +
                     c * CHUNK;
  const bool w_copy = W_COPIES == THREADS || threadIdx.x < W_COPIES;
  const int rw = w_copy ? threadIdx.x / W_CHUNKS_PER_ROW : 0;
  const int cw = threadIdx.x % W_CHUNKS_PER_ROW;
  const int w_dst = TILE_BYTES + W::chunk(rw, cw);
  const int NB = N / W::COLS_PER_BYTE;
  const int w_col0 = n0 / W::COLS_PER_BYTE + cw * CHUNK;
  const int w_live = clamp16(NB - w_col0);
  const int8_t* pw = w + static_cast<size_t>(rw) * NB + w_col0;
  const size_t w_step = static_cast<size_t>(BK) * NB;
  int k_next = 0;
  auto issue = [&](int8_t* stage) {
    stage_chunk<VX>(stage + dst, px, x,
                    x_row ? clamp16(K - k_next - c * CHUNK) : 0);
    if (w_copy)
      stage_chunk<VW>(stage + w_dst, pw, w, k_next + rw < K ? w_live : 0);
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
      b_off[h][j] = TILE_BYTES + W::frag(kk + 16 * h + 4 * t + j, wn + 4 * g);

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
        for (int j = 0; j < 4; ++j) rows[j] = W::read(st + b_off[h][j]);
        W::columns(rows, cols);
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
    sum[n][0] = wrap_add(keep[n][0], o.x);
    sum[n][1] = wrap_add(keep[n][1], o.y);
    sum[n][2] = wrap_add(keep[n][2], o.z);
    sum[n][3] = wrap_add(keep[n][3], o.w);
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

// One block per 64x64 output tile, linear over the tiles (row-major);
// E experts on the y axis.
inline dim3 grid_for(int M, int N, int E = 1) {
  return dim3(static_cast<unsigned>(((M + BM - 1) / BM) *
                                    ((N + BN - 1) / BN)),
              E);
}

using s8small::ExpertStrides;
using s8small::expert_ptr;

// EXPERTS: the batched kernel (each expert's pointers offset first); the
// 2-D kernel keeps its arguments as they are, its code unchanged.
template <class W, bool VX, bool VW, bool EXPERTS>
__global__ void __launch_bounds__(THREADS)
    tile_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ xs, const float* __restrict__ ws,
                int32_t* __restrict__ acc_out, float* __restrict__ f_out,
                int M, int K, int N, ExpertStrides es) {
  if constexpr (EXPERTS)
    gemm_tile<W, VX, VW>(expert_ptr(x, es.x), expert_ptr(w, es.w),
                         expert_ptr(xs, es.xs), expert_ptr(ws, es.ws),
                         expert_ptr(acc_out, es.out),
                         expert_ptr(f_out, es.out), M, K, N);
  else
    gemm_tile<W, VX, VW>(x, w, xs, ws, acc_out, f_out, M, K, N);
}

template <class W, bool VX, bool VW>
void launch_vec(const void* x, const void* w, const void* xs,
                const void* ws, void* acc_out, void* f_out, int E, int M,
                int K, int N, ExpertStrides es, void* stream) {
  auto kernel = E > 1 ? tile_kernel<W, VX, VW, true>
                      : tile_kernel<W, VX, VW, false>;
  kernel<<<grid_for(M, N, E), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<int32_t*>(acc_out), static_cast<float*>(f_out), M, K, N,
      es);
}

// The C entry points' body: the vector paths chosen by the wrapper
// (vec_x: K % 16 == 0 and x 16-byte aligned; vec_w: a stored w row of a
// multiple of 16 bytes and w 16-byte aligned); E experts on the grid's y
// axis (E = 1 and zero strides for a 2-D launch).  Returns
// cudaErrorInvalidValue (nothing launched) for E outside 1..65535, else
// cudaGetLastError() after the launch.
template <class W>
int launch_tile(const void* x, const void* w, const void* xs,
                const void* ws, void* acc_out, void* f_out, int E, int M,
                int K, int N, int vec_x, int vec_w, ExpertStrides es,
                void* stream) {
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (vec_x && vec_w)
    launch_vec<W, true, true>(x, w, xs, ws, acc_out, f_out, E, M, K, N, es,
                              stream);
  else if (vec_x)
    launch_vec<W, true, false>(x, w, xs, ws, acc_out, f_out, E, M, K, N, es,
                               stream);
  else if (vec_w)
    launch_vec<W, false, true>(x, w, xs, ws, acc_out, f_out, E, M, K, N, es,
                               stream);
  else
    launch_vec<W, false, false>(x, w, xs, ws, acc_out, f_out, E, M, K, N,
                                es, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace s8tile

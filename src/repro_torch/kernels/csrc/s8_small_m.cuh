// Small-M int8 x int8 -> int32 GEMM on Hopper's CUDA cores (dp4a), for
// the decode rows of a quantized matmul: M <= MAX_M = 16 rows of x.
// quant_matmul.cu instantiates it with int8 weights
// (repro_quant_matmul_small_m); the 64x64 tensor-core tile of
// s8_gemm.cuh keeps M > 16.
//
// Replaces, for M <= 16, the TPU kernel
// repro/kernels/quant_matmul.py::quant_matmul_acc (body _qmm_kernel,
// pallas_call at :52).
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes.  A launch must read the
// K*N weight bytes, the M*K bytes of x and the scales, and write the f32
// output, 4*M*N bytes: at decode (M = 8) 0.11 us for a 576x576
// projection, 0.28 us for 576x1536; its 2*M*K*N operations are far
// below any compute peak.  So a launch is bound by launch latency and by
// how many memory round trips it waits out.
//
// What the design does about the three things that held the 64x64 tile
// back at M = 8:
// 1. Too few blocks (3, 9 or 24 on 132 SMs).  The grid runs over output
//    columns only, COLS = 32 per block, and no block reduces across
//    blocks: 6 / 18 / 48 blocks for N = 192 / 576 / 1536.  Inside a
//    block the K axis is split over 32 interleaved streams (8 warps x 4
//    lane groups) and reduced in registers and shared memory.
// 2. A serial load -> transposing store -> barrier -> mma chain per K
//    step, with 4-way bank conflicts on the transposing stores.  Each
//    thread issues every weight load of a round (RQ quads of 4 k rows,
//    1536 k per round: one round for K <= 1536) into registers before
//    it computes on any of them, and transposes the 4x4 byte blocks in
//    registers (__byte_perm): no shared-memory transpose, no conflicts.
//    A warp's load instruction covers 4 rows x 32 contiguous bytes,
//    whole 32-byte sectors.
// 3. M padded to 64.  x is staged in shared memory once per block, as
//    int32 words of 4 consecutive k, padded only to MT, the next of 1,
//    2, 4, 8, 16 at or above M; the products run on the CUDA cores
//    (dp4a), so there is no tensor-core tile to fill.
//
// Ragged M, K and N are masked in the kernel: x words past K or for rows
// m >= M are staged as zeros, weight words outside [K, N) load as zeros,
// and only m < M, n < N are written.  The vector paths (one 4-byte load
// per word) need K % 4 == 0 and a 4-byte aligned x, N % 4 == 0 and a
// 4-byte aligned w; the wrapper chooses them, else each byte loads alone.
//
// Sums are int32 and exact while K * 2^14 < 2^31, i.e. K < 2^17; the
// wrapper refuses a larger K on this path.  The order is fixed: each
// stream in k order, then the lane groups (xor 8, then xor 16), then the
// warps in order.  Epilogue as s8_gemm.cuh: acc (int32) and/or
// f = ((float)acc * x_scale[m]) * w_scale[n], each product rounded to
// nearest: bit-identical to the plain PyTorch version.
//
// The constants below are read by tests/test_torch_small_m.py, whose
// numpy emulation of this kernel runs on the CPU against the plain
// version: keep each a literal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace s8small {

constexpr int MAX_M = 16;          // rows of x this kernel takes
constexpr int WARPS = 8;           // per block
constexpr int GROUPS = 4;          // lane groups per warp, one K stream each
constexpr int COLS_PER_LANE = 4;   // output columns per thread
constexpr int RQ = 12;             // quads (4 k rows) per stream per round

constexpr int THREADS = 32 * WARPS;
constexpr int LANES_PER_GROUP = 32 / GROUPS;
constexpr int COLS = LANES_PER_GROUP * COLS_PER_LANE;   // per block
constexpr int STREAMS = WARPS * GROUPS;                 // K streams
constexpr int QR = STREAMS * RQ;                        // quads per round
static_assert(COLS_PER_LANE == 4, "one 4-byte weight word per row");
static_assert(COLS == 32 && STREAMS == 32 && QR == 384,
              "32 columns per block, 32 K streams, 1536 k per round");

// __byte_perm selectors of the 4x4 byte transpose.  Byte i of the result
// is byte (s >> 4i) & 7 of the pair {x: bytes 0-3, y: bytes 4-7}.
constexpr uint32_t PERM_PAIR_LO = 0x5140;   // x.b0 y.b0 x.b1 y.b1
constexpr uint32_t PERM_PAIR_HI = 0x7362;   // x.b2 y.b2 x.b3 y.b3
constexpr uint32_t PERM_HALF_LO = 0x5410;   // x.b0 x.b1 y.b0 y.b1
constexpr uint32_t PERM_HALF_HI = 0x7632;   // x.b2 x.b3 y.b2 y.b3

// r[j]: row k+j's bytes of 4 columns (byte c = column c).  Returns
// c[i]: column i's bytes of rows k..k+3 (byte j = row k+j).
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], PERM_PAIR_LO);
  const uint32_t t1 = __byte_perm(r[0], r[1], PERM_PAIR_HI);
  const uint32_t t2 = __byte_perm(r[2], r[3], PERM_PAIR_LO);
  const uint32_t t3 = __byte_perm(r[2], r[3], PERM_PAIR_HI);
  c[0] = __byte_perm(t0, t2, PERM_HALF_LO);
  c[1] = __byte_perm(t0, t2, PERM_HALF_HI);
  c[2] = __byte_perm(t1, t3, PERM_HALF_LO);
  c[3] = __byte_perm(t1, t3, PERM_HALF_HI);
}

// The 4 bytes p[0..n) as a little-endian word, zeros from byte n on.
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p, int n) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < n) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[b]))
                    << (8 * b);
  return v;
}

// x[m, k..k+3] as one word; zeros past K and for m >= M.  vec: K % 4 == 0
// and x 4-byte aligned.
__device__ __forceinline__ int load_x_word(const int8_t* __restrict__ x,
                                           int M, int K, int m, int k,
                                           bool vec) {
  if (m >= M || k >= K) return 0;
  const int8_t* p = x + static_cast<size_t>(m) * K + k;
  if (vec) return *reinterpret_cast<const int*>(p);
  return static_cast<int>(load_bytes(p, K - k));
}

// w[k, col..col+3] as one word; zeros outside [K, N).  vec: N % 4 == 0
// and w 4-byte aligned, so a word lies wholly inside or outside N.
struct LoadW8Word {
  __device__ __forceinline__ static uint32_t load(
      const int8_t* __restrict__ w, int K, int N, int k, int col,
      bool vec) {
    if (k >= K || col >= N) return 0;
    const int8_t* p = w + static_cast<size_t>(k) * N + col;
    if (vec) return *reinterpret_cast<const uint32_t*>(p);
    return load_bytes(p, N - col);
  }
};

// One block: out[:, n0:n0+COLS] = x[:M] @ W[:, n0:n0+COLS], with each
// weight word (row k, 4 columns from col) from LoadW::load.
template <int MT, class LoadW>
__device__ __forceinline__ void gemm_small_m(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ xs, const float* __restrict__ ws,
    int32_t* __restrict__ acc_out, float* __restrict__ f_out, int M, int K,
    int N, bool vec_x, bool vec_w) {
  static_assert(MT >= 1 && MT <= MAX_M, "MT rows of x");
  __shared__ int xw[MT][QR];                       // x words of a round
  __shared__ __align__(16) int red[WARPS][MT][COLS];   // warp partials

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / LANES_PER_GROUP, cl = lane % LANES_PER_GROUP;
  const int s = warp * GROUPS + g;                 // this thread's stream
  const int n0 = blockIdx.x * COLS;
  const int col = n0 + cl * COLS_PER_LANE;
  const int KQ = (K + 3) >> 2;                     // quads of k

  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  for (int q0 = 0; q0 < KQ; q0 += QR) {
    // every weight load of the round in flight before any is used
    uint32_t wr[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int k = 4 * (q0 + s + i * STREAMS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wr[i][j] = LoadW::load(w, K, N, k + j, col, vec_w);
    }
    const int nq = min(QR, KQ - q0);
    __syncthreads();                  // the previous round's xw is read
    for (int t = threadIdx.x; t < MT * nq; t += THREADS) {
      const int m = t / nq, ql = t - m * nq;
      xw[m][ql] = load_x_word(x, M, K, m, 4 * (q0 + ql), vec_x);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int ql = s + i * STREAMS;
      if (ql < nq) {
        uint32_t wc[4];
        transpose4x4(wr[i], wc);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int xv = xw[m][ql];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][c] = __dp4a(static_cast<int>(wc[c]), xv, acc[m][c]);
        }
      }
    }
  }

  // the warp's 4 lane groups, then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, LANES_PER_GROUP);
      v += __shfl_xor_sync(0xffffffffu, v, 2 * LANES_PER_GROUP);
      acc[m][c] = v;
    }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m % GROUPS == g)
      *reinterpret_cast<int4*>(&red[warp][m][cl * COLS_PER_LANE]) =
          make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int t = threadIdx.x; t < MT * COLS; t += THREADS) {
    const int m = t / COLS, c = t % COLS, n = n0 + c;
    if (m < M && n < N) {
      int sum = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) sum += red[v][m][c];
      const size_t o = static_cast<size_t>(m) * N + n;
      if (acc_out) acc_out[o] = sum;
      if (f_out)
        f_out[o] = __fmul_rn(__fmul_rn(__int2float_rn(sum), xs[m]), ws[n]);
    }
  }
}

inline dim3 grid_for(int N) { return dim3((N + COLS - 1) / COLS); }

}  // namespace s8small

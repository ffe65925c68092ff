// Small-M int8 x int8 -> int32 GEMM on Hopper's CUDA cores (dp4a), for
// the decode rows of a quantized matmul: M <= MAX_M = 16 rows of x.
// Two entry points instantiate it through launch_small_m<LoadW>:
// quant_matmul.cu with int8 weights (LoadW8Word,
// repro_quant_matmul_small_m) and packed_w4_matmul.cu with packed int4
// weights unpacked in registers (LoadW4Word,
// repro_packed_w4_matmul_small_m).  The tensor-core tile of
// s8_tile.cuh takes M > 16 for both.
//
// Replaces, for M <= 16, the TPU kernels
// repro/kernels/quant_matmul.py::quant_matmul_acc (body _qmm_kernel,
// pallas_call at :52) and repro/kernels/packed_matmul.py::
// packed_w4_matmul_acc (body _pmm_kernel, pallas_call at :61).
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes.  A launch must read the
// weight bytes (K*N int8, or K*N/2 packed int4), the M*K bytes of x and
// the scales, and write the f32 output, 4*M*N bytes: at decode (M = 8)
// 0.11 us for a 576x576 int8 projection, 0.28 us for 576x1536, about
// half that packed; its 2*M*K*N operations are far below any compute
// peak.  So a launch is bound by launch latency and by how many memory
// round trips it waits out.
//
// What the design does about the three things that held the first 64x64
// tensor-core tile back at M = 8:
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
//    registers (__byte_perm; packed int4: a 2x4 byte gather, then the
//    nibbles unpacked 4 rows at a time): no shared-memory transpose, no
//    conflicts.
//    A warp's load instruction covers 4 rows x 32 contiguous bytes,
//    whole 32-byte sectors (packed int4: 4 rows x 16 bytes, half a
//    sector each).
// 3. M padded to 64.  x is staged in shared memory once per block, as
//    int32 words of 4 consecutive k, padded only to MT, the next of 1,
//    2, 4, 8, 16 at or above M; the products run on the CUDA cores
//    (dp4a), so there is no tensor-core tile to fill.
//
// Ragged M, K and N are masked in the kernel: x words past K or for rows
// m >= M are staged as zeros, weight words outside [K, N) load as
// (decoded) zeros, and only m < M, n < N are written.  The vector paths
// need K % 4 == 0 and a 4-byte aligned x (one 4-byte load per x word);
// for w, N % 4 == 0 and a 4-byte aligned int8 w (one 4-byte load per
// word), or N % 4 == 0 and a 2-byte aligned packed w (one 2-byte load);
// the wrapper chooses them, else each byte loads alone.
//
// Sums are int32 modulo 2^32, as the reference's accumulator is (and
// the tile's of s8_tile.cuh): dp4a accumulates with wrap-around, and the
// lane-group and warp sums add in uint32_t, read back as int32 by
// as_int, where a C++ signed add could overflow into undefined
// behaviour; exact while K * 2^14 < 2^31, i.e. K < 2^17, and wrapped as
// the plain version wraps past it.  The order is fixed: each stream in
// k order, then the lane groups (xor 8, then xor 16), then the warps in
// order.  Epilogue as s8_tile.cuh: acc (int32) and/or
// f = ((float)acc * x_scale[m]) * w_scale[n], each product rounded to
// nearest: bit-identical to the plain PyTorch version.
//
// Expert-stacked weights (the MoE family's [E, K, N] experts, which the
// reference serves by vmap over the pallas_call, one grid axis more):
// one launch takes all E experts, expert e on blockIdx.y = e.  Each
// expert's x, w, scales and outputs start at e times their expert
// stride (ExpertStrides, in elements; computed in size_t, since a
// stacked arctic weight is 128 x 7168 x 4864 = 4.46e9 bytes), and inside
// an expert the kernel is the 2-D kernel unchanged.  An x stride of 0
// hands every expert the same x rows and scales (the per-token MoE path
// feeds one x to all experts).  The 2-D entries launch E = 1 with zero
// strides: the same grid, the same blocks, the same sums.  Bound: the
// 2-D bound summed over the experts; a decode launch of granite's
// [32, 1024, 512] int8 experts moves 16.8 MB, 5.0 us at 3.35 TB/s.
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

// The two's-complement reading of a uint32_t sum (defined for every bit
// pattern, where a cast above INT_MAX is not before C++20).
__device__ __forceinline__ int as_int(uint32_t u) {
  return u <= 0x7FFFFFFFu ? static_cast<int>(u) : -static_cast<int>(~u) - 1;
}

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

// A weight loader has two steps.  load(w, K, N, k, col, vec) reads the
// stored bits of row k, columns col..col+3, and is issued for a whole
// round before any result is used, so all of a round's loads are in
// flight together.  columns(r, c) turns the bits of rows k..k+3 (r[j]:
// row k+j) into c[i]: column col+i's int8 values of rows k..k+3 (byte j
// = row k+j), the operand of dp4a; zeros outside [K, N).

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
  __device__ __forceinline__ static void columns(const uint32_t (&r)[4],
                                                 uint32_t (&c)[4]) {
    transpose4x4(r, c);
  }
};

// Packed int4 weights: w holds K x N/2 bytes, byte j of a row holding
// columns 2j and 2j+1 as (w_even + 8) | (w_odd << 4) (N even).  A row's
// columns col..col+3 (col % 4 == 0, so col/2 is even) are its 2 bytes
// b0 (columns col, col+1) and b1 (col+2, col+3).  columns():
// 1. 4 __byte_perm gather b0 of the 4 rows into one word and b1 into
//    another (byte j = row k+j);
// 2. each column word is one nibble of every byte: the low nibbles by a
//    mask, the high ones by a shift and a mask;
// 3. each byte to its value in [-8, 7].  A 4-bit field u sign-extends
//    as u | (u & 8) * 0x1E (bit 3 copied into bits 4-7; no carry leaves
//    a byte).  A high nibble is w_odd's field (u = n); a low nibble
//    holds w_even + 8, so w_even = n - 8, the sign extension of
//    u = n ^ 8: the low nibbles' words are xored with W4_BIAS.
// A zero byte decodes to (-8, 0), so bytes outside [K, N) load as the
// padding byte W4_PAD, which decodes to (0, 0), as the TPU wrapper pads.
constexpr uint32_t W4_NIBBLES = 0x0F0F0F0F;  // one nibble of each byte
constexpr uint32_t W4_BIAS = 0x08080808;     // bit 3 of each byte
constexpr uint32_t W4_SEXT = 0x1E;           // (u & 8) * 0x1E = 0xF0
constexpr uint32_t W4_PAD = 0x08;            // packed (0, 0)

__device__ __forceinline__ uint32_t sext4(uint32_t u) {
  return u | (u & W4_BIAS) * W4_SEXT;
}

// load: the 2 packed bytes of w[k, col..col+3], W4_PAD outside [K, N).
// vec: N % 4 == 0 and w 2-byte aligned, so the 2 bytes are one aligned
// 16-bit word wholly inside or outside N.
struct LoadW4Word {
  __device__ __forceinline__ static uint32_t load(
      const int8_t* __restrict__ w, int K, int N, int k, int col,
      bool vec) {
    constexpr uint32_t PAD_PAIR = W4_PAD | W4_PAD << 8;
    if (k >= K || col >= N) return PAD_PAIR;
    const int8_t* p = w + static_cast<size_t>(k) * (N / 2) + col / 2;
    if (vec) return *reinterpret_cast<const uint16_t*>(p);
    if (col + 2 < N) return load_bytes(p, 2);
    return load_bytes(p, 1) | (PAD_PAIR & 0xFF00u);
  }
  __device__ __forceinline__ static void columns(const uint32_t (&r)[4],
                                                 uint32_t (&c)[4]) {
    const uint32_t t0 = __byte_perm(r[0], r[1], PERM_PAIR_LO);
    const uint32_t t1 = __byte_perm(r[2], r[3], PERM_PAIR_LO);
    const uint32_t b0 = __byte_perm(t0, t1, PERM_HALF_LO);
    const uint32_t b1 = __byte_perm(t0, t1, PERM_HALF_HI);
    c[0] = sext4((b0 & W4_NIBBLES) ^ W4_BIAS);
    c[1] = sext4((b0 >> 4) & W4_NIBBLES);
    c[2] = sext4((b1 & W4_NIBBLES) ^ W4_BIAS);
    c[3] = sext4((b1 >> 4) & W4_NIBBLES);
  }
};

// One block: out[:, n0:n0+COLS] = x[:M] @ W[:, n0:n0+COLS], with the
// weight bits of each row k, 4 columns from col, from LoadW::load, and
// each quad's column words from LoadW::columns in the compute loop.
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
        LoadW::columns(wr[i], wc);
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
      uint32_t v = static_cast<uint32_t>(acc[m][c]);
      v += __shfl_xor_sync(0xffffffffu, v, LANES_PER_GROUP);
      v += __shfl_xor_sync(0xffffffffu, v, 2 * LANES_PER_GROUP);
      acc[m][c] = as_int(v);
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
      uint32_t total = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v)
        total += static_cast<uint32_t>(red[v][m][c]);
      const int sum = as_int(total);
      const size_t o = static_cast<size_t>(m) * N + n;
      if (acc_out) acc_out[o] = sum;
      if (f_out)
        f_out[o] = __fmul_rn(__fmul_rn(__int2float_rn(sum), xs[m]), ws[n]);
    }
  }
}

inline dim3 grid_for(int N, int E = 1) {
  return dim3((N + COLS - 1) / COLS, E);
}

// Elements between consecutive experts of a batched launch: x (0: one x
// for every expert), the stored w bytes, x_scale (0 with x), w_scale and
// the outputs.  All zero for a 2-D launch (E = 1).
struct ExpertStrides {
  size_t x, w, xs, ws, out;
};

// The strides of E experts of [M, K] x (x_per_expert; else one shared x)
// against [K, N] weights stored in rows of w_row bytes (N int8, N / 2
// packed int4).
inline ExpertStrides expert_strides(int M, int K, int N, int w_row,
                                    bool x_per_expert) {
  const size_t m = static_cast<size_t>(M);
  return ExpertStrides{x_per_expert ? m * K : 0,
                       static_cast<size_t>(K) * w_row, x_per_expert ? m : 0,
                       static_cast<size_t>(N), m * N};
}

// Expert blockIdx.y's pointer: base + e * stride (null stays null).
template <class T>
__device__ __forceinline__ T* expert_ptr(T* base, size_t stride) {
  return base ? base + static_cast<size_t>(blockIdx.y) * stride : base;
}

// EXPERTS: the batched kernel, each expert's pointers offset first; the
// 2-D kernel (EXPERTS false) keeps the kernel arguments as they are, so
// its code is the kernel's before the expert axis (the offsets, held in
// registers through the K loop, cost the batched kernel 17 registers at
// MT = 8).
template <int MT, class LoadW, bool EXPERTS>
__global__ void __launch_bounds__(THREADS)
    small_m_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ xs,
                   const float* __restrict__ ws,
                   int32_t* __restrict__ acc_out, float* __restrict__ f_out,
                   int M, int K, int N, bool vec_x, bool vec_w,
                   ExpertStrides es) {
  if constexpr (EXPERTS)
    gemm_small_m<MT, LoadW>(expert_ptr(x, es.x), expert_ptr(w, es.w),
                            expert_ptr(xs, es.xs), expert_ptr(ws, es.ws),
                            expert_ptr(acc_out, es.out),
                            expert_ptr(f_out, es.out), M, K, N, vec_x,
                            vec_w);
  else
    gemm_small_m<MT, LoadW>(x, w, xs, ws, acc_out, f_out, M, K, N, vec_x,
                            vec_w);
}

template <int MT, class LoadW>
void launch_mt(const void* x, const void* w, const void* xs, const void* ws,
               void* acc_out, void* f_out, int E, int M, int K, int N,
               int vec_x, int vec_w, ExpertStrides es, void* stream) {
  auto kernel = E > 1 ? small_m_kernel<MT, LoadW, true>
                      : small_m_kernel<MT, LoadW, false>;
  kernel<<<grid_for(N, E), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<int32_t*>(acc_out), static_cast<float*>(f_out), M, K, N,
      vec_x != 0, vec_w != 0, es);
}

// The C entry points' body: x rows padded to MT, the next of 1, 2, 4, 8,
// 16 at or above M; E experts on the grid's y axis (E = 1 and zero
// strides for a 2-D launch).  Returns cudaErrorInvalidValue (nothing
// launched) for M outside 1..MAX_M or E outside 1..65535, else
// cudaGetLastError() after the launch.
template <class LoadW>
int launch_small_m(const void* x, const void* w, const void* xs,
                   const void* ws, void* acc_out, void* f_out, int E, int M,
                   int K, int N, int vec_x, int vec_w, ExpertStrides es,
                   void* stream) {
  if (M < 1 || M > MAX_M || E < 1 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 1)
    launch_mt<1, LoadW>(x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x,
                        vec_w, es, stream);
  else if (M <= 2)
    launch_mt<2, LoadW>(x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x,
                        vec_w, es, stream);
  else if (M <= 4)
    launch_mt<4, LoadW>(x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x,
                        vec_w, es, stream);
  else if (M <= 8)
    launch_mt<8, LoadW>(x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x,
                        vec_w, es, stream);
  else
    launch_mt<16, LoadW>(x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x,
                         vec_w, es, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace s8small

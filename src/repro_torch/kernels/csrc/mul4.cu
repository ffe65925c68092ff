// Factor-4 4-bit multiplications for Hopper (paper sec. 2.3, Eq. 3): four
// 4-bit a_i at bit offsets 0/8/16/24 of one 32-bit word, ONE multiply by
// the shared 4-bit b, then the four products recovered lane by lane with
// sign borrows.  Two entry points, as in the reference:
//
//   full32  all four a_i in the word; signed lanes, or (signed=0) the
//           word and product taken modulo 2^32 as uint32
//   split   the paper's 27-bit-port layout (Fig. 3, Eq. 4): a_3 >> 1 in
//           the top lane, then p_3 = (p_3hi << 1) + (a_3 & 1 ? b : 0)
//
// Replaces the TPU kernels repro/kernels/mul4.py::mul4_full32 (:103 via
// _run :72, body :36) and ::mul4_split (:112, body :53), and the
// Pallas-Triton variant repro/kernels/gpu_pallas.py::mul4 :145.
//
// Bound on an H100 SXM: 5 bytes read and 16 written per element at
// 3.35 TB/s (E=2^23: 176 MB, 53 us); the output's 16 B/element is three
// quarters of the traffic and is what the kernels must write.  All
// wrapping arithmetic is uint32 (swar.cuh).
//
// full32 (mul4_kernel): one thread per 16 consecutive elements, one
// 16-byte load of b and of each a row, the four product rows out through
// shared memory in coalesced 16-byte stores (swar.cuh, stage_out).
//
// split (mul4_split_kernel): no shared memory and no barrier.  A thread
// owns GROUP = 4 consecutive elements per step: one 4-byte streaming load
// of each a row and of b (a warp reads 128 contiguous bytes per row) and
// one 16-byte streaming store per product row (512 contiguous bytes per
// warp), so it holds 16 products, not 64, in 32 registers: 8 blocks of
// 256 threads reside on an SM.  The grid is the SMs times the blocks
// resident on each, and walks the groups with a grid stride, one group
// per step (two or four per step took 40 or 54 registers, fewer resident
// blocks, and read no faster on an H100: PERF.md section 6).  A ragged or
// unaligned operand (vec = 0), and a last partial group, take a masked
// scalar path.
#include "swar.cuh"

namespace {

using swar::PER_THREAD;
using swar::u32;

template <bool SPLIT, bool SIGNED>
__device__ __forceinline__ void mul4_elem(int8_t a0, int8_t a1, int8_t a2,
                                          int8_t a3, int8_t bv,
                                          int32_t (&p)[4]) {
  const int32_t b = bv;
  if (SPLIT) {
    // int32 throughout, as the reference's split kernel
    const int32_t a3_hi = swar::asr(a3, 1);
    const uint32_t a3_lo = u32(a3) & 1u;
    int32_t r = swar::as_i32(
        (u32(a0) + (u32(a1) << 8) + (u32(a2) << 16) + (u32(a3_hi) << 24)) *
        u32(b));
    for (int l = 0; l < 3; ++l) {
      if (SIGNED) {
        p[l] = swar::pop_lane8_signed(r);
      } else {
        p[l] = static_cast<int32_t>(u32(r) & 0xFFu);
        r = swar::asr(swar::as_i32(u32(r) - u32(p[l])), 8);
      }
    }
    p[3] = swar::as_i32((u32(r) << 1) + (a3_lo != 0u ? u32(b) : 0u));
  } else if (SIGNED) {
    int32_t r = swar::as_i32(
        (u32(a0) + (u32(a1) << 8) + (u32(a2) << 16) + (u32(a3) << 24)) *
        u32(b));
    p[0] = swar::pop_lane8_signed(r);
    p[1] = swar::pop_lane8_signed(r);
    p[2] = swar::pop_lane8_signed(r);
    p[3] = r;
  } else {
    // uint32 word and product, logical shifts (exact: the true value of
    // the unsigned product is below 2^32)
    uint32_t r =
        (u32(a0) + (u32(a1) << 8) + (u32(a2) << 16) + (u32(a3) << 24)) *
        u32(b);
    for (int l = 0; l < 3; ++l) {
      const uint32_t lane = r & 0xFFu;
      p[l] = swar::as_i32(lane);
      r = (r - lane) >> 8;
    }
    p[3] = swar::as_i32(r);
  }
}

template <bool SPLIT, bool SIGNED>
__global__ void __launch_bounds__(swar::THREADS)
    mul4_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t e, bool vec) {
  __shared__ int32_t stage[swar::STAGE_WORDS];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * swar::THREADS * PER_THREAD;
  const int64_t i = base + threadIdx.x * PER_THREAD;
  const swar::Bytes16 vb = swar::load16(b, i, e, vec);
  const swar::Bytes16 v0 = swar::load16(a, i, e, vec);
  const swar::Bytes16 v1 = swar::load16(a + e, i, e, vec);
  const swar::Bytes16 v2 = swar::load16(a + 2 * e, i, e, vec);
  const swar::Bytes16 v3 = swar::load16(a + 3 * e, i, e, vec);
  int32_t r[4][PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    int32_t p[4];
    mul4_elem<SPLIT, SIGNED>(v0.v[j], v1.v[j], v2.v[j], v3.v[j], vb.v[j], p);
#pragma unroll
    for (int l = 0; l < 4; ++l) r[l][j] = p[l];
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
    swar::stage_out(r[l], stage, out + l * e, base, e, vec);
}

// keep each a literal: tests/test_torch_mul4.py reads them
constexpr int GROUP = 4;            // consecutive elements per thread step
constexpr int SPLIT_THREADS = 256;  // threads per block of the split kernel

// byte j of w as a signed int8 (element j of a group's little-endian word)
__device__ __forceinline__ int8_t byte_s8(uint32_t w, int j) {
  return static_cast<int8_t>(
      static_cast<int32_t>(((w >> (8 * j)) & 0xFFu) ^ 0x80u) - 0x80);
}

// One group's operands: byte j of a[l] and of b is element i + j.
struct SplitGroup {
  uint32_t a[4];
  uint32_t b;
};

__device__ __forceinline__ SplitGroup load_group(const int8_t* a,
                                                 const int8_t* b, int64_t i,
                                                 int64_t e, bool vec) {
  SplitGroup g;
  if (vec && i + GROUP <= e) {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      g.a[l] = __ldcs(reinterpret_cast<const unsigned int*>(a + l * e + i));
    g.b = __ldcs(reinterpret_cast<const unsigned int*>(b + i));
  } else {
    g.b = 0;
#pragma unroll
    for (int l = 0; l < 4; ++l) g.a[l] = 0;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (i + j < e) {
#pragma unroll
        for (int l = 0; l < 4; ++l)
          g.a[l] |= (u32(a[l * e + i + j]) & 0xFFu) << (8 * j);
        g.b |= (u32(b[i + j]) & 0xFFu) << (8 * j);
      }
    }
  }
  return g;
}

template <bool SIGNED>
__device__ __forceinline__ void store_group(const SplitGroup& g,
                                            int32_t* out, int64_t i,
                                            int64_t e, bool vec) {
  int32_t r[4][GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    int32_t p[4];
    mul4_elem<true, SIGNED>(byte_s8(g.a[0], j), byte_s8(g.a[1], j),
                            byte_s8(g.a[2], j), byte_s8(g.a[3], j),
                            byte_s8(g.b, j), p);
#pragma unroll
    for (int l = 0; l < 4; ++l) r[l][j] = p[l];
  }
  if (vec && i + GROUP <= e) {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      __stcs(reinterpret_cast<int4*>(out + l * e + i),
             make_int4(r[l][0], r[l][1], r[l][2], r[l][3]));
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (i + j < e) {
#pragma unroll
        for (int l = 0; l < 4; ++l) out[l * e + i + j] = r[l][j];
      }
  }
}

template <bool SIGNED>
__global__ void __launch_bounds__(SPLIT_THREADS)
    mul4_split_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ b,
                      int32_t* __restrict__ out, int64_t e, bool vec) {
  const int64_t groups = (e + GROUP - 1) / GROUP;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * SPLIT_THREADS;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * SPLIT_THREADS +
                   threadIdx.x;
       g < groups; g += stride)
    store_group<SIGNED>(load_group(a, b, g * GROUP, e, vec), out,
                        g * GROUP, e, vec);
}

// The split kernel's grid cap: SMs x its resident blocks on the current
// device, computed once per instantiation (an error is kept and returned
// by every launch).
struct GridCap {
  cudaError_t err;
  unsigned int blocks;
};

template <bool SIGNED>
GridCap split_grid_cap() {
  static const GridCap cap = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mul4_split_kernel<SIGNED>, SPLIT_THREADS, 0);
    return GridCap{err, static_cast<unsigned int>(sms * per_sm)};
  }();
  return cap;
}

template <bool SIGNED>
int launch_split(const int8_t* a, const int8_t* b, int32_t* out, int e,
                 bool vec, cudaStream_t s) {
  const GridCap cap = split_grid_cap<SIGNED>();
  if (cap.err != cudaSuccess) return static_cast<int>(cap.err);
  const int64_t blocks =
      ((static_cast<int64_t>(e) + GROUP - 1) / GROUP + SPLIT_THREADS - 1) /
      SPLIT_THREADS;
  const unsigned int grid = static_cast<unsigned int>(
      blocks < cap.blocks ? blocks : cap.blocks);
  mul4_split_kernel<SIGNED><<<grid, SPLIT_THREADS, 0, s>>>(a, b, out, e, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (4, e) int8, b: e int8, out: (4, e) int32, all contiguous.  Return
// cudaGetLastError() after the launch.  full32's vec: e % 16 == 0 and
// every pointer 16-byte aligned.
extern "C" int repro_mul4_full32(const void* a, const void* b, void* out,
                                 int e, int is_signed, int vec,
                                 void* stream) {
  const unsigned int grid = swar::blocks_for(e, PER_THREAD);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  if (is_signed)
    mul4_kernel<false, true><<<grid, swar::THREADS, 0, s>>>(pa, pb, po, e,
                                                            vec != 0);
  else
    mul4_kernel<false, false><<<grid, swar::THREADS, 0, s>>>(pa, pb, po, e,
                                                             vec != 0);
  return static_cast<int>(cudaGetLastError());
}

// split's vec: e % GROUP == 0 and every pointer 16-byte aligned.
extern "C" int repro_mul4_split(const void* a, const void* b, void* out,
                                int e, int is_signed, int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  return is_signed ? launch_split<true>(pa, pb, po, e, vec != 0, s)
                   : launch_split<false>(pa, pb, po, e, vec != 0, s);
}

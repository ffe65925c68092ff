// Shared integer helpers of the SWAR kernels (simd_add.cu, muladd2.cu,
// mul4.cu).
//
// The reference computes in wrapping int32 (and uint32) arithmetic.  In
// C++ a signed overflow is undefined, so every wrapping sum, product and
// shift here is done in uint32_t, and a value goes back to int32_t only
// through as_i32 (the two's-complement reading, defined for every bit
// pattern) and is shifted right only through asr (arithmetic, written
// out instead of relying on the implementation's >> of a negative int).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace swar {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;   // elements a thread owns (muladd2, mul4)

__device__ __forceinline__ uint32_t u32(int32_t v) {
  return static_cast<uint32_t>(v);    // modular conversion: always defined
}

__device__ __forceinline__ int32_t as_i32(uint32_t u) {
  return u <= 0x7FFFFFFFu ? static_cast<int32_t>(u)
                          : -static_cast<int32_t>(~u) - 1;
}

__device__ __forceinline__ int32_t asr(int32_t v, int s) {
  return v >= 0 ? (v >> s) : ~((~v) >> s);
}

// low 8-bit lane of p sign-extended, and the rest (p - lane) >> 8 -- the
// reference's extract_lane8(p, signed=True) in int32
__device__ __forceinline__ int32_t pop_lane8_signed(int32_t& p) {
  const int32_t lane = static_cast<int32_t>((u32(p) & 0xFFu) ^ 0x80u) - 0x80;
  p = asr(as_i32(u32(p) - u32(lane)), 8);
  return lane;
}

// A thread owns PER_THREAD consecutive elements and reads each int8 row
// of them with one 16-byte load: the warp's load instruction covers 512
// contiguous bytes.  Its 16 int32 results would leave as four 16-byte
// stores 64 bytes from its neighbour's, spreading each store instruction
// over 2 KB; so an output is staged through shared memory and stored by
// the block in coalesced 16-byte pieces instead (stage_out).
struct alignas(16) Bytes16 {
  int8_t v[PER_THREAD];
};

__device__ __forceinline__ Bytes16 load16(const int8_t* p, int64_t i,
                                          int64_t n, bool vec) {
  Bytes16 r;
  if (vec && i + PER_THREAD <= n) {
    *reinterpret_cast<int4*>(r.v) = *reinterpret_cast<const int4*>(p + i);
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) r.v[j] = i + j < n ? p[i + j] : 0;
  }
  return r;
}

// shared-memory words per block for stage_out; a row of PER_THREAD + 1
// words per thread keeps the column writes free of bank conflicts
constexpr int STAGE_WORDS = THREADS * (PER_THREAD + 1);

// Store this block's THREADS * PER_THREAD results (v: the calling thread's
// PER_THREAD consecutive ones) to out[base ...], masked at n.  Every
// thread of the block must call it (it synchronizes the block).
__device__ __forceinline__ void stage_out(const int32_t (&v)[PER_THREAD],
                                          int32_t* stage, int32_t* out,
                                          int64_t base, int64_t n,
                                          bool vec) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) stage[t * (PER_THREAD + 1) + j] = v[j];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < PER_THREAD / 4; ++s) {
    const int idx = (s * THREADS + t) * 4;      // block-local element
    const int64_t i = base + idx;
    int32_t w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = idx + m;
      w[m] = stage[(k / PER_THREAD) * (PER_THREAD + 1) + k % PER_THREAD];
    }
    if (vec && i + 4 <= n) {
      *reinterpret_cast<int4*>(out + i) = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (i + m < n) out[i + m] = w[m];
    }
  }
  __syncthreads();
}

inline unsigned int blocks_for(int64_t n, int per_thread) {
  const int64_t threads = (n + per_thread - 1) / per_thread;
  return static_cast<unsigned int>((threads + THREADS - 1) / THREADS);
}

}  // namespace swar

// w4a8 GEMM for Hopper: int8 x[M,K] @ packed int4 w[K,N/2] -> int32 acc
// [M,N] and/or the dequantized f32 ((float)acc * x_scale[M]) * w_scale[N].
// Word j of a weight row holds columns 2j and 2j+1:
// word = (w_even + 8) | (w_odd << 4).
//
// Replaces the TPU kernel repro/kernels/packed_matmul.py::
// packed_w4_matmul_acc (body _pmm_kernel, pallas_call at :61; wrapper
// packed_w4_matmul :73).
//
// Bound on an H100 SXM: at decode (M = batch) the weight bytes dominate,
// and they are HALF those of w8a8 -- K*N/2 bytes over 3.35 TB/s, 0.05 us
// for a 576x576 projection.  That is the paper's DSP packing (two narrow
// multiplies per wide unit) moved to the scarce resource of this card,
// memory bandwidth (DESIGN.md sec. 2).  At prefill the f32 output's
// 4*M*N bytes and the 2*M*K*N int8 operations (1,979 TOP/s peak) bound it,
// the same as w8a8.
// What the design does about it: weights cross device memory packed and
// are unpacked in registers (column 2j = (w & 0xF) - 8, column 2j+1 =
// w >> 4 on the signed byte) while being staged into shared memory, then
// feed the same int8 tensor-core tile as quant_matmul.cu.
//
// Padding: the TPU wrapper pads packed words with 0x08, which decodes to
// (0, 0); a zero byte would decode to -8.  Here out-of-range words are
// staged as 0x08 too, but correctness does not rest on it: the K tail of
// x is staged as zeros (s8_gemm.cuh) and columns >= N are never stored.
//
// For M <= 16 (decode rows) the wrapper launches the second entry point,
// repro_packed_w4_matmul_small_m: the column-split dp4a kernel of
// s8_small_m.cuh (whose note gives its bound and design) with the
// LoadW4Word loader, which reads each row's 2 packed bytes of 4 columns
// and unpacks them in registers, in place of the 64-row tensor-core tile.
#include "s8_gemm.cuh"
#include "s8_small_m.cuh"

namespace {

// Stage packed words w[k0:k0+BK, n0/2 : (n0+BN)/2] into Bs[n][k] as int8
// values.  NH = N / 2 words per row; vec: NH % 16 == 0 and w 16-byte
// aligned.
struct LoadW4 {
  __device__ __forceinline__ static void load(int8_t* Bs, const int8_t* w,
                                              int K, int N, int n0, int k0,
                                              bool vec) {
    using namespace s8gemm;
    constexpr int WORDS = BN / 2;                  // words per tile row
    constexpr int CHUNKS = BK * WORDS / 16;
    const int NH = N / 2;
#pragma unroll
    for (int it = 0; it < CHUNKS / THREADS; ++it) {
      const int c = threadIdx.x + it * THREADS;
      const int kr = c / (WORDS / 16), wc = (c % (WORDS / 16)) * 16;
      const int gk = k0 + kr, gw = n0 / 2 + wc;
      alignas(16) int8_t v[16];
      if (vec && gk < K && gw + 16 <= NH) {
        *reinterpret_cast<int4*>(v) =
            *reinterpret_cast<const int4*>(w + (size_t)gk * NH + gw);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          v[j] = (gk < K && gw + j < NH) ? w[(size_t)gk * NH + gw + j]
                                         : int8_t(0x08);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int b = v[j];                        // sign-extended byte
        Bs[(2 * (wc + j)) * LDS + kr] = int8_t((b & 0xF) - 8);
        Bs[(2 * (wc + j) + 1) * LDS + kr] = int8_t(b >> 4);
      }
    }
  }
};
static_assert(s8gemm::BK * s8gemm::BN / 2 / 16 % s8gemm::THREADS == 0,
              "packed tile must split evenly over the block");

__global__ void __launch_bounds__(s8gemm::THREADS)
    packed_w4_matmul_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ xs,
                            const float* __restrict__ ws,
                            int32_t* __restrict__ acc_out,
                            float* __restrict__ f_out, int M, int K, int N,
                            bool vec_x, bool vec_w) {
  s8gemm::gemm_tile<LoadW4>(x, w, xs, ws, acc_out, f_out, M, K, N, vec_x,
                            vec_w);
}

}  // namespace

// N is the LOGICAL column count (even); w holds K x N/2 words.  acc_out and
// f_out may each be null (then not written); xs/ws may be null when f_out
// is.  Returns cudaGetLastError() after the launch.
extern "C" int repro_packed_w4_matmul(const void* x, const void* w,
                                      const void* xs, const void* ws,
                                      void* acc_out, void* f_out, int M,
                                      int K, int N, int vec_x, int vec_w,
                                      void* stream) {
  packed_w4_matmul_kernel<<<s8gemm::grid_for(M, N), s8gemm::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<int32_t*>(acc_out), static_cast<float*>(f_out), M, K, N,
      vec_x != 0, vec_w != 0);
  return static_cast<int>(cudaGetLastError());
}

// The same contract for 1 <= M <= s8small::MAX_M (cudaErrorInvalidValue
// otherwise, nothing launched); vec_x means 4-byte x words (K % 4 == 0, x
// 4-byte aligned), vec_w 2-byte packed words (N % 4 == 0, w 2-byte
// aligned).
extern "C" int repro_packed_w4_matmul_small_m(const void* x, const void* w,
                                              const void* xs,
                                              const void* ws, void* acc_out,
                                              void* f_out, int M, int K,
                                              int N, int vec_x, int vec_w,
                                              void* stream) {
  return s8small::launch_small_m<s8small::LoadW4Word>(
      x, w, xs, ws, acc_out, f_out, M, K, N, vec_x, vec_w, stream);
}

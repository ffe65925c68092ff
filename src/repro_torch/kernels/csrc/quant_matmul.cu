// w8a8 GEMM for Hopper: int8 x[M,K] @ int8 w[K,N] -> int32 acc [M,N] and/or
// the dequantized f32 ((float)acc * x_scale[M]) * w_scale[N].
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul_acc
// (body _qmm_kernel, pallas_call at :52; wrapper quant_matmul :64).
//
// Two kernels, by the wrapper's rule on M (kernels/quant_matmul.py):
// - M > 16 (prefill): repro_quant_matmul, the tensor-core tile of
//   s8_tile.cuh (mma.sync m16n8k32 s8, a cp.async ring of raw x and w
//   tiles, the weights transposed in registers at the fragment reads);
//   its note gives the bound per prefill shape and the design.
// - M <= 16 (decode rows, which torch._int_mm refuses):
//   repro_quant_matmul_small_m, a column-split dp4a kernel
//   (s8_small_m.cuh, whose note gives its bound and design).
// The third entry, repro_quant_matmul_tile64, launches the 64x64 tile of
// s8_gemm.cuh that took M > 16 before s8_tile.cuh; the wrapper never
// binds it: chip_smoke.py times it beside the new tile in one run.
// repro_quant_matmul_grid reports the new tile's grid for a shape.
#include "s8_gemm.cuh"
#include "s8_small_m.cuh"
#include "s8_tile.cuh"

namespace {

// The 64x64 tile's loader: stage w[k0:k0+BK, n0:n0+BN] transposed into
// Bs[n][k]; zeros outside [K, N).  vec: N % 16 == 0 and w 16-byte aligned.
struct LoadW8 {
  __device__ __forceinline__ static void load(int8_t* Bs, const int8_t* w,
                                              int K, int N, int n0, int k0,
                                              bool vec) {
    using namespace s8gemm;
    constexpr int CHUNKS = BK * BN / 16;
#pragma unroll
    for (int it = 0; it < CHUNKS / THREADS; ++it) {
      const int c = threadIdx.x + it * THREADS;
      const int kr = c / (BN / 16), nc = (c % (BN / 16)) * 16;
      const int gk = k0 + kr, gn = n0 + nc;
      alignas(16) int8_t v[16];
      if (vec && gk < K && gn + 16 <= N) {
        *reinterpret_cast<int4*>(v) =
            *reinterpret_cast<const int4*>(w + (size_t)gk * N + gn);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          v[j] = (gk < K && gn + j < N) ? w[(size_t)gk * N + gn + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[(nc + j) * LDS + kr] = v[j];
    }
  }
};

template <bool VX, bool VW>
__global__ void __launch_bounds__(s8tile::THREADS)
    quant_matmul_tile_kernel(const int8_t* __restrict__ x,
                             const int8_t* __restrict__ w,
                             const float* __restrict__ xs,
                             const float* __restrict__ ws,
                             int32_t* __restrict__ acc_out,
                             float* __restrict__ f_out, int M, int K,
                             int N) {
  s8tile::gemm_tile<s8small::LoadW8Word, VX, VW>(x, w, xs, ws, acc_out,
                                                 f_out, M, K, N);
}

template <bool VX, bool VW>
void launch_tile(const void* x, const void* w, const void* xs,
                 const void* ws, void* acc_out, void* f_out, int M, int K,
                 int N, void* stream) {
  quant_matmul_tile_kernel<VX, VW>
      <<<s8tile::grid_for(M, N), s8tile::THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(xs), static_cast<const float*>(ws),
          static_cast<int32_t*>(acc_out), static_cast<float*>(f_out), M, K,
          N);
}

__global__ void __launch_bounds__(s8gemm::THREADS)
    quant_matmul_tile64_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ w,
                               const float* __restrict__ xs,
                               const float* __restrict__ ws,
                               int32_t* __restrict__ acc_out,
                               float* __restrict__ f_out, int M, int K,
                               int N, bool vec_x, bool vec_w) {
  s8gemm::gemm_tile<LoadW8>(x, w, xs, ws, acc_out, f_out, M, K, N, vec_x,
                            vec_w);
}

}  // namespace

// acc_out and f_out may each be null (then not written); xs/ws may be null
// when f_out is.  vec_x: K % 16 == 0 and x 16-byte aligned; vec_w:
// N % 16 == 0 and w 16-byte aligned.  Returns cudaGetLastError() after
// the launch.
extern "C" int repro_quant_matmul(const void* x, const void* w,
                                  const void* xs, const void* ws,
                                  void* acc_out, void* f_out, int M, int K,
                                  int N, int vec_x, int vec_w,
                                  void* stream) {
  if (vec_x && vec_w)
    launch_tile<true, true>(x, w, xs, ws, acc_out, f_out, M, K, N, stream);
  else if (vec_x)
    launch_tile<true, false>(x, w, xs, ws, acc_out, f_out, M, K, N, stream);
  else if (vec_w)
    launch_tile<false, true>(x, w, xs, ws, acc_out, f_out, M, K, N, stream);
  else
    launch_tile<false, false>(x, w, xs, ws, acc_out, f_out, M, K, N,
                              stream);
  return static_cast<int>(cudaGetLastError());
}

// The number of blocks repro_quant_matmul launches for an M x N output
// (s8tile::grid_for; a host function, nothing runs on the card).
extern "C" int repro_quant_matmul_grid(int M, int N) {
  return static_cast<int>(s8tile::grid_for(M, N).x);
}

// The same contract on the 64x64 tile of s8_gemm.cuh (any M >= 1).
extern "C" int repro_quant_matmul_tile64(const void* x, const void* w,
                                         const void* xs, const void* ws,
                                         void* acc_out, void* f_out, int M,
                                         int K, int N, int vec_x, int vec_w,
                                         void* stream) {
  quant_matmul_tile64_kernel<<<s8gemm::grid_for(M, N), s8gemm::THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<int32_t*>(acc_out), static_cast<float*>(f_out), M, K, N,
      vec_x != 0, vec_w != 0);
  return static_cast<int>(cudaGetLastError());
}

// The same contract for 1 <= M <= s8small::MAX_M (cudaErrorInvalidValue
// otherwise, nothing launched); vec_x / vec_w here mean 4-byte words
// (K % 4 == 0, N % 4 == 0, 4-byte aligned pointers).
extern "C" int repro_quant_matmul_small_m(const void* x, const void* w,
                                          const void* xs, const void* ws,
                                          void* acc_out, void* f_out, int M,
                                          int K, int N, int vec_x,
                                          int vec_w, void* stream) {
  return s8small::launch_small_m<s8small::LoadW8Word>(
      x, w, xs, ws, acc_out, f_out, M, K, N, vec_x, vec_w, stream);
}

// w8a8 GEMM for Hopper: int8 x[M,K] @ int8 w[K,N] -> int32 acc [M,N] and/or
// the dequantized f32 ((float)acc * x_scale[M]) * w_scale[N].
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul_acc
// (body _qmm_kernel, pallas_call at :52; wrapper quant_matmul :64).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1,979 TOP/s dense int8): at decode
// (M = batch, e.g. 8) the weight bytes dominate -- K*N bytes, 0.10 us for
// a 576x576 projection -- so the kernel is bound by memory and, at these
// tiny sizes, by launch and load latency.  At prefill (M = B*S, e.g.
// 1024) the f32 output's 4*M*N bytes (1.9 us for 1024x576x1536) outweigh
// the 2*M*K*N int8 operations (0.91 us).  What the design does about it:
// int8 operands go straight to the tensor cores (mma.sync m16n8k32 s8,
// int32 accumulation, exact), each weight byte is read from device memory
// once per 64-row block of x, deep 256-k steps keep many loads in flight
// per round trip, and the dequant epilogue is fused so the int32
// accumulator never leaves registers.  Multi-stage copies (cp.async /
// TMA), wgmma, split-K for the few-block decode grid and a bf16 output
// are left to a later tuning pass.
//
// For M <= 16 (decode rows, which torch._int_mm refuses) the wrapper
// launches the second entry point, repro_quant_matmul_small_m: a
// column-split dp4a kernel (s8_small_m.cuh, whose note gives its bound
// and design) in place of the 64-row tensor-core tile.
#include "s8_gemm.cuh"
#include "s8_small_m.cuh"

namespace {

// Stage w[k0:k0+BK, n0:n0+BN] transposed into Bs[n][k]; zeros outside
// [K, N).  vec: N % 16 == 0 and w 16-byte aligned.
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

__global__ void __launch_bounds__(s8gemm::THREADS)
    quant_matmul_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ xs,
                        const float* __restrict__ ws,
                        int32_t* __restrict__ acc_out,
                        float* __restrict__ f_out, int M, int K, int N,
                        bool vec_x, bool vec_w) {
  s8gemm::gemm_tile<LoadW8>(x, w, xs, ws, acc_out, f_out, M, K, N, vec_x,
                            vec_w);
}

}  // namespace

// acc_out and f_out may each be null (then not written); xs/ws may be null
// when f_out is.  Returns cudaGetLastError() after the launch.
extern "C" int repro_quant_matmul(const void* x, const void* w,
                                  const void* xs, const void* ws,
                                  void* acc_out, void* f_out, int M, int K,
                                  int N, int vec_x, int vec_w,
                                  void* stream) {
  quant_matmul_kernel<<<s8gemm::grid_for(M, N), s8gemm::THREADS, 0,
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

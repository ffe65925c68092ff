// w8a8 GEMM for Hopper: int8 x[M,K] @ int8 w[K,N] -> int32 acc [M,N] and/or
// the dequantized f32 ((float)acc * x_scale[M]) * w_scale[N].
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul_acc
// (body _qmm_kernel, pallas_call at :52; wrapper quant_matmul :64).
//
// Two kernels, by the wrapper's rule on M (kernels/quant_matmul.py):
// - M > 16 (prefill): repro_quant_matmul, the tensor-core tile of
//   s8_tile.cuh with int8 weights (loader TileW8: mma.sync m16n8k32 s8, a
//   cp.async ring of raw x and w tiles, the weights transposed in
//   registers at the fragment reads); its note gives the bound per
//   prefill shape and the design.
// - M <= 16 (decode rows, which torch._int_mm refuses):
//   repro_quant_matmul_small_m, a column-split dp4a kernel
//   (s8_small_m.cuh, whose note gives its bound and design).
// repro_quant_matmul_grid reports the tile's grid for a shape.
#include "s8_small_m.cuh"
#include "s8_tile.cuh"

// acc_out and f_out may each be null (then not written); xs/ws may be null
// when f_out is.  vec_x: K % 16 == 0 and x 16-byte aligned; vec_w:
// N % 16 == 0 and w 16-byte aligned.  Returns cudaGetLastError() after
// the launch.
extern "C" int repro_quant_matmul(const void* x, const void* w,
                                  const void* xs, const void* ws,
                                  void* acc_out, void* f_out, int M, int K,
                                  int N, int vec_x, int vec_w,
                                  void* stream) {
  return s8tile::launch_tile<s8tile::TileW8>(
      x, w, xs, ws, acc_out, f_out, 1, M, K, N, vec_x, vec_w,
      s8small::ExpertStrides{}, stream);
}

// The number of blocks repro_quant_matmul launches for an M x N output
// (s8tile::grid_for; a host function, nothing runs on the card).
extern "C" int repro_quant_matmul_grid(int M, int N) {
  return static_cast<int>(s8tile::grid_for(M, N).x);
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
      x, w, xs, ws, acc_out, f_out, 1, M, K, N, vec_x, vec_w,
      s8small::ExpertStrides{}, stream);
}

// Expert-stacked weights, one launch for all E experts (blockIdx.y =
// e): w [E, K, N], w_scale [E, N], outputs [E, M, N]; x [E, M, K]
// and x_scale [E, M] with x_per_expert, else one x [M, K] and x_scale [M]
// for every expert.  The tile (repro_quant_matmul_experts) and the
// small-M kernel (repro_quant_matmul_small_m_experts), each with the contract
// of its 2-D entry above per expert; E = 1 gives the 2-D entry's result
// bit for bit.  cudaErrorInvalidValue (nothing launched) for E outside
// 1..65535.
extern "C" int repro_quant_matmul_experts(
    const void* x, const void* w, const void* xs, const void* ws,
    void* acc_out, void* f_out, int E, int M, int K, int N, int x_per_expert,
    int vec_x, int vec_w, void* stream) {
  return s8tile::launch_tile<s8tile::TileW8>(
      x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x, vec_w,
      s8small::expert_strides(M, K, N, N, x_per_expert != 0), stream);
}

extern "C" int repro_quant_matmul_small_m_experts(
    const void* x, const void* w, const void* xs, const void* ws,
    void* acc_out, void* f_out, int E, int M, int K, int N, int x_per_expert,
    int vec_x, int vec_w, void* stream) {
  return s8small::launch_small_m<s8small::LoadW8Word>(
      x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x, vec_w,
      s8small::expert_strides(M, K, N, N, x_per_expert != 0), stream);
}

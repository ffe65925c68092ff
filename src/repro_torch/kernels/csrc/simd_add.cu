// SWAR SIMD add/sub on packed 32-bit words for Hopper: four 8-bit or two
// 16-bit lanes per word, each lane wrapping on its own (carry-kill):
//
//   add: ((x & ~H) + (y & ~H)) ^ ((x ^ y) & H)
//   sub: ((x | H) - (y & ~H)) ^ ((x ^ ~y) & H)      H = each lane's MSB
//
// Replaces the TPU kernel repro/kernels/simd_add.py::simd_add_packed
// (body _swar_kernel :24, pallas_call :58; wrapper simd_add :70) and its
// Pallas-Triton variant repro/kernels/gpu_pallas.py::simd_add_packed :57.
//
// Bound on an H100 SXM: 8 bytes read and 4 written per word at 3.35 TB/s
// (e.g. 2^22 words: 50 MB, 15 us); the arithmetic is five integer ops per
// word.  What the design does about it: one thread owns four consecutive
// words and moves them with one 16-byte load per operand and one 16-byte
// store, so a warp reads 512 contiguous bytes per operand per request;
// the ragged tail is masked word by word.  The words are uint32 bit
// patterns (int32 tensors in PyTorch); all arithmetic is unsigned.
#include "swar.cuh"

namespace {

__device__ __forceinline__ uint32_t swar_op(uint32_t x, uint32_t y,
                                            uint32_t h, bool sub) {
  const uint32_t nh = ~h;
  return sub ? ((x | h) - (y & nh)) ^ ((x ^ ~y) & h)
             : ((x & nh) + (y & nh)) ^ ((x ^ y) & h);
}

__global__ void __launch_bounds__(swar::THREADS)
    simd_add_kernel(const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                    int64_t n, uint32_t h, bool sub, bool vec) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (vec && i + 4 <= n) {
    const uint4 a = *reinterpret_cast<const uint4*>(x + i);
    const uint4 b = *reinterpret_cast<const uint4*>(y + i);
    uint4 r;
    r.x = swar_op(a.x, b.x, h, sub);
    r.y = swar_op(a.y, b.y, h, sub);
    r.z = swar_op(a.z, b.z, h, sub);
    r.w = swar_op(a.w, b.w, h, sub);
    *reinterpret_cast<uint4*>(out + i) = r;
  } else {
    for (int64_t j = i; j < i + 4 && j < n; ++j)
      out[j] = swar_op(x[j], y[j], h, sub);
  }
}

}  // namespace

// x, y, out: n words each.  lane_bits is 8 or 16 (checked by the
// wrapper); vec: all three pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_simd_add_packed(const void* x, const void* y, void* out,
                                     int n, int lane_bits, int sub, int vec,
                                     void* stream) {
  const uint32_t h = lane_bits == 8 ? 0x80808080u : 0x80008000u;
  simd_add_kernel<<<swar::blocks_for(n, 4), swar::THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<uint32_t*>(out), n, h, sub != 0, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

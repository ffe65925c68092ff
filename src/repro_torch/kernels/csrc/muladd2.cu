// Factor-2 shared-operand MAD chains for Hopper (wp486, paper Eq. 1): for
// stacked int8 operands a, b, c of shape (n, E),
//
//   P   = sum_i (a_i * 2^16 + b_i) * c_i     one 32-bit multiply per i
//   p_b = sign_extend_16(P mod 2^16)         exact while |p_b| < 2^15,
//   p_a = (P - p_b) >> 16                    the Eq. 2 chain bound
//
// Replaces the TPU kernel repro/kernels/muladd2.py::muladd2 (:36, body
// _muladd2_kernel :27, pallas_call :67) and its Pallas-Triton variant
// repro/kernels/gpu_pallas.py::muladd2 :103.
//
// Bound on an H100 SXM: 3n bytes read and 8 written per element at
// 3.35 TB/s (n=1, E=2^24: 184 MB, 55 us); 2n integer multiply-adds per
// element are far below the integer rate.  What the design does about
// it: the TPU grid's sequential block walk becomes one thread per 16
// consecutive elements, which walks the n chain rows itself with one
// 16-byte load of a, b and c per row and keeps the 16 packed sums in
// registers; both results go out through shared memory in coalesced
// 16-byte stores (swar.cuh, stage_out).  All wrapping arithmetic is
// uint32 (swar.cuh).
#include "swar.cuh"

namespace {

using swar::PER_THREAD;

__global__ void __launch_bounds__(swar::THREADS)
    muladd2_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const int8_t* __restrict__ c, int32_t* __restrict__ pa,
                   int32_t* __restrict__ pb, int n, int64_t e, bool vec) {
  __shared__ int32_t stage[swar::STAGE_WORDS];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * swar::THREADS * PER_THREAD;
  const int64_t i = base + threadIdx.x * PER_THREAD;
  uint32_t acc[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) acc[j] = 0;
  for (int k = 0; k < n && i < e; ++k) {
    const int64_t row = static_cast<int64_t>(k) * e;
    const swar::Bytes16 va = swar::load16(a + row, i, e, vec);
    const swar::Bytes16 vb = swar::load16(b + row, i, e, vec);
    const swar::Bytes16 vc = swar::load16(c + row, i, e, vec);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      acc[j] += ((swar::u32(va.v[j]) << 16) + swar::u32(vb.v[j])) *
                swar::u32(vc.v[j]);
  }
  int32_t ra[PER_THREAD], rb[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int32_t lo =
        static_cast<int32_t>((acc[j] & 0xFFFFu) ^ 0x8000u) - 0x8000;
    rb[j] = lo;
    ra[j] = swar::asr(swar::as_i32(acc[j] - swar::u32(lo)), 16);
  }
  swar::stage_out(ra, stage, pa, base, e, vec);
  swar::stage_out(rb, stage, pb, base, e, vec);
}

}  // namespace

// a, b, c: (n, e) int8, contiguous; pa, pb: e int32.  vec: e % 16 == 0
// and every pointer 16-byte aligned.  Returns cudaGetLastError().
extern "C" int repro_muladd2(const void* a, const void* b, const void* c,
                             void* pa, void* pb, int n, int e, int vec,
                             void* stream) {
  muladd2_kernel<<<swar::blocks_for(e, PER_THREAD), swar::THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int8_t*>(c), static_cast<int32_t*>(pa),
      static_cast<int32_t*>(pb), n, e, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

// w4a8 GEMM for Hopper: int8 x[M,K] @ packed int4 w[K,N/2] -> int32 acc
// [M,N] and/or the dequantized f32 ((float)acc * x_scale[M]) * w_scale[N].
// Word j of a weight row holds columns 2j and 2j+1:
// word = (w_even + 8) | (w_odd << 4).
//
// Replaces the TPU kernel repro/kernels/packed_matmul.py::
// packed_w4_matmul_acc (body _pmm_kernel, pallas_call at :61; wrapper
// packed_w4_matmul :73).
//
// Two kernels, by the wrapper's rule on M (kernels/packed_matmul.py, the
// rule of quant_matmul):
// - M > 16 (prefill): repro_packed_w4_matmul, the tensor-core tile of
//   s8_tile.cuh with the packed loader TileW4 (below);
// - M <= 16 (decode rows): repro_packed_w4_matmul_small_m, the
//   column-split dp4a kernel of s8_small_m.cuh (whose note gives its
//   bound and design) with the LoadW4Word loader, which reads each row's
//   2 packed bytes of 4 columns and unpacks them in registers.
// repro_packed_w4_matmul_grid reports the tile's grid for a shape.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 1,979 TOP/s dense int8): at
// decode (M = batch) the weight bytes dominate, and they are HALF those
// of w8a8 -- K*N/2 bytes, 0.05 us for a 576x576 projection.  That is the
// paper's DSP packing (two narrow multiplies per wide unit) moved to the
// scarce resource of this card, memory bandwidth (DESIGN.md sec. 2).  At
// prefill (M = 1024) a launch reads x (M*K), the packed weights (K*N/2)
// and the scales and writes the f32 output (4*M*N), bytes again: 0.93 /
// 0.43 / 2.19 / 1.31 us for (K, N) = 576x576 / 576x192 / 576x1536 /
// 1536x576 (w8a8: 0.98 / 0.45 / 2.32 / 1.44), where the 2*M*K*N int8
// operations take 0.34 / 0.11 / 0.92 / 0.92 us.
//
// The prefill tile.  What held the first 64x64 tile that took these rows
// back, and what the packed loader of s8_tile.cuh does about each:
// 1. It unpacked each packed byte while staging it, into two int8 values
//    stored transposed ([n][k]) one byte at a time: two shared-memory
//    stores per byte, each with a 4-way bank conflict.  Here the packed
//    bytes are staged raw ([k][N/2] as they lie in device memory, 32
//    bytes per k row of a 64-column block: 2 KB per step against 4 KB of
//    int8) by 16-byte cp.async copies, issued by the first 128 threads,
//    and unpacked in registers at the fragment reads: thread (g, t) reads
//    one 16-bit half-word (the 4 columns 4g..4g+3) of each of 4
//    consecutive k rows, and LoadW4Word::columns -- the small-M kernel's
//    unpacking, 4 __byte_perm, nibble masks and a 4-bit sign extension
//    per byte -- gives its B fragments for all 4 n8 tiles.
// 2. Four 32-byte rows share a 128-byte line, so the fragment read's
//    rows 4 apart (t = 0..3) would sit at the same offset of consecutive
//    lines, a 4-way conflict.  The swizzle swz4 of s8_tile.cuh moves
//    them to 4 distinct chunks; every staging store and fragment read is
//    conflict free (checked in tests/test_torch_tile.py's emulation).
// 3. Its serial load -> barrier -> mma chain had nothing in flight; its
//    256-deep K step left the last step of K = 576 75% zeros; it stored
//    single floats.  The tile's ring of STAGES cp.async stages, its two
//    K groups of 4 warps, BK = 64 and its 16-byte epilogue serve both
//    loaders alike (s8_tile.cuh's note).
// What paces it (scripts/tile_sweep.py, a lone block, K = 64 -> 1536):
// a packed block-step copies 6 KB (4 KB of x, 2 KB of w) against int8's
// 8 KB, yet costs ~0.31 us against ~0.26: the unpacking's ALU work
// (per thread and k16 half of a substep, 4 __byte_perm and ~20 mask,
// shift and sign-extension instructions, against the int8 transpose's 8
// __byte_perm), not the bytes, sets the pace.
//
// Padding: a zero packed byte (what cp.async's zero fill and the byte
// path stage outside [K, N)) decodes to (-8, 0), not (0, 0); the TPU
// wrapper pads with 0x08 instead.  The tile does not rest on either: in
// rows >= K the x tile holds zeros at the same k, and columns >= N are
// never stored.  The vector path of w needs N/2 % 16 == 0 (N % 32 == 0)
// and a 16-byte aligned w; otherwise (N = 34: 17 bytes per row) each
// chunk is gathered byte by byte.
#include "s8_small_m.cuh"
#include "s8_tile.cuh"

// N is the LOGICAL column count (even); w holds K x N/2 bytes.  acc_out
// and f_out may each be null (then not written); xs/ws may be null when
// f_out is.  vec_x: K % 16 == 0 and x 16-byte aligned; vec_w:
// N/2 % 16 == 0 and w 16-byte aligned.  Returns cudaGetLastError() after
// the launch.
extern "C" int repro_packed_w4_matmul(const void* x, const void* w,
                                      const void* xs, const void* ws,
                                      void* acc_out, void* f_out, int M,
                                      int K, int N, int vec_x, int vec_w,
                                      void* stream) {
  return s8tile::launch_tile<s8tile::TileW4>(
      x, w, xs, ws, acc_out, f_out, 1, M, K, N, vec_x, vec_w,
      s8small::ExpertStrides{}, stream);
}

// The number of blocks repro_packed_w4_matmul launches for an M x N
// output (s8tile::grid_for; a host function, nothing runs on the card).
extern "C" int repro_packed_w4_matmul_grid(int M, int N) {
  return static_cast<int>(s8tile::grid_for(M, N).x);
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
      x, w, xs, ws, acc_out, f_out, 1, M, K, N, vec_x, vec_w,
      s8small::ExpertStrides{}, stream);
}

// Expert-stacked weights, one launch for all E experts (blockIdx.y =
// e): w [E, K, N/2], w_scale [E, N], outputs [E, M, N]; x [E, M, K]
// and x_scale [E, M] with x_per_expert, else one x [M, K] and x_scale [M]
// for every expert.  The tile (repro_packed_w4_matmul_experts) and
// the small-M kernel (repro_packed_w4_matmul_small_m_experts), each
// with the contract of its 2-D entry above per expert; E = 1 gives the
// 2-D entry's result bit for bit.  cudaErrorInvalidValue (nothing
// launched) for E outside 1..65535.
extern "C" int repro_packed_w4_matmul_experts(
    const void* x, const void* w, const void* xs, const void* ws,
    void* acc_out, void* f_out, int E, int M, int K, int N, int x_per_expert,
    int vec_x, int vec_w, void* stream) {
  return s8tile::launch_tile<s8tile::TileW4>(
      x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x, vec_w,
      s8small::expert_strides(M, K, N, N / 2, x_per_expert != 0), stream);
}

extern "C" int repro_packed_w4_matmul_small_m_experts(
    const void* x, const void* w, const void* xs, const void* ws,
    void* acc_out, void* f_out, int E, int M, int K, int N, int x_per_expert,
    int vec_x, int vec_w, void* stream) {
  return s8small::launch_small_m<s8small::LoadW4Word>(
      x, w, xs, ws, acc_out, f_out, E, M, K, N, vec_x, vec_w,
      s8small::expert_strides(M, K, N, N / 2, x_per_expert != 0), stream);
}

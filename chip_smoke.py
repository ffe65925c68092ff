#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # from the repository root, one H100

Phases (any failure ends the run nonzero; nothing is caught and passed
over):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
   then the scan gate: `make_fx` on this torch must keep a scan body as
   a sub-GraphModule that feeds one `torch.ops.higher_order.scan` node
   (the pass pipeline recurses into it; there is no fallback to an
   unrolled loop);
2. build all five Hopper kernels from `src/repro_torch/kernels/csrc` into
   the git-ignored `build/` (one nvcc per source, started together),
   timed, beside `nvcc -Xptxas -v` of quant_matmul.cu,
   packed_w4_matmul.cu and mul4.cu (registers, shared memory and spills
   per kernel);
3. each GEMM kernel against its plain PyTorch version at every main-path
   (K, N) with decode M=8 and prefill M=1024, plus ragged shapes on both
   sides of the switch that quant_matmul and packed_w4_matmul share
   (M <= 16: the small-M kernel, with int8 or packed-int4 weights; M > 16:
   the tile of s8_tile.cuh, with int8 or packed-int4 weights -- N/2 odd
   among the ragged shapes; each call must go through the kernel the rule
   picks): the int32 accumulator and the f32 output must be bit-identical
   (`torch.equal`); then per-launch times of the kernel, the plain
   version and `torch._int_mm` where the shape is legal for it (w8a8:
   `library_ms`; w4a8, after an unpack: `yardstick_ms`, since no one
   PyTorch call takes packed int4).  Beside each decode row,
   `torch._int_mm` on x zero-padded to 32 rows (pad + one call; not
   `library_ms`, which is one call on the same inputs); beside each
   prefill row, in the log only, the grid the tile's launcher reports
   (`repro_quant_matmul_grid`, `repro_packed_w4_matmul_grid`) and the
   share of the bound.  Then both small-M kernels at M=8, K=2^17+1 with
   x = w = -128: the int8 sums leave the int32 range and must wrap as
   the plain version's do (ROADMAP C5).  Then both GEMM kernels, bit for
   bit at decode M=8 and prefill M=1024, at every (K, N) of qwen1.5-0.5b,
   yi-6b and command-r-35b that reaches a kernel (up to command-r's
   lm_head, K=8192 N=256000, which the plain version multiplies in
   column slices), each shape's per-launch time beside its bound;
4. each SWAR kernel (simd_add_packed, muladd2, mul4_full32, mul4_split)
   against its plain version at ragged shapes: both lane widths, add and
   sub, k = 1..lanes; chains of 1, 9 and 31; mul4 signed and unsigned,
   with b aligned and b one byte off (no vector path);
5. the SILVIA pass pipeline (`repro_torch.core.optimize`) over the
   paper's programs at card size (inputs from a seeded torch.Generator):
   each program's packed-unit count must match the reference passes',
   one call of each optimized program must launch exactly its kernels,
   its outputs must equal the unoptimized program's and a forced-`ref`
   rerun's (which launches nothing); time per call optimized and
   unoptimized.  MMM and MMM-4b pack inside a scan body, so one call
   launches muladd2 / mul4_full32 once per body call (K times, plus
   one more on torch 2.11, whose eager scan calls the body once first
   to infer shapes: `scan_extra_calls`); one
   optimized call of each runs under the profiler, beside its host
   time: the body kernels' launches and device time.  Off the path, MobileNet-4b packed by hand on mul4_split
   must equal the packed program.  Then each SWAR kernel is gated again
   and timed at the operands its wrapper recorded on the path (mul4_split
   at mul4_full32's), beside its plain version, its bound and (simd_add)
   `torch.add` on the words viewed as int8/int16;
6. greedy generation with full-width smollm-135m (30 layers, d_model 576,
   random weights from a seeded torch.Generator): B=8, prompt 128, 32 new
   tokens, under w4a8 and then w8a8, by the per-step loop
   (`fused=False`) and by the captured CUDA-graph decode step
   (`fused=True`, the default and the main path: its counts are set to 0
   just before it and read just after).  In each, the format's GEMM must
   launch 7 x 30 x 32 = 6720 times and the other format's 0 times; its
   small-M kernel takes the 7 x 30 x 31 = 6510 decode launches and its
   tile the 210 prefill launches.  The per-step loop's launches are its
   wrappers' counts.  A replay of the captured graph launches without
   the wrappers, so the main path runs under the profiler and its
   launches are the device kernels it saw, by symbol
   (`registry.profiled_launches`; a run the profiler counts short, and
   never over, is driven again, at most three times); its wrappers must
   count the prefill's 210 tile launches and nothing else (no decode
   step ran eagerly), and the first fused call's the capture's warm-up
   step and capture on top.
   The fused tokens and logits must equal the per-step loop's, and a rerun with the plain versions forced must give
   identical tokens AND logits (the kernels are bit-exact); `--silvia
   all` must give the tokens of off.  Logged: prefill ms, decode ms/step
   of both loops, the capture time, and profiles of an eager and a
   replayed decode step (host and device ms/step, busy share, top
   kernels, the small-M kernel's per-launch time against its back-to-back
   time); a reduced model must agree with its CPU run;
7. the rest of the dense family at full width, each path through the
   gates of 6 (`_serve_gates`; its main path's counts from 0): yi-6b
   cut to 16 of its 32 layers (`YI_LAYERS`; every width kept) under w4a8
   and w8a8 (7 x 16 x 32 GEMM launches plus the untied lm_head's 32,
   counted by its weight's width), qwen1.5-0.5b under w8a8
   with the int8 KV cache and nonzero q/k/v biases (its logits within
   INT8_KV_REL of the largest against the bf16 cache's at the first and
   last step, teacher-forced), each with a profile of a replayed step;
   then yi-6b's prefill (16 layers), B=2, 2048 tokens, in a float32
   config (w4a8),
   with attn_q_chunk=512 against unchunked: logits within CHUNK_REL of
   the largest and a lower peak of allocated memory;
8. the MoE family: both GEMM kernels on expert-stacked weights, one
   launch per [E, K, N] weight (the experts on the grid's y axis), bit
   for bit against the batched plain versions at granite's expert
   widths (E = 32) and arctic's (an E = 4 slice), M = 1, 8, 16, 17,
   1024 rows per expert, x per expert and x shared by all (expert stride
   0), E = 1 against the 2-D entry, and one arctic-shaped stack of
   4.46 GB (E = 128, past 2^31 bytes: size_t expert offsets), each
   timed beside its bound (`phase_moe_gemms`); then full-width
   granite-moe-1b-a400m (24 layers, 32 experts, vocab 49155; random
   weights, seed 0) under w4a8 and w8a8 through the gates of 6
   (`_serve_gates`: 169 small-M launches per replayed decode step, 168
   tile launches per prefill; the odd vocab's head in w8a8 under both
   formats), `--silvia all` == off, a replayed step's profile, its GEMM
   kernels' time per generate beside their bounds and the step's
   weight-byte bound with every expert read (`phase_moe`);
9. the SSM family: both GEMM kernels bit for bit at mamba2-2.7b's
   widths, in_proj (K 2560, N 10576) and out_proj (5120, 2560), at M = 8
   and the prefill's M = 2048 (the fixed chunk grid pads the 128-token
   prompt to 256), each timed beside its bound with its w-load path (the
   packed tile's rows of 5288 bytes are not a multiple of 16: the byte
   path); then mamba2-2.7b at every width, cut to 16 of its 64 layers
   (`SSM_LAYERS`; tied vocab 50280; random weights, seed 0) under w4a8
   and w8a8 through the gates of 6 (`_serve_gates`: 32 tile launches per
   prefill, 32 small-M launches per replayed decode step; the captured
   step's static buffers are the {ssm, conv} state), `--silvia all` ==
   off, a replayed step's profile, rows 1-2's time per generate beside
   their bounds, and decode ms/step beside the byte bound with and
   without the state's read and write (0.336 GB of float32 state each
   way at B=8 and 16 layers); the reduced model's
   prefill and decode against its CPU run (`phase_ssm`);
10. the hybrid family (`phase_hybrid`): reduced jamba at 2 scan units
   (16 layers, float32) on the card against its CPU run, teacher-forced
   one GEMM and one MoE layer at a time (`teacher_forced_vs_cpu`: at the
   prefill and every decode step each GEMM's output from the CPU's input
   bit for bit, each GEMM's and MoE layer's input, the logits and the
   cache within CARD_CPU_RTOL); both GEMM kernels bit for bit at every
   jamba width, M = 8 and the prefill's M (2048 for the mixers' in_proj
   (4096, 16544) and out_proj (8192, 4096), on the fixed chunk grid;
   1024 for attention, the dense MLP and the head (4096, 65536)) and on
   the [16, 4096, 14336] / [16, 14336, 4096] expert stacks (wi / wg on a
   shared x of expert stride 0, wo per expert; the plain versions walk
   them an expert at a time), each timed beside its bound and its
   w-load path (`phase_hybrid_gemms`); then jamba-v0.1-52b at every
   width, cut to 2 of its 4 scan units (`HYBRID_UNITS`; 16 experts on
   every other layer, 7 SSD mixers and one attention layer per unit,
   untied vocab 65536; random weights from seed 0, built a [K, N] matrix
   at a time by `serve.build_params`, its time and peak memory logged,
   the w4a8 tree freed before the w8a8 one is built) under w4a8 and
   w8a8 through the gates of 6 (`_serve_gates`: 84 tile launches per
   prefill, 85 small-M per replayed step; the captured step's static
   buffers are the flat hybrid cache), `--silvia all` == off, the
   profiles of a replayed step and a prefill, rows 1-2's time per
   generate beside their bounds and decode ms/step beside the byte
   bound with and without the state and KV traffic;
11. the encoder-decoder family (`phase_encdec`): reduced whisper (2 + 2
   layers, float32) on the card against its CPU run, teacher-forced as
   in 10 on (features, dec_tokens); both GEMM kernels bit for bit at
   whisper-small's four (K, N), (768, 768), (768, 3072), (3072, 768)
   and the odd head (768, 51865) (w8a8 only: an odd N has no packed
   weight), at M = 8, 1024 (the decoder's prompt) and 12000 (the
   encoder's 8 x 1500 frames and the cross k, v on the memory), each
   timed beside its bound; then full-width whisper-small (12 encoder and
   12 decoder layers, d 768, 12 heads, d_ff 3072, untied vocab 51865;
   nothing cut; random weights from seed 0) on 1500 seeded frames per
   row, B=8, a decoder prompt of 128, 32 new tokens, under w4a8 and
   w8a8 through the gates of 6 (`_serve_gates`, which takes the
   (features, dec_tokens) tuple: 192 tile launches per prefill, 97
   small-M per replayed step, the head in w8a8 under w4a8; the captured
   step's static buffers are the self KV and the 0.442 GB of cross K/V
   for 1500 frames), `--silvia all` == off and its ms/step, the
   encoder's peak memory, the profiles of a replayed step and a
   prefill, rows 1-2's time per generate beside their bounds and decode
   ms/step beside the byte bound with and without the KV read (cross
   and self);
12. the vlm family (`phase_vlm`): reduced qwen2-vl (2 layers, float32,
   M-RoPE sections (2, 3, 3), nonzero q/k/v biases) on the card against
   its CPU run on an image prompt (stub patch embeddings between text
   embeddings, Qwen2-VL's 3-row positions: the patches share one
   temporal position), teacher-forced as in 10; both GEMM kernels bit
   for bit at qwen2-vl-72b's five (K, N), (8192, 8192), (8192, 1024),
   (8192, 29568), (29568, 8192) and the head (8192, 152064), at M = 8,
   1024 and 3072, each timed beside its bound with its w-load path (the
   plain versions take the 2-D weights past ref.PLAIN_EXPERT_BYTES in
   column slices); then full-width qwen2-vl-72b (80 layers, d 8192, 64
   heads over 8 KV heads, d_ff 29568, untied vocab 152064, M-RoPE
   sections (16, 24, 24) at theta 1e6; nothing cut; random weights from
   seed 0, q/k/v biases drawn nonzero, built a [K, N] matrix at a time;
   the w4a8 tree freed before the w8a8 one is built; build time,
   resident memory and each stage's peak logged) under w4a8 and w8a8:
   token traffic (B=8, prompt 128, 32 new tokens) through the gates of
   6 (`_serve_gates`: 560 tile launches per prefill, 561 small-M per
   replayed step), `--silvia all` == off, the profiles of a replayed
   step and a prefill, rows 1-2's time per generate beside their bounds
   and decode ms/step beside the byte bound (weights and the KV read);
   then image traffic (`vlm_image_traffic`): B=8 rows of 8 text
   tokens, one 448 x 448 image as 256 seeded patch embeddings (a 16 x
   16 grid of merged patches) and 120 text tokens, with their 3-row
   positions (`image_positions`), through `lm.prefill` (560 tile
   launches at M = 3072; equal rows == the default positions bit for
   bit; the image's positions move the logits) and 31 replays of the
   captured decode step, bit for bit the per-step loop's.  Each phase's
   seconds are logged.

Then it prints the `kernels` JSON line (rows 1-2 with the other paths'
launches, the MoE, SSM, hybrid, encdec and vlm paths' included, and
those paths' GEMM time per generate), the nvidia-smi line and, last,
{"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense int8 tensor peak
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

MAIN_KN = [(576, 576), (576, 192), (576, 192), (576, 576),   # q k v o
           (576, 1536), (576, 1536), (1536, 576)]            # gate up down
DECODE_M, PREFILL_M = 8, 1024
RAGGED = [(3, 48, 16), (5, 48, 48), (17, 128, 128), (70, 100, 34),
          (1, 1536, 576), (129, 1000, 250),
          # M > 16: K and N off the tile's 64 (and 16-byte vector paths),
          # M off its 64 rows
          (17, 576, 1536), (1027, 2100, 70), (65, 48, 200), (1024, 1536, 34),
          # small M: ragged K and N, x rows padded to 1 / 8 / 16, K past
          # one 1536-k round; and M = 17 just past the switch
          (1, 7, 6), (8, 100, 34), (15, 129, 250), (16, 1000, 250),
          (16, 2100, 70), (17, 100, 34),
          # M > 16, N = 96: packed rows of 48 bytes on the vector path,
          # the last tile's second chunk past N
          (300, 576, 96)]
BATCH, PROMPT, GEN = 8, 128, 32
# the reduced model on the card against its own CPU run: bf16 roundings
# and float32 sums differ in order between the two devices, and an
# activation's int8 rounding may flip one step, which moves a logit of
# magnitude ~0.1 by ~1e-3
CPU_LOGIT_ATOL = 2e-2


# ---------------------------------------------------------------------------
# the paper's programs (Tables 1a, 1b, 2 and the 4-bit conv pair), written
# as plain torch over narrow integer tensors; the SILVIA passes pack them.
# Torch copies of benchmarks/table1a.py, table1b.py and table2_cnn.py,
# which tests/test_torch_silvia.py holds against the JAX originals.
# Sums pass dtype=torch.int32: an int32 sum widens to int64 otherwise,
# where the reference keeps int32.
# ---------------------------------------------------------------------------

def _f(x):
    return x.to(torch.int32)


def _wh(x, bits: int):
    from repro_torch.core import width_hint
    return width_hint(x, bits)


def vadd_unrolled(a_lanes, b_lanes):
    """Parallel int8 adds over the lanes (the Xilinx vadd example,
    unrolled)."""
    return tuple(a + b for a, b in zip(a_lanes, b_lanes))


def snn_conv_taps(spikes, weights, accs):
    """Spiking conv: membrane += spike ? w : 0 per tap, 3x3 taps
    unrolled, the channels split into 4 independent accumulator lanes.

    spikes: 9 bool [P] maps; weights: 9 x 4 int8 [C/4]; accs: 4 int8
    [P, C/4] membrane accumulators."""
    outs = list(accs)
    for s, w4 in zip(spikes, weights):
        for k in range(len(outs)):
            contrib = torch.where(s[:, None], w4[k][None, :], 0
                                  ).to(torch.int8)
            outs[k] = outs[k] + contrib     # independent across k -> four8
    return tuple(outs)


def mvm(w_even, w_odd, x):
    """int8 matrix-vector product, output-unrolled by 2: the row pair
    shares x (paper Eq. 1 with N=1)."""
    y_e = torch.sum(_f(w_even) * _f(x)[None, :], dim=1, dtype=torch.int32)
    y_o = torch.sum(_f(w_odd) * _f(x)[None, :], dim=1, dtype=torch.int32)
    return y_e, y_o


def scal(x_even, x_odd, alpha):
    """BLAS scal, unrolled by 2 sharing alpha."""
    return _f(x_even) * _f(alpha), _f(x_odd) * _f(alpha)


def axpy(x_even, x_odd, y_even, y_odd, alpha):
    """alpha*x + y: the muls pack (shared alpha); the +y adds stay."""
    return (_f(x_even) * _f(alpha) + _f(y_even),
            _f(x_odd) * _f(alpha) + _f(y_odd))


def gsm(d_even, d_odd, wt, prev):
    """GSM long-term-predictor flavour: two lag streams share the window
    `wt`; one unshared scaling mul stays unpacked."""
    l0 = torch.sum(_f(d_even) * _f(wt), dtype=torch.int32)
    l1 = torch.sum(_f(d_odd) * _f(wt), dtype=torch.int32)
    return l0, l1, _f(prev) * _f(prev)


def rtm(p_a, p_b, taps_a, taps_b, c_center, c_axis):
    """RTM 7-point stencil step on two wavefield streams: the centre-tap
    and axis muls pair across streams; the tap sums stay adds."""
    lap_a = sum(taps_a[1:], taps_a[0])
    lap_b = sum(taps_b[1:], taps_b[0])
    out_a = _f(p_a) * _f(c_center) + _f(lap_a) * _f(c_axis)
    out_b = _f(p_b) * _f(c_center) + _f(lap_b) * _f(c_axis)
    return out_a, out_b


def gat(h_even, h_odd, att, w_self):
    """Graph-attention scores: neighbour feature pairs share the
    attention vector."""
    e0 = torch.sum(_f(h_even) * _f(att), dim=1, dtype=torch.int32)
    e1 = torch.sum(_f(h_odd) * _f(att), dim=1, dtype=torch.int32)
    s0 = torch.sum(_f(h_even) * _f(w_self), dim=1, dtype=torch.int32)
    s1 = torch.sum(_f(h_odd) * _f(w_self), dim=1, dtype=torch.int32)
    return e0, e1, s0, s1


def _scan(body, init, xs):
    from torch._higher_order_ops.scan import scan
    return scan(body, init, xs)


@functools.cache
def scan_extra_calls() -> int:
    """Calls of its body that this torch's eager scan makes beyond one
    per iteration: torch 2.11 calls the body once more first, only to
    infer the per-step outputs' shapes (the result is dropped), so a
    packed unit in a body launches K + 1 times; later versions fold
    that call into the first iteration."""
    from torch._higher_order_ops.scan import scan_op
    calls = []

    def body(c, x):
        calls.append(x)
        return [c + x, x.clone()]

    scan_op(body, [torch.zeros(2)], [torch.ones(3, 2)], ())
    return len(calls) - 3


def mmm(a_even, a_odd, b):
    """int8 matmul, row-unrolled by 2, the k loop a torch scan: the body
    holds two muls sharing b_k.  a_*: [M, K]; b: [K, N].  The body
    returns no per-step outputs ([]: a scan body may not return None)."""
    def body(acc, inp):
        a_e, a_o, b_k = inp
        ce = acc[0] + _f(a_e)[:, None] * _f(b_k)[None, :]
        co = acc[1] + _f(a_o)[:, None] * _f(b_k)[None, :]
        return (ce, co), []

    zeros = lambda a: torch.zeros((a.shape[0], b.shape[1]),
                                  dtype=torch.int32, device=b.device)
    (ce, co), _ = _scan(body, (zeros(a_even), zeros(a_odd)),
                        (a_even.T, a_odd.T, b))
    return ce, co


def mmm_4b(a0, a1, a2, a3, b):
    """4-bit MMM: four row streams share b_k (factor-4 packing in the
    scan body).  a*: [M, K] 4-bit-valued int8; b: [K, N]."""
    def body(acc, inp):
        a_s, b_k = inp[:4], inp[4]
        bk = _f(_wh(b_k, 4))
        outs = tuple(acc[i] + _f(_wh(a_s[i], 4))[:, None] * bk[None, :]
                     for i in range(4))
        return outs, []

    acc0 = tuple(torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                             device=b.device) for a in (a0, a1, a2, a3))
    outs, _ = _scan(body, acc0, (a0.T, a1.T, a2.T, a3.T, b))
    return tuple(outs)


def shift_views(x, k: int = 3):
    """x: [..., H, W] int8 -> k*k shifted views of the last two dims,
    zero padded (the reference's _shift_views at [H, W], batched)."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    return tuple(xp[..., dy:dy + h, dx:dx + w]
                 for dy in range(k) for dx in range(k))


def conv3x3_pair_naive(x, w_even, w_odd):
    """3x3 conv for two output channels sharing the input taps.
    x: [..., H, W] int8; w_*: [9] int8 per-tap weights."""
    taps = shift_views(x)
    ye = _f(taps[0]) * _f(w_even[0])
    yo = _f(taps[0]) * _f(w_odd[0])
    for t in range(1, 9):
        ye = ye + _f(taps[t]) * _f(w_even[t])
        yo = yo + _f(taps[t]) * _f(w_odd[t])
    return ye, yo


def conv3x3_pair_4b(x, w_even, w_odd):
    """The conv pair with 4-bit weights, each tap's weight hinted AFTER
    indexing (width does not pass through indexing): Eq. 2 then allows a
    single in-lane chain of all 9 taps."""
    taps = shift_views(x)
    we = lambda t: _f(_wh(w_even[t], 4))
    wo = lambda t: _f(_wh(w_odd[t], 4))
    ye = _f(taps[0]) * we(0)
    yo = _f(taps[0]) * wo(0)
    for t in range(1, 9):
        ye = ye + _f(taps[t]) * we(t)
        yo = yo + _f(taps[t]) * wo(t)
    return ye, yo


def pw_conv4_naive(x, w4):
    """Pointwise 4-bit conv (MobileNet-4b): 4 output channels share the
    input pixel.  x: [N] 4-bit-valued int8; w4: [4] 4-bit int8."""
    xx = _f(_wh(x, 4))
    return tuple(xx * _f(_wh(w4[i], 4)) for i in range(4))


def pw_conv4_manual_split(x, w4):
    """MobileNet-4b packed by hand onto the paper's Fig. 3 unit (the
    27-bit-port layout with the Eq. 4 patch, `mul4_split`), as FINN
    writes it at RTL level.  Off the SILVIA path: no pass or registry
    lowering selects the split unit (the reference's pw_conv4_manual binds
    the full 32-bit one).  Equals pw_conv4_naive."""
    from repro_torch.kernels import mul4
    a = torch.stack([w.expand(x.shape) for w in w4.unbind(0)])
    return tuple(mul4.mul4_split(a, x))


def _passes(*specs):
    from repro_torch.core import PassConfig
    return [PassConfig(**s) for s in specs]


ADD_PASSES = ({"op": "add", "op_size": 8}, {"op": "add", "op_size": 16})
MAD_PASSES = ({"op": "muladd"},)


def program_specs(card: bool):
    """(name, fn, make_args(i8, i4, boolean), pass specs, units before,
    units after, packed units, {kernel: launches per call}) per program;
    `card` picks the card sizes (benchmark sizes for the five small
    BLAS/kernel programs either way), else the reference benchmarks'
    sizes.  A scan body's units count once; its packed unit launches
    once per call of the body: K times for MMM and MMM-4b, plus
    `scan_extra_calls()`."""
    lanes, vlen = 8, (2 ** 22 if card else 24)
    px, ch = (256 * 32 * 32, 64) if card else (24 * 24, 16)
    mv = (4096, 4096) if card else (96, 192)
    conv = (4096, 32, 32) if card else (16, 16)
    pw = 2 ** 23 if card else 512
    # MMM: a_* [M, K], b [K, N]; MMM-4b: four [M4, K] streams
    mm, mm4 = ((1024, 512, 2048), 512) if card else ((96, 192, 192), 48)
    m, k, n = mm
    return [
        ("vadd", vadd_unrolled,
         lambda i8, i4, bl: (tuple(i8(vlen) for _ in range(lanes)),
                             tuple(i8(vlen) for _ in range(lanes))),
         ADD_PASSES, 8, 2, 2, {"simd_add_packed": 2}),
        ("SNN", snn_conv_taps,
         lambda i8, i4, bl: (tuple(bl(px) for _ in range(9)),
                             tuple(tuple(i8(ch // 4) for _ in range(4))
                                   for _ in range(9)),
                             tuple(i8(px, ch // 4) for _ in range(4))),
         ADD_PASSES, 36, 9, 9, {"simd_add_packed": 9}),
        ("MVM", mvm,
         lambda i8, i4, bl: (i8(*mv), i8(*mv), i8(mv[1])),
         MAD_PASSES, 2, 1, 1, {"muladd2": 1}),
        ("MMM", mmm,
         lambda i8, i4, bl: (i8(m, k), i8(m, k), i8(k, n)),
         MAD_PASSES, 4, 3, 1, {"muladd2": k + scan_extra_calls()}),
        ("MMM-4b", mmm_4b,
         lambda i8, i4, bl: (*(i4(mm4, k) for _ in range(4)), i4(k, n)),
         ({"op": "mul4"},), 8, 5, 1,
         {"mul4_full32": k + scan_extra_calls()}),
        ("scal", scal, lambda i8, i4, bl: (i8(256), i8(256), i8()),
         MAD_PASSES, 2, 1, 1, {"muladd2": 1}),
        ("axpy", axpy,
         lambda i8, i4, bl: (i8(256), i8(256), i8(256), i8(256), i8()),
         MAD_PASSES, 4, 3, 1, {"muladd2": 1}),
        ("GSM", gsm, lambda i8, i4, bl: (i8(40), i8(40), i8(40), i8(40)),
         MAD_PASSES, 3, 2, 1, {"muladd2": 1}),
        ("RTM", rtm,
         lambda i8, i4, bl: (i8(16, 16, 16), i8(16, 16, 16),
                             tuple(i8(16, 16, 16) for _ in range(6)),
                             tuple(i8(16, 16, 16) for _ in range(6)),
                             i8(), i8()),
         MAD_PASSES, 16, 14, 2, {"muladd2": 2}),
        ("GAT", gat,
         lambda i8, i4, bl: (i8(128, 64), i8(128, 64), i8(64), i8(64)),
         MAD_PASSES, 4, 2, 2, {"muladd2": 2}),
        ("conv-pair", conv3x3_pair_naive,
         lambda i8, i4, bl: (i8(*conv), i8(9), i8(9)),
         MAD_PASSES, 34, 25, 9, {"muladd2": 9}),
        ("conv-pair-4b", conv3x3_pair_4b,
         lambda i8, i4, bl: (i8(*conv), i4(9), i4(9)),
         ({"op": "muladd", "m_bits": 4},), 34, 2, 1, {"muladd2": 1}),
        ("MobileNet-4b", pw_conv4_naive,
         lambda i8, i4, bl: (i4(pw), i4(4)),
         ({"op": "mul4"},), 4, 1, 1, {"mul4_full32": 1}),
    ]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(m: int, k: int, n: int, w_bytes: int) -> tuple:
    """Least time for one GEMM call on this card: each input read once
    (x, weights, both scales), the f32 output written once, against
    2*M*K*N int8 operations at the tensor-core peak."""
    nbytes = m * k + w_bytes + 4 * m + 4 * n + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(_build, name: str) -> subprocess.Popen:
    """Start `nvcc -Xptxas -v` on csrc/<name>.cu with the build's flags
    (to a cubin in the build directory, then unused): its output lists
    each kernel's registers, shared memory and spills."""
    flags = list(_build.NVCC_FLAGS)
    flags.remove("-shared")
    del flags[flags.index("-Xcompiler"):flags.index("-Xcompiler") + 2]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o",
           str(_build.BUILD_DIR / f"{name}.ptxas.cubin"),
           str(_build.CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def device_ms(torch, fn, n_iter: int) -> float:
    """Mean device time of fn(i) over n_iter calls, by CUDA events.  A
    sleep kernel queued first holds the stream while the host enqueues
    every call, so host overhead between launches is not timed."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(n_iter * 2e5))   # ~0.1 ms per call at ~2 GHz
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def call_ms(fn, n_iter: int) -> float:
    """Mean time per call of fn() on the host clock around n_iter calls
    that end in a synchronize: the host's dispatch of the call's many
    small ops counts, as it does for its caller."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_iter


GEMM_KERNELS = {
    "quant_matmul": dict(
        source="src/repro_torch/kernels/csrc/quant_matmul.cu",
        replaces="src/repro/kernels/quant_matmul.py:30"),
    "quant_matmul_small_m": dict(
        source="src/repro_torch/kernels/csrc/s8_small_m.cuh",
        replaces="src/repro/kernels/quant_matmul.py:30",
        entry="quant_matmul.cu::repro_quant_matmul_small_m (LoadW8Word)"),
    "packed_w4_matmul": dict(
        source="src/repro_torch/kernels/csrc/packed_w4_matmul.cu",
        replaces="src/repro/kernels/packed_matmul.py:35"),
    "packed_w4_matmul_small_m": dict(
        source="src/repro_torch/kernels/csrc/s8_small_m.cuh",
        replaces="src/repro/kernels/packed_matmul.py:35",
        entry="packed_w4_matmul.cu::repro_packed_w4_matmul_small_m "
              "(LoadW4Word)"),
}


def phase_kernels(torch) -> dict:
    """Returns {kernel name: {"rows": per-shape timings of the main-path
    shapes, "max_abs_err": ...}} for the four GEMM kernels."""
    import torch.nn.functional as F

    import ctypes

    from repro_torch.kernels import (_build, common, packed_matmul,
                                     quant_matmul, ref)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    # the tiles' grids as their launchers compute them (host functions)
    grids = {}
    for name in ("quant_matmul", "packed_w4_matmul"):
        fn = getattr(_build.load(name), f"repro_{name}_grid")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        grids[name] = fn

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 0.02 + 1e-3

    def pad32(x):    # x zero-padded to the 32 rows torch._int_mm accepts
        return F.pad(x, (0, 0, 0, 32 - x.shape[0]))

    def rule(name):   # the kernel the wrappers' rule picks for M rows
        return lambda m: (f"{name}_small_m" if m <= quant_matmul.SMALL_M
                          else name)

    specs = [
        dict(name="quant_matmul", kernel_for=rule("quant_matmul"),
             small=quant_matmul.SMALL_M_LAUNCHES,
             acc=quant_matmul.quant_matmul_acc,
             out=quant_matmul.quant_matmul,
             acc_ref=ref.quant_matmul_acc_ref, out_ref=ref.quant_matmul_ref,
             wshape=lambda k, n: (k, n),
             lib=lambda x, w: torch._int_mm(x, w), one_call=True),
        dict(name="packed_w4_matmul", kernel_for=rule("packed_w4_matmul"),
             small=packed_matmul.SMALL_M_LAUNCHES,
             acc=packed_matmul.packed_w4_matmul_acc,
             out=packed_matmul.packed_w4_matmul,
             acc_ref=ref.packed_w4_matmul_acc_ref,
             out_ref=ref.packed_w4_matmul_ref,
             wshape=lambda k, n: (k, n // 2),
             # no one PyTorch call takes packed int4: a yardstick
             lib=lambda x, w: torch._int_mm(x, common.unpack_w4_words(w)),
             one_call=False),
    ]
    main_shapes = [(m, k, n) for m in (DECODE_M, PREFILL_M)
                   for k, n in dict.fromkeys(MAIN_KN)]
    results = {name: dict(rows=[], max_abs_err=0.0, shapes=0)
               for name in GEMM_KERNELS}
    for sp in specs:
        small = sp["small"]
        for m, k, n in main_shapes + RAGGED:
            kname = sp["kernel_for"](m)
            res = results[kname]
            x, w = i8(m, k), i8(*sp["wshape"](k, n))
            xs, ws = scales(m, 1), scales(1, n)
            start = small.count
            acc_k, acc_p = sp["acc"](x, w), sp["acc_ref"](x, w)
            out_k = sp["out"](x, w, xs, ws)
            out_p = sp["out_ref"](x, w, xs, ws)
            torch.cuda.synchronize()
            if small.count - start != \
                    (2 if kname.endswith("_small_m") else 0):
                raise AssertionError(f"{sp['name']} {(m, k, n)}: "
                                     f"{small.count - start} small-M "
                                     f"launches, expected {kname}")
            if not torch.equal(acc_k, acc_p):
                bad = (acc_k != acc_p).sum().item()
                raise AssertionError(f"{kname} {(m, k, n)}: int32 "
                                     f"accumulator differs in {bad} places")
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{kname} {(m, k, n)}: f32 output "
                                     "is not bit-identical to the plain "
                                     "version")
            err = (out_k - out_p).abs().max().item() if out_k.numel() else 0.
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["shapes"] += 1
            if (m, k, n) not in main_shapes:
                continue
            # time over enough distinct weight copies to spill the 50 MB
            # L2, as the 30-layer decode loop does
            w_bytes = w.numel()
            copies = [w] + [i8(*w.shape) for _ in range(
                math.ceil(128e6 / w_bytes) - 1)]
            wi = lambda i: copies[i % len(copies)]
            n_it = 200 if m == DECODE_M else 100
            t_k = device_ms(torch, lambda i: sp["out"](x, wi(i), xs, ws),
                            n_it)
            t_p = device_ms(torch, lambda i: sp["out_ref"](x, wi(i), xs, ws),
                            20)
            try:
                t_l = device_ms(torch, lambda i: sp["lib"](x, wi(i)), 50)
            except RuntimeError:   # shape not legal for torch._int_mm
                t_l = None
            b_ms, b_by = bound_ms(m, k, n, w_bytes)
            row = dict(m=m, k=k, n=n, ms=t_k, plain_ms=t_p,
                       library_ms=t_l if sp["one_call"] else None,
                       bound_ms=b_ms, bound_by=b_by)
            if not sp["one_call"]:
                row["yardstick_ms"] = t_l
            extra = ""
            if m == DECODE_M:
                if not torch.equal(sp["lib"](pad32(x), w)[:m], acc_p):
                    raise AssertionError(f"{sp['name']} {(m, k, n)}: padded "
                                         "torch._int_mm differs")
                row["pad32_int_mm_ms"] = device_ms(
                    torch, lambda i: sp["lib"](pad32(x), wi(i)), 50)
                extra = (f"  pad32+_int_mm "
                         f"{row['pad32_int_mm_ms'] * 1e3:7.2f} us")
            else:
                extra = (f"  grid {grids[sp['name']](m, n)} blocks  bound "
                         f"share {100 * b_ms / t_k:.1f}%")
            res["rows"].append(row)
            del copies
            log(f"  {kname:24s} M={m:5d} K={k:5d} N={n:5d}  kernel "
                f"{t_k * 1e3:9.2f} us  plain {t_p * 1e3:9.2f} us  "
                + ("library " if sp["one_call"] else "unpack+_int_mm ")
                + (f"{t_l * 1e3:9.2f} us" if t_l is not None else "  n/a")
                + f"  bound {b_ms * 1e3:7.3f} us ({b_by})" + extra)
    # ROADMAP C5: past K = 2^17 the int8 sums of -128 * -128 leave the
    # int32 range; the small-M kernel wraps them as the plain version
    k_wrap, n_wrap = 2 ** 17 + 1, 34
    for sp in specs:
        x = torch.full((DECODE_M, k_wrap), -128, dtype=torch.int8,
                       device="cuda")
        w = torch.full(sp["wshape"](k_wrap, n_wrap), -128, dtype=torch.int8,
                       device="cuda")
        start = sp["small"].count
        acc_k, acc_p = sp["acc"](x, w), sp["acc_ref"](x, w)
        torch.cuda.synchronize()
        if sp["small"].count != start + 1 or not torch.equal(acc_k, acc_p):
            raise AssertionError(f"{sp['name']}_small_m M={DECODE_M} "
                                 f"K={k_wrap}: differs from the plain "
                                 "version past the int32 range")
        log(f"{sp['name']}_small_m M={DECODE_M} K={k_wrap} N={n_wrap}, x = w "
            f"= -128: bit-identical to the plain version (acc "
            f"{acc_k[0, 0].item()})")
    for name, res in results.items():
        if res["shapes"] == 0:
            raise AssertionError(f"{name}: no shape reached it")
        log(f"{name}: bit-identical to the plain version at "
            f"{res['shapes']} shapes")
    return results


def mixer_widths(cfg) -> list:
    """The SSD mixer's (K, N): in_proj and out_proj."""
    from repro_torch.models import ssm
    s, d_inner, n_heads, _ = ssm.dims(cfg)
    return [(cfg.d_model, 2 * d_inner + 2 * s.n_groups * s.d_state
             + n_heads), (d_inner, cfg.d_model)]


def gemm_widths(cfg) -> list:
    """Every 2-D (K, N) of cfg that reaches a GEMM kernel, by family: the
    q, k, v, o projections and the MLP's gate, up and down (dense), the
    SSD mixer's in_proj and out_proj (ssm), both and the dense MLP's
    (hybrid), the projections and the GELU MLP's up and down (encdec:
    self and cross attention share the widths; vlm: the dense ones); and
    an untied lm_head
    (a tied one is the bf16 embedding, a plain matmul).  The
    expert-stacked widths are phase_moe_gemms' and phase_hybrid_gemms'."""
    d = cfg.d_model
    attn = [(d, cfg.q_dim), (d, cfg.kv_dim), (cfg.q_dim, d)]
    ffn = [(d, cfg.d_ff), (cfg.d_ff, d)]
    if cfg.family == "ssm":
        kn = mixer_widths(cfg)
    elif cfg.family in ("dense", "encdec", "vlm"):
        kn = attn + ffn
    elif cfg.family == "hybrid":
        kn = attn + mixer_widths(cfg) + ffn
    else:
        raise ValueError(f"gemm_widths: family {cfg.family!r}")
    if not cfg.tie_embeddings:
        kn.append((d, cfg.vocab))
    return list(dict.fromkeys(kn))


def hybrid_kinds(cfg) -> collections.Counter:
    """Layers of each kind in one hybrid scan unit, from the layout the
    model runs (`blocks.hybrid_layout`): {"attn": 1, "mamba": 7, "moe":
    4, "dense": 4} for jamba."""
    from repro_torch.models import blocks
    return collections.Counter(
        kind for layer in blocks.hybrid_layout(cfg) for kind in layer)


def gemms_per_forward(cfg) -> int:
    """GEMM launches of the blocks per forward (the head's apart): per
    dense or moe layer q k v o and the MLP's three (a moe layer's three
    expert-stacked GEMMs, one launch each); per ssm layer the mixer's
    in_proj and out_proj; per hybrid unit its attention layers' four,
    its mixers' two each and its FFNs' three each (42 for jamba's unit
    of 8); encdec (a prefill) per encoder layer q k v o and the MLP's
    two, per decoder layer the self-attention's four, the cross
    attention's q, o and its k, v on the memory, and the MLP's two (192
    for whisper-small)."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers
    if cfg.family == "hybrid":
        n = hybrid_kinds(cfg)
        per_unit = (4 * n["attn"] + 2 * n["mamba"]
                    + 3 * (n["moe"] + n["dense"]))
        return cfg.n_layers // cfg.hybrid.period * per_unit
    if cfg.family == "encdec":
        return 6 * cfg.n_layers + 10 * cfg.n_decoder_layers
    return 7 * cfg.n_layers


def gemms_per_step(cfg) -> int:
    """GEMM launches of the blocks per decode step (the head's apart):
    gemms_per_forward, but for encdec, whose step runs only the decoder
    and reads the cross K/V the prefill projected: per decoder layer the
    self-attention's four, the cross attention's q and o and the MLP's
    two (96 for whisper-small)."""
    if cfg.family == "encdec":
        return 8 * cfg.n_decoder_layers
    return gemms_per_forward(cfg)


def moe_layers(cfg) -> int:
    """Calls of `mlp.moe` per forward."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.period * hybrid_kinds(cfg)["moe"]
    return cfg.n_layers if cfg.family == "moe" else 0


def dec_tokens(prompts):
    """The decoder's prompt [B, S]: the tokens, or an encdec input's
    second half."""
    return prompts[1] if isinstance(prompts, tuple) else prompts


def prompt_prefix(prompts, n: int):
    """The first n prompt tokens (an encdec input keeps its frames)."""
    if isinstance(prompts, tuple):
        return prompts[0], prompts[1][:, :n]
    return prompts[:, :n]


def w_load_path(launch: dict, row: int) -> str:
    """The w-load path a GEMM launch took, as `common.launch_gemm`
    recorded it on the wrapper's counter (`LaunchCounter.last`); `row` is
    the stored row's bytes."""
    vec = launch["vec_bytes"]
    return (f"w {vec}-byte vector loads" if launch["vec_w"] else
            f"w byte path (stored row {row} B, not {vec}-byte loads)")


WIDE_ARCHS = ("qwen1.5-0.5b", "yi-6b", "command-r-35b")


def phase_wide_gemms(torch, archs=WIDE_ARCHS, prefill_m=PREFILL_M) -> dict:
    """Both GEMM kernels bit for bit (`torch.equal`, acc and out) against
    their plain versions at decode M=8 and prefill M=prefill_m (an int or
    a tuple of them, or {(K, N): either} with PREFILL_M for the shapes it
    omits), at every
    (K, N) of `archs` that reaches a kernel (`gemm_widths`; for the three
    other dense configs K up to 22528, N up to 256000: command-r's
    lm_head, k * n = 2.097e9, just under the kernels' 2^31 index limit).
    The plain version takes a weight whose float64 copy would pass
    ref.PLAIN_EXPERT_BYTES in column slices itself.  Logs each shape's
    per-launch time (CUDA events, L2 spilled), its bound and the w-load
    path its launch recorded (`w_load_path`).  Returns the per-launch
    times, {(kernel, arch): {(K, N): us}} (the small-M kernel's at M=8,
    the tile's at the last prefill M) and {(kernel, arch, M): {(K, N):
    us}}."""
    from repro_torch import configs
    from repro_torch.kernels import packed_matmul, quant_matmul, ref

    gen = torch.Generator(device="cuda").manual_seed(4321)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 0.02 + 1e-3

    specs = [("quant_matmul", quant_matmul, ref.quant_matmul_acc_ref,
              ref.quant_matmul_ref, 1),
             ("packed_w4_matmul", packed_matmul,
              ref.packed_w4_matmul_acc_ref, ref.packed_w4_matmul_ref, 2)]
    t0 = time.perf_counter()
    n_shapes = 0
    times = {}
    for arch in archs:
        cfg = configs.get_config(arch)
        for k, n in gemm_widths(cfg):
            for name, mod, acc_ref, out_ref, per_word in specs:
                if n % per_word:    # an odd N has no packed int4 weight:
                    continue        # it serves w8a8 (`serving_format`)
                acc_fn = getattr(mod, f"{name}_acc")
                out_fn = getattr(mod, name)
                w = i8(k, n // per_word)
                ws = scales(1, n)
                m_pre = prefill_m.get((k, n), PREFILL_M) \
                    if isinstance(prefill_m, dict) else prefill_m
                if not isinstance(m_pre, tuple):
                    m_pre = (m_pre,)
                for m in (DECODE_M,) + m_pre:
                    x, xs = i8(m, k), scales(m, 1)
                    start = mod.SMALL_M_LAUNCHES.count
                    acc_k, out_k = acc_fn(x, w), out_fn(x, w, xs, ws)
                    torch.cuda.synchronize()
                    w_path = w_load_path(mod.LAUNCHES.last, w.shape[-1])
                    small = m <= quant_matmul.SMALL_M
                    kname = name + ("_small_m" if small else "")
                    if mod.SMALL_M_LAUNCHES.count - start != \
                            (2 if small else 0):
                        raise AssertionError(f"{name} {(m, k, n)}: not "
                                             f"through {kname}")
                    if not torch.equal(acc_k, acc_ref(x, w)):
                        raise AssertionError(f"{kname} {arch} {(m, k, n)}: "
                                             "int32 accumulator differs")
                    if not torch.equal(out_k, out_ref(x, w, xs, ws)):
                        raise AssertionError(f"{kname} {arch} {(m, k, n)}: "
                                             "f32 output differs")
                    del acc_k, out_k
                    # time over enough weight copies to spill the 50 MB L2
                    copies = [w] + [i8(*w.shape) for _ in range(
                        math.ceil(128e6 / w.numel()) - 1)]
                    t_k = device_ms(torch, lambda i: out_fn(
                        x, copies[i % len(copies)], xs, ws),
                        100 if m == DECODE_M else 20)
                    del copies
                    b_ms, b_by = bound_ms(m, k, n, w.numel())
                    times.setdefault((kname, arch), {})[(k, n)] = t_k * 1e3
                    times.setdefault((kname, arch, m), {})[(k, n)] = \
                        t_k * 1e3
                    log(f"  {kname:24s} {arch:13s} M={m:5d} K={k:5d} "
                        f"N={n:6d}  kernel {t_k * 1e3:10.2f} us  bound "
                        f"{b_ms * 1e3:9.2f} us ({b_by}, "
                        f"{100 * b_ms / t_k:.1f}%)  "
                        f"{w_path}")
                    n_shapes += 1
                del w, ws
                torch.cuda.empty_cache()
    log(f"wide GEMM gates: both kernels bit-identical to the plain "
        f"versions at {n_shapes} (kernel, M, K, N) of "
        f"{', '.join(archs)} in {time.perf_counter() - t0:.1f} s")
    return times


def phase_scan_gate() -> None:
    """`make_fx` on this torch keeps MMM's scan body as a sub-GraphModule
    (a `get_attr` node) that feeds one `higher_order.scan` node, the
    body's two multiplies inside it: the structure the pass pipeline
    recurses into.  Raises otherwise."""
    from repro_torch import core as silvia
    a = torch.ones((4, 3), dtype=torch.int8, device=DEVICE)
    gm = silvia.trace(mmm, a, a, torch.ones((3, 5), dtype=torch.int8,
                                            device=DEVICE))
    scans = [n for n in gm.graph.nodes if n.op == "call_function"
             and n.target is getattr(torch.ops.higher_order, "scan", None)]
    bodies = [n for n in gm.graph.nodes if n.op == "get_attr" and
              isinstance(getattr(gm, n.target), torch.fx.GraphModule)]
    if len(scans) != 1 or len(bodies) != 1 or scans[0].args[0] is not \
            bodies[0]:
        raise AssertionError(f"scan gate: make_fx on torch "
                             f"{torch.__version__} traced MMM without one "
                             f"scan node over one body sub-GraphModule:\n"
                             f"{gm.graph}")
    body = getattr(gm, bodies[0].target)
    muls = [n for n in body.graph.nodes
            if n.target is torch.ops.aten.mul.Tensor]
    if len(muls) != 2:
        raise AssertionError(f"scan gate: MMM's body holds {len(muls)} "
                             f"multiplies, expected 2:\n{body.graph}")
    log(f"scan gate: make_fx keeps MMM's body as `{bodies[0].target}` "
        f"under one {scans[0].target} node ({len(body.graph.nodes)} body "
        f"nodes, 2 multiplies); the eager scan calls a body K + "
        f"{scan_extra_calls()} times for K iterations")


# ---------------------------------------------------------------------------
# the SWAR kernels and the SILVIA pass pipeline over the paper's programs
# ---------------------------------------------------------------------------

DEVICE = "cuda"
# ragged element counts (the masked tail) and aligned ones (16-byte path)
SWAR_RAGGED = [(1,), (5,), (17, 3), (1000,), (33, 65), (4096 + 7,),
               (64, 256)]
# the H100 SXM's CUDA-core float32 rate, the nearest published peak for
# the kernels' 32-bit integer ALU ops (the tensor cores do none of them)
CUDA_CORE_OPS_PER_S = 67e12
SWAR_KERNELS = {
    "simd_add_packed": dict(
        source="src/repro_torch/kernels/csrc/simd_add.cu",
        replaces="src/repro/kernels/simd_add.py:29"),
    "muladd2": dict(
        source="src/repro_torch/kernels/csrc/muladd2.cu",
        replaces="src/repro/kernels/muladd2.py:36"),
    "mul4_full32": dict(
        source="src/repro_torch/kernels/csrc/mul4.cu",
        replaces="src/repro/kernels/mul4.py:103"),
    "mul4_split": dict(
        source="src/repro_torch/kernels/csrc/mul4.cu",
        replaces="src/repro/kernels/mul4.py:112"),
}


def _swar_counters():
    from repro_torch.kernels import mul4, muladd2, simd_add
    return {"simd_add_packed": simd_add.LAUNCHES,
            "muladd2": muladd2.LAUNCHES, "mul4_full32": mul4.LAUNCHES,
            "mul4_split": mul4.SPLIT_LAUNCHES}


def _randint(gen, lo, hi, shape, dtype):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int64).to(dtype)


def _outs(x) -> list:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _same(got, want) -> bool:
    got, want = _outs(got), _outs(want)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


def phase_swar_gates() -> int:
    """Each SWAR kernel against its plain version at ragged shapes: every
    lane width, add and sub, k = 1..lanes; muladd2 chains of 1, 9, 31
    (4-bit a and b beyond 1, inside the Eq. 2 bound); mul4 full32 and
    split, signed and unsigned, with b aligned and b one byte into its
    storage (no vector path).  Returns the number of checks."""
    from repro_torch.kernels import mul4, muladd2, ref, simd_add
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    checks = 0
    for shape in SWAR_RAGGED:
        for lane_bits, dt in ((8, torch.int8), (16, torch.int16)):
            lo = -(1 << (lane_bits - 1))
            for sub in (False, True):
                words = [_randint(gen, -2 ** 31, 2 ** 31, shape,
                                  torch.int32) for _ in range(2)]
                if not torch.equal(
                        simd_add.simd_add_packed(*words, lane_bits=lane_bits,
                                                 sub=sub),
                        simd_add.simd_add_packed_plain(
                            *words, lane_bits=lane_bits, sub=sub)):
                    raise AssertionError(f"simd_add_packed {shape} lane "
                                         f"{lane_bits} sub={sub}")
                for k in range(1, 32 // lane_bits + 1):
                    xs = [_randint(gen, lo, -lo, shape, dt)
                          for _ in range(k)]
                    ys = [_randint(gen, lo, -lo, shape, dt)
                          for _ in range(k)]
                    if not _same(simd_add.simd_add(xs, ys,
                                                   lane_bits=lane_bits,
                                                   sub=sub),
                                 ref.simd_add_ref(xs, ys, sub=sub,
                                                  lane_bits=lane_bits)):
                        raise AssertionError(f"simd_add {shape} lane "
                                             f"{lane_bits} k={k} sub={sub}")
                    checks += 2
        for n in (1, 9, 31):
            lo = -128 if n == 1 else -8
            a, b = (_randint(gen, lo, -lo, (n, *shape), torch.int8)
                    for _ in range(2))
            c = _randint(gen, -128, 128, (n, *shape), torch.int8)
            if not _same(muladd2.muladd2(a, b, c),
                         muladd2.muladd2_plain(a, b, c)):
                raise AssertionError(f"muladd2 n={n} {shape}")
            checks += 1
        for signed, (lo, hi) in ((True, (-8, 8)), (False, (0, 16))):
            a = _randint(gen, lo, hi, (4, *shape), torch.int8)
            b = _randint(gen, lo, hi, shape, torch.int8)
            b_off = torch.empty(b.numel() + 1, dtype=torch.int8,
                                device=DEVICE)[1:].view(shape)
            b_off.copy_(b)
            want = mul4.mul4_plain(a, b)
            for fn in (mul4.mul4_full32, mul4.mul4_split):
                for bb in (b, b_off):
                    if not _same(fn(a, bb, signed=signed), want):
                        raise AssertionError(
                            f"{fn.__name__} signed={signed} {shape} b at "
                            f"{bb.data_ptr() % 16} mod 16")
                    checks += 1
    torch.cuda.synchronize()
    log(f"SWAR kernels: bit-identical to their plain versions in {checks} "
        f"ragged checks over {len(SWAR_RAGGED)} shapes")
    return checks


def _replay(kname: str, operands, attrs):
    """(signature, kernel(ops), plain(ops), library(ops) or None, bytes
    moved, integer ops) to replay one captured launch of a SWAR kernel on
    operands shaped as its wrapper launched it with (`ops`: those
    operands, or a copy of them)."""
    from repro_torch.kernels import mul4, muladd2, simd_add
    if kname == "simd_add_packed":
        xw, _ = operands
        lane = torch.int8 if attrs["lane_bits"] == 8 else torch.int16
        lib = torch.sub if attrs["sub"] else torch.add
        return (("words", tuple(xw.shape), attrs["lane_bits"], attrs["sub"]),
                lambda ops: simd_add.simd_add_packed(*ops, **attrs),
                lambda ops: simd_add.simd_add_packed_plain(*ops, **attrs),
                lambda ops: lib(ops[0].view(lane),
                                ops[1].view(lane)).view(torch.int32),
                12 * xw.numel(), 5 * xw.numel())
    if kname == "muladd2":
        a = operands[0]
        n, e = a.shape[0], a[0].numel()
        return (("n", n, tuple(a.shape[1:])),
                lambda ops: muladd2.muladd2(*ops),
                lambda ops: muladd2.muladd2_plain(*ops), None,
                (3 * n + 8) * e, (4 * n + 6) * e)
    b = operands[1]
    fn, ops = ((mul4.mul4_full32, 20) if kname == "mul4_full32"
               else (mul4.mul4_split, 24))
    return (("e", tuple(b.shape)), lambda o: fn(*o, **attrs),
            lambda o: mul4.mul4_plain(*o), None, 21 * b.numel(),
            ops * b.numel())


def spill_copies(operands, n_iter: int) -> list:
    """The operands and distinct copies of them, enough that n_iter
    launches cycling through them read their operands from HBM: 128 MB
    of them, past the 50 MB L2, where n_iter copies reach that (a launch
    on less is bound by its launch, not its bytes)."""
    n_in = sum(t.numel() * t.element_size() for t in operands)
    n = min(n_iter, math.ceil(128e6 / max(n_in, 1)))
    return [operands] + [tuple(t.clone() for t in operands)
                         for _ in range(n - 1)]


def swar_bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_programs() -> list:
    """The paper's programs through the SILVIA passes at card size, then
    the SWAR kernels gated and timed at the shapes they ran at.  Returns
    the four SWAR kernels' entries of the `kernels` line."""
    from repro_torch import core as silvia
    from repro_torch.core import opcount
    from repro_torch.kernels import registry

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    i8 = lambda *s: _randint(gen, -128, 128, s, torch.int8)
    i4 = lambda *s: _randint(gen, -8, 8, s, torch.int8)
    bl = lambda *s: torch.rand(s, generator=gen, device=DEVICE) > 0.7
    counters = _swar_counters()
    progs, scans = [], set()     # scans: programs with a scan body
    for name, fn, make, pspecs, u_before, u_after, packed, want in \
            program_specs(card=True):
        args = make(i8, i4, bl)
        passes = _passes(*pspecs)
        traced = silvia.trace(fn, *args)
        before = opcount.count_ops(traced).units
        after = opcount.count_ops(silvia.optimized_graph(
            fn, *args, passes=passes))
        if (before, after.units, after.packed_units) != \
                (u_before, u_after, packed):
            raise AssertionError(f"{name}: units {before} -> {after.units} "
                                 f"({after.packed_units} packed), expected "
                                 f"{u_before} -> {u_after} ({packed} "
                                 "packed)")
        opt = silvia.optimize(fn, passes)
        opt(*args)            # trace + rewrite; its launches are not counted
        if any(isinstance(sub, torch.fx.GraphModule)
               for sub in traced.children()):
            scans.add(name)
        progs.append((name, fn, args, opt, want))
    torch.cuda.synchronize()

    # the main path: every program's optimized version once
    for c in counters.values():
        c.reset()
    outs = {}
    for name, _, args, opt, want in progs:
        start = {k: c.count for k, c in counters.items()}
        outs[name] = opt(*args)
        got = {k: c.count - start[k] for k, c in counters.items()}
        if got != {k: want.get(k, 0) for k in counters}:
            raise AssertionError(f"{name}: kernel launches {got}, expected "
                                 f"{want}")
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    on_path = {k for _, _, _, _, want in progs for k in want}
    for k in on_path:
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on the program path")
    log(f"programs: kernel launches on the path {launches}")

    # off the path: MobileNet-4b packed by hand onto the split unit (no
    # pass or registry lowering selects mul4_split)
    pw_args = next(args for name, _, args, _, _ in progs
                   if name == "MobileNet-4b")
    start = counters["mul4_split"].count
    if not _same(pw_conv4_manual_split(*pw_args), outs["MobileNet-4b"]):
        raise AssertionError("MobileNet-4b packed by hand on mul4_split "
                             "differs from the SILVIA-packed program")
    if counters["mul4_split"].count != start + 1:
        raise AssertionError("MobileNet-4b packed by hand did not launch "
                             "mul4_split once")

    for name, fn, args, opt, want in progs:
        if not _same(outs[name], fn(*args)):
            raise AssertionError(f"{name}: optimized != unoptimized")
        before = {k: c.count for k, c in counters.items()}
        with registry.force("ref"):
            forced = opt(*args)
        if {k: c.count for k, c in counters.items()} != before:
            raise AssertionError(f"{name}: forced-ref run launched kernels")
        if not _same(forced, outs[name]):
            raise AssertionError(f"{name}: forced-ref output differs")
        t_opt = call_ms(lambda: opt(*args), 20)
        t_base = call_ms(lambda: fn(*args), 20)
        log(f"  {name:13s} optimized {t_opt * 1e3:10.2f} us/call  "
            f"unoptimized {t_base * 1e3:10.2f} us/call  launches {want}; "
            "== unoptimized == forced-ref, bit for bit")
        if name in scans:
            scan_profile(name, opt, args, want, t_opt)

    # each kernel at the shapes the programs gave it: gate, then time;
    # mul4_split at the operands mul4_full32 got
    with contextlib.ExitStack() as stack:
        seen = {k: stack.enter_context(c.capture())
                for k, c in counters.items()}
        for name, fn, args, opt, want in progs:
            opt(*args)
    torch.cuda.synchronize()
    seen["mul4_split"] = seen["mul4_full32"]
    rows: dict = {}
    for kname in SWAR_KERNELS:
        for operands, attrs in seen[kname]:
            sig, kern, plain, lib, nbytes, ops = _replay(kname, operands,
                                                         attrs)
            row = rows.setdefault((kname, sig), dict(
                kernel=kname, sig=sig, count=0, kern=kern, plain=plain,
                lib=lib, nbytes=nbytes, ops=ops, operands=operands))
            row["count"] += 1
    per = {k: [] for k in SWAR_KERNELS}
    for r in rows.values():
        got, want = r["kern"](r["operands"]), r["plain"](r["operands"])
        if not _same(got, want):
            raise AssertionError(f"{r['kernel']} {r['sig']}: differs from "
                                 "its plain version at card size")
        r["err"] = max((g.long() - w.long()).abs().max().item()
                       for g, w in zip(_outs(got), _outs(want)))
        if r["lib"] is not None and not torch.equal(
                r["lib"](r["operands"]), r["kern"](r["operands"])):
            raise AssertionError(f"{r['kernel']} {r['sig']}: differs from "
                                 "its library yardstick")
        # timed over distinct operand copies, from HBM as the bound
        # assumes (in MMM's scan a launch reads what the adapter has
        # just written, from L2: scan_profile times that)
        copies = spill_copies(r["operands"], 50)
        op = lambda i: copies[i % len(copies)]
        r["ms"] = device_ms(torch, lambda i: r["kern"](op(i)), 50)
        r["plain_ms"] = device_ms(torch, lambda i: r["plain"](op(i)), 10)
        r["library_ms"] = device_ms(torch, lambda i: r["lib"](op(i)), 50) \
            if r["lib"] is not None else None
        del copies
        r["bound_ms"], r["bound_by"] = swar_bound_ms(r["nbytes"], r["ops"])
        per[r["kernel"]].append(r)
        lib_s = (f"{r['library_ms'] * 1e3:9.2f} us" if r["library_ms"]
                 is not None else "      n/a")
        log(f"  {r['kernel']:15s} {str(r['sig']):32s} x{r['count']:<2d} "
            f"kernel {r['ms'] * 1e3:9.2f} us  plain "
            f"{r['plain_ms'] * 1e3:9.2f} us  library {lib_s}  bound "
            f"{r['bound_ms'] * 1e3:8.2f} us ({r['bound_by']}); bit-identical")
    entries = []
    for kname, meta in SWAR_KERNELS.items():
        rs = per[kname]
        total = lambda key: sum(r[key] * r["count"] for r in rs)
        libs = [r["library_ms"] for r in rs]
        entries.append(dict(
            name=kname, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[kname],
            max_abs_err=float(max(r["err"] for r in rs)), ms=total("ms"),
            plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"), bound_by="bytes" if all(
                r["bound_by"] == "bytes" for r in rs) else "operations",
            library_ms=total("library_ms") if all(
                v is not None for v in libs) else None,
            per="one pass over the thirteen SILVIA-packed programs at "
                "card size (MMM and MMM-4b launch once per call of "
                "their scan body): sums of per-launch times x launches "
                "per shape"
                if kname != "mul4_split" else "off the path (no pass "
                "selects it): at mul4_full32's shapes, as often as it "
                "launched",
            library_note=None if kname == "simd_add_packed" else
            "no single PyTorch call: int32 products of int8 operands need "
            "a widening copy before the multiply (and a sum for muladd2)",
            shapes=[dict(sig=str(r["sig"]), count=r["count"], ms=r["ms"],
                         plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                         bound_ms=r["bound_ms"]) for r in rs]))
    return entries


def scan_profile(name: str, opt, args, want: dict, t_call: float) -> None:
    """One optimized call of a scan program under the profiler: the
    launches and device time of its body's kernel against the call's
    host time (`t_call` ms, unprofiled; the profiled call's beside it),
    so the log shows whether the eager scan's per-iteration host dispatch
    or the kernel sets the pace."""
    import re

    from repro_torch.kernels import registry
    counters = {c.name: c for c in registry.LAUNCH_COUNTERS}
    for kname, n in want.items():
        sym = counters[kname].symbol
        # a profile may drop a few kernel events (never add one): a call
        # counted short is profiled again, three times at most
        for _ in range(3):
            wall_ms, dev_ms, rows = _profiled(torch, lambda: (
                opt(*args), torch.cuda.synchronize()), 1)
            mine = [r for r in rows if re.search(sym, r[0])]
            seen = sum(r[2] for r in mine)
            if seen >= n:
                break
        if seen != n:
            raise AssertionError(f"{name}: the profiler saw {seen:.0f} "
                                 f"{kname} launches in one call, expected "
                                 f"{n}")
        k_ms = sum(r[1] for r in mine)
        log(f"    {name} profiled: device kernels {dev_ms:.3f} ms/call, "
            f"{100 * dev_ms / t_call:.1f}% of the unprofiled call's "
            f"{t_call:.2f} ms (the profiled call: {wall_ms:.2f} ms); "
            f"{kname} {seen:.0f} launches {k_ms:.3f} ms "
            f"({k_ms / seen * 1e3:.2f} us each)")
        for key, ms, calls, us in rows[:4]:
            log(f"      {ms:8.3f} ms  {calls:6.0f} calls  {us:8.2f} us/call"
                f"  {key[:60]}")


def kernel_entry(name: str, res: dict, launches: int) -> dict:
    """One generate's worth of one GEMM kernel: per-launch numbers of each
    main-path shape it runs, weighted by how often one generate launches
    it (per layer: one prefill launch at M=B*S, GEN-1 decode launches at
    M=B for each of the 7 projections)."""
    rows = res["rows"]
    n_layers = 30
    per_gen = {}
    for k, n in MAIN_KN:
        for m, times in ((PREFILL_M, n_layers), (DECODE_M,
                                                  n_layers * (GEN - 1))):
            per_gen[(m, k, n)] = per_gen.get((m, k, n), 0) + times

    def weight(r):
        return per_gen[(r["m"], r["k"], r["n"])]

    def total(key):
        vals = [r.get(key) for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(r[key] * weight(r) for r in rows)

    by = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        by[r["bound_by"]] += r["bound_ms"] * weight(r)
    meta = GEMM_KERNELS[name]
    entry = dict(
        name=name, route="cuda", **meta, launches=launches,
        max_abs_err=res["max_abs_err"], ms=total("ms"),
        plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by=max(by, key=by.get), library_ms=total("library_ms"),
        per=f"one generate: smollm-135m B={BATCH} prompt={PROMPT} "
            f"gen={GEN}; sums of per-launch times x launches per shape "
            f"({sum(weight(r) for r in rows)} launches)",
        shapes=rows)
    if total("yardstick_ms") is not None:
        entry["yardstick_ms"] = total("yardstick_ms")
        entry["yardstick_note"] = (
            "not library_ms: no one PyTorch call takes packed int4; "
            "common.unpack_w4_words, then one torch._int_mm")
    if total("pad32_int_mm_ms") is not None:
        entry["pad32_int_mm_ms"] = total("pad32_int_mm_ms")
        entry["pad32_int_mm_note"] = (
            "yardstick, not library_ms: x zero-padded to 32 rows, then one "
            "torch._int_mm (which refuses M <= 16)")
    return entry


def _timed_generate(serve, params, prompts, cfg, **kw):
    """(tokens, logits, launch counts, seconds) of one generate call on
    the host clock, ending in a synchronize."""
    from repro_torch.kernels import registry
    before = {c.name: c.count for c in registry.LAUNCH_COUNTERS}
    t0 = time.perf_counter()
    toks, logits = serve.generate(params, prompts, cfg, gen=GEN,
                                  cache_len=PROMPT + GEN, return_logits=True,
                                  **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return toks, logits, {c.name: c.count - before[c.name]
                          for c in registry.LAUNCH_COUNTERS}, secs


def _profiled_generate(serve, params, prompts, cfg, **kw):
    """(tokens, logits, the wrappers' launch counts, launches per wrapper
    counter on the device) of one generate under the profiler: the device
    counts are the kernels the run launched, graph replays included, by
    symbol (`registry.profiled_launches`), in a `registry.profile_window`
    (its prologue takes the profiler's loss of a session's first
    kernels)."""
    from repro_torch.kernels import registry
    with registry.profile_window() as prof:
        toks, logits, counts, _ = _timed_generate(serve, params, prompts,
                                                  cfg, **kw)
    kernels = {e.key: e.count for e in registry.window_events(prof)}
    return toks, logits, counts, registry.profiled_launches(kernels)


def _gemm_name(fmt: str) -> str:
    return "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul"


def _serve_gates(cfg, fmt: str, params, prompts, tag: str) -> dict:
    """Drive one quantized params tree through greedy generate at B=BATCH,
    prompt PROMPT, GEN new tokens: the per-step loop (fused=False), the
    first fused call (prefill, warm-up step, capture), then the main path
    (fused=True, every count set to 0 just before it, launches read from
    the profiler just after), its time unprofiled, and a rerun with the
    plain versions forced.  Gates: launch counts of every run (an untied
    lm_head adds one small-M launch per token, counted by its weight's
    width in the per-step loop); fused == per-step == forced-plain in
    tokens and logits, bit for bit; one capture.  `prompts` is [B, S]
    tokens, or an encdec input (features, dec_tokens).  Returns what the
    caller logs and gates further."""
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm

    name = _gemm_name(fmt)
    # an odd vocab has no w4a8 head: it falls back to w8a8 (granite)
    head_fmt = "w8a8" if fmt == "w4a8" and cfg.vocab % 2 else fmt
    hname = _gemm_name(head_fmt)
    counter = {c.name: c for c in registry.LAUNCH_COUNTERS}[hname]
    head = 0 if cfg.tie_embeddings else 1
    tile = gemms_per_forward(cfg)   # prefill: M = B * S > 16
    step = gemms_per_step(cfg)

    def launches(tile, small, heads):
        want = {c.name: 0 for c in registry.LAUNCH_COUNTERS}
        want[name], want[f"{name}_small_m"] = tile + small, small
        want[hname] += heads                # decode rows: M = B, small-M
        want[f"{hname}_small_m"] += heads
        return want

    # the prefill's lm_head runs on the last position only (M = B)
    want = launches(tile, step * (GEN - 1), head * GEN)
    cache_len = PROMPT + GEN
    serve.generate(params, prompt_prefix(prompts, 8), cfg, gen=2,
                   cache_len=16, fused=False)
    torch.cuda.synchronize()

    def check(toks, logits, counts, what, want=want):
        if counts != want:
            raise AssertionError(f"{tag} {what}: kernel launches "
                                 f"{counts}, expected {want}")
        if tuple(toks.shape) != (BATCH, GEN) or \
                toks.dtype != torch.int32 or \
                not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{tag} {what}: bad tokens "
                                 f"{tuple(toks.shape)} {toks.dtype}")
        if tuple(logits.shape) != (BATCH, GEN, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag} {what}: logits not finite / "
                                 "misshapen")

    def same_as_per_step(toks, logits, what):
        if not torch.equal(toks, toks_s) or not torch.equal(logits,
                                                            logits_s):
            raise AssertionError(
                f"{tag}: {what} differs from the per-step loop (tokens "
                f"equal: {torch.equal(toks, toks_s)}, max logit diff "
                f"{(logits - logits_s).abs().max().item()})")

    def prefill_ms():     # the median of 3, host clock
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            lm.prefill(params, prompts, cfg, cache_len=cache_len)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[1]

    secs, t_part = {}, [time.perf_counter()]

    def part(what):       # seconds of each part of the gates, for the log
        now = time.perf_counter()
        secs[what] = now - t_part[0]
        t_part[0] = now

    # the per-step loop; its wrappers see every launch, the lm_head's by
    # its weight's logical width (only the width is kept: the prefill's
    # activations are not held)
    with counter.capture(lambda ops, _: ops[1].shape[-1]) as rec:
        toks_s, logits_s, counts_s, step_s = _timed_generate(
            serve, params, prompts, cfg, fused=False)
    heads = sum(1 for n in rec
                if n * (2 if head_fmt == "w4a8" else 1) == cfg.vocab)
    del rec
    check(toks_s, logits_s, counts_s, "per-step")
    if heads != head * GEN:
        raise AssertionError(f"{tag} per-step: {heads} lm_head launches, "
                             f"expected {head * GEN}")
    part("per-step loop")
    prefill_before = prefill_ms()
    part("prefills")
    # the first fused call: the prefill, one eager warm-up step and the
    # capture (its wrappers launch into the graph), then the replays
    toks_1, logits_1, counts_1, first_s = _timed_generate(
        serve, params, prompts, cfg)
    check(toks_1, logits_1, counts_1, "first fused call (wrappers)",
          launches(tile, 2 * step, 3 * head))
    same_as_per_step(toks_1, logits_1, "the first fused call")
    bundle = serve._decode_bundle(cfg, "off", "cuda")
    captured = bundle.step
    part("first fused call")
    # the main path: every count from 0, the captured graph replayed
    # under the profiler, which counts what the replays launch.  The
    # profiler has been seen to drop ~1% of one profile's kernel
    # events: a run that falls short of the counts (and exceeds none)
    # is driven again, at most three times in all
    for attempt in range(1, 4):
        for c in registry.LAUNCH_COUNTERS:
            c.reset()
        toks, logits, counts, launched = _profiled_generate(
            serve, params, prompts, cfg)
        short = [k for k, n in launched.items() if n < want[k]]
        if not short or attempt == 3 or \
                any(n > want[k] for k, n in launched.items()):
            break
        log(f"{tag} fused (profiled), run {attempt}: launches "
            f"{launched} short of {want}; driven again")
    part(f"profiled main path ({attempt} run{'s' * (attempt > 1)})")
    check(toks, logits, launched, "fused (profiled)")
    check(toks, logits, counts, "fused (wrappers: no eager decode step)",
          launches(tile, 0, head))
    same_as_per_step(toks, logits, "fused decode")
    # its time, unprofiled
    toks_t, logits_t, _, total_s = _timed_generate(serve, params,
                                                   prompts, cfg)
    same_as_per_step(toks_t, logits_t, "fused decode")
    if bundle.captures != 1:
        raise AssertionError(f"{tag}: {bundle.captures} captures, "
                             "expected 1")

    prefill_after = prefill_ms()
    prefill_s = (prefill_before + prefill_after) / 2e3
    # the replays alone: GEN-1 decode steps after a prefill
    lg, kv = lm.prefill(params, prompts, cfg, cache_len=cache_len)
    tok0 = lg[:, -1].argmax(dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured.run(tok0, kv, PROMPT, GEN - 1)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / (GEN - 1)
    del lg, kv
    step_ms = (step_s - prefill_s) / (GEN - 1) * 1e3
    fused_ms = (total_s - prefill_s) / (GEN - 1) * 1e3
    log(f"{tag}: prefill {prefill_before:.1f} ms before the capture, "
        f"{prefill_after:.1f} ms after it (medians of 3); decode "
        "per-step "
        f"{step_ms:.2f} ms/step (generate {step_s * 1e3:.1f} ms, "
        f"{BATCH * GEN / step_s:.1f} tok/s), fused {fused_ms:.2f} "
        f"ms/step (replays alone {replay_ms:.2f} ms/step; generate "
        f"{total_s * 1e3:.1f} ms, "
        f"{BATCH * GEN / total_s:.1f} tok/s); first fused call "
        f"{first_s * 1e3:.1f} ms, capture {captured.capture_ms:.1f} "
        f"ms; kernel launches per generate, profiled {launched}, "
        f"counted by the wrappers {counts} (lm_head {heads} per "
        "generate); fused tokens and logits identical to the per-step "
        "loop's")

    part("timed run, prefills, replays")
    before = {c.name: c.count for c in registry.LAUNCH_COUNTERS}
    with registry.force("ref"):
        toks_p, logits_p = serve.generate(params, prompts, cfg, gen=GEN,
                                          cache_len=cache_len,
                                          return_logits=True)
    torch.cuda.synchronize()
    part("plain-forced run")
    if {c.name: c.count for c in registry.LAUNCH_COUNTERS} != before:
        raise AssertionError(f"{tag}: forced plain run launched kernels")
    if not torch.equal(toks, toks_p) or not torch.equal(logits, logits_p):
        raise AssertionError(
            f"{tag}: kernel path differs from the plain-forced path "
            f"(tokens equal: {torch.equal(toks, toks_p)}, max logit "
            f"diff {(logits - logits_p).abs().max().item()})")
    log(f"{tag}: tokens and logits identical to the plain-forced run; "
        f"sample tokens {toks[0, :16].tolist()}; the gates' seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return dict(toks=toks, logits=logits, launched=launched,
                captured=captured, bundle=bundle, prefill_s=prefill_s,
                step_ms=step_ms, fused_ms=fused_ms, replay_ms=replay_ms,
                capture_ms=captured.capture_ms,
                prefill_ms=(prefill_before + prefill_after) / 2)


def phase_generate(torch, kernel_results: dict) -> list:
    """Full-width greedy generation under w4a8 and w8a8: the per-step
    loop (fused=False) and the captured CUDA-graph decode (fused=True,
    the default: the main path), each gated on its launch counts; fused
    == per-step == plain-forced in tokens and logits, bit for bit
    (`_serve_gates`); --silvia all == off in tokens; decode ms/step of
    both loops, the capture time, and profiles of an eager and a
    replayed decode step."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config("smollm-135m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    cache_len = PROMPT + GEN
    entries = []
    for fmt in ("w4a8", "w8a8"):
        name = _gemm_name(fmt)
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        r = _serve_gates(cfg, fmt, params, prompts, fmt)
        toks, logits, launched = r["toks"], r["logits"], r["launched"]
        captured, prefill_s = r["captured"], r["prefill_s"]

        first_a = _timed_generate(serve, params, prompts, cfg,
                                  silvia_passes="all")[3]
        silvia_s = _timed_generate(serve, params, prompts, cfg,
                                   silvia_passes="all")[3]
        toks_a, logits_a, _, launched_a = _profiled_generate(
            serve, params, prompts, cfg, silvia_passes="all")
        if not torch.equal(toks_a, toks):
            raise AssertionError(f"{fmt}: --silvia all tokens differ from "
                                 "off")
        swar = {k: n for k, n in launched_a.items()
                if k not in (name, f"{name}_small_m") and n}
        log(f"{fmt} --silvia all: tokens identical to off, logits "
            f"{'identical' if torch.equal(logits_a, logits) else 'DIFFER'}"
            f"; first call (trace + capture) {first_a * 1e3:.1f} ms, fused "
            f"decode {(silvia_s - prefill_s) / (GEN - 1) * 1e3:.2f} "
            f"ms/step; SWAR launches (profiled) {swar or 'none'}; passes "
            f"{serve.get_decode_step(cfg, 'all').cache_info()}")

        small_b2b = _small_m_back_to_back_us(kernel_results[
            f"{name}_small_m"])
        decode_profile(torch, params, cfg, prompts, cache_len, fmt,
                       small_b2b)
        replay_profile(torch, captured, params, cfg, prompts, cache_len,
                       fmt, small_b2b)
        small = launched[f"{name}_small_m"]
        entries += [
            kernel_entry(name, kernel_results[name], launched[name] - small),
            kernel_entry(f"{name}_small_m",
                         kernel_results[f"{name}_small_m"], small)]
        del params, logits, logits_a, captured, r
        serve.decode_cache_clear()
        torch.cuda.empty_cache()

    # a small input against its CPU run (plain versions there)
    red = configs.get_reduced_config("smollm-135m")
    rng_prompts = torch.randint(0, red.vocab, (2, 8), generator=gen,
                                device="cuda")
    for fmt in ("w4a8", "w8a8"):
        p_gpu = serve.build_params(red, fmt, seed=0, quant_force=True,
                                   device="cuda")
        p_cpu = _to_cpu(p_gpu)     # the same weights on both devices
        lg, _ = lm.prefill(p_gpu, rng_prompts, red, cache_len=8)
        lc, _ = lm.prefill(p_cpu, rng_prompts.cpu(), red, cache_len=8)
        diff = (lg.cpu() - lc).abs().max().item()
        if not diff <= CPU_LOGIT_ATOL:
            raise AssertionError(f"reduced {fmt}: card vs CPU prefill logits "
                                 f"differ by {diff} > {CPU_LOGIT_ATOL}")
        log(f"reduced {fmt}: card vs CPU prefill logits max diff {diff:.3g}")
    return entries


# phase 7: qwen's biases are drawn nonzero (the init's are zeros)
QWEN_BIAS_STD = 0.1
# the int8 cache against the bf16 one: the bound of the reference's
# tests/test_perf_variants.py::test_int8_kv_decode_accuracy, relative to
# the largest |logit|
INT8_KV_REL = 0.05
# yi-6b at half its depth (16 of 32 layers; every width kept) in both of
# its paths: a layer's gates are those of every other, and phase 9 took
# the whole run past ~480 s
YI_LAYERS = 16
# yi-6b's prefill with and without attn_q_chunk, in a float32 config
CHUNK_B, CHUNK_S, Q_CHUNK, CHUNK_REL = 2, 2048, 512, 1e-4


def step_weight_bytes(cfg, fmt: str) -> float:
    """Weight bytes one decode step reads, from param_count: the blocks
    and an untied lm_head in the format's bytes per weight (an odd vocab's
    head in int8: no w4a8 there), a tied head as the bf16 embedding (the
    embedding lookup reads B rows, left out); scales and activations left
    out.  A moe layer reads every expert: the serving path runs all of
    them on every token (mlp.moe); its float32 router is counted at the
    format's bytes too (0.06% of granite's), as an ssm layer's conv taps,
    A_log, D, dt_bias and gated-norm weight are (0.08% of mamba2's).
    The recurrent state is `step_state_bytes`.  An encdec step reads the
    decoder's GEMM weights only (self q k v o, cross q o, the MLP's two;
    the encoder's and the cross k, v ran at the prefill)."""
    emb = cfg.vocab * cfg.d_model
    blocks = cfg.param_count() - emb * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "encdec":
        d = cfg.d_model
        blocks = cfg.n_decoder_layers * (
            d * cfg.q_dim * 2 + d * cfg.kv_dim * 2 + 2 * d * cfg.q_dim
            + 2 * d * cfg.d_ff)
    per = 0.5 if fmt == "w4a8" else 1.0
    head = 1.0 if cfg.vocab % 2 else per
    return blocks * per + (2.0 * emb if cfg.tie_embeddings else head * emb)


def phase_dense(wide_us: dict) -> dict:
    """Phase 7, full-width dense serving beyond smollm (random weights from
    seeded torch.Generators; yi-6b at YI_LAYERS of its 32 layers): yi-6b
    under w4a8 and w8a8 with the bf16
    cache, and qwen1.5-0.5b under w8a8 with the int8 cache and nonzero
    q/k/v biases, each through `_serve_gates` (B=8, prompt 128, 32 new
    tokens; fused == per-step == forced-plain, bit for bit; yi's untied
    lm_head counted); qwen's int8-cache logits against the bf16 cache's
    on the same weights, teacher-forced on the int8 run's tokens, within
    INT8_KV_REL of the largest logit at the first step and the last; and
    yi-6b's prefill (B=2, prompt 2048, float32 config, w4a8) with
    attn_q_chunk=512 against the unchunked one: logits within CHUNK_REL
    of the largest |logit| and a lower peak of allocated memory.  Each
    served path's replayed decode step is profiled, its small-M GEMM
    launches against their back-to-back times (`wide_us`, from
    phase_wide_gemms).  Returns {GEMM counter: {path: launches}} of the
    main paths it drove."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    gen = torch.Generator(device="cuda").manual_seed(7)
    launches = {}

    def record(tag, fmt, launched):
        name = _gemm_name(fmt)
        small = launched[f"{name}_small_m"]
        launches.setdefault(name, {})[tag] = launched[name] - small
        launches.setdefault(f"{name}_small_m", {})[tag] = small

    def release():
        serve.decode_cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def profile(cfg, fmt, params, prompts, r, tag):
        d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
        kn = [(d, q), (d, kv), (d, kv), (q, d), (d, ff), (d, ff), (ff, d)]
        if not cfg.tie_embeddings:
            kn.append((d, cfg.vocab))
        per = wide_us[(f"{_gemm_name(fmt)}_small_m", cfg.name)]
        b2b = sum(per[x] for x in kn[:7]) * cfg.n_layers
        b2b = (b2b + sum(per[x] for x in kn[7:])) / (
            7 * cfg.n_layers + len(kn) - 7)
        replay_profile(torch, r["captured"], params, cfg, prompts,
                       PROMPT + GEN, tag, b2b)

    def bound_note(cfg, fmt, r):
        nbytes = step_weight_bytes(cfg, fmt)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        return (f"decode bound {b:.3f} ms/step ({nbytes / 1e9:.2f} GB of "
                f"weights at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): fused "
                f"{r['fused_ms']:.2f} ms/step, {100 * b / r['fused_ms']:.1f}%"
                f" of it; replays alone {r['replay_ms']:.2f}")

    cfg = dataclasses.replace(configs.get_config("yi-6b"), n_layers=YI_LAYERS)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    for fmt in ("w4a8", "w8a8"):
        tag = f"yi-6b {YI_LAYERS}L {fmt}"
        t0 = time.perf_counter()
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        r = _serve_gates(cfg, fmt, params, prompts, tag)
        record(tag, fmt, r["launched"])
        profile(cfg, fmt, params, prompts, r, tag)
        log(f"{tag}: built and quantized in {t_build:.1f} s; "
            f"{bound_note(cfg, fmt, r)}; phase {time.perf_counter() - t0:.1f}"
            " s")
        del params, r
        release()

    t0 = time.perf_counter()
    bcfg = configs.get_config("qwen1.5-0.5b")
    qcfg = dataclasses.replace(bcfg, serve_kv_dtype="int8")
    tag = "qwen1.5-0.5b w8a8 int8-KV"
    params = serve.build_params(qcfg, "w8a8", seed=0, device="cuda")
    attn = params["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = (torch.randn(attn[b].shape, generator=gen, device="cuda")
                   * QWEN_BIAS_STD).to(attn[b].dtype)
    prompts = torch.randint(0, qcfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    r = _serve_gates(qcfg, "w8a8", params, prompts, tag)
    record(tag, "w8a8", r["launched"])
    profile(qcfg, "w8a8", params, prompts, r, tag)
    kv = r["captured"].cache
    if set(kv) != {"k", "v", "k_s", "v_s"} or kv["k"].dtype != torch.int8:
        raise AssertionError(f"{tag}: the captured step's cache is "
                             f"{ {k: t.dtype for k, t in kv.items()} }")
    toks, logits = r["toks"], r["logits"]
    lg, cache = lm.prefill(params, prompts, bcfg, cache_len=PROMPT + GEN)
    ref = [lg[:, -1]]
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int64, device="cuda")
    for i in range(GEN - 1):
        lg, _ = lm.decode_step(params, toks[:, i:i + 1], cache, pos + i, bcfg)
        ref.append(lg[:, -1])
    ref = torch.stack(ref, dim=1)
    rel = [((logits[:, i] - ref[:, i]).abs().max()
            / ref[:, i].abs().max()).item() for i in range(GEN)]
    for step in (0, GEN - 1):
        if not rel[step] <= INT8_KV_REL:
            raise AssertionError(f"{tag}: step {step} logits differ from the "
                                 f"bf16 cache's by {rel[step]:.4g} of the "
                                 f"largest, over {INT8_KV_REL}")
    log(f"{tag}: against the bf16 cache on the same weights (teacher-forced "
        f"on the int8 run's tokens), logits differ by {rel[0]:.3g} of the "
        f"largest at the first step and {rel[GEN - 1]:.3g} at the last "
        f"(bound {INT8_KV_REL}; over all steps {min(rel[1:]):.3g}-"
        f"{max(rel):.3g}, mean {sum(rel[1:]) / (GEN - 1):.3g}); {bound_note(bcfg, 'w8a8', r)}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    del params, attn, r, kv, logits, ref, lg, cache
    release()

    t0 = time.perf_counter()
    fcfg = dataclasses.replace(configs.get_config("yi-6b"), dtype="float32",
                               n_layers=YI_LAYERS)
    params = serve.build_params(fcfg, "w4a8", seed=0, device="cuda")
    release()
    prompts = torch.randint(0, fcfg.vocab, (CHUNK_B, CHUNK_S), generator=gen,
                            device="cuda")
    runs = {}
    for label, c in (("unchunked", fcfg), ("chunked", dataclasses.replace(
            fcfg, attn_q_chunk=Q_CHUNK))):
        lm.prefill(params, prompts[:, :2 * Q_CHUNK], c,
                   cache_len=2 * Q_CHUNK)        # warm-up, chunked if c is
        release()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        lg, _ = lm.prefill(params, prompts, c, cache_len=CHUNK_S)
        torch.cuda.synchronize()
        runs[label] = (lg, (time.perf_counter() - t1) * 1e3,
                       torch.cuda.max_memory_allocated(), base)
        del _
    (lg0, ms0, peak0, base0), (lg1, ms1, peak1, base1) = runs.values()
    diff = ((lg1 - lg0).abs().max() / lg0.abs().max()).item()
    if not bool(torch.isfinite(lg1).all()) or not diff <= CHUNK_REL:
        raise AssertionError(f"yi-6b f32 prefill: chunked logits differ by "
                             f"{diff:.3g} of the largest, over {CHUNK_REL}")
    if not peak1 < peak0:
        raise AssertionError(f"yi-6b f32 prefill: chunked peak {peak1} B "
                             f"not below the unchunked {peak0} B")
    log(f"yi-6b {YI_LAYERS}L f32 w4a8 prefill B={CHUNK_B} S={CHUNK_S}: "
        f"attn_q_chunk="
        f"{Q_CHUNK} logits within {diff:.3g} of the largest |logit| (bound "
        f"{CHUNK_REL}); peak allocated {peak0 / 2**30:.3f} GiB unchunked, "
        f"{peak1 / 2**30:.3f} GiB chunked ({(peak0 - base0) / 2**30:.3f} / "
        f"{(peak1 - base1) / 2**30:.3f} GiB above the {base0 / 2**30:.3f} "
        f"GiB before the call); prefill {ms0:.1f} / {ms1:.1f} ms; phase "
        f"{time.perf_counter() - t0:.1f} s")
    del params, runs, lg0, lg1
    release()
    return launches


# phase 8: the MoE family.  Expert widths (E, K, N): granite's three
# expert GEMMs, and arctic's on a 4-expert slice of its 128
GRANITE_EXPERT_KN = [(1024, 512), (512, 1024)]
ARCTIC_EXPERT_KN = [(7168, 4864), (4864, 7168)]
EXPERT_M = (1, DECODE_M, 16, 17, PREFILL_M)
# one stacked weight past 2^31 bytes: arctic-shaped, all 128 experts
BIG_EXPERTS = (128, 7168, 4864)


def bound_ms_experts(e: int, m: int, k: int, n: int, w_bytes: int,
                     shared: bool) -> tuple:
    """bound_ms of one launch over E experts: x read once (once for all
    experts when shared), the stacked weights, both scales, the E f32
    outputs, against 2*E*M*K*N int8 operations."""
    nbytes = m * k * (1 if shared else e) + w_bytes + 4 * m * (
        1 if shared else e) + 4 * e * n + 4 * e * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * e * m * k * n / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_device_ms(fn, n_iter: int) -> float:
    """The median of three device_ms runs: in one run of phase 8 two
    shapes read 3.9x and 11x the per-launch time that another run read
    (cause not measured), and one reading weighs 5208 launches in the
    per-generate sums."""
    return sorted(device_ms(torch, fn, n_iter) for _ in range(3))[1]


def phase_moe_gemms() -> dict:
    """Both GEMM kernels on expert-stacked weights, bit for bit (acc and
    f32 out, `torch.equal`) against their batched plain versions: granite's
    expert widths (E = 32; (K, N) = (1024, 512), (512, 1024)) and arctic's
    on an E = 4 slice ((7168, 4864), (4864, 7168)), at M = 1, 8, 16, 17,
    1024 rows per expert, with x per expert and x shared by every expert
    (expert stride 0, the per-token path's wi / wg); each call ONE launch
    (on the small-M counter for M <= 16 rows per expert); E = 1 equal to
    the 2-D entry.  Then one stacked weight past 2^31 bytes (arctic-shaped
    E = 128 at (7168, 4864): 4.46 GB int8, 2.23 GB packed; M = 8), the
    plain version compared in expert slices.  Granite's attention and
    head widths gate the 2-D entries.  Logs per-launch times (CUDA events,
    L2 spilled; the median of three runs) beside the bounds; returns
    {(kernel, M, K, N, E, shared x): ms} of granite's widths at M = 8 and
    1024, for the per-generate sums."""
    from repro_torch import configs
    from repro_torch.kernels import packed_matmul, quant_matmul, ref

    gen = torch.Generator(device="cuda").manual_seed(2468)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 0.02 + 1e-3

    specs = [("quant_matmul", quant_matmul, ref.quant_matmul_acc_ref,
              ref.quant_matmul_ref, 1),
             ("packed_w4_matmul", packed_matmul,
              ref.packed_w4_matmul_acc_ref, ref.packed_w4_matmul_ref, 2)]
    cfg = configs.get_config("granite-moe-1b-a400m")
    times = {}
    t0 = time.perf_counter()
    n_cases = 0

    def gate(name, mod, acc_ref, out_ref, x, w, xs, ws, what, plain=True):
        acc_fn, out_fn = getattr(mod, f"{name}_acc"), getattr(mod, name)
        m = x.shape[-2]
        before = (mod.LAUNCHES.count, mod.SMALL_M_LAUNCHES.count)
        acc_k, out_k = acc_fn(x, w), out_fn(x, w, xs, ws)
        torch.cuda.synchronize()
        small = 2 if m <= quant_matmul.SMALL_M else 0
        if (mod.LAUNCHES.count - before[0],
                mod.SMALL_M_LAUNCHES.count - before[1]) != (2, small):
            raise AssertionError(f"{name} {what}: launches "
                                 f"{mod.LAUNCHES.count - before[0]} / small-M "
                                 f"{mod.SMALL_M_LAUNCHES.count - before[1]}, "
                                 f"expected 2 / {small} (one per call)")
        if plain and not (torch.equal(acc_k, acc_ref(x, w))
                          and torch.equal(out_k, out_ref(x, w, xs, ws))):
            raise AssertionError(f"{name} {what}: differs from the plain "
                                 "version")
        return acc_k, out_k

    for name, mod, acc_ref, out_ref, per in specs:
        out_fn = getattr(mod, name)
        for e, kns in ((cfg.moe.n_experts, GRANITE_EXPERT_KN),
                       (4, ARCTIC_EXPERT_KN)):
            for k, n in kns:
                w, ws = i8(e, k, n // per), scales(e, 1, n)
                copies = [w] + [i8(*w.shape) for _ in range(
                    math.ceil(128e6 / w.numel()) - 1)]
                for m in EXPERT_M:
                    for shared in (False, True):
                        if e == 4 and shared and m not in (DECODE_M,
                                                           PREFILL_M):
                            continue
                        if shared:
                            x = i8(m, k).expand(e, m, k)
                            xs = scales(m, 1).expand(e, m, 1)
                        else:
                            x, xs = i8(e, m, k), scales(e, m, 1)
                        what = (f"E={e} M={m} K={k} N={n}"
                                f"{' shared x' if shared else ''}")
                        _, out_k = gate(name, mod, acc_ref, out_ref, x, w, xs,
                                        ws, what)
                        one = out_fn(x[:1].contiguous(), w[:1],
                                     xs[:1].contiguous(), ws[:1])
                        two = out_fn(x[0].contiguous(), w[0],
                                     xs[0].contiguous(), ws[0])
                        if not (torch.equal(one[0], two)
                                and torch.equal(out_k[0], two)):
                            raise AssertionError(f"{name} {what}: E = 1 "
                                                 "differs from the 2-D entry")
                        n_cases += 1
                        if m not in (DECODE_M, PREFILL_M):
                            continue
                        t = median_device_ms(lambda i: out_fn(
                            x, copies[i % len(copies)], xs, ws),
                            100 if m == DECODE_M else 20)
                        b_ms, b_by = bound_ms_experts(e, m, k, n, w.numel(),
                                                      shared)
                        kname = name + ("_small_m" if m <= 16 else "")
                        if e == cfg.moe.n_experts:
                            times[(kname, m, k, n, e, shared)] = t
                        log(f"  {kname:24s} {what:34s} kernel "
                            f"{t * 1e3:9.2f} us  bound {b_ms * 1e3:8.2f} us "
                            f"({b_by}, {100 * b_ms / t:.1f}%)")
                del w, ws, copies, x, xs
                torch.cuda.empty_cache()
        # granite's attention and head widths, 2-D
        d = cfg.d_model
        for k, n in dict.fromkeys([(d, cfg.q_dim), (d, cfg.kv_dim),
                                   (cfg.q_dim, d), (d, cfg.vocab)]):
            if n % per:
                continue                 # the odd head: w8a8 only
            w, ws = i8(k, n // per), scales(1, n)
            copies = [w] + [i8(*w.shape) for _ in range(
                math.ceil(128e6 / w.numel()) - 1)]
            for m in (DECODE_M, PREFILL_M):
                x, xs = i8(m, k), scales(m, 1)
                gate(name, mod, acc_ref, out_ref, x, w, xs, ws,
                     f"M={m} K={k} N={n}")
                n_cases += 1
                t = median_device_ms(lambda i: out_fn(
                    x, copies[i % len(copies)], xs, ws),
                    100 if m == DECODE_M else 20)
                b_ms, b_by = bound_ms(m, k, n, w.numel())
                kname = name + ("_small_m" if m <= 16 else "")
                times[(kname, m, k, n, 1, False)] = t
                log(f"  {kname:24s} {'M=%d K=%d N=%d (2-D)' % (m, k, n):34s} "
                    f"kernel {t * 1e3:9.2f} us  bound {b_ms * 1e3:8.2f} us "
                    f"({b_by}, {100 * b_ms / t:.1f}%)")
            del w, ws, copies
            torch.cuda.empty_cache()

    # one stacked weight past 2^31 bytes: experts past the int32 offset
    e, k, n = BIG_EXPERTS
    for name, mod, acc_ref, out_ref, per in specs:
        w = i8(e, k, n // per)
        ws = scales(e, 1, n)
        x, xs = i8(e, DECODE_M, k), scales(e, DECODE_M, 1)
        what = f"E={e} M={DECODE_M} K={k} N={n} ({w.numel() / 1e9:.2f} GB)"
        acc_k, out_k = gate(name, mod, acc_ref, out_ref, x, w, xs, ws, what,
                            plain=False)
        last = None
        for e0 in range(0, e, 16):        # the plain version's float64 copy
            sl = slice(e0, e0 + 16)
            if not (torch.equal(acc_k[sl], acc_ref(x[sl], w[sl])) and
                    torch.equal(out_k[sl], out_ref(x[sl], w[sl], xs[sl],
                                                   ws[sl]))):
                raise AssertionError(f"{name} {what}: experts {e0}.. differ "
                                     "from the plain version")
            last = e0 + 15
        t = device_ms(torch, lambda i: getattr(mod, name)(x, w, xs, ws), 5)
        b_ms, b_by = bound_ms_experts(e, DECODE_M, k, n, w.numel(), False)
        log(f"  {name + '_small_m':24s} {what}: bit-identical to the plain "
            f"version in all {last + 1} experts (expert {e - 1} at byte "
            f"{(e - 1) * k * n // per:,}, past 2^31); kernel "
            f"{t * 1e3:9.2f} us  bound {b_ms * 1e3:8.2f} us ({b_by}, "
            f"{100 * b_ms / t:.1f}%)")
        del w, ws, x, xs, acc_k, out_k
        torch.cuda.empty_cache()
    log(f"expert-stacked GEMM gates: both kernels bit-identical to the plain "
        f"versions at {n_cases} cases (one launch per call; E = 1 equal to "
        f"the 2-D entry) in {time.perf_counter() - t0:.1f} s")
    return times


def moe_per_generate(cfg, fmt: str, times: dict) -> dict:
    """One generate's worth (B=BATCH, prompt PROMPT, GEN new tokens) of
    each GEMM kernel on granite's path, from phase_moe_gemms' per-launch
    times: per layer the prefill's 7 tile launches (4 attention, 3
    expert-stacked) and 7 small-M launches per decode step; the head's
    small-M launch per token.  {kernel: (launches, ms, bound_ms)}."""
    name = _gemm_name(fmt)
    hname = _gemm_name("w8a8" if fmt == "w4a8" and cfg.vocab % 2 else fmt)
    per = 2 if fmt == "w4a8" else 1
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    layer = [(d, cfg.q_dim, 1, False), (d, cfg.kv_dim, 1, False),
             (d, cfg.kv_dim, 1, False), (cfg.q_dim, d, 1, False),
             (d, f, e, True), (d, f, e, True), (f, d, e, False)]
    out = {}

    def add(kname, m, k, n, ee, shared, count, wper):
        t = times[(kname, m, k, n, ee, shared)]
        b, _ = (bound_ms_experts(ee, m, k, n, ee * k * n // wper, shared)
                if ee > 1 else bound_ms(m, k, n, k * n // wper))
        c, ms, bd = out.get(kname, (0, 0.0, 0.0))
        out[kname] = (c + count, ms + t * count, bd + b * count)

    for k, n, ee, shared in layer:
        add(name, PREFILL_M, k, n, ee, shared, cfg.n_layers, per)
        add(f"{name}_small_m", DECODE_M, k, n, ee, shared,
            cfg.n_layers * (GEN - 1), per)
    add(f"{hname}_small_m", DECODE_M, d, cfg.vocab, 1, False, GEN,
        1 if hname == "quant_matmul" else 2)
    return out


def phase_moe(times: dict) -> dict:
    """Phase 8: granite-moe-1b-a400m served at full width (24 layers,
    d 1024, 32 experts of d_ff 512, vocab 49155; nothing cut; random
    weights from seed 0), B=8, prompt 128, 32 new tokens, greedy, w4a8
    and w8a8, bf16 cache, through `_serve_gates` (fused == per-step ==
    plain-forced, bit for bit; launches counted: 24 x 7 GEMMs per step,
    the three expert-stacked ones one launch each, and the odd-vocab head
    in w8a8 under both formats); --silvia all == off in tokens; a
    replayed step's profile; the step's weight-byte bound (all 32 experts
    are read every step).  Returns ({GEMM counter: {path: launches}},
    {path: {GEMM counter: its launches, ms and bound_ms per generate}})."""
    from repro_torch import configs
    from repro_torch.launch import serve

    cfg = configs.get_config("granite-moe-1b-a400m")
    gen = torch.Generator(device="cuda").manual_seed(11)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    launches, per_generate = {}, {}
    for fmt in ("w4a8", "w8a8"):
        tag = f"granite-moe-1b-a400m {fmt}"
        t0 = time.perf_counter()
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        head = params["lm_head"]
        moe = params["blocks"]["moe"]
        if head.fmt != "w8a8" or moe["wi"].fmt != fmt or \
                tuple(moe["wi"].scale.shape) != (cfg.n_layers,
                                                  cfg.moe.n_experts, 1,
                                                  cfg.moe.d_ff_expert) or \
                moe["router"].dtype != torch.float32:
            raise AssertionError(f"{tag}: quantized tree {head.fmt} head, "
                                 f"{moe['wi'].fmt} experts "
                                 f"{tuple(moe['wi'].scale.shape)} scales, "
                                 f"router {moe['router'].dtype}")
        r = _serve_gates(cfg, fmt, params, prompts, tag)
        for k in ("quant_matmul", "packed_w4_matmul"):   # as phase_dense's
            small = r["launched"][f"{k}_small_m"]
            for kname, n in ((k, r["launched"][k] - small),
                             (f"{k}_small_m", small)):
                if n:
                    launches.setdefault(kname, {})[tag] = n
        first_a = _timed_generate(serve, params, prompts, cfg,
                                  silvia_passes="all")[3]
        toks_a, logits_a, _, silvia_s = _timed_generate(
            serve, params, prompts, cfg, silvia_passes="all")
        if not torch.equal(toks_a, r["toks"]):
            raise AssertionError(f"{tag}: --silvia all tokens differ from off")
        same = "identical" if torch.equal(logits_a, r["logits"]) \
            else "DIFFER"
        log(f"{tag} --silvia all: tokens identical to off, logits {same}"
            f"; first call (trace + capture) {first_a * 1e3:.1f} ms, fused "
            f"decode {(silvia_s - r['prefill_s']) / (GEN - 1) * 1e3:.2f} "
            f"ms/step; passes "
            f"{serve.get_decode_step(cfg, 'all').cache_info()}")
        # the replayed steps' small-M launches (the profiled main path)
        small = sum(n for k, n in r["launched"].items()
                    if k.endswith("_small_m"))
        per_step = (small - 1) / (GEN - 1)   # the prefill's head: one
        if per_step != 7 * cfg.n_layers + 1:
            raise AssertionError(f"{tag}: {per_step} small-M launches per "
                                 f"replayed step, expected "
                                 f"{7 * cfg.n_layers + 1}")
        per_gen = moe_per_generate(cfg, fmt, times)
        small = [k for k in per_gen if k.endswith("_small_m")]
        b2b = sum(per_gen[k][1] for k in small) / sum(
            per_gen[k][0] for k in small) * 1e3
        replay_profile(torch, r["captured"], params, cfg, prompts,
                       PROMPT + GEN, tag, b2b)
        nbytes = step_weight_bytes(cfg, fmt)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        for k, (c, _, _) in per_gen.items():     # the profiled launches
            seen = r["launched"][k] if k.endswith("_small_m") else \
                r["launched"][k] - r["launched"][f"{k}_small_m"]
            if c != seen:
                raise AssertionError(f"{tag}: {k} launched {seen} times, "
                                     f"the per-generate sum counts {c}")
        log(f"{tag}: {per_step:.0f} small-M launches per replayed decode "
            f"step (profiled); built and quantized in {t_build:.1f} s; GEMM "
            "kernels "
            "per generate (per-launch times x launches, phase 8's gates): "
            + "; ".join(f"{k} {c} launches {ms:.3f} ms (bound {bd:.3f})"
                        for k, (c, ms, bd) in per_gen.items())
            + f"; decode bound {b:.3f} ms/step ({nbytes / 1e9:.3f} GB of "
            f"weights, every expert, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): "
            f"fused {r['fused_ms']:.2f} ms/step, {100 * b / r['fused_ms']:.1f}"
            f"% of it; replays alone {r['replay_ms']:.2f}; phase "
            f"{time.perf_counter() - t0:.1f} s")
        per_generate[tag] = {k: dict(launches=c, ms=ms, bound_ms=bd)
                             for k, (c, ms, bd) in per_gen.items()}
        del params, head, moe, r, toks_a, logits_a
        serve.decode_cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches, per_generate


# phase 9: the SSM family
SSM_ARCH = "mamba2-2.7b"
# mamba2-2.7b at a quarter of its depth (16 of 64 layers; every width
# kept) in both of its paths: a layer's gates are those of every other;
# cut to 32 when phase 10 took the whole run past ~600 s, to 16 when
# phase 11 took it past ~700 s
SSM_LAYERS = 16
# the reduced model against its CPU run: a prompt of three chunks of 16
SSM_CPU_PROMPT, SSM_CPU_STEPS = 40, 3


def ssm_prefill_m(cfg) -> int:
    """The prefill GEMMs' rows: the fixed chunk grid pads a PROMPT-token
    prompt to a multiple of the chunk (128 -> 256 for mamba2)."""
    q = cfg.ssm.chunk
    return BATCH * (-(-PROMPT // q) * q)


def step_state_bytes(cfg, cache_len: int = PROMPT + GEN) -> float:
    """State bytes one decode step reads and writes (0 for the dense and
    moe families, whose KV cache is not counted; for vlm each layer's KV
    cache [B, cache_len, KV, D], k and v, read once and one position of
    it written): per mixer layer the float32
    SSM state [B, H, P, N] and the conv window [B, W-1, ch] in cfg.dtype,
    each read once and written once; for the hybrid family also its
    attention layers' KV cache [B, cache_len, KV, D] (k and v) read once
    (the decode attends over the whole buffer) and one position of it
    written; for encdec each decoder layer's self KV the same way and its
    cross K/V [B, S_enc, KV, D] (k and v) read once (never written)."""
    elt = getattr(torch, cfg.dtype).itemsize
    kv = 2 * BATCH * cfg.kv_dim * elt * (cache_len + 1)
    if cfg.family == "encdec":
        cross = 2 * BATCH * cfg.kv_dim * elt * ENC_FRAMES
        return cfg.n_decoder_layers * (kv + cross)
    if cfg.family == "vlm":
        return cfg.n_layers * kv
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    from repro_torch.models import ssm
    s, _, n_heads, ch = ssm.dims(cfg)
    per_layer = BATCH * (n_heads * s.headdim * s.d_state * 4
                         + (s.conv_width - 1) * ch * elt)
    if cfg.family == "ssm":
        return 2.0 * cfg.n_layers * per_layer
    units, n = cfg.n_layers // cfg.hybrid.period, hybrid_kinds(cfg)
    return units * (2.0 * n["mamba"] * per_layer + n["attn"] * kv)


def phase_ssm() -> tuple:
    """Phase 9: the SSM family.  Both GEMM kernels bit for bit at
    mamba2-2.7b's widths, in_proj (2560, 10576) and out_proj (5120,
    2560), at M = 8 and the prefill's M = 2048 (`phase_wide_gemms`; the
    packed tile's w rows of 5288 bytes take the byte path).  Then
    mamba2-2.7b served at every width (d 2560, 80 heads of 64, d_state
    128, tied vocab 50280; random weights from seed 0) at SSM_LAYERS of
    its 64 layers, B=8, prompt 128, 32 new tokens, greedy, w4a8 and w8a8,
    through `_serve_gates` (fused == per-step == plain-forced, bit for
    bit; 2 tile launches per layer and prefill, 2 small-M per layer and
    replayed step,
    none of the other format); the captured step's static buffers are
    the {ssm, conv} state; --silvia all == off in tokens; the profiles
    of a replayed step and of a prefill; rows 1-2's time per generate
    beside their bounds; the step's byte bound with and without the
    state's read and write.  Then the reduced model on the card against
    its CPU run.  Returns
    ({GEMM counter: {path: launches}}, {path: {GEMM counter: launches,
    ms and bound_ms per generate}})."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config(SSM_ARCH),
                              n_layers=SSM_LAYERS)
    m_pre = ssm_prefill_m(cfg)
    t0 = time.perf_counter()
    times = phase_wide_gemms(torch, archs=(SSM_ARCH,), prefill_m=m_pre)
    log(f"{SSM_ARCH} GEMM gates: {time.perf_counter() - t0:.1f} s")
    kn = gemm_widths(cfg)
    gen = torch.Generator(device="cuda").manual_seed(13)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    per_fwd = gemms_per_forward(cfg)
    launches, per_generate = {}, {}
    for fmt in ("w4a8", "w8a8"):
        tag = f"{SSM_ARCH} {SSM_LAYERS}L {fmt}"
        name = _gemm_name(fmt)
        t1 = time.perf_counter()
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t1
        mixer = params["blocks"]["ssm"]
        floats = {k: mixer[k].dtype for k in ("conv_w", "conv_b", "A_log",
                                             "D", "dt_bias", "norm_w")}
        if "lm_head" in params or any(
                mixer[k].fmt != fmt for k in ("in_proj", "out_proj")) or \
                floats != {"conv_w": torch.bfloat16,
                           "conv_b": torch.bfloat16,
                           "A_log": torch.float32, "D": torch.float32,
                           "dt_bias": torch.float32,
                           "norm_w": torch.float32}:
            raise AssertionError(f"{tag}: quantized tree {sorted(params)}, "
                                 f"{floats}")
        r = _serve_gates(cfg, fmt, params, prompts, tag)
        launched = r["launched"]
        small = launched[f"{name}_small_m"]
        tile = launched[name] - small
        if tile != per_fwd or small != per_fwd * (GEN - 1):
            raise AssertionError(f"{tag}: {tile} tile launches per prefill, "
                                 f"{small / (GEN - 1)} small-M per replayed "
                                 f"step, expected {per_fwd}")
        for kname, c in ((name, tile), (f"{name}_small_m", small)):
            launches.setdefault(kname, {})[tag] = c
        state = r["captured"].cache
        if {k: (t.dtype, tuple(t.shape)) for k, t in state.items()} != \
                {k: (t.dtype, tuple(t.shape)) for k, t in lm.init_cache(
                    cfg, BATCH, 1, device="meta").items()}:
            raise AssertionError(f"{tag}: the captured step's buffers are "
                                 f"{ {k: t.shape for k, t in state.items()} }")
        first_a = _timed_generate(serve, params, prompts, cfg,
                                  silvia_passes="all")[3]
        toks_a, logits_a, _, silvia_s = _timed_generate(
            serve, params, prompts, cfg, silvia_passes="all")
        if not torch.equal(toks_a, r["toks"]):
            raise AssertionError(f"{tag}: --silvia all tokens differ from off")
        same = "identical" if torch.equal(logits_a, r["logits"]) \
            else "DIFFER"
        log(f"{tag} --silvia all: tokens identical to off, logits {same}"
            f"; first call (trace + capture) {first_a * 1e3:.1f} ms, fused "
            f"decode {(silvia_s - r['prefill_s']) / (GEN - 1) * 1e3:.2f} "
            f"ms/step; passes "
            f"{serve.get_decode_step(cfg, 'all').cache_info()}")
        # rows 1-2 per generate, from the gates' per-launch times
        per = 2 if fmt == "w4a8" else 1
        per_gen = {}
        for kname, m, count in ((name, m_pre, cfg.n_layers),
                                (f"{name}_small_m", DECODE_M,
                                 cfg.n_layers * (GEN - 1))):
            us = times[(kname, SSM_ARCH)]
            per_gen[kname] = dict(
                launches=count * len(kn),
                ms=sum(us[x] for x in kn) * count / 1e3,
                bound_ms=sum(bound_ms(m, k, n, k * n // per)[0]
                             for k, n in kn) * count)
        b2b = per_gen[f"{name}_small_m"]["ms"] * 1e3 / \
            per_gen[f"{name}_small_m"]["launches"]
        replay_profile(torch, r["captured"], params, cfg, prompts,
                       PROMPT + GEN, tag, b2b)
        prefill_profile(torch, params, cfg, prompts, PROMPT + GEN, tag)
        w_bytes = step_weight_bytes(cfg, fmt)
        s_bytes = step_state_bytes(cfg)
        b_w = w_bytes / HBM_BYTES_PER_S * 1e3
        b_ws = (w_bytes + s_bytes) / HBM_BYTES_PER_S * 1e3
        log(f"{tag}: {small / (GEN - 1):.0f} small-M launches per replayed "
            f"decode step (profiled), {tile} tile launches per prefill (M = "
            f"{m_pre}); built and quantized in {t_build:.1f} s; GEMM kernels "
            "per generate (per-launch times x launches, phase 9's gates): "
            + "; ".join(f"{k} {v['launches']} launches {v['ms']:.3f} ms "
                        f"(bound {v['bound_ms']:.3f})"
                        for k, v in per_gen.items())
            + f"; decode bound {b_ws:.3f} ms/step ({w_bytes / 1e9:.3f} GB "
            f"of weights + {s_bytes / 1e9:.3f} GB of state read and written "
            f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; weights alone "
            f"{b_w:.3f}): fused {r['fused_ms']:.2f} ms/step, "
            f"{100 * b_ws / r['fused_ms']:.1f}% of it; replays alone "
            f"{r['replay_ms']:.2f}; phase {time.perf_counter() - t1:.1f} s")
        per_generate[tag] = per_gen
        del params, mixer, r, state, toks_a, logits_a
        serve.decode_cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the reduced model, prefill and decode, against its CPU run
    red = configs.get_reduced_config(SSM_ARCH)
    rp = torch.randint(0, red.vocab, (2, SSM_CPU_PROMPT), generator=gen,
                       device="cuda")
    for fmt in ("w4a8", "w8a8"):
        p_gpu = serve.build_params(red, fmt, seed=0, quant_force=True,
                                   device="cuda")
        p_cpu = _to_cpu(p_gpu)
        cache_len = SSM_CPU_PROMPT + SSM_CPU_STEPS
        lg, kv = lm.prefill(p_gpu, rp, red, cache_len=cache_len)
        lc, kc = lm.prefill(p_cpu, rp.cpu(), red, cache_len=cache_len)
        diffs = [(lg.cpu() - lc).abs().max().item()]
        tok = lc[:, -1].argmax(dim=-1)[:, None]
        for i in range(SSM_CPU_STEPS):
            pos = torch.full((2,), SSM_CPU_PROMPT + i)
            lg, kv = lm.decode_step(p_gpu, tok.cuda(), kv, pos.cuda(), red)
            lc, kc = lm.decode_step(p_cpu, tok, kc, pos, red)
            diffs.append((lg.cpu() - lc).abs().max().item())
            tok = lc[:, -1].argmax(dim=-1)[:, None]
        if not max(diffs) <= CPU_LOGIT_ATOL:
            raise AssertionError(f"reduced {SSM_ARCH} {fmt}: card vs CPU "
                                 f"logits differ by {max(diffs)} > "
                                 f"{CPU_LOGIT_ATOL}")
        log(f"reduced {SSM_ARCH} {fmt}: card vs CPU logits max diff "
            f"{max(diffs):.3g} (prefill of {SSM_CPU_PROMPT} tokens, then "
            f"{SSM_CPU_STEPS} decode steps)")
    return launches, per_generate


# phase 10: the hybrid family
HYBRID_ARCH = "jamba-v0.1-52b"
# jamba-v0.1-52b's served path at half its depth (2 of its 4 scan units,
# 16 layers; every width and every layer kind kept): a unit's gates are
# those of every other; cut when phase 12 took the whole run past ~1000 s
HYBRID_UNITS = 2
# the reduced model against its CPU run: 2 scan units (16 layers), a
# prompt of three chunks of 16
HYBRID_CPU_LAYERS, HYBRID_CPU_PROMPT, HYBRID_CPU_STEPS = 16, 40, 3


def expert_widths(cfg) -> list:
    """(K, N, x shared by every expert) of the expert-stacked GEMMs, as
    mlp.moe runs them: wi and wg on one x broadcast to every expert
    (expert stride 0), wo on each expert's own rows."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    return [(d, f, True), (f, d, False)]


def phase_hybrid_gemms(cfg) -> dict:
    """Both GEMM kernels bit for bit at every (K, N) of jamba's path: the
    2-D widths through `phase_wide_gemms` (the mixers' in_proj (4096,
    16544), whose packed rows of 8272 bytes take the 16-byte path, and
    out_proj (8192, 4096) at the prefill's M = 2048 of the fixed chunk
    grid; attention, the dense MLP and the head at M = 1024), then the
    [16, K, N] expert stacks at M = 8 and 1024 rows per expert (wi / wg
    on a shared x of expert stride 0, wo per expert): one launch per
    call, acc and f32 out `torch.equal` to the batched plain versions
    (which walk a stack this large an expert at a time,
    `ref.PLAIN_EXPERT_BYTES`), each timed (CUDA events; the median of
    three runs; a 0.94 GB stack spills the L2 by itself) beside its
    bound and its w-load path.  Returns {(kernel, arch): {(K, N): us}},
    the expert stacks' under (kernel, arch + " experts")."""
    from repro_torch.kernels import packed_matmul, quant_matmul, ref

    rows = {kn: ssm_prefill_m(cfg) for kn in mixer_widths(cfg)}
    times = phase_wide_gemms(torch, archs=(HYBRID_ARCH,), prefill_m=rows)
    gen = torch.Generator(device="cuda").manual_seed(8642)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 0.02 + 1e-3

    specs = [("quant_matmul", quant_matmul, ref.quant_matmul_acc_ref,
              ref.quant_matmul_ref, 1),
             ("packed_w4_matmul", packed_matmul,
              ref.packed_w4_matmul_acc_ref, ref.packed_w4_matmul_ref, 2)]
    e = cfg.moe.n_experts
    t0 = time.perf_counter()
    for name, mod, acc_ref, out_ref, per in specs:
        acc_fn, out_fn = getattr(mod, f"{name}_acc"), getattr(mod, name)
        for k, n, shared in expert_widths(cfg):
            w, ws = i8(e, k, n // per), scales(e, 1, n)
            for m in (DECODE_M, PREFILL_M):
                if shared:
                    x, xs = i8(m, k).expand(e, m, k), \
                        scales(m, 1).expand(e, m, 1)
                else:
                    x, xs = i8(e, m, k), scales(e, m, 1)
                what = (f"E={e} M={m} K={k} N={n}"
                        f"{' shared x' if shared else ''}")
                before = (mod.LAUNCHES.count, mod.SMALL_M_LAUNCHES.count)
                acc_k, out_k = acc_fn(x, w), out_fn(x, w, xs, ws)
                torch.cuda.synchronize()
                small = 2 if m <= quant_matmul.SMALL_M else 0
                if (mod.LAUNCHES.count - before[0],
                        mod.SMALL_M_LAUNCHES.count - before[1]) != (2, small):
                    raise AssertionError(f"{name} {what}: not one launch "
                                         "per call")
                w_path = w_load_path(mod.LAUNCHES.last, w.shape[-1])
                if not torch.equal(acc_k, acc_ref(x, w)):
                    raise AssertionError(f"{name} {what}: int32 accumulator "
                                         "differs from the plain version")
                if not torch.equal(out_k, out_ref(x, w, xs, ws)):
                    raise AssertionError(f"{name} {what}: f32 output "
                                         "differs from the plain version")
                del acc_k, out_k
                t = median_device_ms(lambda i: out_fn(x, w, xs, ws),
                                     20 if m == DECODE_M else 10)
                b_ms, b_by = bound_ms_experts(e, m, k, n, w.numel(), shared)
                kname = name + ("_small_m" if small else "")
                times.setdefault((kname, HYBRID_ARCH + " experts"),
                                 {})[(k, n)] = t * 1e3
                log(f"  {kname:24s} {what:34s} kernel {t * 1e3:9.2f} us  "
                    f"bound {b_ms * 1e3:8.2f} us ({b_by}, "
                    f"{100 * b_ms / t:.1f}%)  {w_path}")
            del w, ws, x, xs
            torch.cuda.empty_cache()
    log(f"{HYBRID_ARCH} expert-stacked GEMM gates: both kernels bit-identical "
        f"to the plain versions at M = {DECODE_M} and {PREFILL_M} in "
        f"{time.perf_counter() - t0:.1f} s")
    return times


def hybrid_per_generate(cfg, fmt: str, times: dict) -> dict:
    """One generate's worth (B=BATCH, prompt PROMPT, GEN new tokens) of
    each GEMM kernel on jamba's path, from phase_hybrid_gemms' per-launch
    times: per unit the prefill's 42 tile launches (the mixers' at the
    chunk grid's M) and 42 small-M launches per decode step, the head's
    small-M launch per token.  {kernel: (launches, ms, bound_ms)}."""
    name = _gemm_name(fmt)
    per = 2 if fmt == "w4a8" else 1
    units, kinds = cfg.n_layers // cfg.hybrid.period, hybrid_kinds(cfg)
    d = cfg.d_model
    (kin, nin), (kout, nout) = mixer_widths(cfg)
    m_mix = ssm_prefill_m(cfg)
    e = cfg.moe.n_experts
    # (K, N, launches per unit, prefill M, experts, shared x)
    rows = [(d, cfg.q_dim, kinds["attn"], PREFILL_M, 1, False),
            (d, cfg.kv_dim, 2 * kinds["attn"], PREFILL_M, 1, False),
            (cfg.q_dim, d, kinds["attn"], PREFILL_M, 1, False),
            (kin, nin, kinds["mamba"], m_mix, 1, False),
            (kout, nout, kinds["mamba"], m_mix, 1, False),
            (d, cfg.d_ff, 2 * kinds["dense"], PREFILL_M, 1, False),
            (cfg.d_ff, d, kinds["dense"], PREFILL_M, 1, False)] + [
        (k, n, (2 if shared else 1) * kinds["moe"], PREFILL_M, e, shared)
        for k, n, shared in expert_widths(cfg)]
    out = {}

    def add(kname, mm, k, n, ee, shared, count):
        key = (kname, HYBRID_ARCH + (" experts" if ee > 1 else ""))
        t = times[key][(k, n)] / 1e3
        b, _ = (bound_ms_experts(ee, mm, k, n, ee * k * n // per, shared)
                if ee > 1 else bound_ms(mm, k, n, k * n // per))
        c, ms, bd = out.get(kname, (0, 0.0, 0.0))
        out[kname] = (c + count, ms + t * count, bd + b * count)

    for k, n, count, m_pre, ee, shared in rows:
        add(name, m_pre, k, n, ee, shared, count * units)
        add(f"{name}_small_m", DECODE_M, k, n, ee, shared,
            count * units * (GEN - 1))
    add(f"{name}_small_m", DECODE_M, d, cfg.vocab, 1, False, GEN)
    return out


# the reduced hybrid on the card against its CPU run, each quantized GEMM
# and MoE layer of the card's run fed the CPU's input: every compared
# tensor within this share of the CPU tensor's largest magnitude (float32
# sums in other orders and other libm roundings, ~1e-6; a wrong op or a
# dropped term moves a tensor by O(1) of it)
CARD_CPU_RTOL = 1e-4


@contextlib.contextmanager
def _hooked(qmatmul, moe):
    """Route the model's quantized GEMMs (`qmatmul` as attention, lm, mlp
    and ssm call it) and its MoE layers (`mlp.moe`) through `qmatmul(orig,
    x, w)` and `moe(orig, p, x, cfg, per_token, **kw)`, `orig` the
    function they replace."""
    from repro_torch.models import attention, lm, mlp, ssm
    mods = (attention, lm, mlp, ssm)
    orig_q, orig_moe = mlp.qmatmul, mlp.moe
    for m in mods:
        m.qmatmul = functools.partial(qmatmul, orig_q)
    mlp.moe = functools.partial(moe, orig_moe)
    try:
        yield
    finally:
        mlp.moe = orig_moe
        for m in mods:
            m.qmatmul = orig_q


def _kept(x):
    """x on the host; an expert-stacked GEMM's x of expert stride 0 (one
    x broadcast to every expert) as its one expert's rows."""
    shared = x.ndim == 3 and x.stride(0) == 0
    return (x[:1] if shared else x).detach().cpu().clone(), shared


def teacher_forced_vs_cpu(params, cpu_params, prompts, cfg, steps: int,
                          rtol: float = CARD_CPU_RTOL,
                          positions=None) -> dict:
    """The hybrid model on `params` (on the card) against its run on
    `cpu_params` (the same weights on the host), teacher-forced one
    quantized GEMM and one MoE layer at a time.  The host runs a prefill
    of `prompts` and `steps` greedy decode steps, recording each GEMM's
    and MoE layer's input and output in call order.  The card runs the
    same steps on the host's tokens; each GEMM and MoE layer there gets
    the host's input in place of its own, so an int8 rounding tie or a
    router near-tie cannot carry the host's last-bit differences through
    the rest of the stack (ROADMAP C8).  Held, at every step (the prefill
    and each decode step):
      * each GEMM's and MoE layer's own input within `rtol` of the host's
        (everything between two GEMMs: norms, rope, attention, the SSD
        scan and its conv, the SwiGLU, the router and the MoE combine);
      * each GEMM's output from the host's input bit for bit (the int8
        rows, the int32 sums and the float32 epilogue are exact);
      * each MoE layer's output from the host's input within `rtol`;
      * the logits and every cache tensor within `rtol`;
      * the number of GEMM and MoE calls: gemms_per_forward (a decode
        step: gemms_per_step) + the head, and one MoE call per MoE layer.
    `prompts` is [B, S] tokens, [B, S, d] stub embeddings (an image
    prompt, with its [3, B, S] `positions`), or an encdec input
    (features, dec_tokens).  Returns {"gemms", "moes", "tensors": counts
    compared, "worst": the largest difference over the tensor's largest
    magnitude}."""
    from repro_torch.models import lm
    tokens_in = dec_tokens(prompts)
    b, s = tokens_in.shape[:2]
    dev = tokens_in.device
    cache_len = s + steps
    moes = moe_layers(cfg)
    want_calls = [gemms_per_forward(cfg) + 1 + moes] + \
        [gemms_per_step(cfg) + 1 + moes] * steps
    stats = {"gemms": 0, "moes": 0, "tensors": 0, "worst": 0.0}

    # the host: each step's calls [(kind, input, shared, output)]
    host, calls = [], []

    def rec_q(orig, x, w):
        i = len(calls)
        calls.append(None)
        y = orig(x, w)
        calls[i] = ("GEMM", *_kept(x), y.clone())
        return y

    def rec_moe(orig, p, x, c, per_token=False, **kw):
        i = len(calls)
        calls.append(None)
        y, aux = orig(p, x, c, per_token, **kw)
        calls[i] = ("MoE", x.clone(), False, y.clone())
        return y, aux

    tokens = []
    host_prompts = tuple(t.cpu() for t in prompts) \
        if isinstance(prompts, tuple) else prompts.cpu()
    with _hooked(rec_q, rec_moe):
        logits, cache = lm.prefill(
            cpu_params, host_prompts, cfg, cache_len=cache_len,
            positions=None if positions is None else positions.cpu())
        for i in range(steps + 1):
            host.append((calls, logits[:, -1].clone(),
                         {k: t.clone() for k, t in cache.items()}))
            calls = []
            tokens.append(logits[:, -1].argmax(dim=-1)[:, None])
            if i == steps:
                break
            logits, _ = lm.decode_step(cpu_params, tokens[-1], cache,
                                       torch.full((b,), s + i), cfg)

    def close(got, want, what):
        got = got.detach().cpu().float()
        want = want.float()
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} on the "
                                 f"card, {tuple(want.shape)} on the host")
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        if not err <= rtol * top:
            raise AssertionError(f"{what}: card and host differ by {err} "
                                 f"(largest |host| {top}, limit {rtol} of it)")
        stats["tensors"] += 1
        stats["worst"] = max(stats["worst"], err / top if top else 0.0)

    def fed(want, shared, like):
        x = want.to(like.device)
        return x.expand(like.shape) if shared else x

    for t, (want_calls_t, want_logits, want_cache) in enumerate(host):
        at = iter(range(len(want_calls_t)))
        step = "prefill" if t == 0 else f"decode step {t}"

        def take(kind):
            i = next(at, None)
            if i is None or want_calls_t[i][0] != kind:
                raise AssertionError(f"{step}: call {i} is a {kind} on the "
                                     "card, not on the host")
            return i, want_calls_t[i][1:]

        def fq(orig, x, w):
            i, (xw, shared, yw) = take("GEMM")
            close(x[:1] if shared else x, xw, f"{step}, GEMM {i}'s input")
            y = orig(fed(xw, shared, x), w)
            if not torch.equal(y.cpu(), yw):
                raise AssertionError(f"{step}, GEMM {i}: the card's output "
                                     "from the host's input is not the "
                                     "host's, bit for bit")
            stats["gemms"] += 1
            return y

        def fmoe(orig, p, x, c, per_token=False, **kw):
            i, (xw, _, yw) = take("MoE")
            close(x, xw, f"{step}, MoE {i}'s input")
            y, aux = orig(p, fed(xw, False, x), c, per_token, **kw)
            close(y, yw, f"{step}, MoE {i}'s output")
            stats["moes"] += 1
            return y, aux

        with _hooked(fq, fmoe):
            if t == 0:
                logits, cache = lm.prefill(
                    params, prompts, cfg, cache_len=cache_len,
                    positions=None if positions is None
                    else positions.to(dev))
            else:
                logits, _ = lm.decode_step(
                    params, tokens[t - 1].to(dev), cache,
                    torch.full((b,), s + t - 1, device=dev), cfg)
        if len(want_calls_t) != want_calls[t] or next(at, None) is not None:
            raise AssertionError(f"{step}: {len(want_calls_t)} GEMM and MoE "
                                 f"calls on the host, {want_calls[t]} "
                                 "expected, or fewer on the card")
        close(logits[:, -1], want_logits, f"{step}, logits")
        for k, v in want_cache.items():
            close(cache[k], v, f"{step}, cache {k}")
    return stats


def hybrid_reduced_vs_cpu(gen) -> None:
    """Reduced jamba at 2 scan units, in a float32 config, on the card
    against its CPU run (the same weights, moved), under both formats:
    a prefill of HYBRID_CPU_PROMPT tokens, then HYBRID_CPU_STEPS decode
    steps on the CPU's greedy tokens, teacher-forced one GEMM and one MoE
    layer at a time (`teacher_forced_vs_cpu`: every GEMM's and MoE
    layer's input, every GEMM's output bit for bit, the logits and the
    cache at every step).  Why teacher-forced: the devices' last-bit
    float differences tip an int8 rounding now and then (~10 of ~0.5 M
    activations per prefill here, ROADMAP C8), and a free-running
    16-layer stack carries one such step into the logits and the
    routes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    red = dataclasses.replace(configs.get_reduced_config(HYBRID_ARCH),
                              n_layers=HYBRID_CPU_LAYERS, dtype="float32")
    rp = torch.randint(0, red.vocab, (2, HYBRID_CPU_PROMPT), generator=gen,
                       device="cuda")
    for fmt in ("w4a8", "w8a8"):
        p_gpu = serve.build_params(red, fmt, seed=0, quant_force=True,
                                   device="cuda")
        st = teacher_forced_vs_cpu(p_gpu, _to_cpu(p_gpu), rp, red,
                                   HYBRID_CPU_STEPS)
        log(f"reduced {HYBRID_ARCH} ({HYBRID_CPU_LAYERS} layers, float32) "
            f"{fmt}, card against CPU, teacher-forced (prefill of "
            f"{HYBRID_CPU_PROMPT} tokens, then {HYBRID_CPU_STEPS} decode "
            f"steps): {st['gemms']} GEMM outputs bit for bit, "
            f"{st['moes']} MoE layers, {st['tensors']} tensors (GEMM and "
            f"MoE inputs, MoE outputs, logits, caches) within "
            f"{st['worst']:.3e} of their largest magnitude (limit "
            f"{CARD_CPU_RTOL})")


def phase_hybrid() -> tuple:
    """Phase 10: the hybrid family.  Reduced jamba (2 units) on the card
    against its CPU run; both GEMM kernels bit for bit at every jamba
    width (`phase_hybrid_gemms`); then jamba-v0.1-52b served at full width
    and HYBRID_UNITS of its 4 scan units (d 4096, 16 experts of d_ff
    14336 on every other layer, 7 SSD mixers and one attention layer per
    unit, untied vocab 65536; random weights from seed 0, built a [K, N]
    matrix at a time by `serve.build_params`, its time and peak memory
    logged), B=8, prompt 128, 32 new tokens, greedy, w4a8 and then w8a8
    (the first tree freed before the second is built), through
    `_serve_gates` (fused == per-step == plain-forced, bit for bit; 42
    tile launches per unit and prefill, 42 small-M launches per unit and
    replayed step and the head's; one capture); the captured
    step's static buffers are the flat hybrid cache; --silvia all == off
    in tokens; the profiles of a replayed step and of a prefill; rows
    1-2's time per generate beside their bounds; decode ms/step beside
    the step's byte bound with and without the state and KV traffic.
    Returns ({GEMM counter: {path: launches}}, {path: {GEMM counter:
    launches, ms and bound_ms per generate}})."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    import dataclasses
    full = configs.get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full,
                              n_layers=HYBRID_UNITS * full.hybrid.period)
    gen = torch.Generator(device="cuda").manual_seed(17)
    t0 = time.perf_counter()
    hybrid_reduced_vs_cpu(gen)
    log(f"reduced {HYBRID_ARCH} against the CPU: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = phase_hybrid_gemms(cfg)
    log(f"{HYBRID_ARCH} GEMM gates: {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    per_fwd = gemms_per_forward(cfg)
    units, n_moe = lm.n_scan_units(cfg), hybrid_kinds(cfg)["moe"]
    launches, per_generate = {}, {}
    for fmt in ("w4a8", "w8a8"):
        tag = f"{HYBRID_ARCH} {cfg.n_layers}L {fmt}"
        name = _gemm_name(fmt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t1
        resident = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        blk = params["blocks"]
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        if params["lm_head"].fmt != fmt or \
                any(blk["moe"][k].fmt != fmt for k in ("wi", "wg", "wo")) or \
                tuple(blk["moe"]["wi"].scale.shape) != (units, n_moe, e, 1, f) or \
                blk["moe"]["router"].dtype != torch.float32 or \
                any(blk["mamba"][k].fmt != fmt
                    for k in ("in_proj", "out_proj")) or \
                blk["mamba"]["conv_w"].dtype != torch.bfloat16 or \
                any(blk["attn"][k].fmt != fmt for k in blk["attn"]) or \
                any(blk["dense"][k].fmt != fmt for k in blk["dense"]):
            raise AssertionError(f"{tag}: the quantized tree is not the "
                                 "serving tree")
        log(f"{tag}: built and quantized a matrix at a time in {t_build:.1f} "
            f"s; resident {resident / 2**30:.2f} GiB, peak "
            f"{peak / 2**30:.2f} GiB above the card's {base / 2**30:.2f} GiB "
            f"before (torch.cuda.max_memory_allocated)")
        r = _serve_gates(cfg, fmt, params, prompts, tag)
        launched = r["launched"]
        small = launched[f"{name}_small_m"]
        tile = launched[name] - small
        per_step = (small - 1) / (GEN - 1)   # the prefill's head: one
        if tile != per_fwd or per_step != per_fwd + 1:
            raise AssertionError(f"{tag}: {tile} tile launches per prefill, "
                                 f"{per_step} small-M per replayed step, "
                                 f"expected {per_fwd} and {per_fwd + 1}")
        for kname, c in ((name, tile), (f"{name}_small_m", small)):
            launches.setdefault(kname, {})[tag] = c
        state = r["captured"].cache
        want = lm.init_cache(cfg, BATCH, PROMPT + GEN, device="meta")
        if {k: (t.dtype, tuple(t.shape)) for k, t in state.items()} != \
                {k: (t.dtype, tuple(t.shape)) for k, t in want.items()}:
            raise AssertionError(f"{tag}: the captured step's buffers are "
                                 f"{ {k: t.shape for k, t in state.items()} }")
        first_a = _timed_generate(serve, params, prompts, cfg,
                                  silvia_passes="all")[3]
        toks_a, logits_a, _, silvia_s = _timed_generate(
            serve, params, prompts, cfg, silvia_passes="all")
        if not torch.equal(toks_a, r["toks"]):
            raise AssertionError(f"{tag}: --silvia all tokens differ from off")
        same = "identical" if torch.equal(logits_a, r["logits"]) \
            else "DIFFER"
        log(f"{tag} --silvia all: tokens identical to off, logits {same}"
            f"; first call (trace + capture) {first_a * 1e3:.1f} ms, fused "
            f"decode {(silvia_s - r['prefill_s']) / (GEN - 1) * 1e3:.2f} "
            f"ms/step; passes "
            f"{serve.get_decode_step(cfg, 'all').cache_info()}")
        del toks_a, logits_a
        serve.decode_cache_clear()        # the --silvia bundle's graph
        per_gen = hybrid_per_generate(cfg, fmt, times)
        for k, (c, _, _) in per_gen.items():     # the profiled launches
            seen = launched[k] if k.endswith("_small_m") else \
                launched[k] - launched[f"{k}_small_m"]
            if c != seen:
                raise AssertionError(f"{tag}: {k} launched {seen} times, "
                                     f"the per-generate sum counts {c}")
        sm = per_gen[f"{name}_small_m"]
        replay_profile(torch, r["captured"], params, cfg, prompts,
                       PROMPT + GEN, tag, sm[1] * 1e3 / sm[0])
        prefill_profile(torch, params, cfg, prompts, PROMPT + GEN, tag)
        w_bytes = step_weight_bytes(cfg, fmt)
        s_bytes = step_state_bytes(cfg)
        b_w = w_bytes / HBM_BYTES_PER_S * 1e3
        b_ws = (w_bytes + s_bytes) / HBM_BYTES_PER_S * 1e3
        log(f"{tag}: {per_step:.0f} small-M launches per replayed decode "
            f"step (profiled), {tile} tile launches per prefill; prefill "
            f"{r['prefill_ms']:.1f} ms; GEMM kernels per generate "
            "(per-launch times x launches, phase 10's gates): "
            + "; ".join(f"{k} {c} launches {ms:.3f} ms (bound {bd:.3f})"
                        for k, (c, ms, bd) in per_gen.items())
            + f"; decode bound {b_ws:.3f} ms/step ({w_bytes / 1e9:.3f} GB "
            f"of weights, every expert, + {s_bytes / 1e9:.3f} GB of state "
            f"and KV at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; weights alone "
            f"{b_w:.3f}): fused {r['fused_ms']:.2f} ms/step, "
            f"{100 * b_ws / r['fused_ms']:.1f}% of it; replays alone "
            f"{r['replay_ms']:.2f}; per-step loop {r['step_ms']:.2f}; "
            f"{time.perf_counter() - t1:.1f} s")
        per_generate[tag] = {k: dict(launches=c, ms=ms, bound_ms=bd)
                             for k, (c, ms, bd) in per_gen.items()}
        del params, blk, r, state
        serve.decode_cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches, per_generate


# phase 11: the encoder-decoder family
ENCDEC_ARCH = "whisper-small"
GEMMS = ("quant_matmul", "packed_w4_matmul")
# whisper's 30 s window after the conv frontend's stride: the encoder's
# frames, and the rows of both learned position tables (`max_seq`)
ENC_FRAMES = 1500
# the reduced model against its CPU run: frames, decoder prompt, steps
ENCDEC_CPU_FRAMES, ENCDEC_CPU_PROMPT, ENCDEC_CPU_STEPS = 60, 12, 3


def encdec_rows(cfg) -> list:
    """(K, N, tile launches per prefill, prefill M, small-M launches per
    decode step) of each 2-D width on whisper's path: per encoder layer
    q k v o and the MLP's two at M = B * S_enc; per decoder layer the
    self q k v o, the cross q o and the MLP's two at M = B * S (and once
    per step at M = B), the cross k v at M = B * S_enc (the prefill
    only)."""
    d, enc, dec = cfg.d_model, cfg.n_layers, cfg.n_decoder_layers
    m_enc, m_dec = BATCH * ENC_FRAMES, BATCH * PROMPT
    return [(d, d, 4 * enc + 2 * dec, m_enc, 0),
            (d, cfg.d_ff, enc, m_enc, 0), (cfg.d_ff, d, enc, m_enc, 0),
            (d, d, 6 * dec, m_dec, 6 * dec),
            (d, cfg.d_ff, dec, m_dec, dec), (cfg.d_ff, d, dec, m_dec, dec)]


def encdec_per_generate(cfg, fmt: str, times: dict) -> dict:
    """One generate's worth (B=BATCH, S_enc frames, prompt PROMPT, GEN new
    tokens) of each GEMM kernel on whisper's path, from phase 11's
    per-launch times (`encdec_rows`; the head's small-M launch per token,
    in w8a8 under w4a8: the odd vocab).  {kernel: (launches, ms,
    bound_ms)}."""
    name = _gemm_name(fmt)
    hname = _gemm_name("w8a8" if fmt == "w4a8" and cfg.vocab % 2 else fmt)
    out = {}

    def add(kname, m, k, n, count):
        per = 2 if kname.startswith("packed") else 1
        t = times[(kname, ENCDEC_ARCH, m)][(k, n)] / 1e3
        b, _ = bound_ms(m, k, n, k * n // per)
        c, ms, bd = out.get(kname, (0, 0.0, 0.0))
        out[kname] = (c + count, ms + t * count, bd + b * count)

    for k, n, tile, m_pre, small in encdec_rows(cfg):
        add(name, m_pre, k, n, tile)
        if small:
            add(f"{name}_small_m", DECODE_M, k, n, small * (GEN - 1))
    add(f"{hname}_small_m", DECODE_M, cfg.d_model, cfg.vocab, GEN)
    return out


def _features(cfg, gen, b: int, frames: int):
    """Seeded frame embeddings [b, frames, d] (the audio frontend's
    output; a stub in the reference too), float32 on the card."""
    return torch.randn((b, frames, cfg.d_model), generator=gen,
                       device="cuda")


def encdec_reduced_vs_cpu(gen) -> None:
    """Reduced whisper (2 + 2 layers, d 64), in a float32 config, on the
    card against its CPU run (the same weights, moved), under both
    formats: a prefill of ENCDEC_CPU_FRAMES frames and a decoder prompt
    of ENCDEC_CPU_PROMPT tokens, then ENCDEC_CPU_STEPS decode steps on
    the CPU's greedy tokens, teacher-forced one GEMM at a time
    (`teacher_forced_vs_cpu`: every GEMM's input, every GEMM's output
    bit for bit, the logits and the cache at every step)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    red = dataclasses.replace(configs.get_reduced_config(ENCDEC_ARCH),
                              dtype="float32")
    inputs = (_features(red, gen, 2, ENCDEC_CPU_FRAMES),
              torch.randint(0, red.vocab, (2, ENCDEC_CPU_PROMPT),
                            generator=gen, device="cuda"))
    for fmt in ("w4a8", "w8a8"):
        p_gpu = serve.build_params(red, fmt, seed=0, quant_force=True,
                                   device="cuda", max_seq=ENCDEC_CPU_FRAMES)
        st = teacher_forced_vs_cpu(p_gpu, _to_cpu(p_gpu), inputs, red,
                                   ENCDEC_CPU_STEPS)
        log(f"reduced {ENCDEC_ARCH} (float32) {fmt}, card against CPU, "
            f"teacher-forced ({ENCDEC_CPU_FRAMES} frames, a prompt of "
            f"{ENCDEC_CPU_PROMPT} tokens, then {ENCDEC_CPU_STEPS} decode "
            f"steps): {st['gemms']} GEMM outputs bit for bit, "
            f"{st['tensors']} tensors (GEMM inputs, logits, caches) within "
            f"{st['worst']:.3e} of their largest magnitude (limit "
            f"{CARD_CPU_RTOL})")


def phase_encdec() -> tuple:
    """Phase 11: the encoder-decoder family.  Reduced whisper on the card
    against its CPU run, teacher-forced (`encdec_reduced_vs_cpu`); both
    GEMM kernels bit for bit at whisper-small's four (K, N), (768, 768),
    (768, 3072), (3072, 768) and the head (768, 51865), at M = 8, 1024
    (the decoder's prompt) and 12000 (the encoder's 8 x 1500 frames, and
    the cross k, v on the memory), each timed beside its bound
    (`phase_wide_gemms`).  Then whisper-small served at full width (12
    encoder and 12 decoder layers, d 768, 12 heads of 64, d_ff 3072,
    untied vocab 51865; nothing cut; random weights from seed 0, both
    position tables of ENC_FRAMES rows), B=8, 1500 seeded encoder frames,
    a decoder prompt of 128 tokens, 32 new tokens, greedy, w4a8 and w8a8,
    through `_serve_gates` (fused == per-step == plain-forced, bit for
    bit; 192 tile launches per prefill, 97 small-M per replayed step,
    the head in w8a8 under w4a8; one capture); the captured step's
    static buffers are the self KV and the 0.442 GB of cross K/V, as
    `lm.init_cache` shapes them for 1500 frames; --silvia all == off in
    tokens, its ms/step logged; the encoder's peak memory; the profiles
    of a replayed step and a prefill; rows 1-2's time per generate beside
    their bounds; decode ms/step beside the step's byte bound with and
    without the KV read (cross and self).  Returns ({GEMM counter:
    {path: launches}}, {path: {GEMM counter: launches, ms and bound_ms
    per generate}})."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config(ENCDEC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(23)
    t0 = time.perf_counter()
    encdec_reduced_vs_cpu(gen)
    log(f"reduced {ENCDEC_ARCH} against the CPU: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m_enc, m_dec = BATCH * ENC_FRAMES, BATCH * PROMPT
    times = phase_wide_gemms(torch, archs=(ENCDEC_ARCH,),
                             prefill_m=(m_dec, m_enc))
    log(f"{ENCDEC_ARCH} GEMM gates: {time.perf_counter() - t0:.1f} s")
    prompts = (_features(cfg, gen, BATCH, ENC_FRAMES),
               torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                             device="cuda"))
    per_fwd, per_step = gemms_per_forward(cfg), gemms_per_step(cfg)
    launches, per_generate = {}, {}
    for fmt in ("w4a8", "w8a8"):
        tag = f"{ENCDEC_ARCH} {fmt}"
        name = _gemm_name(fmt)
        head_fmt = "w8a8" if cfg.vocab % 2 else fmt
        t1 = time.perf_counter()
        params = serve.build_params(cfg, fmt, seed=0, device="cuda",
                                    max_seq=ENC_FRAMES)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t1
        gemm_leaves = [params[st][part][k] for st, parts in (
            ("enc", ("attn", "mlp")), ("dec", ("self", "cross", "mlp")))
            for part in parts for k in params[st][part]
            if k.startswith("w")]
        if params["lm_head"].fmt != head_fmt or len(gemm_leaves) != 16 or \
                any(w.fmt != fmt for w in gemm_leaves) or \
                params["dec"]["mlp"]["bi"].dtype != torch.bfloat16 or \
                params["enc_norm"]["b"].dtype != torch.float32 or \
                tuple(params["enc_pos"].shape) != (ENC_FRAMES, cfg.d_model):
            raise AssertionError(f"{tag}: the quantized tree is not the "
                                 "serving tree")
        # the encoder alone: its peak memory above what is resident
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        memory = lm.encode(params, prompts[0], cfg)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t1) * 1e3
        enc_peak = torch.cuda.max_memory_allocated() - base
        if tuple(memory.shape) != (BATCH, ENC_FRAMES, cfg.d_model) or \
                not bool(torch.isfinite(memory).all()):
            raise AssertionError(f"{tag}: encoder output misshapen or not "
                                 "finite")
        del memory
        log(f"{tag}: built and quantized in {t_build:.1f} s; encoder "
            f"({BATCH} x {ENC_FRAMES} frames) {enc_ms:.1f} ms, peak "
            f"{enc_peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB "
            "before (torch.cuda.max_memory_allocated; its [8, 12, 1500, "
            "1500] float32 scores alone are 0.81 GiB)")
        r = _serve_gates(cfg, fmt, params, prompts, tag)
        launched = r["launched"]
        small = sum(launched[f"{k}_small_m"] for k in GEMMS)
        tile = sum(launched[k] for k in GEMMS) - small
        steps = (small - 1) / (GEN - 1)      # the prefill's head: one
        if tile != per_fwd or steps != per_step + 1:
            raise AssertionError(f"{tag}: {tile} tile launches per prefill, "
                                 f"{steps} small-M per replayed step, "
                                 f"expected {per_fwd} and {per_step + 1}")
        for k in GEMMS:
            for kname, c in ((k, launched[k] - launched[f"{k}_small_m"]),
                             (f"{k}_small_m", launched[f"{k}_small_m"])):
                if c:
                    launches.setdefault(kname, {})[tag] = c
        state = r["captured"].cache
        want = lm.init_cache(cfg, BATCH, PROMPT + GEN, device="meta",
                             s_enc=ENC_FRAMES)
        if {k: (t.dtype, tuple(t.shape)) for k, t in state.items()} != \
                {k: (t.dtype, tuple(t.shape)) for k, t in want.items()}:
            raise AssertionError(f"{tag}: the captured step's buffers are "
                                 f"{ {k: t.shape for k, t in state.items()} }")
        first_a = _timed_generate(serve, params, prompts, cfg,
                                  silvia_passes="all")[3]
        toks_a, logits_a, _, silvia_s = _timed_generate(
            serve, params, prompts, cfg, silvia_passes="all")
        if not torch.equal(toks_a, r["toks"]):
            raise AssertionError(f"{tag}: --silvia all tokens differ from off")
        same = "identical" if torch.equal(logits_a, r["logits"]) \
            else "DIFFER"
        log(f"{tag} --silvia all: tokens identical to off, logits {same}"
            f"; first call (trace + capture) {first_a * 1e3:.1f} ms, fused "
            f"decode {(silvia_s - r['prefill_s']) / (GEN - 1) * 1e3:.2f} "
            f"ms/step (off: {r['fused_ms']:.2f}); passes "
            f"{serve.get_decode_step(cfg, 'all').cache_info()}")
        del toks_a, logits_a
        serve.decode_cache_clear()        # the --silvia bundle's graph
        per_gen = encdec_per_generate(cfg, fmt, times)
        for k, (c, _, _) in per_gen.items():     # the profiled launches
            seen = launched[k] if k.endswith("_small_m") else \
                launched[k] - launched[f"{k}_small_m"]
            if c != seen:
                raise AssertionError(f"{tag}: {k} launched {seen} times, "
                                     f"the per-generate sum counts {c}")
        sm = per_gen[f"{name}_small_m"]
        replay_profile(torch, r["captured"], params, cfg, prompts,
                       PROMPT + GEN, tag, sm[1] * 1e3 / sm[0])
        prefill_profile(torch, params, cfg, prompts, PROMPT + GEN, tag)
        w_bytes = step_weight_bytes(cfg, fmt)
        s_bytes = step_state_bytes(cfg)
        b_w = w_bytes / HBM_BYTES_PER_S * 1e3
        b_ws = (w_bytes + s_bytes) / HBM_BYTES_PER_S * 1e3
        log(f"{tag}: {steps:.0f} small-M launches per replayed decode "
            f"step (profiled), {tile} tile launches per prefill; prefill "
            f"{r['prefill_ms']:.1f} ms; GEMM kernels per generate "
            "(per-launch times x launches, phase 11's gates): "
            + "; ".join(f"{k} {c} launches {ms:.3f} ms (bound {bd:.3f})"
                        for k, (c, ms, bd) in per_gen.items())
            + f"; decode bound {b_ws:.3f} ms/step ({w_bytes / 1e9:.3f} GB "
            f"of weights + {s_bytes / 1e9:.3f} GB of KV read, cross and "
            f"self, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; weights alone "
            f"{b_w:.3f}): fused {r['fused_ms']:.2f} ms/step, "
            f"{100 * b_ws / r['fused_ms']:.1f}% of it; replays alone "
            f"{r['replay_ms']:.2f}; per-step loop {r['step_ms']:.2f}; "
            f"{time.perf_counter() - t1:.1f} s")
        per_generate[tag] = {k: dict(launches=c, ms=ms, bound_ms=bd)
                             for k, (c, ms, bd) in per_gen.items()}
        del params, gemm_leaves, r, state
        serve.decode_cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches, per_generate


# phase 12: the vlm family
VLM_ARCH = "qwen2-vl-72b"
# the image prompt of each row: 8 text tokens, one 448 x 448 image as 256
# stub patch embeddings (Qwen2-VL's 14-pixel patches merged 2 x 2 into a
# 16 x 16 grid), 120 text tokens: 384 positions
IMG_BEFORE, IMG_GRID, IMG_AFTER = 8, (16, 16), 120
IMG_PROMPT = IMG_BEFORE + IMG_GRID[0] * IMG_GRID[1] + IMG_AFTER
# the reduced model against its CPU run: 3 text tokens, a 4 x 4 image, 5
# text tokens, then 3 decode steps
VLM_CPU_LAYOUT, VLM_CPU_STEPS = (3, (4, 4), 5), 3


def image_positions(b: int, n_before: int, grid, n_after: int, device):
    """Qwen2-VL's M-RoPE positions [3, b, S] (arXiv:2409.12191) of b rows
    of n_before text tokens, one image of grid = (rows, cols) merged
    patches and n_after text tokens: text has t = h = w = its index; the
    image's patches t = n_before, h = n_before + row, w = n_before +
    col; the text after it resumes at n_before + max(rows, cols).  Input
    data of phase 12: the package computes no positions."""
    gh, gw = grid
    after = n_before + max(gh, gw) + torch.arange(n_after)
    rows = [torch.cat([torch.arange(n_before), img, after]) for img in (
        torch.full((gh * gw,), n_before),
        n_before + torch.arange(gh).repeat_interleave(gw),
        n_before + torch.arange(gw).repeat(gh))]
    return torch.stack(rows)[:, None].expand(3, b, -1).contiguous().to(
        device)


def image_embeds(params, cfg, gen, b: int, n_before: int, grid,
                 n_after: int):
    """[b, S, d] float32 stub embeddings of an image prompt (the vision
    frontend's output; a stub in the reference too): the text positions
    the port's embedding rows of seeded tokens, the image's patch rows
    seeded normals at the table's scale (the std of its first 4096
    rows).  On the generator's device."""
    table = params["embed"]
    toks = torch.randint(0, cfg.vocab, (b, n_before + n_after),
                         generator=gen, device=gen.device)
    patches = torch.randn((b, grid[0] * grid[1], cfg.d_model),
                          generator=gen, device=gen.device)
    text = table[toks].float()
    return torch.cat([text[:, :n_before],
                      patches * table[:4096].float().std(),
                      text[:, n_before:]], dim=1)


def _nonzero_biases(params, gen) -> None:
    """The q/k/v biases drawn nonzero (the init's are zeros), in place,
    as phase 7 draws qwen's."""
    attn = params["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = (torch.randn(attn[b].shape, generator=gen,
                               device=gen.device)
                   * QWEN_BIAS_STD).to(attn[b].dtype)


def vlm_reduced_vs_cpu(gen) -> None:
    """Reduced qwen2-vl (2 layers, d 64, sections (2, 3, 3)), in a float32
    config, on the card against its CPU run (the same weights, moved;
    nonzero q/k/v biases), under both formats: an image prompt (stub
    embeddings of VLM_CPU_LAYOUT with its 3-row positions: the patches
    share a temporal position), then VLM_CPU_STEPS decode steps on the
    CPU's greedy tokens, teacher-forced one GEMM at a time
    (`teacher_forced_vs_cpu`: every GEMM's input, every GEMM's output
    bit for bit, the logits and the cache at every step)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    red = dataclasses.replace(configs.get_reduced_config(VLM_ARCH),
                              dtype="float32")
    n0, grid, n1 = VLM_CPU_LAYOUT
    pos = image_positions(2, n0, grid, n1, "cuda")
    for fmt in ("w4a8", "w8a8"):
        p_gpu = serve.build_params(red, fmt, seed=0, quant_force=True,
                                   device="cuda")
        _nonzero_biases(p_gpu, gen)
        emb = image_embeds(p_gpu, red, gen, 2, n0, grid, n1)
        st = teacher_forced_vs_cpu(p_gpu, _to_cpu(p_gpu), emb, red,
                                   VLM_CPU_STEPS, positions=pos)
        log(f"reduced {VLM_ARCH} (float32) {fmt}, card against CPU, "
            f"teacher-forced (an image prompt of {emb.shape[1]} stub "
            f"embeddings, a {grid[0]} x {grid[1]} image at position {n0}, "
            f"then {VLM_CPU_STEPS} decode steps): {st['gemms']} GEMM "
            f"outputs bit for bit, {st['tensors']} tensors (GEMM inputs, "
            f"logits, caches) within {st['worst']:.3e} of their largest "
            f"magnitude (limit {CARD_CPU_RTOL})")


def vlm_per_generate(cfg, fmt: str, times: dict, m: int = PREFILL_M,
                     steps: int = GEN - 1) -> dict:
    """One generate's worth of each GEMM kernel on qwen2-vl's path, from
    phase 12's per-launch times: per layer q, k, v, o and the MLP's
    gate, up and down, one tile launch each at the prefill's M = m and
    one small-M launch each per decode step, and the head's small-M
    launch per token (steps + 1).  {kernel: (launches, ms, bound_ms)}."""
    name = _gemm_name(fmt)
    per = 2 if fmt == "w4a8" else 1
    d, layers = cfg.d_model, cfg.n_layers
    rows = [(d, cfg.q_dim, 1), (d, cfg.kv_dim, 2), (cfg.q_dim, d, 1),
            (d, cfg.d_ff, 2), (cfg.d_ff, d, 1)]
    out = {}

    def add(kname, mm, k, n, count):
        t = times[(kname, VLM_ARCH, mm)][(k, n)] / 1e3
        b, _ = bound_ms(mm, k, n, k * n // per)
        c, ms, bd = out.get(kname, (0, 0.0, 0.0))
        out[kname] = (c + count, ms + t * count, bd + b * count)

    for k, n, count in rows:
        add(name, m, k, n, count * layers)
        add(f"{name}_small_m", DECODE_M, k, n, count * layers * steps)
    add(f"{name}_small_m", DECODE_M, d, cfg.vocab, steps + 1)
    return out


def vlm_image_traffic(cfg, fmt: str, params, gen, tag: str) -> dict:
    """qwen2-vl's image traffic: B=BATCH rows of an image prompt
    (`image_embeds`, IMG_PROMPT stub embeddings with their
    `image_positions`) through `lm.prefill`, then GEN-1 steps of the
    captured decode step from that cache.  Gates: the prefill's
    per_fwd tile launches (M = B * IMG_PROMPT) and the head's one
    small-M launch, nothing else; explicit equal 3-row positions give
    the logits of positions=None bit for bit, and the image's positions
    move them; the captured step (one new capture, for the wider cache)
    equals the per-step loop on the same cache in tokens and logits, bit
    for bit, all finite.  Returns what the caller logs."""
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm

    name = _gemm_name(fmt)
    cache_len = IMG_PROMPT + GEN
    emb = image_embeds(params, cfg, gen, BATCH, IMG_BEFORE, IMG_GRID,
                       IMG_AFTER)
    pos = image_positions(BATCH, IMG_BEFORE, IMG_GRID, IMG_AFTER, "cuda")
    counters = {c.name: c for c in registry.LAUNCH_COUNTERS}
    want = {k: 0 for k in counters}
    want[name] = gemms_per_forward(cfg) + 1     # the head: M = B, small-M
    want[f"{name}_small_m"] = 1

    def prefill(positions):
        before = {k: c.count for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.prefill(params, emb, cfg, cache_len=cache_len,
                         positions=positions)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: c.count - before[k] for k, c in counters.items()}
        if counts != want:
            raise AssertionError(f"{tag} image prefill: kernel launches "
                                 f"{counts}, expected {want}")
        return out, ms

    (logits, kv), ms_img = prefill(pos)
    out, ms_none = prefill(None)
    lg_none = out[0]
    out, ms_eq = prefill(torch.arange(
        IMG_PROMPT, device="cuda").expand(3, BATCH, IMG_PROMPT))
    lg_eq = out[0]
    del out                     # its cache
    if not torch.equal(lg_eq, lg_none):
        raise AssertionError(f"{tag}: explicit equal position rows differ "
                             "from the default positions")
    moved = (logits - lg_none).abs().max().item()
    if not moved > 0 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: the image positions moved the logits "
                             f"by {moved}")
    del lg_none, lg_eq
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    bundle = serve._decode_bundle(cfg, "off", "cuda")
    captures = bundle.captures
    t0 = time.perf_counter()
    step = bundle.captured(params, BATCH, cache_len, True, GEN - 1,
                           torch.device("cuda"))
    capture_s = time.perf_counter() - t0
    if bundle.captures != captures + 1:
        raise AssertionError(f"{tag}: the image cache did not capture anew")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_c, seen_c = step.run(tok, kv, IMG_PROMPT, GEN - 1)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / (GEN - 1)
    t, toks_s, seen_s = tok, [], []
    t0 = time.perf_counter()
    for i in range(GEN - 1):
        lg, _ = bundle.decode(params, t, kv, torch.full(
            (BATCH,), IMG_PROMPT + i, dtype=torch.int64, device="cuda"))
        t = lg[:, -1].argmax(dim=-1)[:, None]
        toks_s.append(t)
        seen_s.append(lg[:, -1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (GEN - 1)
    toks_s = torch.cat(toks_s, dim=1).to(torch.int32)
    seen_s = torch.stack(seen_s, dim=1)
    if not torch.equal(toks_c, toks_s) or not torch.equal(seen_c, seen_s):
        raise AssertionError(
            f"{tag} image traffic: the captured step differs from the "
            f"per-step loop (tokens equal: {torch.equal(toks_c, toks_s)}, "
            f"max logit diff {(seen_c - seen_s).abs().max().item()})")
    if not bool(torch.isfinite(seen_c).all()) or \
            not bool(((toks_c >= 0) & (toks_c < cfg.vocab)).all()):
        raise AssertionError(f"{tag} image traffic: bad tokens or logits")
    del kv, step
    return dict(prefill_ms=ms_img, prefill_ms_all=(ms_img, ms_none, ms_eq),
                moved=moved, replay_ms=replay_ms, step_ms=step_ms,
                capture_s=capture_s, toks=toks_c, tile=want[name] - 1)


def phase_vlm() -> tuple:
    """Phase 12: the vlm family.  Reduced qwen2-vl on the card against its
    CPU run on an image prompt, teacher-forced (`vlm_reduced_vs_cpu`);
    both GEMM kernels bit for bit at qwen2-vl-72b's five (K, N), (8192,
    8192), (8192, 1024), (8192, 29568), (29568, 8192) and the head
    (8192, 152064), at M = 8, 1024 and 3072 (the image prompt's 8 x
    384), each timed beside its bound with its w-load path
    (`phase_wide_gemms`).  Then qwen2-vl-72b served at full width (80
    layers, d 8192, 64 heads over 8 KV heads, d_ff 29568, untied vocab
    152064, q/k/v biases drawn nonzero; nothing cut; random weights from
    seed 0 built a [K, N] matrix at a time by `serve.build_params`, the
    w4a8 tree freed before the w8a8 one is built), under w4a8 and w8a8:
    token traffic (B=8, prompt 128, 32 new tokens, greedy; the three
    position rows equal, as the reference's `generate` serves tokens)
    through `_serve_gates` (fused == per-step == plain-forced, bit for
    bit; 560 tile launches per prefill, 561 small-M per replayed step;
    one capture), --silvia all == off in tokens, the profiles of a
    replayed step and a prefill, rows 1-2's time per generate beside
    their bounds, decode ms/step beside the byte bound (weights and the
    KV read); then image traffic (`vlm_image_traffic`).  Build time,
    resident memory and each stage's peak are logged.  Returns ({GEMM
    counter: {path: launches}}, {path: {GEMM counter: launches, ms and
    bound_ms per generate}})."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config(VLM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(29)
    t0 = time.perf_counter()
    vlm_reduced_vs_cpu(gen)
    log(f"reduced {VLM_ARCH} against the CPU: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m_img = BATCH * IMG_PROMPT
    times = phase_wide_gemms(torch, archs=(VLM_ARCH,),
                             prefill_m=(PREFILL_M, m_img))
    log(f"{VLM_ARCH} GEMM gates: {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    per_fwd = gemms_per_forward(cfg)
    launches, per_generate = {}, {}
    for fmt in ("w4a8", "w8a8"):
        tag = f"{VLM_ARCH} {fmt}"
        name = _gemm_name(fmt)
        gib = lambda n: n / 2 ** 30
        peaks = []

        def stage(what):
            torch.cuda.synchronize()
            peak = gib(torch.cuda.max_memory_allocated())
            peaks.append(f"{what} {peak:.2f}")
            torch.cuda.reset_peak_memory_stats()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t1
        resident = torch.cuda.memory_allocated() - base
        stage("build")
        attn, mlp = params["blocks"]["attn"], params["blocks"]["mlp"]
        if params["lm_head"].fmt != fmt or \
                any(attn[k].fmt != fmt for k in ("wq", "wk", "wv", "wo")) or \
                any(mlp[k].fmt != fmt for k in mlp) or \
                params["embed"].dtype != torch.bfloat16 or \
                attn["bq"].dtype != torch.bfloat16:
            raise AssertionError(f"{tag}: the quantized tree is not the "
                                 "serving tree")
        _nonzero_biases(params, gen)
        log(f"{tag}: built and quantized a matrix at a time in {t_build:.1f} "
            f"s; resident {gib(resident):.2f} GiB above the card's "
            f"{gib(base):.2f} GiB before, of "
            f"{gib(torch.cuda.mem_get_info()[1]):.2f} GiB")
        r = _serve_gates(cfg, fmt, params, prompts, tag)
        stage("token gates")
        launched = r["launched"]
        small = launched[f"{name}_small_m"]
        tile = launched[name] - small
        per_step = (small - 1) / (GEN - 1)   # the prefill's head: one
        if tile != per_fwd or per_step != per_fwd + 1:
            raise AssertionError(f"{tag}: {tile} tile launches per prefill, "
                                 f"{per_step} small-M per replayed step, "
                                 f"expected {per_fwd} and {per_fwd + 1}")
        for kname, c in ((name, tile), (f"{name}_small_m", small)):
            launches.setdefault(kname, {})[tag] = c
        state = r["captured"].cache
        want = lm.init_cache(cfg, BATCH, PROMPT + GEN, device="meta")
        if {k: (t.dtype, tuple(t.shape)) for k, t in state.items()} != \
                {k: (t.dtype, tuple(t.shape)) for k, t in want.items()}:
            raise AssertionError(f"{tag}: the captured step's buffers are "
                                 f"{ {k: t.shape for k, t in state.items()} }")
        del state
        first_a = _timed_generate(serve, params, prompts, cfg,
                                  silvia_passes="all")[3]
        toks_a, logits_a, _, silvia_s = _timed_generate(
            serve, params, prompts, cfg, silvia_passes="all")
        if not torch.equal(toks_a, r["toks"]):
            raise AssertionError(f"{tag}: --silvia all tokens differ from off")
        same = "identical" if torch.equal(logits_a, r["logits"]) \
            else "DIFFER"
        log(f"{tag} --silvia all: tokens identical to off, logits {same}"
            f"; first call (trace + capture) {first_a * 1e3:.1f} ms, fused "
            f"decode {(silvia_s - r['prefill_s']) / (GEN - 1) * 1e3:.2f} "
            f"ms/step (off: {r['fused_ms']:.2f}); passes "
            f"{serve.get_decode_step(cfg, 'all').cache_info()}")
        del toks_a, logits_a
        serve.decode_cache_clear()        # the --silvia bundle's graph
        stage("--silvia all")
        per_gen = vlm_per_generate(cfg, fmt, times)
        for k, (c, _, _) in per_gen.items():     # the profiled launches
            seen = launched[k] if k.endswith("_small_m") else \
                launched[k] - launched[f"{k}_small_m"]
            if c != seen:
                raise AssertionError(f"{tag}: {k} launched {seen} times, "
                                     f"the per-generate sum counts {c}")
        sm = per_gen[f"{name}_small_m"]
        replay_profile(torch, r["captured"], params, cfg, prompts,
                       PROMPT + GEN, tag, sm[1] * 1e3 / sm[0])
        prefill_profile(torch, params, cfg, prompts, PROMPT + GEN, tag)
        w_bytes = step_weight_bytes(cfg, fmt)
        s_bytes = step_state_bytes(cfg)
        b_w = w_bytes / HBM_BYTES_PER_S * 1e3
        b_ws = (w_bytes + s_bytes) / HBM_BYTES_PER_S * 1e3
        log(f"{tag}: {per_step:.0f} small-M launches per replayed decode "
            f"step (profiled), {tile} tile launches per prefill; prefill "
            f"{r['prefill_ms']:.1f} ms; GEMM kernels per generate "
            "(per-launch times x launches, phase 12's gates): "
            + "; ".join(f"{k} {c} launches {ms:.3f} ms (bound {bd:.3f})"
                        for k, (c, ms, bd) in per_gen.items())
            + f"; decode bound {b_ws:.3f} ms/step ({w_bytes / 1e9:.3f} GB "
            f"of weights + {s_bytes / 1e9:.3f} GB of KV read at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; weights alone "
            f"{b_w:.3f}): fused {r['fused_ms']:.2f} ms/step, "
            f"{100 * b_ws / r['fused_ms']:.1f}% of it; replays alone "
            f"{r['replay_ms']:.2f}; per-step loop {r['step_ms']:.2f}; "
            f"{time.perf_counter() - t1:.1f} s")
        per_generate[tag] = {k: dict(launches=c, ms=ms, bound_ms=bd)
                             for k, (c, ms, bd) in per_gen.items()}
        del r
        serve.decode_cache_clear()
        torch.cuda.empty_cache()
        stage("profiles")
        t2 = time.perf_counter()
        img = vlm_image_traffic(cfg, fmt, params, gen, tag)
        stage("image traffic")
        launches.setdefault(name, {})[f"{tag} image prefill"] = img["tile"]
        img_gen = vlm_per_generate(cfg, fmt, times, m=m_img, steps=0)[name]
        log(f"{tag} image traffic (B={BATCH}, {IMG_BEFORE} text tokens, a "
            f"{IMG_GRID[0]} x {IMG_GRID[1]} image, {IMG_AFTER} text tokens: "
            f"{IMG_PROMPT} stub embeddings, then {GEN - 1} decode steps): "
            f"{img['tile']} tile launches per prefill at M = {m_img} "
            f"({img_gen[1]:.3f} ms of tile per prefill, bound "
            f"{img_gen[2]:.3f}); prefill {img['prefill_ms']:.1f} ms (the "
            f"three runs "
            f"{', '.join(f'{x:.1f}' for x in img['prefill_ms_all'])}); "
            f"equal rows == default positions bit for bit, the image "
            f"positions move the logits by up to {img['moved']:.4g}; "
            f"captured step (capture {img['capture_s'] * 1e3:.1f} ms) == "
            f"per-step loop bit for bit: replays {img['replay_ms']:.2f} "
            f"ms/step, per-step loop {img['step_ms']:.2f} ms/step; sample "
            f"tokens {img['toks'][0, :8].tolist()}; "
            f"{time.perf_counter() - t2:.1f} s")
        log(f"{tag}: allocated GiB, each stage's peak (max_memory_allocated"
            f"): {'; '.join(peaks)}")
        del params, attn, mlp, img
        serve.decode_cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches, per_generate


def _small_m_back_to_back_us(res: dict) -> float:
    """The small-M kernel's mean time per decode launch, back to back
    (phase_kernels' CUDA-event timing, L2 spilled), weighted as one
    decode step launches it (the seven projections of a layer)."""
    per = {(r["k"], r["n"]): r["ms"] for r in res["rows"]
           if r["m"] == DECODE_M}
    return sum(per[kn] for kn in MAIN_KN) / len(MAIN_KN) * 1e3


def _profiled(torch, run, steps: int):
    """Profile run() (which makes `steps` decode steps and synchronizes):
    (host ms/step, device ms/step, [(key, device ms/step, calls/step,
    us/call)] of the device kernels, by device time), in a
    `registry.profile_window` (its prologue is not timed or listed)."""
    from repro_torch.kernels import registry
    with registry.profile_window() as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = sorted((e for e in registry.window_events(prof)
                     if e.device_time_us > 0),
                    key=lambda e: e.device_time_us, reverse=True)
    rows = [(e.key, e.device_time_us / 1e3 / steps, e.count / steps,
             e.device_time_us / e.count) for e in events]
    return wall_ms, sum(r[1] for r in rows), rows


def _log_profile(what: str, wall_ms: float, dev_ms: float, rows,
                 steps: int, small_b2b: float) -> None:
    if dev_ms <= 0:
        log(f"{what}: device time not measured (profiler saw no device "
            f"events); host {wall_ms:.2f} ms/step")
        return
    log(f"{what} (profiled, {steps} steps): host {wall_ms:.2f} ms/step, "
        f"device kernels {dev_ms:.3f} ms/step in "
        f"{sum(r[2] for r in rows):.0f} launches, device busy "
        f"{100 * dev_ms / wall_ms:.1f}%")
    for key, ms, calls, us in rows[:8]:
        log(f"    {ms:8.3f} ms/step  {calls:7.1f} calls/step  {us:7.2f} "
            f"us/call  {key[:70]}")
    small = [(ms, calls) for key, ms, calls, _ in rows if "small_m" in key]
    if small:
        ms, calls = sum(m for m, _ in small), sum(c for _, c in small)
        log(f"    small-M kernel: {ms / calls * 1e3:.2f} us per launch "
            f"(profiled kernel duration, {calls:.0f} launches/step) against "
            f"{small_b2b:.2f} us back to back (CUDA events, L2 spilled)")


def decode_profile(torch, params, cfg, prompts, cache_len, fmt, small_b2b,
                   steps: int = 4) -> None:
    """Where an eager (per-step) decode step's time goes: device kernel
    time (profiler) against the host clock, and the top kernels."""
    from repro_torch.models import lm
    logits, cache = lm.prefill(params, prompts, cfg, cache_len=cache_len)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int64, device="cuda")
    lm.decode_step(params, tok, cache, pos, cfg)
    torch.cuda.synchronize()

    def run():
        t = tok
        for i in range(steps):
            lg, _ = lm.decode_step(params, t, cache, pos + 1 + i, cfg)
            t = lg[:, -1].argmax(dim=-1)[:, None]
        torch.cuda.synchronize()

    _log_profile(f"{fmt} decode profile, per-step loop",
                 *_profiled(torch, run, steps), steps, small_b2b)


def prefill_profile(torch, params, cfg, prompts, cache_len, what) -> None:
    """Where one prefill's time goes: device kernel time (profiler)
    against the host clock, and the top kernels (the small-M line of
    `_log_profile` does not apply: prefill rows run on the tile)."""
    from repro_torch.models import lm
    lm.prefill(params, prompts, cfg, cache_len=cache_len)
    torch.cuda.synchronize()

    def run():
        lm.prefill(params, prompts, cfg, cache_len=cache_len)
        torch.cuda.synchronize()

    _log_profile(f"{what} prefill profile", *_profiled(torch, run, 1), 1,
                 0.0)


def replay_profile(torch, captured, params, cfg, prompts, cache_len, fmt,
                   small_b2b, steps: int = 8) -> None:
    """The same for replays of the captured decode step (fused=True)."""
    from repro_torch.models import lm
    logits, cache = lm.prefill(params, prompts, cfg, cache_len=cache_len)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    captured.run(tok, cache, PROMPT, 1)
    torch.cuda.synchronize()

    def run():
        captured.run(tok, cache, PROMPT, steps)
        torch.cuda.synchronize()

    _log_profile(f"{fmt} decode profile, captured graph replays",
                 *_profiled(torch, run, steps), steps, small_b2b)


def _to_cpu(tree):
    from repro_torch.quant.qtensor import QTensor
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.cpu(), tree.scale.cpu(), tree.fmt)
    return tree.cpu()


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = ("quant_matmul", "packed_w4_matmul", "simd_add", "muladd2",
             "mul4")
    fresh = [n for n in names if not _build.library_path(n).exists()]
    ptxas = {n: ptxas_report(_build, n)
             for n in ("quant_matmul", "packed_w4_matmul", "mul4")}
    _build.build(*names)
    log(f"build: {time.perf_counter() - t0:.1f} s (compiled "
        f"{fresh or 'nothing: cached'}) into {_build.BUILD_DIR}")
    for n, proc in ptxas.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {n}.cu:\n{out}")
        log(f"ptxas, {n}.cu:\n" + "\n".join(
            "  " + ln.strip() for ln in out.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def phase(label, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        log(f"== {label}: {time.perf_counter() - t1:.1f} s")
        return out

    phase("scan gate", phase_scan_gate)
    results = phase("GEMM gates, smollm widths", phase_kernels, torch)
    wide = phase("GEMM gates, the other dense widths", phase_wide_gemms,
                 torch)
    phase("SWAR gates", phase_swar_gates)
    swar_entries = phase("programs", phase_programs)
    entries = phase("smollm-135m serving", phase_generate, torch,
                    results) + swar_entries
    other = phase("dense serving: yi-6b, qwen1.5-0.5b int8 KV, "
                  "attn_q_chunk", phase_dense, wide)
    moe_times = phase("expert-stacked GEMM gates", phase_moe_gemms)
    moe, per_gen = phase("MoE serving: granite-moe-1b-a400m", phase_moe,
                         moe_times)
    ssm, ssm_gen = phase("SSM: mamba2-2.7b GEMM gates and serving",
                         phase_ssm)
    hyb, hyb_gen = phase("hybrid: jamba-v0.1-52b", phase_hybrid)
    enc, enc_gen = phase("encoder-decoder: whisper-small", phase_encdec)
    vlm, vlm_gen = phase("vlm: qwen2-vl-72b", phase_vlm)
    for paths_of in (moe, ssm, hyb, enc, vlm):
        for k, paths in paths_of.items():
            other.setdefault(k, {}).update(paths)
    for e in entries:
        if e["name"] in other:
            e["launches_other_paths"] = other[e["name"]]
        for key, gens in (("moe_path_per_generate", per_gen),
                          ("ssm_path_per_generate", ssm_gen),
                          ("hybrid_path_per_generate", hyb_gen),
                          ("encdec_path_per_generate", enc_gen),
                          ("vlm_path_per_generate", vlm_gen)):
            path = {tag: rows[e["name"]] for tag, rows in gens.items()
                    if e["name"] in rows}
            if path:
                e[key] = path
    log(f"== total: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": entries}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving entry point: quantized weights + batched prefill / greedy decode.

Port of `repro/launch/serve.py` (greedy `generate` and the CLI):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --quant w4a8 --batch 8 --prompt-len 128 --gen 32 --device cuda

Weights are quantized offline (w8a8, or w4a8 with two int4 per int8
word); every weight matmul dispatches through kernels/registry.py to the
Hopper kernels on a CUDA device (the census and per-op dispatch counts
are printed per run).  ``REPRO_TORCH_LOWERING='*=ref'`` serves on the
plain PyTorch versions instead, bit-identically.

The decode loop is a per-step Python loop over `lm.decode_step`, the
port's counterpart of the reference's per-step (`fused=False`) loop;
capturing it in a CUDA graph is later work.  Sampling is greedy only.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.kernels import registry
from repro_torch.models import lm
from repro_torch.quant.qtensor import quantize_tree_for_serving


def generate(params, prompts, cfg, *, gen: int, cache_len: int,
             device="cuda", return_logits: bool = False):
    """Greedy generation: prefill, its argmax, then gen-1 decode steps.

    prompts: [B,S] int tokens (tensor or numpy).  Returns the generated
    tokens [B, gen] int32 on `device`, the reference's dtype; with
    return_logits=True also the float32 logits each token was chosen
    from, [B, gen, V]."""
    dev = device_lib.resolve(device)
    prompts = torch.as_tensor(prompts, device=dev)
    b, s = prompts.shape
    if gen < 1 or cache_len < s + gen - 1:
        raise ValueError(f"need gen >= 1 and cache_len >= prompt + gen - 1 "
                         f"(got gen={gen}, cache_len={cache_len}, "
                         f"prompt={s})")
    logits, cache = lm.prefill(params, prompts, cfg, cache_len=cache_len)
    tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    out, seen = [tok], [logits[:, -1, :]]
    pos = torch.full((b,), s, dtype=torch.int64, device=dev)
    for i in range(gen - 1):
        logits, cache = lm.decode_step(params, tok, cache, pos + i, cfg)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        out.append(tok)
        seen.append(logits[:, -1, :])
    toks = torch.cat(out, dim=1).to(torch.int32)
    if return_logits:
        return toks, torch.stack(seen, dim=1)
    return toks


def build_params(cfg, quant: str, *, seed: int = 0, quant_force=False,
                 device="cuda"):
    """Random params from `seed`, quantized for serving as `quant`."""
    params = lm.init_params(cfg, seed, device=device)
    return quantize_tree_for_serving(params, quant, force=quant_force)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="w8a8",
                    choices=["bf16", "w8a8", "w4a8"])
    ap.add_argument("--quant-force", action="store_true",
                    help="drop the quantization size floors (reduced "
                         "configs sit entirely under them)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = configs.get_reduced_config(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    cache_len = args.prompt_len + args.gen
    params = build_params(cfg, args.quant, seed=args.seed,
                          quant_force=args.quant_force, device=dev)
    if args.quant != "bf16":
        print(f"quantized weights to {args.quant}"
              + (" (forced floors)" if args.quant_force else ""))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    print("active lowerings:", registry.census_str(dev))
    registry.reset_dispatch_counts()
    t0 = time.perf_counter()
    toks = generate(params, prompts, cfg, gen=args.gen, cache_len=cache_len,
                    device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.gen
    print("dispatch counts:", registry.dispatch_counts())
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s batch-aggregate, {dev})")
    print("sample tokens:", toks[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()

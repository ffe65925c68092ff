"""Architecture registry (port of `repro/configs`): one module per arch.

Use `get_config(name)` / `get_reduced_config(name)` (smoke-test scale).
`ARCHS` lists the architectures ported so far.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "smollm-135m",
    "qwen1.5-0.5b",
    "yi-6b",
    "command-r-35b",
    # the vlm family runs the dense block (M-RoPE, stub patch embeddings)
    "qwen2-vl-72b",
    "granite-moe-1b-a400m",
    "arctic-480b",
    "mamba2-2.7b",
    "jamba-v0.1-52b",
    "whisper-small",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r} "
                       f"(ported: {', '.join(ARCHS)})")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced_config(name: str):
    return _module(name).reduced()


__all__ = ["ARCHS", "get_config", "get_reduced_config"]

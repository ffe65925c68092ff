"""Model configuration schema (port of `repro/models/config.py`).

The port keeps its own copy: it imports nothing of `repro`.  Only the
fields and derived widths the ported families use are carried; the
sub-configs of the MoE, SSM and hybrid families arrive with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    rope_theta: float = 10000.0
    activation: str = "swiglu"         # swiglu (gelu: not ported yet)
    norm: str = "rmsnorm"              # rmsnorm (layernorm: not ported yet)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    serve_kv_dtype: str = "bfloat16"   # bfloat16 (int8: not ported yet)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else \
            self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

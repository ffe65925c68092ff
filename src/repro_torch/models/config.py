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
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    activation: str = "swiglu"         # swiglu (gelu: not ported yet)
    norm: str = "rmsnorm"              # rmsnorm (layernorm: not ported yet)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # serving quantization format for decode/prefill cells
    serve_fmt: str = "w8a8"            # bf16 | w8a8 | w4a8
    serve_kv_dtype: str = "bfloat16"   # bfloat16 | int8 (quantized KV cache)
    # chunk the query dim of causal self-attention: only a
    # [B, KV, G, chunk, T] score block is live at a time
    attn_q_chunk: Optional[int] = None

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

    def param_count(self) -> int:
        """Analytic parameter count of the dense family, as the
        reference's: embeddings (twice when untied), the four attention
        projections and the SwiGLU MLP per layer; norms and biases are not
        counted.  Used for byte bounds."""
        if self.family != "dense":
            raise NotImplementedError(
                f"param_count: family {self.family!r} is not ported yet")
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim * 2 + d * self.kv_dim * 2
        n_mlp = 3 if self.activation == "swiglu" else 2
        return emb + self.n_layers * (attn + n_mlp * d * self.d_ff)

"""Model configuration schema (port of `repro/models/config.py`).

The port keeps its own copy: it imports nothing of `repro`.  Only the
fields and derived widths the ported families (dense, moe, ssm, hybrid,
encdec, vlm) use are carried.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's MoEConfig, field for field.  Serving routes every
    token to its top_k experts dropless (`mlp.moe(per_token=True)`) and
    reads n_experts, top_k, d_ff_expert and dense_residual;
    capacity_factor, interleave, dispatch and dispatch_groups belong to
    the capacity dispatch of training (ROADMAP queue A items 4.6, 8) and
    are carried so that a config equals the reference's."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # arctic: a dense FFN runs in parallel with the MoE ("dense residual")
    dense_residual: bool = False
    # jamba: MoE only on every `interleave`-th layer (1 = every layer)
    interleave: int = 1
    # token dispatch of training: "global" or "grouped" (GShard-style)
    dispatch: str = "global"
    dispatch_groups: int = 32


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The reference's SSMConfig, field for field: the Mamba2 SSD mixer
    (models/ssm.py)."""
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """The reference's HybridConfig, field for field: jamba-style
    super-blocks ("scan units") of `period` layers, layer `attn_index`
    attention and the others Mamba2 SSD mixers."""
    period: int = 8            # layers per super-block
    attn_index: int = 4        # which layer in the block is attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # m_rope: 3-section multimodal rotary (qwen2-vl); None = standard RoPE
    m_rope_sections: Optional[Tuple[int, int, int]] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # encdec (whisper): decoder layer count; encoder uses n_layers
    n_decoder_layers: Optional[int] = None
    learned_pos: bool = False          # whisper: learned positional embeds
    activation: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None     # None | "audio" | "vision"
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
        """Analytic parameter count, as the reference's: embeddings (twice
        when untied), then per family: the four attention projections per
        layer and the MLPs (`_mlp_params_all`; norms and biases not
        counted), or for ssm each layer's mixer (`_ssm_layer_params`) and
        the final norm, or for hybrid one attention layer per `period`,
        a mixer on each of the others and every layer's MLP (no final
        norm), or for encdec the encoder's attention and GELU MLP (up and
        down) per layer and the decoder's self and cross attention and
        MLP per decoder layer (learned positions not counted); vlm counts
        as dense (its vision frontend is a stub).  Used for byte
        bounds."""
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm"):
            raise NotImplementedError(
                f"param_count: family {self.family!r} is not ported yet")
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            return emb + self.n_layers * self._ssm_layer_params() + d
        attn = d * self.q_dim * 2 + d * self.kv_dim * 2
        if self.family == "hybrid":
            n_attn = self.n_layers // (self.hybrid or HybridConfig()).period
            n_mamba = self.n_layers - n_attn
            return emb + n_attn * attn + n_mamba * \
                self._ssm_layer_params() + self._mlp_params_all()
        if self.family == "encdec":
            nd = self.n_decoder_layers or self.n_layers
            mlp = 2 * d * self.d_ff  # gelu mlp: up + down
            return emb + self.n_layers * (attn + mlp) + nd * (2 * attn + mlp)
        return emb + self.n_layers * attn + self._mlp_params_all()

    def _ssm_layer_params(self) -> int:
        """One Mamba2 mixer: in_proj (z, x, B, C, dt), out_proj, the
        depthwise conv's taps and bias, and A_log, D, dt_bias and the
        gated norm's weight."""
        s = self.ssm or SSMConfig()
        d = self.d_model
        d_inner = s.expand * d
        n_heads = d_inner // s.headdim
        d_conv_ch = d_inner + 2 * s.n_groups * s.d_state
        in_proj = d * (2 * d_inner + 2 * s.n_groups * s.d_state + n_heads)
        out_proj = d_inner * d
        conv = s.conv_width * d_conv_ch + d_conv_ch
        extras = 3 * n_heads + d_inner  # A, D, dt_bias, gated norm
        return in_proj + out_proj + conv + extras

    def _mlp_params_all(self) -> int:
        """The MLPs of every layer: the dense MLP, or per MoE layer the
        E experts and the router (d x E); arctic's dense residual adds a
        dense MLP to every layer."""
        d = self.d_model
        n_mlp = 3 if self.activation == "swiglu" else 2
        dense = n_mlp * d * self.d_ff
        if self.moe is None:
            return self.n_layers * dense
        m = self.moe
        expert = n_mlp * d * m.d_ff_expert
        n_moe_layers = self.n_layers // m.interleave
        n_dense_layers = self.n_layers - n_moe_layers
        total = n_moe_layers * (m.n_experts * expert + d * m.n_experts)
        if m.dense_residual:
            total += self.n_layers * dense
        else:
            total += n_dense_layers * dense
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts), as
        the reference counts them.  The port's serving path runs every
        expert on every token (`mlp.moe`), so a decode step still reads
        all of param_count()'s weights."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_mlp = 3 if self.activation == "swiglu" else 2
        expert = n_mlp * self.d_model * m.d_ff_expert
        n_moe_layers = self.n_layers // m.interleave
        inactive = n_moe_layers * (m.n_experts - m.top_k) * expert
        return self.param_count() - inactive

"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 -- Mamba+attn 1:7 interleave, MoE every
other layer.  [arXiv:2403.19887; hf]

Four scan units of eight layers: layer 4 of each is attention, the other
seven are Mamba2 SSD mixers; layers 1, 3, 5, 7 take the MoE as their
FFN, the others a dense SwiGLU MLP.  51.46 B parameters: served on one
card, built a [K, N] matrix at a time (`launch/serve.py::build_params`)."""
import dataclasses

from repro_torch.models.config import (HybridConfig, ModelConfig, MoEConfig,
                                       SSMConfig)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, interleave=2),
    ssm=SSMConfig(d_state=16, headdim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=256),
    hybrid=HybridConfig(period=8, attn_index=4),
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="jamba-reduced", n_layers=8, d_model=64,
        n_heads=4, n_kv=2, d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, interleave=2),
        ssm=SSMConfig(d_state=16, headdim=16, expand=2, conv_width=4,
                      n_groups=1, chunk=16),
        hybrid=HybridConfig(period=8, attn_index=4))

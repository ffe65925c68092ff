"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="granite-moe-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=64, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64))

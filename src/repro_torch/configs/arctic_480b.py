"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

Not served at full width: 480 B parameters do not fit one card."""
import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864, vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="arctic-480b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96,
                      dense_residual=True))

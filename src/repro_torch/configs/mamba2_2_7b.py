"""mamba2-2.7b [ssm]: 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv=1, d_ff=0, vocab=50280,
    d_head=64,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=256),
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="mamba2-reduced", n_layers=2, d_model=64, vocab=256,
        ssm=SSMConfig(d_state=16, headdim=16, expand=2, conv_width=4,
                      n_groups=1, chunk=16))

"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 -- GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv=8, d_ff=22528, vocab=256000,
    rope_theta=8_000_000.0,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="command-r-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256)

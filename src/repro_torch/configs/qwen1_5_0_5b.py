"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936 -- QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=2816, vocab=151936,
    qkv_bias=True, tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="qwen1.5-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=256)

"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- M-RoPE, dynamic resolution (vision frontend STUB:
inputs arrive as precomputed patch embeddings).
[arXiv:2409.12191; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568, vocab=152064,
    m_rope_sections=(16, 24, 24), rope_theta=1_000_000.0, qkv_bias=True,
    frontend="vision",
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256,
        m_rope_sections=(2, 3, 3))

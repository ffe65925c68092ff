"""whisper-small [audio]: 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865
-- enc-dec, conv frontend (STUB: the encoder takes precomputed frame
embeddings [B, S_enc, d], 1500 frames for a 30 s window).
[arXiv:2212.04356]

12 encoder layers (bidirectional attention over the frames) and 12
decoder layers (causal self-attention, cross-attention over the
encoder's output, the GELU MLP), LayerNorm, learned positions, untied
vocab 51865: 277.8 M parameters by param_count."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=51865,
    n_decoder_layers=12, learned_pos=True, activation="gelu",
    norm="layernorm", frontend="audio",
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="whisper-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=256, n_decoder_layers=2)

"""Atomic, resumable checkpointing (port of `repro/checkpoint`)."""
from repro_torch.checkpoint.ckpt import (latest_step, load_meta,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["latest_step", "load_meta", "restore_checkpoint",
           "save_checkpoint"]

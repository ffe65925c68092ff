"""Optimizer substrate (port of `repro/optim`): AdamW with a configurable
state dtype, schedules, clipping, and int8 gradient compression with
error feedback."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compression import (compress_grads, compressed_psum,
                                           decompress_grads)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_grads",
           "compressed_psum", "decompress_grads", "global_norm",
           "warmup_cosine"]

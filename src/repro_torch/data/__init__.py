"""Data pipeline (port of `repro/data`): deterministic, shardable token
streams."""
from repro_torch.data.pipeline import (DataConfig, TokenStream, make_stream,
                                       mmap_stream, synthetic_stream)

__all__ = ["DataConfig", "TokenStream", "make_stream", "mmap_stream",
           "synthetic_stream"]

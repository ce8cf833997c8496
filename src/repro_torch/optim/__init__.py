"""Optimizers: AdamW with the reference's schedules and update, and int8
gradient compression with error feedback."""

from .adamw import (AdamWConfig, AdamWState, apply_updates, global_norm,
                    init, make_schedule)
from .compression import (compress_decompress, compression_ratio,
                          init_error_feedback)

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "compress_decompress",
           "compression_ratio", "global_norm", "init", "init_error_feedback",
           "make_schedule"]

"""Input specs for every (architecture × shape) dry-run cell: the port of the
JAX package's ``repro.launch.specs``.

Shapes:
  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill (forward) step
  decode_32k   seq 32768 cache, global_batch 128, 1 new token -> serve_step
  long_500k    seq 524288 cache, global_batch 1 -> serve_step
               (sub-quadratic archs only; the skip is recorded)

Plus the paper's own workload (quantixar-db): sharded flat / PQ / BQ scans.
Every spec is a tensor on the meta device (a shape and a dtype, no
storage), in the reference's global shapes and dtypes; nothing is
allocated here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.model import abstract_decode_state


def S(shape, dtype) -> torch.Tensor:
    """A spec: an empty tensor of ``shape`` and ``dtype`` on the meta
    device."""
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str             # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """The skip rule (skips are recorded, not silently dropped)."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention arch — 512k-token dense "
                       "KV cache is the quadratic regime long_500k excludes "
                       "(DESIGN.md §5)")
    return True, ""


def lm_train_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    b, s = cell.global_batch, cell.seq_len
    specs = {
        "tokens": S((b, s), torch.int32),
        "targets": S((b, s), torch.int32),
        "segment_ids": S((b, s), torch.int32),
    }
    if cfg.is_enc_dec:
        # audio frontend stub: precomputed frame embeddings
        specs["frames"] = S((b, s, cfg.d_model), cfg.activation_dtype)
    return specs


def lm_decode_specs(cfg: ModelConfig, cell: ShapeCell):
    """(tokens, abstract decode state) for serve_step."""
    b = cell.global_batch
    cache_len = cell.seq_len
    cross_len = cell.seq_len if cfg.is_enc_dec else 0
    state = abstract_decode_state(cfg, b, cache_len, with_cross_len=cross_len)
    return S((b, 1), torch.int32), state


# ---------------------------------------------------------------------------
# quantixar-db cells (the paper's own workload)
# ---------------------------------------------------------------------------

def db_specs(db_cfg, mode: str, row_multiple: int = 1) -> Dict[str, Any]:
    """row_multiple: round the corpus up to a shard multiple (the engine pads
    with +inf rows on ingest; the row shards must be equal).  The BQ words
    are uint32, as the reference's; the port's BQ scan reads them as int32
    words (``.view(torch.int32)``, the same bits)."""
    n, d, q = db_cfg.n_vectors, db_cfg.dim, db_cfg.query_batch
    n = -(-n // row_multiple) * row_multiple
    if mode == "flat":
        return {"corpus": S((n, d), torch.float32),
                "queries": S((q, d), torch.float32)}
    if mode == "pq":
        return {"codes": S((n, db_cfg.pq_m), torch.uint8),
                "lut": S((q, db_cfg.pq_m, db_cfg.pq_k), torch.float32)}
    if mode == "bq":
        w = db_cfg.bq_bits // 32
        return {"codes": S((n, w), torch.uint32),
                "q_codes": S((q, w), torch.uint32)}
    raise ValueError(mode)

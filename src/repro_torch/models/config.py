"""Unified model configuration covering all 10 assigned architectures.

A copy of the JAX package's ``repro.models.config`` whose
``activation_dtype`` is a ``torch.dtype``; everything else is the same data.

One dataclass + a block-pattern string list expresses dense / MoE / hybrid
(RG-LRU) / SSM (xLSTM) / VLM / audio enc-dec families.  Block types:

  "attn"        full (GQA) attention + MLP
  "swa"         sliding-window attention + MLP           (mixtral)
  "local_attn"  local window attention + MLP             (recurrentgemma)
  "attn_moe"    attention + MoE FFN                      (mixtral, granite)
  "swa_moe"     sliding-window attention + MoE FFN       (mixtral)
  "rglru"       RG-LRU recurrent block + MLP             (recurrentgemma)
  "mlstm"       xLSTM matrix-memory block (self-contained)
  "slstm"       xLSTM scalar-memory block (self-contained)

The pattern is cycled over ``n_layers``; the layer stack scans over whole
pattern units (HLO stays small, compile stays fast — DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

VALID_BLOCKS = ("attn", "swa", "local_attn", "attn_moe", "swa_moe",
                "rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int                    # decoder layers for enc-dec
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"         # swiglu|geglu|gelu
    norm_type: str = "rmsnorm"       # rmsnorm|layernorm
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # fraction of head dim rotated (stablelm .25)
    window: int = 4096               # swa window
    local_window: int = 2048         # local_attn window
    attn_chunk: int = 512            # online-softmax block (bounds VMEM/HBM
    #                                  transients: B·H·c² scores per block)
    dense_attn_threshold: int = 1024  # dense softmax below this seq len
    attn_schedule: str = "masked"    # "masked": every (q,kv) chunk pair is
    #                                  computed then masked (simple scan²,
    #                                  2x causal waste); "extent": static
    #                                  per-q-chunk kv ranges skip fully
    #                                  masked chunks (§Perf; falls back to
    #                                  masked above 16 q-chunks to bound HLO)
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_group_size: int = 1024       # GShard-style routing wave (tokens)
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"     # "einsum": GShard one-hot matmuls
    #                                  (baseline); "gather": index-based
    #                                  dispatch/combine — O(E·C·d) data
    #                                  movement instead of O(g·E·C·d) matmul
    #                                  flops (§Perf MoE iteration)
    # enc-dec (audio)
    encoder_layers: int = 0          # >0 -> encoder-decoder model
    # recurrent widths
    rnn_width: int = 0               # RG-LRU width (0 -> d_model)
    mlstm_proj_factor: float = 2.0   # xLSTM mLSTM up-projection
    slstm_proj_factor: float = 1.375  # xLSTM sLSTM FFN factor (qkv conv omitted)
    mlstm_chunk: int = 256           # chunkwise-parallel block; §Perf tunes
    #                                  toward dk (state-vs-intra balance)
    mlstm_state_dtype: str = "float32"  # carried C/N dtype (§Perf: bfloat16)
    decode_pos_mode: str = "ragged"  # "ragged": per-seq positions (scatter
    #                                  cache update); "uniform": one shared
    #                                  position (dynamic-update-slice — fully
    #                                  shardable, §Perf decode iteration)
    # frontends (assignment: modality frontends are stubs)
    frontend: str = "none"           # none|vq_tokens|audio_frames
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # mesh axes the activation batch dim is pinned to (with_sharding_constraint
    # at block boundaries — keeps GSPMD from replicating the token dim);
    # empty = no constraints (single-device tests)
    batch_axes: Tuple[str, ...] = ()
    # cast unit params to the activation dtype at the scan boundary so the
    # FSDP all-gather moves bf16, not f32 (§Perf: halves gather traffic;
    # master weights stay f32 in the optimizer)
    bf16_weight_gather: bool = False
    # Megatron-style sequence parallelism: residual stream pinned
    # (batch, S/model, d) at block boundaries — norm/residual cotangents stay
    # sharded instead of f32 full-activation gathers in backward (§Perf 5)
    sequence_parallel: bool = False
    # which shape cells this arch runs (assignment skip rules)
    supports_long_context: bool = False

    def __post_init__(self):
        for b in self.block_pattern:
            if b not in VALID_BLOCKS:
                raise ValueError(f"unknown block type {b!r}")
        if any(b.endswith("moe") for b in self.block_pattern):
            if self.moe_experts <= 0 or self.moe_top_k <= 0:
                raise ValueError(f"{self.name}: moe blocks need moe_experts/top_k")

    # ------------------------------------------------------------------ dims
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_units(self) -> int:
        """Full pattern repetitions (scanned); remaining layers form `tail`."""
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        """Leftover blocks when n_layers isn't a pattern multiple (e.g.
        recurrentgemma's 38 = 12×(R,R,A) + (R,R)); applied after the scan."""
        return self.block_pattern[: self.n_layers % len(self.block_pattern)]

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def lru_width(self) -> int:
        return self.rnn_width or self.d_model

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dh = self.d_model, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        counts = {
            "embed": self.vocab_size * d,
            "head": 0 if self.tie_embeddings else self.vocab_size * d,
            "final_norm": d,
        }
        attn = d * nq * dh + 2 * d * nkv * dh + nq * dh * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * dh
        mlp_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        mlp = mlp_mats * d * self.d_ff
        moe = self.moe_experts * (mlp_mats * d * self.d_ff) + d * self.moe_experts
        lru = self.lru_width
        rglru = (2 * d * lru            # in/gate projections (x, y branches)
                 + lru * d              # out projection
                 + 3 * lru              # Λ, input-gate, rec-gate params (diag)
                 + 2 * lru * lru // 4)  # block-diag gate weights (4 blocks)
        dm = int(d * self.mlstm_proj_factor)
        mh = max(self.n_heads, 1)
        mlstm = (2 * d * dm                 # up (x2 branches)
                 + 3 * dm * dm // mh        # q,k,v block-diag per head
                 + 2 * dm * mh + 2 * mh     # i/f gate projections + biases
                 + dm * d)                  # down
        ds = int(d * self.slstm_proj_factor)
        slstm = (4 * d * d                  # i,f,z,o input weights
                 + 4 * d * d // mh          # block-diag recurrent weights
                 + 4 * d                    # biases
                 + 2 * d * ds)              # ffn
        per_block = {
            "attn": attn + mlp + 2 * d,
            "swa": attn + mlp + 2 * d,
            "local_attn": attn + mlp + 2 * d,
            "attn_moe": attn + moe + 2 * d,
            "swa_moe": attn + moe + 2 * d,
            "rglru": rglru + mlp + 2 * d,
            "mlstm": mlstm + d,
            "slstm": slstm + 2 * d,
        }
        total = counts["embed"] + counts["head"] + counts["final_norm"]
        for i in range(self.n_layers):
            total += per_block[self.block_pattern[i % len(self.block_pattern)]]
        if self.is_enc_dec:
            # encoder blocks (full attn, no extra embed) + cross-attn in decoder
            total += self.encoder_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)      # cross-attention + norm
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of experts)."""
        if self.moe_experts == 0:
            return self.param_count()
        mlp_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        unused = (self.moe_experts - self.moe_top_k) * mlp_mats * \
            self.d_model * self.d_ff
        n_moe_blocks = sum(1 for i in range(self.n_layers)
                           if self.block_pattern[i % len(self.block_pattern)]
                           .endswith("moe"))
        return int(self.param_count() - n_moe_blocks * unused)

"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per expert) vocab=49155; MoE 40 experts top-8 (structured spec; the prose
comment says 32 — we follow the structured spec, noted in DESIGN.md).
Tied embeddings. [hf:ibm-granite/granite-3.0-*; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_head=64, d_ff=512, vocab_size=49155,
    block_pattern=("attn_moe",), mlp_type="swiglu",
    moe_experts=40, moe_top_k=8, tie_embeddings=True)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=32,
    vocab_size=256, moe_experts=8, moe_top_k=2, moe_group_size=64)

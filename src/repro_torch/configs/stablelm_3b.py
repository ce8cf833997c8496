"""stablelm-3b [dense] — 32L d_model=2560 32H (kv=32, i.e. MHA) d_ff=6912
vocab=50304; partial RoPE (25% of head dim), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b family; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_head=80, d_ff=6912, vocab_size=50304,
    block_pattern=("attn",), mlp_type="swiglu", norm_type="layernorm",
    rope_pct=0.25)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab_size=256)

"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA + RoPE, gelu MLP, qkv bias, layernorm.
Treated as full attention per the assignment's long_500k skip
categorisation (the spec line lists only "GQA, RoPE").
[arXiv:2402.19173; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_head=128, d_ff=24576, vocab_size=49152,
    block_pattern=("attn",), mlp_type="gelu", norm_type="layernorm",
    qkv_bias=True, rope_theta=100_000.0)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256)

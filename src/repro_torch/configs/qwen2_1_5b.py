"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; GQA with QKV bias, tied embeddings, RoPE theta 1e6.
[arXiv:2407.10671; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_head=128, d_ff=8960, vocab_size=151936,
    block_pattern=("attn",), mlp_type="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256)

"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936; qk_norm, GQA, tied embeddings, head_dim 128 (q/k/v project to n_heads*128
independent of d_model). [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=9728, vocab_size=151936,
    block_pattern=("attn",), mlp_type="swiglu", qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=True)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256)

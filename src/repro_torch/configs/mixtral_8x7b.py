"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; 8 experts top-2, sliding-window attention (4096).
SWA ring cache is bounded => runs the long_500k cell.
[arXiv:2401.04088; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab_size=32000,
    block_pattern=("swa_moe",), mlp_type="swiglu", window=4096,
    moe_experts=8, moe_top_k=2, supports_long_context=True)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256, window=32, moe_experts=4, moe_top_k=2,
    moe_group_size=64)

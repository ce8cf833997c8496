"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; Griffin pattern: 2 RG-LRU blocks : 1 local-attention block
(window 2048), GeGLU MLP.  Bounded recurrent state + window cache =>
runs the long_500k cell. [arXiv:2402.19427; unverified]

38 layers = 12 scanned (rglru, rglru, local_attn) units + a (rglru,
rglru) tail — exact layer count via ModelConfig.tail_pattern."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_head=256, d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"), mlp_type="geglu",
    local_window=2048, rnn_width=4096, supports_long_context=True)

SMOKE = CONFIG.with_overrides(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
    vocab_size=256, rnn_width=64, local_window=32)

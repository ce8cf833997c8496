"""seamless-m4t-medium [audio] — enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206; the speech frontend
(conformer feature extractor) is a STUB per the assignment: input_specs
provides precomputed frame embeddings (B, S_enc, d_model) to the encoder;
the text decoder decodes with self- + cross-attention. LayerNorm, gelu.
[arXiv:2308.11596; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_head=64, d_ff=4096, vocab_size=256206,
    block_pattern=("attn",), mlp_type="gelu", norm_type="layernorm",
    encoder_layers=12, frontend="audio_frames")

SMOKE = CONFIG.with_overrides(
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab_size=256)

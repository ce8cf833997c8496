"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion: image patches arrive as VQ-VAE token ids inside
the same 65536 vocabulary (the VQ tokenizer IS the modality frontend and is
stubbed per the assignment — input_specs provides token ids directly; the
VQ codebook-lookup machinery is the same construction as core/pq.py decode).
qk_norm as in the paper. [arXiv:2405.09818; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=22016, vocab_size=65536,
    block_pattern=("attn",), mlp_type="swiglu", qk_norm=True,
    frontend="vq_tokens")

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256)

"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304; xLSTM[7:1]
(the published 1.3B config): 7 mLSTM blocks per 1 sLSTM block, 6 units of 8.
Blocks are self-contained (internal up/down projections; d_ff=0 per spec).
Pure recurrent state => runs the long_500k cell.
[arXiv:2405.04517; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    supports_long_context=True)

SMOKE = CONFIG.with_overrides(
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=256,
    block_pattern=("mlstm", "slstm"))

"""The LM stack ported to PyTorch: xLSTM (mLSTM and sLSTM blocks) serving —
prefill / scoring ``forward`` and greedy or sampled decode — with the sLSTM
recurrence on the ``slstm_sequence`` CUDA kernel."""

from .config import ModelConfig
from .convert import from_numpy_params, to_numpy_params
from .model import (DecodeState, Model, decode_step, embed_tokens, forward,
                    init_decode_state, init_params, logits_from_hidden)
from .steps import make_serve_step

__all__ = ["DecodeState", "Model", "ModelConfig", "decode_step",
           "embed_tokens", "forward", "from_numpy_params",
           "init_decode_state", "init_params", "logits_from_hidden",
           "make_serve_step", "to_numpy_params"]

"""The LM stack ported to PyTorch: every block type of the JAX package's
``repro.models`` (attention with MLP or MoE, RG-LRU, mLSTM, sLSTM) and
encoder-decoder models, for serving — prefill / scoring ``forward`` and
greedy or sampled decode over KV caches and recurrent states — with the
sLSTM recurrence on the ``slstm_sequence`` CUDA kernel."""

from .config import ModelConfig
from .convert import from_numpy_params, to_numpy_params
from .model import (DecodeState, Model, decode_step, embed_tokens, encode,
                    forward, init_decode_state, init_params,
                    logits_from_hidden, precompute_cross_kv)
from .steps import make_serve_step

__all__ = ["DecodeState", "Model", "ModelConfig", "decode_step",
           "embed_tokens", "encode", "forward", "from_numpy_params",
           "init_decode_state", "init_params", "logits_from_hidden",
           "make_serve_step", "precompute_cross_kv", "to_numpy_params"]

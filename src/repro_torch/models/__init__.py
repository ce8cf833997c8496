"""The LM stack ported to PyTorch: every block type of the JAX package's
``repro.models`` (attention with MLP or MoE, RG-LRU, mLSTM, sLSTM) and
encoder-decoder models, for serving — prefill / scoring ``forward`` and
greedy or sampled decode over KV caches and recurrent states — and for
training (the loss, its gradient through ``forward`` and the AdamW step),
with the sLSTM recurrence on the ``slstm_sequence`` CUDA kernel and its
backward."""

from .config import ModelConfig
from .convert import (decay_mask, from_numpy_params, leaf_groups,
                      to_numpy_params, train_state_to_numpy)
from .model import (DecodeState, Model, abstract_decode_state,
                    abstract_params, decode_step, embed_tokens, encode,
                    forward, init_decode_state, init_params,
                    logits_from_hidden, place_decode_state,
                    precompute_cross_kv)
from .steps import (MOE_AUX_WEIGHT, TrainState, abstract_train_state,
                    cross_entropy, init_train_state, make_loss_fn,
                    make_serve_step, make_train_step)

__all__ = ["DecodeState", "MOE_AUX_WEIGHT", "Model", "ModelConfig",
           "TrainState", "abstract_decode_state", "abstract_params",
           "abstract_train_state", "cross_entropy", "decay_mask",
           "decode_step",
           "embed_tokens", "encode", "forward", "from_numpy_params",
           "init_decode_state", "init_params", "init_train_state",
           "leaf_groups", "logits_from_hidden", "make_loss_fn",
           "make_serve_step", "make_train_step", "place_decode_state",
           "precompute_cross_kv",
           "to_numpy_params", "train_state_to_numpy"]

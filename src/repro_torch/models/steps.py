"""Serve step factory: one decode step over the KV caches and recurrent
states (and an encoder-decoder model's cross K/V), then the next token — the serving half of the JAX package's
``repro.models.steps``.  The loss and the train step come with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import ModelConfig
from .model import DecodeState, Model, decode_step


def make_serve_step(cfg: ModelConfig, *, greedy: bool = True,
                    temperature: float = 1.0,
                    generator: Optional[torch.Generator] = None):
    """Greedy (argmax, first index on ties) or sampled from
    softmax(logits / temperature) with ``generator``, which the sampled
    path requires (its draws are not ``jax.random``'s)."""
    if not greedy and generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")

    def serve_step(params: Model, state: DecodeState, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, DecodeState]:
        """tokens (B, 1) current token -> (next_token (B, 1) int32, new
        state)."""
        logits, new_state = decode_step(params, state, tokens, cfg)
        last = logits[:, -1, :]
        if greedy:
            nxt = torch.argmax(last, dim=-1)
        else:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt[:, None].to(torch.int32), new_state

    return serve_step

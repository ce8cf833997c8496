"""The fp64 witness of a train step: the step-1 gradient of the global
batch in fp64 in one process, the value a placed fp32 step and its
baseline are each held to where their sums run in different orders.

``witness_grads`` takes ``init_params``' fp32 weights (the runs' bits)
widened to fp64 and the first ``lm_batches`` batch whole, and computes the
loss in fp64 throughout: while it runs, a float64 tensor's ``.float()``
keeps it float64, so the norms, scores and logits the model computes in
fp32 stay fp64, and the mLSTM's carried state too; the sLSTM layers run
their plain recurrence.  ``distance`` is each tensor's distance from it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..data.synthetic import lm_batches
from ..models import init_params, make_loss_fn
from ..models.config import ModelConfig


def witness_grads(cfg: ModelConfig, batch: int, seq_len: int, *,
                  device="cpu", seed: int = 0) -> Dict[str, torch.Tensor]:
    """{parameter name: its fp64 step-1 gradient} of ``cfg`` from weights
    of ``seed`` on the first ``lm_batches`` batch of ``batch`` x
    ``seq_len`` tokens (``launch.train.train``'s init and data)."""
    from .train import rank_batch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = init_params(cfg, generator=gen, device=device).double()
    cfg64 = cfg.with_overrides(dtype="float64", mlstm_state_dtype="float64")
    data = rank_batch(next(lm_batches(cfg.vocab_size, batch, seq_len,
                                      seed=seed)),
                      slice(0, batch), cfg64, seq_len, device)
    orig = torch.Tensor.float

    def keep64(t, *a, **kw):
        return t if t.dtype == torch.float64 else orig(t, *a, **kw)
    torch.Tensor.float = keep64
    try:
        loss, _ = make_loss_fn(cfg64, force_ref=True)(model, data)
        loss.backward()
    finally:
        torch.Tensor.float = orig
    return {k: p.grad.detach() for k, p in model.named_parameters()}


def distance(grads: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
             ) -> Dict[str, Tuple[float, float]]:
    """Per tensor of ``want``, a gradient's distance from it: (relative L2,
    the largest absolute difference)."""
    out = {}
    for k, w in want.items():
        d = grads[k].to(w.device, torch.float64) - w
        out[k] = (float(d.norm() / w.norm().clamp_min(1e-300)),
                  float(d.abs().max()))
    return out

"""Train and serve step factories: the port of the JAX package's
``repro.models.steps``.

train_step: CE loss (fp32 logsumexp) + the MoE aux loss, its gradient by
autograd through ``forward`` (each pattern unit recomputed in the backward,
the sLSTM layers through ``SLSTMSequence``), then AdamW.  serve_step: one
decode step over the KV caches and recurrent states (and an
encoder-decoder model's cross K/V), then the next token.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..optim import adamw
from ..optim.compression import compress_decompress
from .config import ModelConfig
from .convert import decay_mask, leaf_groups
from .model import DecodeState, Model, decode_step, forward

MOE_AUX_WEIGHT = 0.01


class TrainState(NamedTuple):
    """The model (its parameters are the fp32 master weights, updated in
    place by a step) and AdamW's state, keyed by parameter name."""
    model: Model
    opt: adamw.AdamWState


def masked_ce_sum(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ CE · mask, Σ mask) over logits (B, S, V) fp32: the CE of each
    position is logsumexp - the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over mask; logits fp32 (B, S, V)."""
    total, count = masked_ce_sum(logits, targets, mask)
    return total / torch.clamp_min(count, 1.0)


def _mask(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``segment_ids`` as the CE's weights (ones where the batch has
    none)."""
    seg = batch.get("segment_ids")
    return (torch.ones_like(batch["targets"]) if seg is None else seg).float()


def make_loss_fn(cfg: ModelConfig, *, force_ref: bool = False):
    """loss_fn(model, batch) -> (loss, {"ce", "aux"}): ce + 0.01 · aux.
    ``force_ref`` runs the sLSTM layers' plain recurrence and backward."""
    def loss_fn(model: Model, batch: Dict[str, torch.Tensor]):
        logits, aux = forward(model, batch, cfg, force_ref=force_ref)
        ce = cross_entropy(logits, batch["targets"], _mask(batch))
        return ce + MOE_AUX_WEIGHT * aux, {"ce": ce, "aux": aux}

    return loss_fn


def _data_parallel_loss(model: Model, batch: Dict[str, torch.Tensor],
                        cfg: ModelConfig, group):
    """This rank's slice of a batch split over ``group``: (the loss whose
    gradient, averaged over the ranks, is the global loss's; the global
    loss, ce and aux).  The CE is the global masked mean (the masked sums
    and the mask counts summed over ranks), the aux loss the ranks' mean."""
    world = dist.get_world_size(group)
    logits, aux = forward(model, batch, cfg)
    total, count = masked_ce_sum(logits, batch["targets"], _mask(batch))
    sums = torch.stack([total.detach(), count, aux.detach()])
    dist.all_reduce(sums, group=group)
    denom = torch.clamp_min(sums[1], 1.0)
    local = world * total / denom + MOE_AUX_WEIGHT * aux
    ce, aux_mean = sums[0] / denom, sums[2] / world
    return local, ce + MOE_AUX_WEIGHT * aux_mean, ce, aux_mean


def _average_grads(grads: Dict[str, Optional[torch.Tensor]], group) -> None:
    """Every gradient averaged over ``group``, in place (one all_reduce a
    dtype over the flattened gradients): the replicated model's data
    parallelism (a placed model's backward reduces its own)."""
    world = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads.values():
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        flat /= world
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    compress: bool = False, group=None):
    """train_step(state, batch) -> (state, metrics): the loss's value and
    gradient, then ``adamw.apply_updates`` in place on the model's fp32
    parameters (weight decay by the reference leaf, ``decay_mask``).
    metrics: ``ce``, ``aux``, ``loss``, ``grad_norm``, ``step`` (0-d f32
    tensors).

    ``compress``: the step takes and returns ``(state, ef)``, and the
    gradients go through ``compress_decompress`` (int8, one scale per
    reference leaf, error feedback ``ef``) before the update, as the
    reference's ``--grad-compress`` step.  ``group``: a process group whose
    ranks each hold a slice of the global batch; the loss is the global
    masked mean.  On a placed model (``model.placement``) the backward
    reduce-scatters each gradient to the rank's block (``Placement``), the
    compression's scales and the clipping norm are the whole gradient's
    (a max and a sum over the mesh), and AdamW updates the blocks; on a
    replicated one every gradient is averaged over ``group`` (after the
    compression, each rank's own, as before) before it is clipped."""
    loss_fn = make_loss_fn(cfg)
    masks: list = []     # (decay, leaves): the same for every model of cfg

    def train_step(state, batch):
        state, ef = state if compress else (state, None)
        model = state.model
        if not masks:
            masks.extend((decay_mask(model), leaf_groups(model)))
        decay, leaves = masks
        placement = getattr(model, "placement", None)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if group is None:
            loss, aux_m = loss_fn(model, batch)
            loss.backward()
            ce, aux = aux_m["ce"], aux_m["aux"]
        else:
            local, loss, ce, aux = _data_parallel_loss(model, batch, cfg,
                                                       group)
            local.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        if compress:
            grads, ef = compress_decompress(grads, ef, leaves=leaves,
                                            placement=placement)
        norm = None
        if placement is not None:
            norm = placement.global_norm(grads)
        elif group is not None:
            _average_grads(grads, group)
        _, opt, gnorm = adamw.apply_updates(params, grads, state.opt,
                                            opt_cfg, decay=decay, norm=norm)
        metrics = {"ce": ce.detach(), "aux": aux.detach(),
                   "loss": loss.detach(), "grad_norm": gnorm,
                   "step": opt.step.to(torch.float32)}
        new = TrainState(model=model, opt=opt)
        return ((new, ef) if compress else new), metrics

    return train_step


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                     device="cuda", placement_of=None) -> TrainState:
    """Random weights from ``generator`` (``init_params``) and zero AdamW
    moments, on ``device``.  With ``placement_of`` (model -> its
    ``Placement``) the state is placed: each rank holds its blocks only,
    cut from ``init_params``' values as each piece is drawn
    (``init_params_placed``)."""
    from .model import init_params, init_params_placed
    if placement_of is None:
        model = init_params(cfg, generator=generator, device=device)
    else:
        model = init_params_placed(cfg, generator=generator,
                                   placement_of=placement_of, device=device)
    return TrainState(model=model,
                      opt=adamw.init(dict(model.named_parameters())))


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

"""AdamW + schedules: the port of the JAX package's ``repro.optim.adamw``.

The state holds m and v per parameter, f32, keyed like the parameters (a
dict of name -> tensor), and the step count.  ``apply_updates`` follows the
reference's order of operations: the global norm of the raw gradients;
clipping by it with the 1e-9 guard; step + 1; the schedule at the new step;
bias corrections 1 - b^step in f32; delta = m̂ / (√v̂ + ε), plus wd·p where
the parameter is decayed; p - lr·delta.  ``torch.optim.AdamW`` puts ε
after dividing by √bc2 and would decay by the port's tensor rank, so it is
not this update.

Weight decay: the reference decays a leaf of rank >= 2 of its own tree,
whose scanned units stack each parameter along a leading ``n_units`` axis:
a norm scale or bias inside a unit is (n_units, d) there and is decayed,
while the same vector in a tail block or ``final_norm`` is (d,) and is not.
The port keeps one tensor a layer, so the decision comes in ``decay`` (name
-> bool), from the reference leaf each tensor belongs to
(``models.convert.decay_mask``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"       # "cosine" | "linear" | "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Params
    v: Params


def make_schedule(cfg: AdamWConfig
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step -> learning rate (f32): linear warm-up over ``warmup_steps``,
    then cosine or linear decay to ``min_lr_ratio`` · lr at
    ``total_steps``, or constant."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1.0 + torch.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1.0 - frac)
        else:
            decay = torch.ones_like(step)
        return cfg.lr * warm * decay

    return sched


def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero m and v (f32, each parameter's device) and step 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = next(iter(params.values())).device if params else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()})


# elements whose squares ``square_sum`` adds at a time (a 128 MiB f64 copy)
_SQUARE_CHUNK = 1 << 24


def square_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ t² as a 0-d f64 tensor.  Each f32 square is exact in f64, and the
    sum carries 29 bits more than f32, so the order of its terms (a whole
    tensor, or its blocks summed over a mesh) reaches the f32 norm only
    where the sum lies within those bits of an f32 rounding boundary."""
    total = torch.zeros((), dtype=torch.float64, device=t.device)
    for part in t.detach().reshape(-1).split(_SQUARE_CHUNK):
        total += part.double().square().sum()
    return total


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square (summed in f64,
    ``square_sum``), as f32."""
    return torch.sqrt(torch.stack([square_sum(t)
                                   for t in tree.values()]).sum()).float()


def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, Optional[torch.Tensor]],
                  state: AdamWState, cfg: AdamWConfig, *,
                  decay: Mapping[str, bool],
                  norm: Optional[torch.Tensor] = None
                  ) -> Tuple[Params, AdamWState, torch.Tensor]:
    """One AdamW step, in place: the new values are written into the given
    parameters, m and v (the fp32 master weights and both moments are not
    held twice).  Returns (those parameters, the state with the new step,
    grad norm).  A missing gradient (None) is a zero one.  ``norm``: the
    whole gradient's global norm where ``grads`` are a rank's blocks of it
    (``Placement.global_norm``); by default ``global_norm(grads)``."""
    with torch.no_grad():
        grads = {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
                 for k, p in params.items()}
        sched = make_schedule(cfg)
        gnorm = global_norm(grads) if norm is None else norm
        scale = None
        if cfg.grad_clip_norm is not None:
            scale = torch.clamp_max(cfg.grad_clip_norm / (gnorm + 1e-9), 1.0)
        step = state.step + 1
        lr = sched(step)
        step_f = step.to(torch.float32)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=step.device), step_f)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=step.device), step_f)
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            m2 = b1 * state.m[k] + (1 - b1) * g
            v2 = b2 * state.v[k] + (1 - b2) * g * g
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
            if cfg.weight_decay > 0 and decay[k]:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            state.m[k].copy_(m2)
            state.v[k].copy_(v2)
    return (dict(params), AdamWState(step=step, m=state.m, v=state.v),
            gnorm)

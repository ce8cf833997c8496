"""End-to-end training driver with fault tolerance: the port of the JAX
package's ``repro.launch.train``.

  * the train state placed by the reference's policy on the mesh
    (``ShardingPolicy``, ``Placement``), at world 1 too: each parameter
    (fp32 master), its gradient and its AdamW m and v live as this rank's
    block of the reference leaf's spec, FSDP over ``data`` and the spec's
    ``model`` dims over ``model``; init draws from a seeded
    ``torch.Generator`` on the device, piece by piece, each piece cut to
    the rank's blocks as it is drawn (the world-1 values, bit for bit)
  * each scanned unit gathers its blocks just before it runs (bf16 with
    ``bf16_weight_gather``) and again in its recompute (remat), and the
    backward reduce-scatters its gradients; activations in the config's
    dtype
  * the ``lm_batches`` stream; at world > 1 each rank takes its rows of the
    global batch over the batch axes (``ShardingPolicy.batch_spec``); the
    loss is the global masked mean; the clipping norm and the compression
    scales are the whole gradient's
  * async checkpoints every --checkpoint-every steps through
    ``CheckpointStore``, in the reference's flat keys and stacked layout
    (``params/units/<i>/...``, ``opt/m/...``, ``opt/v/...``, ``opt/step``),
    each leaf gathered whole (every rank takes part, rank 0 writes), so a
    generation written by either package, at any mesh, restores in the
    other at any mesh; on start the newest complete generation is restored,
    each rank reading its blocks
  * --simulate-failure-at N raises at step N; ``main`` then restarts from
    the last checkpoint (the restart path's regression proof)

Usage (CPU example):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --device cpu --steps 8 --ckpt-dir /tmp/ck --checkpoint-every 2

The reference's options, plus ``--device`` (default ``cuda``; without a
card anything but ``--device cpu`` raises).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointStore
from ..configs import arch_ids, get_config, get_smoke_config
from ..data.synthetic import lm_batches
from ..device import resolve_device
from ..distributed.sharding import ShardingPolicy
from ..models.config import ModelConfig
from ..models.convert import (load_flat_state, placement,
                              train_state_to_numpy)
from ..models.steps import TrainState, init_train_state, make_train_step
from ..optim import AdamWConfig
from ..optim.compression import init_error_feedback
from .mesh import make_local_mesh, mesh_axis_sizes


def _flatten_state(state: TrainState, *, keep: bool = True
                   ) -> Optional[Dict[str, np.ndarray]]:
    """The reference's ``_flatten_state``: "/"-joined paths of its
    ``TrainState`` tree -> numpy arrays.  A placed state's leaves are
    gathered one at a time, a collective every rank calls; a rank with
    ``keep=False`` takes part and gets None."""
    tree = train_state_to_numpy(state.model, state.opt, keep=keep)
    if tree is None:
        return None
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(tree, "")
    return flat


def _unflatten_state(template: TrainState, flat: Dict[str, np.ndarray]
                     ) -> TrainState:
    """The template's state holding ``flat``'s arrays, filled in place
    (each rank its blocks of each leaf, on a placed state); a key ``flat``
    lacks keeps the template's value (the reference's rule)."""
    opt = load_flat_state(template.model, template.opt, flat)
    return TrainState(model=template.model, opt=opt)


def _batch_rows(mesh, policy: ShardingPolicy, global_batch: int) -> slice:
    """This rank's rows of the global batch: its coordinate over the batch
    axes, where they divide the batch (else every rank takes all rows)."""
    n = policy.n_batch_shards
    if n == 1 or policy.batch_spec((global_batch,))[0] is None:
        return slice(0, global_batch)
    names = list(mesh.mesh_dim_names)
    sizes = mesh_axis_sizes(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for ax in policy.batch_axes:
        idx = idx * sizes[ax] + coord[names.index(ax)]
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)


def _batch_groups(mesh, policy: ShardingPolicy) -> tuple:
    """The process groups the batch is split over: one a batch axis of
    size above 1, in the mesh's axis order.  A sum over the batch is a sum
    over each in turn, the order in which a placed model's backward sums
    its gradients (``sharding._reduce_grads``)."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(mesh.get_group(a) for a in mesh.mesh_dim_names
                 if a in policy.batch_axes and sizes[a] > 1)


def opt_config(steps: int, lr: float) -> AdamWConfig:
    """``train``'s AdamW settings for a run of ``steps`` steps (the
    reference's)."""
    return AdamWConfig(lr=lr, total_steps=max(steps, 2),
                       warmup_steps=min(100, steps // 10 + 1))


def rank_batch(nb, rows: slice, cfg: ModelConfig, seq_len: int, dev
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of an ``lm_batches`` batch on ``dev`` (an
    encoder-decoder model's frames zero, as the reference's ``train``)."""
    batch = {name: torch.as_tensor(getattr(nb, name)[rows], device=dev)
             for name in ("tokens", "targets", "segment_ids")}
    if cfg.is_enc_dec:
        batch["frames"] = torch.zeros(
            (rows.stop - rows.start, seq_len, cfg.d_model),
            dtype=cfg.activation_dtype, device=dev)
    return batch


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, checkpoint_every: int = 0,
          mesh=None, lr: float = 3e-4, log_every: int = 1,
          simulate_failure_at: int = -1, seed: int = 0,
          grad_compress: bool = False, device="cuda",
          policy: Optional[ShardingPolicy] = None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` x ``seq_len``
    tokens.  ``policy``: the sharding policy on ``mesh`` (default
    ``ShardingPolicy(mesh)``; the dry run's cells pass theirs, e.g.
    ``dp_only`` or ``head_proj_model_only``).  Returns {"metrics":
    [{"step", "loss", "grad_norm"}, ...], "seconds", "final_loss",
    "start_step", "state"}."""
    dev = resolve_device(device)
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_local_mesh(world, 1, device=dev.type)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for a train state on "
                         f"{dev}")
    if policy is None:
        policy = ShardingPolicy(mesh)
    elif policy.mesh is not mesh:
        raise ValueError("the policy is for another mesh")
    rows = _batch_rows(mesh, policy, global_batch)
    split = rows != slice(0, global_batch)
    groups = _batch_groups(mesh, policy) if split else None
    opt_cfg = opt_config(steps, lr)
    step_fn = make_train_step(cfg, opt_cfg, compress=grad_compress,
                              groups=groups)
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    writer = dist.get_rank() == 0

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_train_state(
        cfg, generator=gen, device=dev,
        placement_of=lambda m: placement(m, policy, batch_split=split))
    start_step = 0
    if store:
        # a restart reads the store once every rank is here: rank 0 has
        # then committed what its last run snapshotted
        dist.barrier()
    if store and store.latest() is not None:   # crash recovery
        state = _unflatten_state(state, store.load())
        start_step = int(store.manifest().step)
        print(f"[train] restored generation {store.latest()} "
              f"at step {start_step}")
    carry = (state, init_error_feedback(dict(
        state.model.named_parameters()))) if grad_compress else state

    def current(c):
        return c[0] if grad_compress else c

    data = lm_batches(cfg.vocab_size, global_batch, seq_len, seed=seed)
    metrics_hist = []
    t0 = time.perf_counter()
    try:
        for step in range(start_step, steps):
            batch = rank_batch(next(data), rows, cfg, seq_len, dev)
            carry, metrics = step_fn(carry, batch)
            if simulate_failure_at == step + 1:
                print(f"[train] >>> simulated failure at step "
                      f"{step + 1} <<<")
                raise RuntimeError("simulated node failure")
            if (step + 1) % log_every == 0:
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                metrics_hist.append({"step": step + 1, "loss": loss,
                                     "grad_norm": gnorm})
                print(f"[train] step {step + 1}: loss={loss:.4f} "
                      f"gnorm={gnorm:.3f}")
            if store and checkpoint_every and \
                    (step + 1) % checkpoint_every == 0:
                flat = _flatten_state(current(carry), keep=writer)
                if writer:
                    store.save_async(flat, step=step + 1)
    finally:
        if store:
            # flush in-flight async commits even on a crashed run, so a
            # restart sees every checkpoint that was snapshotted
            store.wait_async()
    if store:
        flat = _flatten_state(current(carry), keep=writer)
        if writer:
            store.save(flat, step=steps)
    dt = time.perf_counter() - t0
    return {"metrics": metrics_hist, "seconds": dt,
            "final_loss": metrics_hist[-1]["loss"] if metrics_hist else None,
            "start_step": start_step, "state": current(carry)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=arch_ids())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    kw = dict(steps=args.steps, global_batch=args.global_batch,
              seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
              checkpoint_every=args.checkpoint_every, lr=args.lr,
              device=args.device)
    try:
        out = train(cfg, simulate_failure_at=args.simulate_failure_at,
                    grad_compress=args.grad_compress, **kw)
        print(f"[train] done in {out['seconds']:.1f}s "
              f"final loss {out['final_loss']}")
    except RuntimeError as e:
        if "simulated" not in str(e):
            raise
        print("[train] restarting after simulated failure ...")
        out = train(cfg, **kw)
        print(f"[train] recovered; final loss {out['final_loss']}")


if __name__ == "__main__":
    main()

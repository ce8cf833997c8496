"""Parameter / activation sharding policy: TP over ``model``, FSDP over
``data``, DP over ``pod`` — the port of the JAX package's
``repro.distributed.sharding``.

The rules are the reference's, carried across as pure shape and path logic
over the reference's leaf paths (``params/units/0/attn/wq``, ``opt/m/...``):
a dim is sharded only if the mesh axis divides it, otherwise it stays
replicated and is recorded in the decision log.  A spec is a tuple with one
entry per dim: None (replicated), an axis name, or a tuple of axis names
(the batch's, where it spans several axes).  ``placements`` maps a spec onto a ``DeviceMesh``'s
``Shard`` / ``Replicate`` per mesh dim.  The policy reads only the mesh's
axis names and sizes (``mesh_dim_names``, ``mesh.shape``).

The train driver uses the batch spec: each rank takes its slice of the
global batch over the batch axes, and the parameters stay replicated;
placing the parameters by ``param_spec`` (FSDP / TP) is not done yet.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from ..launch.mesh import batch_axes, mesh_axis_sizes

Spec = Tuple[Any, ...]

# params whose *first* dim is the contraction output of an up-projection —
# shard it on `model` to match, avoiding an inter-matmul reshard.
_ROW_PARALLEL_SUFFIXES = ("wd", "w_out", "w_down", "wo")
# embedding tables: vocab × d_model — vocab over `model` (masked-gather +
# all-reduce pattern), d over `data` (FSDP).
_EMBED_NAMES = ("embed",)
# block-diagonal per-head projections (see __init__ head_proj_model_only)
_HEAD_PROJ_NAMES = ("w_q", "w_k", "w_v", "r", "gate_a", "gate_i")


def _divides(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested mapping, paths joined by "/" (the
    reference's ``_path_str`` of the same tree)."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def _map(tree, fn, prefix: str = ""):
    return {k: (_map(v, fn, f"{prefix}/{k}" if prefix else str(k))
                if isinstance(v, Mapping)
                else fn(f"{prefix}/{k}" if prefix else str(k), v))
            for k, v in tree.items()}


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def _axes(names: Tuple[str, ...]):
    """A spec entry over several mesh axes: their tuple, or the one name
    (as ``PartitionSpec`` writes a tuple of one)."""
    return names[0] if len(names) == 1 else tuple(names)


class ShardingPolicy:
    """Assigns specs to a train / serve state tree for a mesh."""

    def __init__(self, mesh, *, shard_cache_seq: bool = False,
                 head_proj_model_only: bool = False, dp_only: bool = False):
        self.mesh = mesh
        sizes = mesh_axis_sizes(mesh)
        # dp_only: fold the model axis into data parallelism (small-state
        # coupled archs: xlstm's 4-head blocked mLSTM resists 16-way TP);
        # model_size = 0 => the model axis is never assigned to a param dim
        self.dp_only = dp_only
        self.model_size = 0 if dp_only else sizes.get("model", 1)
        self.data_size = sizes.get("data", 1)
        self.batch_axes = batch_axes(mesh) + ("model",) if dp_only \
            else batch_axes(mesh)
        # the KV cache's seq dim over `model` (flash-decode layout)
        self.shard_cache_seq = shard_cache_seq
        # block-diagonal per-head projections: column-parallel only
        self.head_proj_model_only = head_proj_model_only
        self.decisions: List[Tuple[str, Tuple[int, ...], Spec]] = []

    # ------------------------------------------------------------- params
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        name = path.rsplit("/", 1)[-1]
        nd = len(shape)
        spec: List[Optional[Any]] = [None] * nd

        if self.head_proj_model_only and name in _HEAD_PROJ_NAMES:
            if _divides(shape[nd - 1], self.model_size):
                spec[nd - 1] = "model"
            return tuple(spec)

        if nd >= 2:
            if name in _EMBED_NAMES:
                if _divides(shape[0], self.model_size):
                    spec[0] = "model"
                if _divides(shape[1], self.data_size):
                    spec[1] = "data"
            elif name.rstrip("0123456789_") in _ROW_PARALLEL_SUFFIXES \
                    or name in _ROW_PARALLEL_SUFFIXES:
                # row-parallel: contraction dim over model, output over data
                cdim = nd - 2
                if _divides(shape[cdim], self.model_size):
                    spec[cdim] = "model"
                if _divides(shape[nd - 1], self.data_size):
                    spec[nd - 1] = "data"
            else:
                # column-parallel default: last dim over model, biggest
                # other dim over data (FSDP)
                if _divides(shape[nd - 1], self.model_size):
                    spec[nd - 1] = "model"
                rest = [(shape[i], i) for i in range(nd - 1)]
                rest.sort(reverse=True)
                for sz, i in rest:
                    if _divides(sz, self.data_size) and sz >= 64:
                        spec[i] = "data"
                        break
        # the stacked-unit leading dim stays unsharded
        return tuple(spec)

    def spec_tree(self, tree):
        """The spec of every leaf of a nested mapping (arrays, tensors or
        shapes), logged in ``decisions``."""
        def rule(path, leaf):
            shape = _shape(leaf)
            spec = self.param_spec(path, shape)
            self.decisions.append((path, shape, spec))
            return spec

        return _map(tree, rule)

    def sharding_tree(self, tree):
        """Each leaf's placements on the policy's mesh."""
        return _map(self.spec_tree(tree),
                    lambda _, spec: placements(spec, self.mesh))

    # -------------------------------------------------------------- batch
    @property
    def n_batch_shards(self) -> int:
        sizes = mesh_axis_sizes(self.mesh)
        n = 1
        for ax in self.batch_axes:
            n *= sizes.get(ax, 1)
        return n

    def batch_spec(self, shape: Tuple[int, ...]) -> Spec:
        """Dim 0 (the global batch) over the batch axes iff they divide it
        (a global batch of 1 stays replicated)."""
        ndim = len(shape)
        if ndim == 0 or not _divides(shape[0], self.n_batch_shards):
            return (None,) * ndim
        return (_axes(self.batch_axes),) + (None,) * (ndim - 1)

    def batch_spec_tree(self, tree):
        return _map(tree, lambda _, leaf: self.batch_spec(_shape(leaf)))

    def batch_sharding_tree(self, tree):
        return _map(self.batch_spec_tree(tree),
                    lambda _, spec: placements(spec, self.mesh))

    # -------------------------------------------------- decode/serve state
    def serve_state_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Decode state: batch dim over the batch axes; stacked-unit leaves
        have the batch at dim 1 (dim 0 is the scanned unit axis)."""
        nd = len(shape)
        if nd == 0:
            return ()
        stacked = ("block_states" in path or "cross_kv" in path) \
            and "tail" not in path and nd >= 2
        batch_dim = 1 if stacked else 0
        spec: List[Optional[Any]] = [None] * nd
        if _divides(shape[batch_dim], self.n_batch_shards):
            spec[batch_dim] = _axes(self.batch_axes)
        # KV caches (units, B, S, nkv, dh): optionally shard S over `model`
        leaf = path.rsplit("/", 1)[-1]
        if (self.shard_cache_seq and leaf in ("k", "v") and nd == 5
                and _divides(shape[2], self.model_size)):
            spec[2] = "model"
        return tuple(spec)

    # ------------------------------------------------------------- report
    def replicated_report(self) -> List[str]:
        """Large params left fully replicated (divisibility misses)."""
        out = []
        for path, shape, spec in self.decisions:
            n = 1
            for s in shape:
                n *= s
            if n >= 1 << 20 and all(a is None for a in spec):
                out.append(f"{path} {shape} replicated")
        return out


def placements(spec: Spec, mesh) -> list:
    """A spec as DTensor placements, one per mesh dim: ``Shard(i)`` where
    tensor dim i names that mesh axis (alone or in a tuple), else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def make_train_shardings(policy: ShardingPolicy, state_tree, batch_tree):
    """(the state's placements, the batch's placements) trees."""
    return policy.sharding_tree(state_tree), \
        policy.batch_sharding_tree(batch_tree)

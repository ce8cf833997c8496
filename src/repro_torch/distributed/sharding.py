"""Parameter / activation sharding policy: TP over ``model``, FSDP over
``data``, DP over ``pod`` — the port of the JAX package's
``repro.distributed.sharding``.

The rules are the reference's, carried across as pure shape and path logic
over the reference's leaf paths (``params/units/0/attn/wq``, ``opt/m/...``):
a dim is sharded only if the mesh axis divides it, otherwise it stays
replicated and is recorded in the decision log.  A spec is a tuple with one
entry per dim: None (replicated), an axis name, or a tuple of axis names
(the batch's, where it spans several axes).  ``placements`` maps a spec
onto a ``DeviceMesh``'s ``Shard`` / ``Replicate`` per mesh dim.  The policy
reads only the mesh's axis names and sizes (``mesh_dim_names``,
``mesh.shape``).

``launch.train.train`` places its state by the policy (``Placement``):
each port tensor takes the spec of the reference leaf it belongs to (the stacked
``params/units/<i>/...`` leaf, the unit dim dropped), every rank holds only
its shard of each parameter and of its AdamW moments, and each rank takes
its slice of the global batch over the batch axes.  A unit's shards are
all-gathered just before the unit runs (after the ``bf16_weight_gather``
cast, so the gather moves bf16) and freed after it; the backward
reduce-scatters each gradient over the batch axes that split the batch,
the FSDP of the reference's GSPMD program.  A weight sharded over
``model`` is gathered whole as well: every rank of a ``model`` group runs
its unit on the whole weight, and keeps its own slice of the gradient.

Serving runs on the same placement: ``models.model.decode_step`` gathers
each unit as a train step does, and ``models.model.place_decode_state``
cuts the decode state by ``serve_state_spec`` (rows over the batch axes;
with ``shard_cache_seq`` each KV cache's slots over ``model``, whose
attention ``SeqShard`` merges).  With ``sequence_parallel`` a train
step's residual stream holds each ``model`` rank's slice of the sequence
(``SeqParallel``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ..launch.mesh import batch_axes, mesh_axis_sizes
from ..optim.adamw import square_sum

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
    def serve_spec_tree(self, tree):
        """The serve spec of every leaf of a decode state tree in the
        reference's layout (``models.model.decode_state_shapes``)."""
        return _map(tree, lambda path, leaf: self.serve_state_spec(
            path, _shape(leaf)))

    def serve_sharding_tree(self, tree):
        """Each decode-state leaf's placements on the policy's mesh."""
        return _map(self.serve_spec_tree(tree),
                    lambda _, spec: placements(spec, self.mesh))

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
    """(the state's placements, the batch's placements) for a train state
    tree in the reference's layout (``models.convert.train_state_shapes``)
    and a batch tree of shapes."""
    return (policy.sharding_tree(state_tree),
            policy.batch_sharding_tree(batch_tree))


# ---------------------------------------------------------------------------
# the placed train state
# ---------------------------------------------------------------------------

class Placement:
    """Where each tensor of a placed train state lives on the mesh, and
    the collectives that move it (``models.convert.placement`` makes one
    for a model).

    ``specs`` / ``placements``: each parameter's (and so its AdamW
    moments') spec and ``Shard`` / ``Replicate`` per mesh dim; ``shapes``
    the whole tensor's shape.  A rank holds the block of every tensor at
    its mesh coordinate (``shard``).  ``grad_axes`` are the axes whose
    ranks hold different rows of the batch (the batch axes of size > 1
    where the batch is split): a gradient is summed over them and divided
    by their size; over every other axis each rank has computed the same
    gradient and keeps its own slice."""

    def __init__(self, policy: ShardingPolicy, specs: Mapping[str, Spec],
                 shapes: Mapping[str, Tuple[int, ...]], *,
                 batch_split: bool = True):
        self.policy = policy
        self.mesh = mesh = policy.mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = mesh_axis_sizes(mesh)
        self.specs = dict(specs)
        self.placements = {k: placements(s, mesh)
                           for k, s in self.specs.items()}
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        for k, spec in self.specs.items():
            for dim, ax in enumerate(spec):
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    if a is not None and self.shapes[k][dim] % self.sizes[a]:
                        raise ValueError(f"{k}: dim {dim} of "
                                         f"{self.shapes[k]} does not split "
                                         f"over {a} ({self.sizes[a]})")
        self.grad_axes = tuple(
            a for a in policy.batch_axes
            if batch_split and self.sizes.get(a, 1) > 1)
        self.grad_divisor = math.prod(self.sizes[a] for a in self.grad_axes)
        self.trivial = all(n == 1 for n in self.sizes.values())
        self._by_id: Dict[int, str] = {}
        # the collectives the unit gathers and their backward issued, and
        # the bytes each rank put into them (read as deltas by a caller)
        self.counts = {"all_gather": 0, "reduce_scatter": 0,
                       "all_reduce": 0, "gather_bytes": 0,
                       "reduce_bytes": 0}

    # ------------------------------------------------------------ layout
    def _coord(self) -> Dict[str, int]:
        coord = self.mesh.get_coordinate()
        return dict(zip(self.names, coord)) if coord is not None \
            else {a: 0 for a in self.names}

    def shard_dims(self, name: str) -> Dict[str, int]:
        """{mesh axis: the tensor dim sharded over it}."""
        return {a: pl.dim for a, pl in zip(self.names, self.placements[name])
                if isinstance(pl, Shard) and self.sizes[a] > 1}

    def local_shape(self, name: str) -> Tuple[int, ...]:
        shape = list(self.shapes[name])
        for a, dim in self.shard_dims(name).items():
            shape[dim] //= self.sizes[a]
        return tuple(shape)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full`` (a view)."""
        coord = self._coord()
        for a, dim in self.shard_dims(name).items():
            n = full.shape[dim] // self.sizes[a]
            full = full.narrow(dim, coord[a] * n, n)
        return full

    def counts_once(self, name: str) -> bool:
        """Whether this rank's block is the one copy counted in a sum over
        the mesh: its coordinate is 0 on every axis the tensor is
        replicated over."""
        coord = self._coord()
        sharded = self.shard_dims(name)
        return all(coord[a] == 0 for a in self.names if a not in sharded)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def bind(self, model) -> None:
        """Attach to ``model`` (``model.placement``) and learn its
        parameters, which must hold this rank's blocks."""
        for k, p in model.named_parameters():
            if tuple(p.shape) != self.local_shape(k):
                raise ValueError(f"{k}: {tuple(p.shape)} is not the block "
                                 f"{self.local_shape(k)} of "
                                 f"{self.shapes[k]}")
        self._by_id = {id(p): k for k, p in model.named_parameters()}
        model.placement = self

    def name_of(self, p: torch.Tensor) -> str:
        return self._by_id[id(p)]

    # ------------------------------------------------------- collectives
    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (a collective: every
        rank calls it); no graph."""
        with torch.no_grad():
            return _gather([local.detach()], [self.shard_dims(name)],
                           self)[0]

    def gather(self, params: Sequence[torch.Tensor],
               cast: Sequence[Optional[torch.dtype]],
               local: Sequence[bool] = (), partial: Sequence[bool] = ()
               ) -> List[torch.Tensor]:
        """The tensors a unit computes with, from this rank's blocks
        ``params`` (each cast to its ``cast`` dtype first, where not None):
        gathered whole, one all-gather a mesh axis and dtype, but over
        ``model`` where ``local`` (a tensor-parallel product's slice).
        Differentiable: the backward sums each gradient (in fp32) over
        ``grad_axes``, and over ``model`` where ``partial`` (a whole tensor
        each model rank used on its own heads), a reduce-scatter where the
        tensor is sharded over the axis and an all-reduce where not; over
        any other axis it keeps the rank's slice.  The gradient returns in
        its block's dtype."""
        names = tuple(self.name_of(p) for p in params)
        n = len(params)
        modes = tuple(zip(tuple(local) or (False,) * n,
                          tuple(partial) or (False,) * n))
        return list(_GatherUnit.apply(self, names, tuple(cast), modes,
                                      *params))

    def model_parallel(self, cfg_local, seq=None) -> "ModelParallel":
        return ModelParallel(self, cfg_local, seq)

    def seq_parallel(self) -> "SeqParallel":
        """The sequence parallelism of a train step over ``model``."""
        return SeqParallel(self)

    def seq_shard(self) -> "SeqShard":
        """A decode attention over a KV cache split over ``model``."""
        return SeqShard(self)

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of every element's square over the whole
        gradient: each block's squares counted once over the mesh."""
        dev = next(iter(grads.values())).device
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for k, g in grads.items():
            if self.counts_once(k):
                total += square_sum(g)
        if not self.trivial:
            dist.all_reduce(total)
        return torch.sqrt(total).float()

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise max of ``x`` over every rank (in place)."""
        if not self.trivial:
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x


def _buckets(tensors, want):
    """{dtype: [index]} of the tensors ``want(i)`` selects."""
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        if want(i):
            out.setdefault(t.dtype, []).append(i)
    return out


def _gather(tensors: List[torch.Tensor], dims: List[Dict[str, int]],
            pl: Placement) -> List[torch.Tensor]:
    """Each block gathered whole over the axes it is sharded on, one
    ``all_gather_into_tensor`` an axis and dtype (rank order along the
    axis is block order along the dim)."""
    out = list(tensors)
    for a in pl.names:
        n = pl.sizes[a]
        for dtype, idx in _buckets(out, lambda i: a in dims[i]).items():
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            buf = torch.empty(n * flat.numel(), dtype=dtype,
                              device=flat.device)
            dist.all_gather_into_tensor(buf, flat, group=pl.group(a))
            pl.counts["all_gather"] += 1
            pl.counts["gather_bytes"] += flat.numel() * flat.element_size()
            buf = buf.view(n, flat.numel())
            off = 0
            for i in idx:
                t, d = out[i], dims[i][a]
                part = buf[:, off:off + t.numel()].reshape(n, *t.shape)
                shape = list(t.shape)
                shape[d] *= n
                out[i] = part.movedim(0, d).reshape(shape)
                off += t.numel()
    return out


def _reduce_grads(grads: List[torch.Tensor], dims: List[Dict[str, int]],
                  sums: List[Tuple[str, ...]], pl: Placement
                  ) -> List[torch.Tensor]:
    """The backward of ``_gather`` for whole-tensor gradients: over an axis
    in the tensor's ``sums``, a sum (a reduce-scatter along the sharded
    dim, an all-reduce where the tensor is replicated over the axis); over
    any other axis it is sharded on, the rank's own slice.  Then divided
    by ``grad_divisor`` (the batch axes' sums are means)."""
    coord = pl._coord()
    out = list(grads)
    for a in pl.names:                  # the slices first: less to send
        for i, d in enumerate(dims):
            if a in d and a not in sums[i]:
                n = out[i].shape[d[a]] // pl.sizes[a]
                out[i] = out[i].narrow(d[a], coord[a] * n, n)
    for a in pl.names:
        if pl.sizes[a] == 1:
            continue
        n, group = pl.sizes[a], pl.group(a)
        for dtype, idx in _buckets(
                out, lambda i: a in sums[i] and a in dims[i]).items():
            parts = []
            for i in idx:
                g, d = out[i], dims[i][a]
                shape = list(g.shape)
                shape[d:d + 1] = [n, shape[d] // n]
                parts.append(g.reshape(shape).movedim(d, 0).reshape(n, -1))
            flat = torch.cat(parts, dim=1).contiguous()
            res = torch.empty(flat.shape[1], dtype=dtype, device=flat.device)
            dist.reduce_scatter_tensor(res, flat.reshape(-1), group=group)
            pl.counts["reduce_scatter"] += 1
            pl.counts["reduce_bytes"] += flat.numel() * flat.element_size()
            off = 0
            for i, part in zip(idx, parts):
                k = part.shape[1]
                shape = list(out[i].shape)
                shape[dims[i][a]] //= n
                out[i] = res[off:off + k].view(shape)
                off += k
        for dtype, idx in _buckets(
                out, lambda i: a in sums[i] and a not in dims[i]).items():
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=group)
            pl.counts["all_reduce"] += 1
            pl.counts["reduce_bytes"] += flat.numel() * flat.element_size()
            off = 0
            for i in idx:
                out[i] = flat[off:off + out[i].numel()].view(out[i].shape)
                off += out[i].numel()
    if pl.grad_divisor > 1:
        out = [g / pl.grad_divisor for g in out]
    return out


class _GatherUnit(torch.autograd.Function):
    """Blocks -> the (cast) tensors a unit computes with; gradients back to
    the blocks."""

    @staticmethod
    def forward(ctx, pl: Placement, names, cast, modes, *blocks):
        dims, sums = [], []
        for k, (local, partial) in zip(names, modes):
            d = pl.shard_dims(k)
            if local:
                d.pop("model", None)
            dims.append(d)
            sums.append(pl.grad_axes + (("model",) if partial else ()))
        ctx.pl, ctx.dims, ctx.sums = pl, dims, sums
        ctx.dtypes = [b.dtype for b in blocks]
        cast_blocks = [b if dt is None else b.to(dt)
                       for b, dt in zip(blocks, cast)]
        return tuple(_gather(cast_blocks, dims, pl))

    @staticmethod
    def backward(ctx, *grads):
        # autograd gives an unused output a zero gradient, so every rank
        # takes part in each collective whichever outputs its graph reached
        red = _reduce_grads([g.float() for g in grads], ctx.dims, ctx.sums,
                            ctx.pl)
        return (None, None, None, None) + tuple(
            g.to(dt) for g, dt in zip(red, ctx.dtypes))


class ModelParallel:
    """The tensor parallelism of one block over ``model`` (Megatron's
    column- then row-parallel pair): ``copy`` marks a whole activation
    entering column-parallel products (identity forward; its gradient, a
    partial sum on each rank, all-reduced), ``reduce`` sums a
    row-parallel product's partial outputs over the ranks (in fp32; the
    backward passes the whole gradient on).  Under sequence parallelism
    (``seq``) the pair is Megatron-SP's: ``copy`` all-gathers the
    sequence (its backward reduce-scatters) and ``reduce`` reduce-scatters
    it (its backward all-gathers).  ``cfg`` is the block's config on this
    rank's heads; ``attn`` / ``cross`` / ``mlp`` say which sub-blocks run
    on their slices."""

    def __init__(self, pl: Placement, cfg_local, seq=None):
        self.pl, self.cfg, self.seq = pl, cfg_local, seq
        self.attn = self.cross = self.mlp = False

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq is not None:
            return self.seq.gather(x)
        return _CopyToModel.apply(x, self.pl)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.seq is not None:
            return self.seq.scatter(x)
        return _ReduceFromModel.apply(x, self.pl)


def _model_all_reduce(x: torch.Tensor, pl: Placement) -> torch.Tensor:
    y = x.float().contiguous().clone()
    dist.all_reduce(y, group=pl.group("model"))
    pl.counts["all_reduce"] += 1
    pl.counts["reduce_bytes"] += y.numel() * y.element_size()
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g, ctx.pl), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        return _model_all_reduce(x, pl)

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# sequence parallelism (train) and the sequence-split KV cache (decode)
# ---------------------------------------------------------------------------

class SeqParallel:
    """Megatron-SP over ``model`` for a train step: between blocks each
    ``model`` rank holds its slice of the sequence (dim 1), block ``index``
    of ``n``.  ``gather`` all-gathers the slices (the backward
    reduce-scatters the gradient, summing the ranks' partial ones);
    ``scatter`` reduce-scatters partial sums to this rank's slice, in fp32
    (the backward all-gathers); ``keep`` is this rank's slice of a tensor
    every rank holds whole (a plain narrow)."""

    def __init__(self, pl: Placement):
        self.pl = pl
        self.n = pl.sizes["model"]
        self.index = pl._coord()["model"]

    def bounds(self, s: int) -> Tuple[int, int]:
        """(start, length) of this rank's slice of a sequence of ``s``."""
        if s % self.n:
            raise ValueError(f"sequence_parallel: S = {s} does not split "
                             f"over {self.n} model ranks")
        per = s // self.n
        return self.index * per, per

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        return x.narrow(1, *self.bounds(x.shape[1]))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _SeqGather.apply(x, self.pl)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _SeqScatter.apply(x, self.pl)


def _seq_all_gather(x: torch.Tensor, pl: Placement) -> torch.Tensor:
    """(B, s, ...) slices -> (B, n·s, ...) in rank order."""
    n = pl.sizes["model"]
    flat = x.contiguous().reshape(-1)
    buf = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(buf, flat, group=pl.group("model"))
    pl.counts["all_gather"] += 1
    pl.counts["gather_bytes"] += flat.numel() * flat.element_size()
    out = buf.view(n, *x.shape).movedim(0, 1)
    return out.reshape(x.shape[0], n * x.shape[1], *x.shape[2:])


def _seq_reduce_scatter(x: torch.Tensor, pl: Placement) -> torch.Tensor:
    """(B, S, ...) partial sums -> this rank's (B, S / n, ...) of their sum
    over ``model``, summed in fp32."""
    n = pl.sizes["model"]
    b, s = x.shape[:2]
    parts = x.float().reshape(b, n, s // n, *x.shape[2:]).movedim(1, 0)
    flat = parts.contiguous().reshape(-1)
    out = torch.empty(flat.numel() // n, dtype=flat.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, flat, group=pl.group("model"))
    pl.counts["reduce_scatter"] += 1
    pl.counts["reduce_bytes"] += flat.numel() * flat.element_size()
    return out.view(b, s // n, *x.shape[2:]).to(x.dtype)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return _seq_all_gather(x, pl)

    @staticmethod
    def backward(ctx, g):
        return _seq_reduce_scatter(g, ctx.pl), None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return _seq_reduce_scatter(x, pl)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.pl), None


class SeqShard:
    """Decode attention over a KV cache whose slots are split over
    ``model`` (``shard_cache_seq``): this rank holds block ``index`` of
    ``n``.  ``softmax_pv`` merges the ranks' partial softmax: the scores'
    max over every rank (an all-reduce), then the sums of exp and the
    weighted sums of V under that max (one all-reduce, fp32)."""

    def __init__(self, pl: Placement):
        self.pl = pl
        self.n = pl.sizes["model"]
        self.index = pl._coord()["model"]

    def softmax_pv(self, sc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """sc (B, nkv, g, 1, T_local) fp32 scores, v (B, T_local, nkv, dh)
        -> (B, 1, nkv, g, dh) in v's dtype: softmax(sc) · v over every
        rank's slots."""
        group = self.pl.group("model")
        m = sc.amax(-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        pexp = torch.exp(sc - m)
        l = pexp.sum(-1)                                 # (B, nkv, g, 1)
        acc = torch.einsum("bngst,btnh->bsngh", pexp.to(v.dtype), v).float()
        flat = torch.cat([l.reshape(-1), acc.reshape(-1)])
        dist.all_reduce(flat, group=group)
        self.pl.counts["all_reduce"] += 2
        self.pl.counts["reduce_bytes"] += (m.numel() + flat.numel()) * 4
        l = flat[:l.numel()].view(l.shape)
        acc = flat[l.numel():].view(acc.shape)
        return (acc / l.permute(0, 3, 1, 2)[..., None]).to(v.dtype)

"""Distributed Quantixar search on ``torch.distributed``: the paper's engine
on a mesh.

The counterpart of the JAX package's ``repro.distributed.search``.  Corpus
rows are sharded over the batch axes (``pod``, ``data``); in "dims" mode
the feature dims (flat), PQ sub-spaces or BQ words are also split over
``model``:

    local partial distances  (B5's matrix entry / B6 pq_adc / B7 hamming
                              over the rank's slice)
      -> all_reduce over ``model``   ("dims" mode, one row chunk at a time)
      -> local top-k                 (k per row shard, global ids)
      -> all_gather over the row shards (k candidates each)
      -> exact merge                 (ties to the lowest global id)

In "rows" mode the rows are sharded over every mesh axis and the feature
axis is whole, so no reduce runs and the local scan is the port's own: the
flat scan is ``core.flat.flat_search`` (on the card at k <= 100, one
launch of B5's fused ``l2_topk``), PQ and BQ are ``scan_topk`` over the
``pq_adc`` and ``hamming`` kernels.

Every rank calls the search with its own block (`local_block` cuts it from
the global arrays as the reference's ``PartitionSpec``s do) and gets the
global ``(dists (Q, k), ids (Q, k) int32)``.  The per-rank work
(`local_partial`, `local_topk`, `merge_shard_topk`) is apart from the
collectives, so that one process can play every rank (`emulate_search`).

Where the result can differ from the reference, and why it does not:

* the "cosine" scan is ``-q.x`` on rows the caller normalised, as the
  reference's (not ``flat_search``'s ``1 - cos``): the local scan runs in
  "dot" mode;
* l2 is clamped at 0 after the reduce, not per rank: a "dims" partial is
  the norms plus twice the dot entry, unclamped;
* a shard's ids are ``idx + shard * n_local`` with the shard index
  row-major over the row axes, and the candidates are concatenated in that
  order, so `topk_smallest` breaks ties to the lowest global id as
  ``lax.top_k`` does over the reference's tiled ``all_gather``;
* a shard smaller than k sends all of its rows;
* the feature axis is split only where ``model`` divides it (``dim=0``:
  assume it does); otherwise it is whole and no reduce runs;
* "dims" never holds a rank's whole (Q, N_local) partial matrix: it is
  reduced and merged one row chunk at a time, which gives the same top-k,
  ties included (`scan_topk`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.distances import l2_norm_sq
from ..core.flat import flat_search, scan_topk
from ..kernels import ops
from ..kernels.ref import topk_smallest
from ..launch.mesh import mesh_axis_sizes

#: rows of a rank's block a chunk of the scan (PQ, BQ and "dims"): the
#: engine's flat-route chunk, a (1,024, 65,536) fp32 block of 256 MB.
#: Read when a scan runs.
CHUNK = 65536

# a chunk's reduce across the model shards: (partial, lo, hi) -> the sum
Reduce = Callable[[torch.Tensor, int, int], torch.Tensor]


@dataclass(frozen=True)
class Layout:
    """How a mesh cuts a search's arrays: the mesh's axis sizes in its
    order, the axes the corpus rows are sharded over (the shard index is
    row-major over them, in this order), and whether the feature axis is
    split over ``model``."""

    sizes: Tuple[Tuple[str, int], ...]
    rows: Tuple[str, ...]
    split: bool

    @property
    def shards(self) -> int:
        size = dict(self.sizes)
        return math.prod(size[a] for a in self.rows)

    @property
    def models(self) -> int:
        return dict(self.sizes)["model"] if self.split else 1

    def shard(self, coord: Dict[str, int]) -> int:
        """The row shard of the rank at ``coord`` ({axis: index})."""
        size, s = dict(self.sizes), 0
        for a in self.rows:
            s = s * size[a] + coord[a]
        return s

    def block(self, x, coord: Dict[str, int], *, rows: bool = True):
        """The rank at ``coord``'s block of the global array ``x`` (numpy or
        torch): its row shard where ``rows`` (the corpus; queries and LUTs
        are whole), and in "dims" mode its slice of axis 1 (the feature,
        sub-space or word axis).  Raises where a split is unequal, as the
        reference's sharding does.  The block is contiguous."""
        idx = [slice(None)] * x.ndim
        if rows:
            n, s = x.shape[0], self.shards
            if n % s:
                raise ValueError(f"{n} rows do not split evenly over {s} "
                                 f"row shards")
            i, per = self.shard(coord), n // s
            idx[0] = slice(i * per, (i + 1) * per)
        if self.split:
            f, m = x.shape[1], self.models
            if f % m:
                raise ValueError(f"axis 1 of width {f} does not split "
                                 f"evenly over {m} model shards")
            j, per = coord["model"], f // m
            idx[1] = slice(j * per, (j + 1) * per)
        out = x[tuple(idx)]
        if isinstance(out, torch.Tensor):
            return out.contiguous()
        return np.ascontiguousarray(out)


def layout(sizes: Dict[str, int], mode: str = "rows",
           dim: int = 0) -> Layout:
    """The layout of a search over a mesh of these axis sizes: in "rows"
    mode the rows go over every axis and the feature axis is whole; in
    "dims" mode the rows go over the batch axes and a feature axis of
    width ``dim`` is split over ``model`` where that divides it (``dim``
    0: assume it does)."""
    if mode not in ("rows", "dims"):
        raise ValueError(f"mode must be 'rows' or 'dims', not {mode!r}")
    rows = ("pod", "data") if "pod" in sizes else ("data",)
    model = sizes.get("model", 1)
    split = (mode == "dims" and model > 1
             and (dim == 0 or dim % model == 0))
    if mode == "rows" and "model" in sizes:
        rows += ("model",)
    return Layout(tuple(sizes.items()), rows, split)


def _coord(mesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def local_block(x, mesh, mode: str = "rows", *, rows: bool = True,
                dim: int = 0):
    """The calling rank's block of the global array ``x`` for a search
    made on ``mesh`` in ``mode`` with this ``dim`` (``m_subspaces``,
    ``words``): the corpus or codes with ``rows=True``, the queries, query
    words or LUTs with ``rows=False``; "dims" mode slices axis 1 (the
    features, words or sub-spaces).  At world 1 the block is the whole
    array."""
    lay = layout(mesh_axis_sizes(mesh), mode, dim)
    return lay.block(x, _coord(mesh), rows=rows)


def local_partial(kind: str, metric: str, block: torch.Tensor,
                  queries: torch.Tensor, lo: int = 0,
                  hi: Optional[int] = None,
                  q_sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A rank's partial distances to rows [lo, hi) of its block, before any
    reduce: flat l2 is ``|q|^2 + |x|^2 + 2 * (-q.x)`` over the rank's dims
    (unclamped; B5's matrix entry in dot mode; ``q_sq`` is ``|q|^2`` where
    the caller has it), flat dot ``-q.x``, PQ the LUT sums over the rank's
    sub-spaces (B6), BQ the int32 bit counts over its words (B7).
    ``queries`` is the LUT for PQ and the query words for BQ."""
    x = block[lo:hi]
    if kind == "flat":
        dot = ops.dot_distances(queries, x)
        if metric == "l2":
            if q_sq is None:
                q_sq = l2_norm_sq(queries)
            return q_sq[:, None] + l2_norm_sq(x)[None, :] + 2.0 * dot
        return dot
    if kind == "pq":
        return ops.pq_adc_distances(queries, x)
    return ops.hamming_distances(queries, x)


def _finish(kind: str, metric: str, part: torch.Tensor) -> torch.Tensor:
    """Reduced partials -> distances: l2 clamped at 0, bit counts as
    float32."""
    if kind == "flat" and metric == "l2":
        return torch.clamp_min(part, 0.0)
    return part.float()


def local_topk(kind: str, metric: str, block: torch.Tensor,
               queries: torch.Tensor, k: int, shard: int, *,
               reduce: Optional[Reduce] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row shard's k candidates (all of its rows where it has fewer):
    (distances (Q, kk) ascending, global ids (Q, kk) int32), ties to the
    lowest row.  ``reduce`` ("dims" mode) turns each chunk's partial into
    the sum over the model shards; without it the block's feature axis is
    whole, and the flat scan is `flat_search`'s own dispatch.  The scan
    takes `CHUNK` rows at a time."""
    n_local = block.shape[0]
    kk = min(k, n_local)
    if kind == "flat" and reduce is None:
        d, idx = flat_search(queries, block, kk, metric=metric, chunk=CHUNK)
    else:
        # the queries' norms once a search, not once a chunk
        q_sq = (l2_norm_sq(queries) if kind == "flat" and metric == "l2"
                else None)

        def dist_fn(lo: int, hi: int) -> torch.Tensor:
            part = local_partial(kind, metric, block, queries, lo, hi, q_sq)
            if reduce is not None:
                part = reduce(part, lo, hi)
            return _finish(kind, metric, part)

        d, idx = scan_topk(dist_fn, n_local, kk, chunk=CHUNK)
    return d, (idx.to(torch.int64) + shard * n_local).to(torch.int32)


def merge_shard_topk(cand_d: torch.Tensor, cand_i: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' candidates, concatenated in shard order ((Q, S * kk)
    each) -> the global (Q, k) top-k, ties to the lowest position, which is
    the lowest global id."""
    d, sel = topk_smallest(cand_d, k)
    return d, cand_i.gather(1, sel)


def _row_group(mesh, lay: Layout):
    """The process group of the ranks that share this rank's coordinates
    off the row axes, and the group ranks of its members in shard order.
    Several row axes are flattened into one mesh dim (row-major, the shard
    order), which the mesh makes once and keeps."""
    rows = (mesh[lay.rows] if len(lay.rows) < mesh.ndim else mesh)._flatten()
    group = rows.get_group()
    members = dist.get_process_group_ranks(group)
    return group, [members.index(r) for r in rows.mesh.tolist()]


def _search(mesh, kind: str, metric: str, k: int, mode: str, dim: int):
    lay = layout(mesh_axis_sizes(mesh), mode, dim)
    coord = _coord(mesh)
    shard = lay.shard(coord)
    rows_group, order = _row_group(mesh, lay)
    reduce = None
    if lay.split:
        model_group = mesh.get_group("model")

        def reduce(part: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
            dist.all_reduce(part, group=model_group)
            return part

    def gather(t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in order]
        dist.all_gather(parts, t.contiguous(), group=rows_group)
        return torch.cat([parts[i] for i in order], dim=1)

    def search(block: torch.Tensor, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if block.shape[1] != queries.shape[1]:
            raise ValueError(f"the block's feature axis ({block.shape[1]}) "
                             f"and the queries' ({queries.shape[1]}) differ")
        d, ids = local_topk(kind, metric, block, queries, k, shard,
                            reduce=reduce)
        return merge_shard_topk(gather(d), gather(ids), k)

    return search


def make_flat_search(mesh, *, k: int, metric: str = "cosine", dim: int = 0,
                     mode: str = "rows"):
    """Sharded exact scan: ``search(block (N_local, D_local), queries (Q,
    D_local)) -> (dists (Q, k), global ids (Q, k) int32)`` on every rank.

    mode="rows": rows over every mesh axis, the feature dim whole, no
    reduce; the only collective is the k-candidate all_gather.
    mode="dims": rows over (pod, data), the feature dim over model with an
    all_reduce of the partial distances, one row chunk at a time.
    cosine and dot are ``-q.x`` on rows the caller normalised; l2 is
    squared."""
    return _search(mesh, "flat", "l2" if metric == "l2" else "dot", k, mode,
                   dim)


def make_pq_search(mesh, *, k: int, m_subspaces: int = 0, mode: str = "rows"):
    """Sharded PQ-ADC scan: ``search(codes (N_local, m_local) uint8, lut
    (Q, m_local, k_cb))``.  mode="rows": rows over every axis, the LUT
    whole; mode="dims": rows over (pod, data), the sub-spaces over model
    with an all_reduce of the partial sums."""
    return _search(mesh, "pq", "adc", k, mode, m_subspaces)


def make_hamming_search(mesh, *, k: int, words: int = 0, mode: str = "rows"):
    """Sharded BQ scan: ``search(codes (N_local, W_local), q_codes (Q,
    W_local))``, int32 words holding the uint32 bits; the int32 counts are
    reduced ("dims") and returned as float32.  Modes as
    `make_flat_search`."""
    return _search(mesh, "hamming", "hamming", k, mode, words)


def emulate_search(kind: str, metric: str, x: torch.Tensor,
                   queries: torch.Tensor, k: int, sizes: Dict[str, int],
                   mode: str = "rows", dim: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One process plays every rank of a mesh of these axis sizes, on the
    global arrays: each row shard runs `local_topk` on its blocks (the
    first model shard's, with the others' partials added in model rank
    order for the reduce), the candidates are concatenated in shard order
    (the all_gather) and merged.  ``metric`` is "l2" or "dot" for the flat
    scan; ``queries`` is the LUT (PQ) or the query words (BQ).  What the
    distributed search returns, with the collectives' sums in a fixed
    order."""
    lay = layout(sizes, mode, dim)
    cands = []
    for s in range(lay.shards):
        coord = _unflatten(lay, s)
        coords = ([{**coord, "model": j} for j in range(lay.models)]
                  if lay.split else [coord])
        blocks = [(lay.block(x, c), lay.block(queries, c, rows=False))
                  for c in coords]
        reduce = None
        if lay.split:
            q_sqs = [l2_norm_sq(q) if kind == "flat" and metric == "l2"
                     else None for _, q in blocks]

            def reduce(part, lo, hi, blocks=blocks, q_sqs=q_sqs):
                for (b, q), q_sq in zip(blocks[1:], q_sqs[1:]):
                    part = part + local_partial(kind, metric, b, q, lo, hi,
                                                q_sq)
                return part
        cands.append(local_topk(kind, metric, *blocks[0], k, s,
                                reduce=reduce))
    return merge_shard_topk(torch.cat([d for d, _ in cands], 1),
                            torch.cat([i for _, i in cands], 1), k)


def _unflatten(lay: Layout, shard: int) -> Dict[str, int]:
    """The coordinates on the row axes of a row shard (model 0 where model
    is not a row axis)."""
    size, coord = dict(lay.sizes), {a: 0 for a, _ in lay.sizes}
    for a in reversed(lay.rows):
        coord[a] = shard % size[a]
        shard //= size[a]
    return coord

"""`PlanExecutor`: staged interpreter for declarative query plans.

Numpy-only copy of the JAX package's ``repro.core.executor``, kept here so
the port imports nothing of that package; ``AnnParams`` is what
`QuantixarEngine.search` takes.

The API layer (`repro.api.plan`) compiles every search — the fluent
`Query`, legacy `Collection.search`, and the wire `Search` op — into a
`QueryPlan`: a tree of stage dataclasses.  This module is the single
execution path for those plans against a `QuantixarEngine`:

  * ``ann``      — one index pass (HNSW/flat/IVF, sealed + delta segments,
                   masks, per-query ef/width/rescore knobs) producing a
                   candidate set;
  * ``sparse``   — one BM25 pass over a text field's inverted index
                   (`repro.core.sparse.SparseIndex`), producing negated-
                   score candidates in the same lower-is-closer space;
  * ``rescore``  — exact float re-ranking of an oversampled candidate set
                   in the collection metric (the coarse-to-fine second
                   stage quantized collections are built around);
  * ``prefetch`` — N independent sub-plans, each with its own vector,
                   filter, and tuning knobs, executed recursively;
  * ``fusion``   — rank fusion (RRF) or score-normalized linear fusion of
                   the prefetch result lists into one candidate set.

The executor is deliberately decoupled from the plan *dataclasses*: stages
are dispatched on their ``op`` tag and read by attribute, so `repro.core`
never imports `repro.api` (which imports this module).  `AnnParams` — the
single struct that carries per-query search knobs through the collection
plumbing and into `QuantixarEngine.search` — lives here for the same
reason.

Every stage execution is timed and counted; `ExecResult.stages` is the
per-stage report `Query.explain()` surfaces (candidate counts in/out,
seconds, nested prefetch children).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnnParams:
    """Per-query ANN knobs, threaded as ONE struct from the API layer
    through the batcher into `QuantixarEngine.search` (replacing the old
    parallel ef/rescore/expansion_width keyword lists).

    ``None`` fields defer to the engine/collection config.  ``rescore``
    here is the *engine-internal* oversample-and-rescore toggle used by
    single-stage plans; multi-stage plans set it False and rescore via an
    explicit ``rescore`` stage instead.
    """

    ef: Optional[int] = None
    expansion_width: Optional[int] = None
    rescore: Optional[bool] = None

    @classmethod
    def or_none(cls, ef: Optional[int] = None,
                expansion_width: Optional[int] = None,
                rescore: Optional[bool] = None) -> Optional["AnnParams"]:
        """All-default knobs collapse to ``None`` so batcher extras keys
        (and wire bodies) stay identical to a knob-less request."""
        if ef is None and expansion_width is None and rescore is None:
            return None
        return cls(ef=ef, expansion_width=expansion_width, rescore=rescore)


@dataclasses.dataclass
class ExecResult:
    """One plan execution: padded (Q, k) candidate arrays + stage report."""

    distances: np.ndarray
    ids: np.ndarray
    stages: List[Dict[str, Any]]


def _valid_count(d: np.ndarray, ids: np.ndarray) -> int:
    """Candidates that are real rows (not padding / masked-out slots)."""
    return int(((ids >= 0) & np.isfinite(d)).sum())


def _pad_topk(pairs: List[Tuple[float, int]], k: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(score, row) pairs, already sorted ascending -> padded (k,) arrays."""
    d = np.full(k, np.inf, dtype=np.float32)
    ids = np.full(k, -1, dtype=np.int64)
    for slot, (score, row) in enumerate(pairs[:k]):
        d[slot] = score
        ids[slot] = row
    return d, ids


def fuse_rrf(results: List[Tuple[np.ndarray, np.ndarray]], k: int,
             rrf_k: int = 60) -> Tuple[np.ndarray, np.ndarray]:
    """Reciprocal-rank fusion of per-query candidate lists.

    Each input is a (1, C_i) ranked list; a candidate's fused score is
    ``sum_i 1 / (rrf_k + rank_i)`` over the lists that contain it.  Scores
    are returned negated so the engine-wide "lower is closer" contract
    holds for fused hits too.
    """
    scores: Dict[int, float] = {}
    for d, ids in results:
        rank = 0
        for dist, row in zip(np.asarray(d).ravel(), np.asarray(ids).ravel()):
            if row < 0 or not np.isfinite(dist):
                continue
            scores[int(row)] = scores.get(int(row), 0.0) \
                + 1.0 / (rrf_k + rank)
            rank += 1
    ranked = sorted(((-s, row) for row, s in scores.items()),
                    key=lambda t: (t[0], t[1]))
    return _pad_topk(ranked, k)


def fuse_linear(results: List[Tuple[np.ndarray, np.ndarray]], k: int,
                weights: Optional[Tuple[float, ...]] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Score-normalized weighted fusion: each list's finite distances are
    min-max normalized to [0, 1]; a candidate absent from a list takes that
    list's worst score (1.0).  Lower fused score = better."""
    if weights is None:
        weights = tuple(1.0 / max(len(results), 1)
                        for _ in range(len(results)))
    per_list: List[Dict[int, float]] = []
    for d, ids in results:
        d, ids = np.asarray(d).ravel(), np.asarray(ids).ravel()
        ok = (ids >= 0) & np.isfinite(d)
        norm: Dict[int, float] = {}
        if ok.any():
            lo, hi = float(d[ok].min()), float(d[ok].max())
            span = (hi - lo) or 1.0
            for dist, row in zip(d[ok], ids[ok]):
                norm[int(row)] = (float(dist) - lo) / span
        per_list.append(norm)
    rows = set()
    for norm in per_list:
        rows.update(norm)
    fused = [(sum(w * norm.get(row, 1.0)
                  for w, norm in zip(weights, per_list)), row)
             for row in rows]
    fused.sort(key=lambda t: (t[0], t[1]))
    return _pad_topk(fused, k)


class PlanExecutor:
    """Executes a `QueryPlan` tree against one engine + row mask.

    ``search_fn(queries, k, flt=..., params=...)`` is the collection's
    masked first-pass search (so empty-corpus padding, liveness masks, and
    k clamping stay in one place); ``engine`` is used for the exact-rescore
    stage.  The executor itself is stateless across calls.
    """

    def __init__(self, search_fn: Callable[..., Tuple[np.ndarray, np.ndarray]],
                 engine, mask: Optional[np.ndarray] = None,
                 sparse_fn: Optional[Callable[
                     ..., Tuple[np.ndarray, np.ndarray]]] = None):
        self._search = search_fn
        self._engine = engine
        self._mask = mask
        # sparse_fn(field, text, k, flt=...) -> (1, k) negated-BM25
        # candidates; None when the collection has no text fields
        self._sparse = sparse_fn

    # ------------------------------------------------------------- execution
    def execute(self, plan, inherited: Optional[np.ndarray] = None,
                deadline: Optional[float] = None) -> ExecResult:
        """Run every stage of ``plan``; returns padded (Q, plan.k) arrays
        plus the per-stage report.  ``inherited`` is the parent plan's
        query matrix — prefetch sub-plans without their own vector reuse
        it, so the wire form carries the root vector once.  ``deadline``
        (a ``time.perf_counter()`` instant) is checked at every stage
        boundary: a plan that outlives it raises `TimeoutError` instead of
        holding the collection lock for the remaining stages."""
        queries = inherited
        if plan.vector is not None:
            queries = np.asarray(plan.vector, dtype=np.float32)
            if queries.ndim == 1:
                queries = queries[None, :]
        cand: Optional[Tuple[np.ndarray, np.ndarray]] = None
        prefetched: Optional[List[ExecResult]] = None
        stages: List[Dict[str, Any]] = []
        for stage in plan.stages:
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError(
                    f"plan exceeded its deadline before stage "
                    f"{stage.op!r}")
            cand_in = 0 if cand is None else _valid_count(*cand)
            t0 = time.perf_counter()
            children: Optional[List[List[Dict[str, Any]]]] = None
            if stage.op == "ann":
                cand = self._run_ann(stage, queries)
            elif stage.op == "sparse":
                cand = self._run_sparse(stage)
            elif stage.op == "rescore":
                cand = self._run_rescore(stage, queries, cand)
            elif stage.op == "prefetch":
                prefetched = [self.execute(sub, inherited=queries,
                                           deadline=deadline)
                              for sub in stage.plans]
                cand_in = 0
                cand = None
                children = [r.stages for r in prefetched]
            elif stage.op == "fusion":
                cand = self._run_fusion(stage, prefetched)
                cand_in = sum(_valid_count(r.distances, r.ids)
                              for r in (prefetched or []))
                prefetched = None
            else:                     # validate_plan rejects this earlier
                raise ValueError(f"unknown plan stage op {stage.op!r}")
            report: Dict[str, Any] = {
                "stage": stage.op,
                "k": int(getattr(stage, "k", 0) or 0),
                "candidates_in": cand_in,
                "candidates_out": (0 if cand is None
                                   else _valid_count(*cand)),
                "seconds": time.perf_counter() - t0,
            }
            if children is not None:
                report["candidates_out"] = sum(
                    _valid_count(r.distances, r.ids) for r in prefetched)
                report["children"] = children
            stages.append(report)
        if cand is None:
            raise ValueError("plan produced no candidate set "
                             "(prefetch without fusion?)")
        d, ids = cand
        d, ids = d[:, : plan.k], ids[:, : plan.k]
        if d.shape[1] < plan.k:            # corpus smaller than k: pad out
            pad = plan.k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return ExecResult(distances=d, ids=ids, stages=stages)

    # ---------------------------------------------------------------- stages
    def _run_ann(self, stage, queries):
        if queries is None:
            raise ValueError("ann stage needs a query vector")
        params = AnnParams.or_none(ef=stage.ef,
                                   expansion_width=stage.expansion_width,
                                   rescore=stage.rescore)
        d, ids = self._search(queries, stage.k, flt=stage.filter,
                              params=params)
        return np.asarray(d), np.asarray(ids)

    def _run_sparse(self, stage):
        if self._sparse is None:
            # validate_plan rejects sparse stages against text-less
            # schemas, so this only guards hand-built executors
            raise ValueError("collection has no text fields; "
                             "sparse stages cannot execute")
        d, ids = self._sparse(stage.field, stage.text, stage.k,
                              flt=stage.filter)
        return np.asarray(d), np.asarray(ids)

    def _run_rescore(self, stage, queries, cand):
        if cand is None:
            raise ValueError("rescore stage needs a preceding candidate set")
        if queries is None:
            raise ValueError("rescore stage needs a query vector")
        d, ids = cand
        return self._engine.exact_rescore(queries, np.asarray(ids, np.int64),
                                          stage.k, mask=self._mask)

    def _run_fusion(self, stage, prefetched):
        if not prefetched:
            raise ValueError("fusion stage needs a preceding prefetch stage")
        q = prefetched[0].distances.shape[0]
        rows_d, rows_i = [], []
        for qi in range(q):
            lists = [(r.distances[qi: qi + 1], r.ids[qi: qi + 1])
                     for r in prefetched]
            if stage.method == "rrf":
                d, ids = fuse_rrf(lists, stage.k, rrf_k=stage.rrf_k)
            else:
                d, ids = fuse_linear(lists, stage.k, weights=stage.weights)
            rows_d.append(d)
            rows_i.append(ids)
        return np.stack(rows_d), np.stack(rows_i)

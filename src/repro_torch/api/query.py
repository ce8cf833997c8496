"""Fluent query builder + `Hit` result type for the Collection API.

    hits = (col.query(vec)
               .filter(category="news")
               .where("price", "lt", 50)
               .top_k(5)
               .ef(128)
               .include("vector")
               .run())

Every setter is **copy-on-write**: it returns a new `Query`, so a base
query can be reused between variants (or threads) without silently
accumulating filters.

`run()` no longer calls the engine directly — the builder *compiles* to a
declarative `QueryPlan` (see `api/plan.py`) and hands it to the
collection's `execute_plan`, the single execution path shared by embedded
collections, the serving batcher, and the wire protocol.  Beyond the
classic single pass:

  * `.stages(coarse_k=...)` — coarse-to-fine: a raw code-domain first pass
    fetching `coarse_k` (default `oversample * k`) candidates, then an
    exact float rescore down to `k` (the explicit form of the engine's old
    `rescore=True` oversampling);
  * `.prefetch(vector=..., k=..., filter=...)` — add an independent
    sub-query; combine several with `.fuse("rrf")` or `.fuse("linear")`;
  * `.text("...")` — BM25 keyword search over a schema `TextField`.
    Alone (`col.query().text("...")`) it compiles to a pure sparse plan;
    with a query vector it becomes a hybrid plan — dense and sparse
    prefetch legs merged by RRF (or whatever `.fuse()` picked);
    `.prefetch(text=...)` adds further keyword legs explicitly;
  * `.explain()` — execute and return the compiled plan with per-stage
    candidate counts and timings (`PlanExplain`).

Filters are validated against the collection schema before execution
(unknown fields and kind-incompatible operators fail fast, instead of
silently matching nothing).

Carried across from the JAX package's ``repro.api.query`` unchanged but for
its imports.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.metadata import And, Filter, Predicate
from .plan import (AnnStage, FusionStage, PlanExplain, PrefetchStage,
                   QueryPlan, RescoreStage, SparseStage, validate_filter)
from .schema import SchemaError

__all__ = ["Hit", "Query", "validate_filter"]


@dataclasses.dataclass
class Hit:
    """One search result: stable string id, score, and the requested
    payload/vector.

    `score` is always "lower = closer", but its scale depends on the final
    plan stage: a distance in the collection metric for plain and rescored
    queries, a *negated RRF sum* for `.fuse("rrf")` results, and a min-max
    normalized weighted sum in [0, 1] for `.fuse("linear")` — fused scores
    rank hits but are NOT metric distances, so don't apply metric-space
    thresholds to them (add `.stages()` for exact final distances)."""

    id: str
    score: float
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    vector: Optional[np.ndarray] = None

    def __repr__(self):
        vec = "" if self.vector is None else f", vector[{len(self.vector)}]"
        return f"Hit(id={self.id!r}, score={self.score:.4f}{vec})"


@dataclasses.dataclass(frozen=True)
class _PrefetchSpec:
    """One `.prefetch()` call, compiled to a sub-plan at run time.  A spec
    is either dense (vector / ef / width knobs) or sparse (`text` set)."""

    vector: Optional[np.ndarray]      # None: reuse the root query vector
    k: Optional[int]                  # None: fusion stage k
    ef: Optional[int]
    expansion_width: Optional[int]
    filter: Optional[Filter]
    coarse_k: Optional[int]           # per-sub-plan coarse-to-fine
    text: Optional[str] = None        # set: this leg is a BM25 keyword pass
    text_field: Optional[str] = None  # None: the schema's single text field


class Query:
    """Immutable builder: every setter returns a new `Query` (copy-on-write),
    so base queries can be shared and specialized freely."""

    def __init__(self, collection, vector: Optional[np.ndarray] = None):
        self._col = collection
        self._vec: Optional[np.ndarray] = None
        if vector is not None:
            self._vec = np.asarray(vector, dtype=np.float32)
            if self._vec.ndim not in (1, 2):
                raise SchemaError(
                    f"query vector must be 1-D or 2-D, got {self._vec.shape}")
            if self._vec.shape[-1] != collection.schema.vector.dim:
                raise SchemaError(
                    f"query dim {self._vec.shape[-1]} != collection dim "
                    f"{collection.schema.vector.dim}")
        self._text: Optional[str] = None
        self._text_field: Optional[str] = None
        self._k = 10
        self._flt: Optional[Filter] = None
        self._ef: Optional[int] = None
        self._width: Optional[int] = None
        self._rescore: Optional[bool] = None
        self._include_vector = False
        self._coarse_k: Optional[int] = None
        self._oversample: Optional[int] = None
        self._prefetch: Tuple[_PrefetchSpec, ...] = ()
        self._fusion: Optional[FusionStage] = None

    def _clone(self) -> "Query":
        # all builder state is immutable (scalars, Filter trees, tuples),
        # so a shallow copy is a safe fork point
        return copy.copy(self)

    # --------------------------------------------------------------- setters
    def filter(self, *clauses: Filter, **equals: Any) -> "Query":
        """AND the given filter trees (and `field=value` equality sugar)
        into the query's filter."""
        q = self._clone()
        new: List[Filter] = list(clauses)
        new += [Predicate(col, "eq", val) for col, val in equals.items()]
        for clause in new:
            clause = validate_filter(self._col.schema, clause)
            q._flt = clause if q._flt is None else And((q._flt, clause))
        return q

    def where(self, column: str, op: str, value: Any) -> "Query":
        """Sugar for `.filter(Predicate(column, op, value))`."""
        return self.filter(Predicate(column, op, value))

    def text(self, text: str, field: Optional[str] = None) -> "Query":
        """BM25 keyword search over a schema `TextField`.  On a vectorless
        query (`col.query().text("...")`) this is the whole search; with a
        query vector it adds a sparse leg next to the dense one and the two
        are rank-fused (RRF unless `.fuse()` chose otherwise).  `field`
        defaults to the collection's single text field."""
        if not isinstance(text, str) or not text.strip():
            raise SchemaError(
                f"text() needs a non-empty string, got {text!r}")
        if field is not None and not isinstance(field, str):
            raise SchemaError(f"text field must be a string, got {field!r}")
        q = self._clone()
        q._text = text
        q._text_field = field
        return q

    def top_k(self, k: int) -> "Query":
        if k <= 0:
            raise SchemaError(f"top_k must be positive, got {k}")
        q = self._clone()
        q._k = int(k)
        return q

    def ef(self, ef: int) -> "Query":
        """HNSW beam width for this query (recall/latency knob)."""
        q = self._clone()
        q._ef = int(ef)
        return q

    def expansion_width(self, width: int) -> "Query":
        """Wide-beam HNSW expansion width for this query: candidates popped
        (and adjacency rows fused) per traversal iteration.  1 = classic
        single-pop; higher widths cut sequential loop trips ~width×."""
        if width < 1:
            raise SchemaError(
                f"expansion_width must be >= 1, got {width}")
        q = self._clone()
        q._width = int(width)
        return q

    def rescore(self, on: bool = True) -> "Query":
        """Override the schema's engine-internal rescore setting for this
        query.  Prefer `.stages()`, which makes the oversample explicit and
        shows up in `.explain()` as its own stage."""
        q = self._clone()
        q._rescore = bool(on)
        return q

    def stages(self, coarse_k: Optional[int] = None, *,
               oversample: Optional[int] = None) -> "Query":
        """Compile to an explicit coarse-to-fine plan: a raw (code-domain
        for quantized collections) first pass fetching `coarse_k`
        candidates, then an exact float rescore down to `top_k`.

        `coarse_k` defaults to `oversample * top_k` (oversample defaults
        to the schema's `rescore_multiplier`), resolved at run time."""
        if coarse_k is not None and coarse_k < 1:
            raise SchemaError(f"coarse_k must be >= 1, got {coarse_k}")
        if oversample is not None and oversample < 1:
            raise SchemaError(f"oversample must be >= 1, got {oversample}")
        q = self._clone()
        q._coarse_k = None if coarse_k is None else int(coarse_k)
        q._oversample = None if oversample is None else int(oversample)
        if q._coarse_k is None and q._oversample is None:
            q._oversample = int(self._col.schema.vector.rescore_multiplier)
        return q

    def prefetch(self, vector: Optional[np.ndarray] = None, *,
                 k: Optional[int] = None, ef: Optional[int] = None,
                 expansion_width: Optional[int] = None,
                 filter: Optional[Filter] = None,
                 coarse_k: Optional[int] = None,
                 text: Optional[str] = None,
                 text_field: Optional[str] = None,
                 **equals: Any) -> "Query":
        """Add one independent sub-query — dense (its own vector / filter /
        ef / width, optional per-sub-plan coarse-to-fine) or sparse
        (`text=...`, a BM25 pass over `text_field`).  Call repeatedly for
        several sub-queries and pick a merge with `.fuse(...)` (RRF is the
        default when prefetches are present)."""
        if text is not None:
            if not isinstance(text, str) or not text.strip():
                raise SchemaError(
                    f"prefetch text must be a non-empty string, got {text!r}")
            if vector is not None or ef is not None \
                    or expansion_width is not None or coarse_k is not None:
                raise SchemaError(
                    "a prefetch leg is dense or sparse, not both: 'text' "
                    "cannot combine with vector/ef/expansion_width/coarse_k")
        elif text_field is not None:
            raise SchemaError("prefetch 'text_field' needs 'text'")
        vec = None
        if vector is not None:
            vec = np.asarray(vector, dtype=np.float32)
            if vec.ndim != 1 or vec.shape[0] != self._col.schema.vector.dim:
                raise SchemaError(
                    f"prefetch vector must be 1-D of dim "
                    f"{self._col.schema.vector.dim}, got {vec.shape}")
        flt = filter
        for col_name, val in equals.items():
            pred = Predicate(col_name, "eq", val)
            flt = pred if flt is None else And((flt, pred))
        if flt is not None:
            flt = validate_filter(self._col.schema, flt)
        if k is not None and k < 1:
            raise SchemaError(f"prefetch k must be >= 1, got {k}")
        if coarse_k is not None and coarse_k < 1:
            raise SchemaError(f"prefetch coarse_k must be >= 1, "
                              f"got {coarse_k}")
        q = self._clone()
        q._prefetch = self._prefetch + (_PrefetchSpec(
            vector=vec, k=k, ef=ef, expansion_width=expansion_width,
            filter=flt, coarse_k=coarse_k, text=text,
            text_field=text_field),)
        return q

    def fuse(self, method: str = "rrf", *,
             weights: Optional[Sequence[float]] = None,
             rrf_k: int = 60) -> "Query":
        """Choose how prefetch sub-query results merge: `"rrf"`
        (reciprocal-rank fusion) or `"linear"` (min-max score-normalized
        weighted sum)."""
        q = self._clone()
        q._fusion = FusionStage(
            k=1, method=method,           # k is resolved at compile time
            weights=tuple(weights) if weights is not None else None,
            rrf_k=int(rrf_k))
        return q

    def include(self, *what: str) -> "Query":
        """Opt into returning heavier attributes; currently `"vector"`."""
        q = self._clone()
        for name in what:
            if name == "vector":
                q._include_vector = True
            elif name != "payload":           # payload always included
                raise SchemaError(f"cannot include {name!r}; "
                                  f"options: 'payload', 'vector'")
        return q

    # ----------------------------------------------------------- compilation
    def _coarse(self, k: int) -> Optional[int]:
        if self._coarse_k is not None:
            return max(self._coarse_k, k)
        if self._oversample is not None:
            return k * self._oversample
        return None

    def _compile(self) -> QueryPlan:
        """Builder state -> declarative `QueryPlan` tree."""
        k = self._k
        prefetch = self._prefetch
        if self._text is not None:
            if self._vec is None and not prefetch:
                # pure keyword search: one sparse stage is the whole plan
                if self._coarse_k is not None or self._oversample is not None:
                    raise SchemaError(
                        "stages() needs a query vector: rescoring keyword "
                        "hits is a vector-space operation")
                if self._rescore:
                    raise SchemaError(
                        "rescore() needs a query vector; keyword-only "
                        "queries have nothing to rescore against")
                if self._fusion is not None:
                    raise SchemaError(
                        "fuse() needs at least two search legs; a "
                        "keyword-only query has one")
                return QueryPlan(k=k, stages=(SparseStage(
                    text=self._text, k=k, field=self._text_field,
                    filter=self._flt),), vector=None)
            # hybrid: the root text becomes a sparse prefetch leg; without
            # explicit prefetches the dense leg is implicit — it inherits
            # the root vector (vector=None on the wire) and knobs
            sparse_spec = _PrefetchSpec(
                vector=None, k=None, ef=None, expansion_width=None,
                filter=None, coarse_k=None, text=self._text,
                text_field=self._text_field)
            if not prefetch:
                prefetch = (_PrefetchSpec(
                    vector=None, k=None, ef=None, expansion_width=None,
                    filter=None, coarse_k=None), sparse_spec)
            else:
                prefetch = prefetch + (sparse_spec,)
        if self._fusion is not None and not prefetch:
            raise SchemaError("fuse() needs at least one prefetch() "
                              "(or a hybrid .text() query)")
        if not prefetch:
            if self._vec is None:
                raise SchemaError(
                    "query needs a vector or text: pass a vector to "
                    "query(...) or add .text('...')")
            coarse = self._coarse(k)
            if coarse is None:                      # classic single pass
                stages: Tuple[Any, ...] = (AnnStage(
                    k=k, ef=self._ef, expansion_width=self._width,
                    filter=self._flt, rescore=self._rescore),)
            else:                                   # explicit coarse-to-fine
                stages = (AnnStage(k=coarse, ef=self._ef,
                                   expansion_width=self._width,
                                   filter=self._flt, rescore=False),
                          RescoreStage(k=k))
            return QueryPlan(k=k, stages=stages, vector=self._vec)

        if self._vec is not None and self._vec.ndim != 1:
            raise SchemaError("prefetch queries take a 1-D root vector")
        plans = []
        coarse = self._coarse(k)
        for spec in prefetch:
            # with .stages() on a fused query, the coarse pool must come
            # from the sub-queries: each fetches coarse-many raw candidates
            # (no engine-internal rescore) and the trailing RescoreStage
            # does the one exact pass after fusion
            sub_k = spec.k if spec.k is not None else (coarse or k)
            # the root filter is an invariant, not a default: a sub-query's
            # own filter narrows it further rather than replacing it
            if spec.filter is None:
                sub_flt = self._flt
            elif self._flt is None:
                sub_flt = spec.filter
            else:
                sub_flt = And((self._flt, spec.filter))
            if spec.text is not None:
                # sparse leg: the whole sub-plan is one BM25 pass fetching
                # the same oversampled pool size as its dense siblings
                plans.append(QueryPlan(k=sub_k, stages=(SparseStage(
                    text=spec.text, k=sub_k, field=spec.text_field,
                    filter=sub_flt),), vector=None))
                continue
            sub_ef = spec.ef if spec.ef is not None else self._ef
            sub_w = (spec.expansion_width if spec.expansion_width is not None
                     else self._width)
            if spec.coarse_k is not None:
                sub_stages: Tuple[Any, ...] = (
                    AnnStage(k=max(spec.coarse_k, sub_k), ef=sub_ef,
                             expansion_width=sub_w, filter=sub_flt,
                             rescore=False),
                    RescoreStage(k=sub_k))
            else:
                sub_rescore = False if coarse is not None else self._rescore
                sub_stages = (AnnStage(k=sub_k, ef=sub_ef,
                                       expansion_width=sub_w,
                                       filter=sub_flt,
                                       rescore=sub_rescore),)
            # sub-plans without their own vector inherit the root's at
            # execution time (vector=None on the wire), so an N-way
            # prefetch ships one vector copy, not N+1
            plans.append(QueryPlan(k=sub_k, stages=sub_stages,
                                   vector=spec.vector))
        fusion = self._fusion or FusionStage(k=k)
        stages = (PrefetchStage(plans=tuple(plans)),
                  dataclasses.replace(fusion, k=coarse or k))
        if coarse is not None:       # fused coarse set -> exact final rank
            stages = stages + (RescoreStage(k=k),)
        return QueryPlan(k=k, stages=stages, vector=self._vec)

    # ------------------------------------------------------------- execution
    def run(self, timeout: float = 120.0
            ) -> Union[List[Hit], List[List[Hit]]]:
        """Execute.  1-D input -> List[Hit]; 2-D input -> List[List[Hit]]."""
        return self._col.execute_plan(
            self._compile(), include_vector=self._include_vector,
            timeout=timeout)

    def explain(self, timeout: float = 120.0) -> PlanExplain:
        """Execute and return the compiled plan plus the executor's
        per-stage candidate counts and timings (embedded and over the wire
        report the same structure)."""
        return self._col.execute_plan(
            self._compile(), include_vector=self._include_vector,
            timeout=timeout, explain=True)

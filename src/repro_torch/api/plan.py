"""Declarative query plans: the wire-serializable form of every search.

The fluent `Query` builder *compiles* to a `QueryPlan` — a tree of stage
dataclasses — instead of calling the engine directly, and the same plan
executes embedded (`Collection.execute_plan` -> `PlanExecutor`) or over the
wire (the `Search` op carries the plan dict).  Stage types:

  * `AnnStage`      — one index pass (HNSW/flat/IVF) with its own
                      k / ef / expansion_width / filter; ``rescore=None``
                      defers to the engine config (the legacy single-stage
                      behaviour), ``False`` forces a raw code-domain pass
                      (the coarse stage of a coarse-to-fine plan);
  * `SparseStage`   — a BM25 keyword pass over a schema `TextField`'s
                      inverted index (standalone keyword search, filtered
                      via its own / the root filter, or fused with dense
                      ANN inside a prefetch sub-plan);
  * `RescoreStage`  — exact float re-rank of the previous stage's
                      (oversampled) candidates down to ``k``;
  * `PrefetchStage` — N independent sub-plans, each with its own vector,
                      filter, and tuning knobs;
  * `FusionStage`   — RRF or score-normalized linear fusion of the
                      prefetch lists into one candidate set.

The codec (`plan_to_dict` / `plan_from_dict`) is versioned with
`PLAN_VERSION`; malformed plans raise `SchemaError`, which every transport
maps to a structured `ErrorInfo`.  `validate_plan` checks stage ordering
and vector dimensions against a collection schema before execution, and
`Query.explain()` returns a `PlanExplain`: the compiled plan dict plus the
executor's per-stage candidate counts and timings.

Carried across from the JAX package's ``repro.api.plan`` unchanged but for
its imports: the port compiles the same fluent queries to the same plans
and plan dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.metadata import And, Filter, Not, Or, Predicate
from .schema import FIELD_OPS, CollectionSchema, SchemaError

PLAN_VERSION = 1

FUSION_METHODS = ("rrf", "linear")


# ------------------------------------------------------------------- filters
def validate_filter(schema: CollectionSchema, flt: Filter) -> Filter:
    """Check every predicate in the tree against the schema's typed fields."""
    if isinstance(flt, Predicate):
        fld = schema.field(flt.column)          # raises on unknown column
        allowed = FIELD_OPS[fld.kind]
        if flt.op not in allowed:
            raise SchemaError(
                f"op {flt.op!r} not valid for {fld.kind} field "
                f"{flt.column!r}; allowed: {allowed}")
        if flt.op == "in":
            value = [fld.validate(v) for v in flt.value]
            return Predicate(flt.column, "in", tuple(value))
        return Predicate(flt.column, flt.op, fld.validate(flt.value))
    if isinstance(flt, (And, Or)):
        clauses = tuple(validate_filter(schema, c) for c in flt.clauses)
        return type(flt)(clauses)
    if isinstance(flt, Not):
        return Not(validate_filter(schema, flt.clause))
    raise SchemaError(f"not a filter: {flt!r}")


# -------------------------------------------------------------------- stages
@dataclasses.dataclass(frozen=True)
class AnnStage:
    """First-pass index search; must open a (sub-)plan's stage pipeline."""

    k: int
    ef: Optional[int] = None
    expansion_width: Optional[int] = None
    filter: Optional[Filter] = None
    # None: engine-config default (quantized engines oversample + rescore
    # internally — the legacy single-stage behaviour).  False: raw
    # code-domain candidates for an explicit downstream rescore stage.
    rescore: Optional[bool] = None
    op = "ann"


@dataclasses.dataclass(frozen=True)
class RescoreStage:
    """Exact float re-rank of the previous stage's candidates to top-k."""

    k: int
    op = "rescore"


@dataclasses.dataclass(frozen=True)
class SparseStage:
    """BM25 keyword pass over a schema `TextField`'s inverted index; like
    `AnnStage` it must open a (sub-)plan's pipeline.  `field=None` targets
    the collection's single text field; candidate scores come back negated
    (lower = better) so they merge with the engine-wide ordering."""

    text: str
    k: int
    field: Optional[str] = None
    filter: Optional[Filter] = None
    op = "sparse"

    def __post_init__(self) -> None:
        if not isinstance(self.text, str) or not self.text.strip():
            raise SchemaError(
                f"sparse stage: 'text' must be a non-empty string, "
                f"got {self.text!r}")
        if isinstance(self.k, bool) or not isinstance(self.k, int) \
                or self.k < 1:
            raise SchemaError(
                f"sparse stage: 'k' must be a positive int, got {self.k!r}")
        if self.field is not None and not isinstance(self.field, str):
            raise SchemaError(
                f"sparse stage: 'field' must be a string, got {self.field!r}")


@dataclasses.dataclass(frozen=True)
class PrefetchStage:
    """N independent sub-plans whose result lists feed a fusion stage."""

    plans: Tuple["QueryPlan", ...]
    op = "prefetch"


@dataclasses.dataclass(frozen=True)
class FusionStage:
    """Merge prefetch lists: reciprocal-rank ("rrf") or min-max-normalized
    weighted ("linear") fusion."""

    k: int
    method: str = "rrf"
    weights: Optional[Tuple[float, ...]] = None
    rrf_k: int = 60
    op = "fusion"

    def __post_init__(self) -> None:
        if self.method not in FUSION_METHODS:
            raise SchemaError(f"fusion method {self.method!r}; "
                              f"have {FUSION_METHODS}")


Stage = Union[AnnStage, SparseStage, RescoreStage, PrefetchStage,
              FusionStage]


@dataclasses.dataclass(frozen=True, eq=False)
class QueryPlan:
    """Root of a compiled query: final k, root query vector(s), and the
    stage pipeline.  ``vector`` may be None only when every stage that
    needs one (ann/rescore) lives inside prefetch sub-plans that carry
    their own vectors."""

    k: int
    stages: Tuple[Stage, ...]
    vector: Optional[np.ndarray] = None

    @property
    def batched(self) -> bool:
        return self.vector is not None and np.asarray(self.vector).ndim == 2

    @property
    def trivial(self) -> bool:
        """Single plain ANN pass — eligible for the serving batcher."""
        return (len(self.stages) == 1
                and isinstance(self.stages[0], AnnStage)
                and self.stages[0].k == self.k)

    def to_dict(self) -> Dict[str, Any]:
        return plan_to_dict(self)


# --------------------------------------------------------------------- codec
def _filter_to_dict(flt: Optional[Filter]) -> Optional[Dict[str, Any]]:
    if flt is None:
        return None
    from .requests import filter_to_dict
    return filter_to_dict(flt)


def _filter_from_dict(d: Optional[Dict[str, Any]]) -> Optional[Filter]:
    if d is None:
        return None
    from .requests import filter_from_dict
    return filter_from_dict(d)


def _stage_to_dict(stage: Stage) -> Dict[str, Any]:
    if isinstance(stage, AnnStage):
        out: Dict[str, Any] = {"op": "ann", "k": stage.k}
        if stage.ef is not None:
            out["ef"] = stage.ef
        if stage.expansion_width is not None:
            out["expansion_width"] = stage.expansion_width
        if stage.filter is not None:
            out["filter"] = _filter_to_dict(stage.filter)
        if stage.rescore is not None:
            out["rescore"] = stage.rescore
        return out
    if isinstance(stage, SparseStage):
        out = {"op": "sparse", "k": stage.k, "text": stage.text}
        if stage.field is not None:
            out["field"] = stage.field
        if stage.filter is not None:
            out["filter"] = _filter_to_dict(stage.filter)
        return out
    if isinstance(stage, RescoreStage):
        return {"op": "rescore", "k": stage.k}
    if isinstance(stage, PrefetchStage):
        return {"op": "prefetch",
                "plans": [plan_to_dict(p) for p in stage.plans]}
    if isinstance(stage, FusionStage):
        out = {"op": "fusion", "k": stage.k, "method": stage.method}
        if stage.weights is not None:
            out["weights"] = list(stage.weights)
        if stage.rrf_k != 60:
            out["rrf_k"] = stage.rrf_k
        return out
    raise SchemaError(f"not a plan stage: {stage!r}")


def plan_to_dict(plan: QueryPlan) -> Dict[str, Any]:
    """Plan tree -> plain-JSON dict (versioned)."""
    out: Dict[str, Any] = {
        "v": PLAN_VERSION,
        "k": plan.k,
        "stages": [_stage_to_dict(s) for s in plan.stages],
    }
    if plan.vector is not None:
        out["vector"] = np.asarray(plan.vector, dtype=np.float32).tolist()
    return out


def _require_pos_int(d: Dict[str, Any], key: str, ctx: str) -> int:
    value = d.get(key)
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise SchemaError(f"{ctx}: {key!r} must be a positive int, "
                          f"got {value!r}")
    return value


def _opt_int(d: Dict[str, Any], key: str, ctx: str,
             minimum: int = 0) -> Optional[int]:
    value = d.get(key)
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, int) \
            or value < minimum:
        raise SchemaError(f"{ctx}: {key!r} must be an int >= {minimum}, "
                          f"got {value!r}")
    return value


def _stage_from_dict(d: Any) -> Stage:
    if not isinstance(d, dict):
        raise SchemaError(f"plan stage must be an object, got {d!r}")
    op = d.get("op")
    if op == "ann":
        rescore = d.get("rescore")
        if rescore is not None and not isinstance(rescore, bool):
            raise SchemaError(
                f"ann stage: 'rescore' must be a bool, got {rescore!r}")
        return AnnStage(
            k=_require_pos_int(d, "k", "ann stage"),
            ef=_opt_int(d, "ef", "ann stage"),
            expansion_width=_opt_int(d, "expansion_width", "ann stage", 1),
            filter=_filter_from_dict(d.get("filter")),
            rescore=rescore)
    if op == "sparse":
        field = d.get("field")
        if field is not None and not isinstance(field, str):
            raise SchemaError(
                f"sparse stage: 'field' must be a string, got {field!r}")
        # SparseStage.__post_init__ rejects empty/non-string text
        return SparseStage(
            text=d.get("text"),
            k=_require_pos_int(d, "k", "sparse stage"),
            field=field,
            filter=_filter_from_dict(d.get("filter")))
    if op == "rescore":
        return RescoreStage(k=_require_pos_int(d, "k", "rescore stage"))
    if op == "prefetch":
        plans = d.get("plans")
        if not isinstance(plans, list) or not plans:
            raise SchemaError("prefetch stage needs a non-empty 'plans' list")
        return PrefetchStage(plans=tuple(plan_from_dict(p) for p in plans))
    if op == "fusion":
        weights = d.get("weights")
        if weights is not None:
            if not isinstance(weights, (list, tuple)) or not all(
                    isinstance(w, (int, float)) and not isinstance(w, bool)
                    for w in weights):
                raise SchemaError(
                    f"fusion weights must be a list of numbers, "
                    f"got {weights!r}")
            weights = tuple(float(w) for w in weights)
        rrf_k = d.get("rrf_k", 60)
        if isinstance(rrf_k, bool) or not isinstance(rrf_k, int) \
                or rrf_k < 1:
            raise SchemaError(
                f"fusion rrf_k must be a positive int, got {rrf_k!r}")
        return FusionStage(
            k=_require_pos_int(d, "k", "fusion stage"),
            method=d.get("method", "rrf"),
            weights=weights, rrf_k=rrf_k)
    raise SchemaError(f"unknown plan stage op {op!r}; have "
                      f"('ann', 'sparse', 'rescore', 'prefetch', 'fusion')")


def plan_from_dict(d: Any) -> QueryPlan:
    """Plain dict -> plan tree; malformed input raises `SchemaError` (every
    transport maps it onto the structured error taxonomy)."""
    if not isinstance(d, dict):
        raise SchemaError(f"plan must be an object, got {type(d).__name__}")
    version = d.get("v", PLAN_VERSION)
    if version != PLAN_VERSION:
        raise SchemaError(f"unsupported plan version {version!r}; "
                          f"this build speaks v{PLAN_VERSION}")
    stages = d.get("stages")
    if not isinstance(stages, list) or not stages:
        raise SchemaError("plan needs a non-empty 'stages' list")
    vector = d.get("vector")
    if vector is not None:
        try:
            vector = np.asarray(vector, dtype=np.float32)
        except (TypeError, ValueError) as exc:   # ragged / non-numeric
            raise SchemaError(f"malformed plan vector: {exc}")
    return QueryPlan(
        k=_require_pos_int(d, "k", "plan"),
        stages=tuple(_stage_from_dict(s) for s in stages),
        vector=vector)


# ---------------------------------------------------------------- validation
def validate_plan(schema: CollectionSchema, plan: QueryPlan,
                  _nested: bool = False,
                  _inherits_vector: bool = False) -> QueryPlan:
    """Structural + schema validation; returns the plan with every filter
    tree validated (and value-normalized) against the collection schema.

    Prefetch sub-plans may omit their vector when the parent has one
    (execution inherits it), so an N-way prefetch query ships the root
    vector once instead of N+1 times."""
    if not plan.stages:
        raise SchemaError("plan has no stages")
    vector = plan.vector
    if vector is not None:
        vector = np.asarray(vector, dtype=np.float32)
        if vector.ndim not in (1, 2) or vector.shape[-1] != schema.vector.dim:
            raise SchemaError(
                f"plan vector shape {vector.shape} does not match "
                f"collection dim {schema.vector.dim}")
        if _nested and vector.ndim != 1:
            raise SchemaError("prefetch sub-plan vectors must be 1-D")
    has_vector = vector is not None or (_nested and _inherits_vector)
    stages: List[Stage] = []
    for pos, stage in enumerate(plan.stages):
        if isinstance(stage, AnnStage):
            if pos != 0:
                raise SchemaError("ann stage must open the plan "
                                  f"(found at position {pos})")
            if not has_vector:
                raise SchemaError("ann stage needs a plan vector")
            if stage.expansion_width is not None and stage.expansion_width < 1:
                raise SchemaError(f"expansion_width must be >= 1, "
                                  f"got {stage.expansion_width}")
            flt = (validate_filter(schema, stage.filter)
                   if stage.filter is not None else None)
            stages.append(dataclasses.replace(stage, filter=flt))
        elif isinstance(stage, SparseStage):
            if pos != 0:
                raise SchemaError("sparse stage must open the plan "
                                  f"(found at position {pos})")
            if vector is not None and vector.ndim != 1:
                # sparse scoring is per-query; a batched root vector has
                # no per-row text to pair with
                raise SchemaError(
                    "sparse stages take single queries; got a batched "
                    f"root vector of shape {vector.shape}")
            field = schema.resolve_text_field(stage.field)
            flt = (validate_filter(schema, stage.filter)
                   if stage.filter is not None else None)
            stages.append(dataclasses.replace(stage, field=field.name,
                                              filter=flt))
        elif isinstance(stage, PrefetchStage):
            if pos != 0:
                raise SchemaError("prefetch stage must open the plan "
                                  f"(found at position {pos})")
            if vector is not None and vector.ndim != 1:
                # each sub-plan is a single query; a batched root has no
                # meaning here and the fused result would silently cover
                # one row (or crash a trailing rescore stage)
                raise SchemaError(
                    "prefetch plans take a 1-D root vector, got shape "
                    f"{vector.shape}")
            nxt = plan.stages[pos + 1] if pos + 1 < len(plan.stages) else None
            if not isinstance(nxt, FusionStage):
                raise SchemaError(
                    "prefetch stage must be followed by a fusion stage")
            stages.append(PrefetchStage(plans=tuple(
                validate_plan(schema, sub, _nested=True,
                              _inherits_vector=has_vector)
                for sub in stage.plans)))
        elif isinstance(stage, FusionStage):
            if pos == 0 or not isinstance(plan.stages[pos - 1],
                                          PrefetchStage):
                raise SchemaError(
                    "fusion stage must follow a prefetch stage")
            prev = plan.stages[pos - 1]
            if stage.weights is not None \
                    and len(stage.weights) != len(prev.plans):
                raise SchemaError(
                    f"fusion has {len(stage.weights)} weights for "
                    f"{len(prev.plans)} prefetch sub-plans")
            stages.append(stage)
        elif isinstance(stage, RescoreStage):
            if pos == 0:
                raise SchemaError(
                    "rescore stage needs a preceding candidate stage")
            if not has_vector:
                raise SchemaError("rescore stage needs a plan vector")
            stages.append(stage)
        else:
            raise SchemaError(f"not a plan stage: {stage!r}")
    final = plan.stages[-1]
    if isinstance(final, PrefetchStage):
        raise SchemaError("plan cannot end on a prefetch stage")
    if getattr(final, "k", plan.k) < plan.k:
        raise SchemaError(
            f"final stage delivers k={final.k} < plan k={plan.k}")
    return QueryPlan(k=plan.k, stages=tuple(stages), vector=vector)


# ------------------------------------------------------------------- explain
@dataclasses.dataclass
class PlanExplain:
    """`Query.explain()` result: the compiled plan (codec form), the
    executor's per-stage report (candidate counts in/out, seconds, nested
    prefetch children), and the hits the plan produced.  The same object
    comes back embedded and over the wire."""

    plan: Dict[str, Any]
    stages: List[Dict[str, Any]]
    hits: List[Any] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"plan": self.plan, "stages": self.stages}

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{s['stage']}(k={s['k']}, out={s['candidates_out']}, "
            f"{s['seconds'] * 1e3:.2f}ms)" for s in self.stages)
        return f"PlanExplain({parts})"


# ----------------------------------------------------------------- recommend
def recommend_vector(collection: Any, positives: Sequence[Any],
                     negatives: Sequence[Any] = ()) -> np.ndarray:
    """Synthesize a query vector from example entities: mean(positives)
    minus mean(negatives).  Examples may be stored entity ids (looked up
    via ``collection.get``) or raw vectors; works against embedded and
    remote collections alike."""
    def resolve(example) -> np.ndarray:
        if isinstance(example, str):
            entity = collection.get(example)
            if entity is None or len(entity.vector) == 0:
                raise SchemaError(f"recommend: no entity {example!r} in "
                                  f"collection {collection.name!r}")
            return np.asarray(entity.vector, dtype=np.float32)
        vec = np.asarray(example, dtype=np.float32)
        if vec.ndim != 1 or vec.shape[0] != collection.schema.vector.dim:
            raise SchemaError(f"recommend: example vector shape {vec.shape} "
                              f"!= dim {collection.schema.vector.dim}")
        return vec

    if not positives:
        raise SchemaError("recommend needs at least one positive example")
    pos = np.stack([resolve(p) for p in positives]).mean(axis=0)
    if not negatives:
        return pos
    neg = np.stack([resolve(n) for n in negatives]).mean(axis=0)
    return pos - neg

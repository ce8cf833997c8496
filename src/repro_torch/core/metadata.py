"""Columnar metadata store + predicate evaluation for MEVS (paper §III-A).

Numpy-only copy of the JAX package's ``repro.core.metadata``, kept here so the port
imports nothing of that package.

"Metadata-Enhanced Vector Search … starts with metadata-based filtering and
then proceeds to vector similarity analysis."  The store keeps one numpy
column per attribute; a predicate tree evaluates to a boolean mask over the
corpus, which the engine threads into the (masked) similarity search.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

_OPS: Dict[str, Callable[[np.ndarray, Any], np.ndarray]] = {
    "eq": lambda c, v: c == v,
    "ne": lambda c, v: c != v,
    "lt": lambda c, v: c < v,
    "le": lambda c, v: c <= v,
    "gt": lambda c, v: c > v,
    "ge": lambda c, v: c >= v,
    "in": lambda c, v: np.isin(c, np.asarray(list(v))),
}


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Leaf predicate: column <op> value."""

    column: str
    op: str
    value: Any

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; have {sorted(_OPS)}")


@dataclasses.dataclass(frozen=True)
class And:
    clauses: Sequence["Filter"]


@dataclasses.dataclass(frozen=True)
class Or:
    clauses: Sequence["Filter"]


@dataclasses.dataclass(frozen=True)
class Not:
    clause: "Filter"


Filter = Union[Predicate, And, Or, Not]


class MetadataStore:
    """Append-only columnar store aligned with the vector corpus by row id."""

    def __init__(self):
        self._columns: Dict[str, List[Any]] = {}
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def columns(self):
        return sorted(self._columns)

    def append_batch(self, records: Sequence[Optional[Dict[str, Any]]]) -> None:
        """Add one record per inserted vector (None allowed -> all-missing)."""
        for rec in records:
            rec = rec or {}
            for key in rec:
                if key not in self._columns:
                    self._columns[key] = [None] * self._n
            for key, col in self._columns.items():
                col.append(rec.get(key))
            self._n += 1

    def column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise KeyError(f"no metadata column {name!r}")
        return np.asarray(self._columns[name])

    def record(self, row: int) -> Dict[str, Any]:
        """The row's metadata record (missing values omitted)."""
        if not 0 <= row < self._n:
            raise IndexError(f"row {row} out of range [0, {self._n})")
        return {name: col[row] for name, col in self._columns.items()
                if col[row] is not None}

    def evaluate(self, flt: Filter) -> np.ndarray:
        """Predicate tree -> (N,) bool mask. Missing values never match —
        including a column no record has ever written: it is all-missing,
        not an error (the schema layer has already vetted the name)."""
        if isinstance(flt, Predicate):
            if flt.op == "in" and len(tuple(flt.value)) == 0:
                # an empty value set matches nothing, by definition; don't
                # hand np.isin an empty (dtype-less float64) array to
                # compare against an object column
                return np.zeros((self._n,), dtype=bool)
            if flt.column not in self._columns:
                return np.zeros((self._n,), dtype=bool)
            col = self.column(flt.column)
            present = col != np.array(None)
            mask = np.zeros((self._n,), dtype=bool)
            if present.any():
                vals = col[present]
                try:
                    vals = vals.astype(type(flt.value))
                except (TypeError, ValueError):
                    pass
                mask[present] = _OPS[flt.op](vals, flt.value)
            return mask
        if isinstance(flt, And):
            out = np.ones((self._n,), dtype=bool)
            for c in flt.clauses:
                out &= self.evaluate(c)
            return out
        if isinstance(flt, Or):
            out = np.zeros((self._n,), dtype=bool)
            for c in flt.clauses:
                out |= self.evaluate(c)
            return out
        if isinstance(flt, Not):
            return ~self.evaluate(flt.clause)
        raise TypeError(f"not a filter: {flt!r}")

    # persistence -----------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {"__n__": np.array([self._n], dtype=np.int64)}
        for name, col in self._columns.items():
            out[f"col:{name}"] = np.asarray(col, dtype=object)
        return out

    @classmethod
    def from_state_dict(cls, state) -> "MetadataStore":
        ms = cls()
        ms._n = int(state["__n__"][0])
        for key, val in state.items():
            if key.startswith("col:"):
                ms._columns[key[4:]] = list(val)
        return ms

"""Sparse full-text retrieval: tokenizer, inverted index, BM25 scoring.

The JAX package's ``repro.core.sparse`` carried across: the numpy index,
tokenizer, corpus statistics and ranking are copies; its JAX scorer becomes
`scores_torch`, the same float32 contributions scatter-added with
``index_add_`` on a torch device (the card unless the caller asks for the
CPU), chosen by ``search(backend="torch")``.  The numpy `scores` stays the
default, as in the JAX package.

Both VDBMS surveys the roadmap cites (Pan et al. 2023, Taipalus 2024) call
combined text+vector querying a defining VDBMS capability; this module is
the sparse half of that hybrid.  It mirrors the dense engine's segmented
shape (`core/segment.py`):

  * `TokenizerConfig` — deterministic, schema-serialized tokenization
    (lowercase + min-length + stopword rules).  The same config tokenizes
    documents at upsert time and queries at search time, so scores are a
    pure function of (corpus, query, config).
  * `SparseIndex` — an incremental inverted index: token -> postings
    (global row id, term frequency) split into a **sealed** packed store
    (CSR-style: one rows array + one tfs array + per-token offsets) and a
    mutable **delta** dict that absorbs post-build upserts without any
    rebuild.  `seal()` folds the delta into new packed arrays; deletes are
    handled by the caller's row mask exactly like the dense engine's
    tombstones, so the index itself never mutates postings in place.
  * BM25 scoring — a vectorized numpy path (`scores()`) that the index's
    `search()` uses, a standalone brute-force reference
    (`bm25_reference`) computing the same formula from raw texts with the
    same accumulation order (so index top-k == reference top-k *exactly*,
    float-for-float), and a batched device path (`scores_torch`) over the
    same packed postings for large candidate sets.

Score contract: BM25 is higher-is-better; `search()` returns **negated**
scores so the engine-wide "lower is closer" ordering holds for sparse
candidates too (RRF ranks are unaffected; linear fusion min-max
normalizes either way).  Ties break deterministically on ascending row id.

Corpus statistics (N, df, avgdl) are computed over every *indexed* doc
regardless of the row mask — matching production engines, where deletes
filter candidates but do not retrain the scorer — and the reference uses
the same convention, so masked searches still match it exactly.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

# small English closed-class words; enough to keep toy corpora honest
# without dragging in a stemming dependency
DEFAULT_STOPWORDS: Tuple[str, ...] = (
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
    "that", "the", "their", "then", "there", "these", "they", "this",
    "to", "was", "will", "with")

_TOKEN_RE = re.compile(r"\w+", re.UNICODE)

BM25_K1 = 1.2
BM25_B = 0.75


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    """Deterministic tokenization rules, serialized inside `TextField`.

    `stopwords=None` means the default English list; an explicit empty
    tuple disables stopword removal entirely.
    """

    lowercase: bool = True
    min_token_len: int = 2
    stopwords: Optional[Tuple[str, ...]] = None

    def stopword_set(self) -> frozenset:
        words = DEFAULT_STOPWORDS if self.stopwords is None else self.stopwords
        return frozenset(words)

    def tokenize(self, text: Optional[str]) -> List[str]:
        if not text:
            return []
        if self.lowercase:
            text = text.lower()
        stop = self.stopword_set()
        return [t for t in _TOKEN_RE.findall(text)
                if len(t) >= self.min_token_len and t not in stop]

    def query_tokens(self, text: str) -> List[str]:
        """Tokenize a query and dedupe preserving first occurrence — the
        iteration order every scoring path (index, reference, torch) shares,
        which is what makes their floating-point sums bit-identical."""
        seen: Dict[str, None] = {}
        for tok in self.tokenize(text):
            seen.setdefault(tok)
        return list(seen)


def _idf(n_docs: int, df: np.ndarray) -> np.ndarray:
    """Lucene-style smoothed idf: ln(1 + (N - df + .5)/(df + .5)), always
    positive so a very common term can demote but never negate a match."""
    df = np.asarray(df, dtype=np.float64)
    return np.log1p((n_docs - df + 0.5) / (df + 0.5))


@dataclasses.dataclass(frozen=True)
class CorpusStats:
    """Externally-supplied BM25 corpus statistics (N, avgdl, per-token df).

    A sharded corpus scores each shard with *global* statistics — local
    df/avgdl would make scores incomparable across shards — so the caller
    gathers every shard's `SparseIndex.term_stats()`, sums them, and passes
    the aggregate back into each shard's `search(stats=...)`.  Summing the
    integer counters before the float divisions reproduces the exact
    float64 values a single unsharded index computes, so the distributed
    merge stays hit-for-hit identical to the single-engine ranking.
    """

    docs_with_text: int
    avgdl: float
    df: Dict[str, int]

    @classmethod
    def aggregate(cls, parts: Sequence[Tuple[int, int, Dict[str, int]]]
                  ) -> "CorpusStats":
        """Sum per-shard `term_stats()` tuples into global statistics."""
        docs = sum(p[0] for p in parts)
        total = sum(p[1] for p in parts)
        df: Dict[str, int] = {}
        for _, _, part_df in parts:
            for tok, n in part_df.items():
                df[tok] = df.get(tok, 0) + n
        return cls(docs_with_text=docs,
                   avgdl=(total / docs if docs else 1.0), df=df)


class SparseIndex:
    """Incremental inverted index with BM25 scoring (sealed + delta).

    Documents are appended in global row order — `add()` MUST be called
    with one entry per corpus row (None/empty for rows without text) so
    sparse row ids stay aligned with the dense engine's.
    """

    # delta postings beyond this fold into the sealed store automatically
    AUTO_SEAL_POSTINGS = 65536

    def __init__(self, config: Optional[TokenizerConfig] = None,
                 k1: float = BM25_K1, b: float = BM25_B):
        self.config = config or TokenizerConfig()
        self.k1 = float(k1)
        self.b = float(b)
        # sealed packed store: vocab token -> slot; postings CSR arrays
        self._vocab: Dict[str, int] = {}
        self._offsets = np.zeros(1, dtype=np.int64)      # (V + 1,)
        self._rows = np.zeros(0, dtype=np.int64)
        self._tfs = np.zeros(0, dtype=np.int64)
        # mutable delta: token -> parallel [rows], [tfs] lists
        self._delta: Dict[str, Tuple[List[int], List[int]]] = {}
        self._delta_postings = 0
        self._doc_lens: List[int] = []     # one per corpus row (0 = no text)
        self._total_tokens = 0
        self._docs_with_text = 0
        self._sealed_docs = 0              # rows covered when last sealed
        self.seals = 0

    # ------------------------------------------------------------ properties
    def __len__(self) -> int:
        return len(self._doc_lens)

    @property
    def docs_indexed(self) -> int:
        """Rows that contributed at least one token."""
        return self._docs_with_text

    @property
    def vocab_size(self) -> int:
        tokens = set(self._vocab)
        tokens.update(self._delta)
        return len(tokens)

    @property
    def sealed_postings(self) -> int:
        return int(self._rows.shape[0])

    @property
    def delta_postings(self) -> int:
        return self._delta_postings

    @property
    def postings(self) -> int:
        return self.sealed_postings + self.delta_postings

    # ---------------------------------------------------------------- writes
    def add(self, texts: Sequence[Optional[str]]) -> None:
        """Append one document per entry (None = row without text)."""
        for text in texts:
            row = len(self._doc_lens)
            tokens = self.config.tokenize(text)
            self._doc_lens.append(len(tokens))
            if tokens:
                self._docs_with_text += 1
                self._total_tokens += len(tokens)
                for tok, tf in Counter(tokens).items():
                    rows, tfs = self._delta.setdefault(tok, ([], []))
                    rows.append(row)
                    tfs.append(tf)
                    self._delta_postings += 1
        if self._delta_postings >= self.AUTO_SEAL_POSTINGS:
            self.seal()

    def seal(self) -> bool:
        """Fold the delta postings into a fresh packed sealed store.
        Returns True if anything was folded."""
        if not self._delta:
            self._sealed_docs = len(self._doc_lens)
            return False
        tokens = sorted(set(self._vocab) | set(self._delta))
        offsets = np.zeros(len(tokens) + 1, dtype=np.int64)
        chunks_r: List[np.ndarray] = []
        chunks_t: List[np.ndarray] = []
        for slot, tok in enumerate(tokens):
            parts_r, parts_t = [], []
            old = self._vocab.get(tok)
            if old is not None:
                lo, hi = self._offsets[old], self._offsets[old + 1]
                parts_r.append(self._rows[lo:hi])
                parts_t.append(self._tfs[lo:hi])
            if tok in self._delta:
                d_rows, d_tfs = self._delta[tok]
                parts_r.append(np.asarray(d_rows, dtype=np.int64))
                parts_t.append(np.asarray(d_tfs, dtype=np.int64))
            # sealed rows predate delta rows, so concat stays ascending
            rows = np.concatenate(parts_r) if len(parts_r) > 1 else parts_r[0]
            tfs = np.concatenate(parts_t) if len(parts_t) > 1 else parts_t[0]
            chunks_r.append(rows)
            chunks_t.append(tfs)
            offsets[slot + 1] = offsets[slot] + rows.shape[0]
        self._vocab = {tok: slot for slot, tok in enumerate(tokens)}
        self._offsets = offsets
        self._rows = (np.concatenate(chunks_r) if chunks_r
                      else np.zeros(0, dtype=np.int64))
        self._tfs = (np.concatenate(chunks_t) if chunks_t
                     else np.zeros(0, dtype=np.int64))
        self._delta = {}
        self._delta_postings = 0
        self._sealed_docs = len(self._doc_lens)
        self.seals += 1
        return True

    # -------------------------------------------------------------- postings
    def _postings(self, token: str) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, tfs) for one token across sealed + delta (row-ascending)."""
        parts_r, parts_t = [], []
        slot = self._vocab.get(token)
        if slot is not None:
            lo, hi = self._offsets[slot], self._offsets[slot + 1]
            if hi > lo:
                parts_r.append(self._rows[lo:hi])
                parts_t.append(self._tfs[lo:hi])
        if token in self._delta:
            d_rows, d_tfs = self._delta[token]
            parts_r.append(np.asarray(d_rows, dtype=np.int64))
            parts_t.append(np.asarray(d_tfs, dtype=np.int64))
        if not parts_r:
            return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
        if len(parts_r) == 1:
            return parts_r[0], parts_t[0]
        return np.concatenate(parts_r), np.concatenate(parts_t)

    def _norm(self, avgdl: Optional[float] = None
              ) -> Tuple[np.ndarray, float]:
        """(per-doc length-normalization denominator term, avgdl); pass
        ``avgdl`` to normalize against global (cross-shard) statistics."""
        lens = np.asarray(self._doc_lens, dtype=np.float64)
        if avgdl is None:
            avgdl = (self._total_tokens / self._docs_with_text
                     if self._docs_with_text else 1.0)
        return self.k1 * (1.0 - self.b + self.b * lens / avgdl), avgdl

    def term_stats(self, tokens: Sequence[str]
                   ) -> Tuple[int, int, Dict[str, int]]:
        """This index's contribution to global BM25 statistics:
        (docs with text, total tokens, per-query-token document
        frequency).  `CorpusStats.aggregate` sums these across shards."""
        return (self._docs_with_text, self._total_tokens,
                {tok: int(self._postings(tok)[0].shape[0])
                 for tok in tokens})

    # --------------------------------------------------------------- scoring
    def scores(self, tokens: Sequence[str],
               stats: Optional[CorpusStats] = None) -> np.ndarray:
        """Dense (n_rows,) float64 BM25 scores for already-deduped query
        tokens — the vectorized numpy path `search()` ranks with.  `stats`
        substitutes global (cross-shard) corpus statistics for this
        index's local ones."""
        n = len(self._doc_lens)
        out = np.zeros(n, dtype=np.float64)
        n_docs = stats.docs_with_text if stats else self._docs_with_text
        if n == 0 or not n_docs:
            return out
        norm, _ = self._norm(stats.avgdl if stats else None)
        for tok in tokens:
            rows, tfs = self._postings(tok)
            if rows.shape[0] == 0:
                continue
            df = stats.df.get(tok, int(rows.shape[0])) if stats \
                else int(rows.shape[0])
            idf = float(_idf(n_docs, df))
            tf = tfs.astype(np.float64)
            contrib = idf * tf * (self.k1 + 1.0) / (tf + norm[rows])
            np.add.at(out, rows, contrib)
        return out

    def scores_torch(self, tokens: Sequence[str],
                     stats: Optional[CorpusStats] = None,
                     device="cuda") -> np.ndarray:
        """Batched device scoring over the packed postings of the query's
        tokens: one gather of (rows, tfs, per-posting idf), one fused
        contribution computation, one ``index_add_`` into the dense score
        vector on ``device``.  Numerically equivalent to `scores()` up to
        float32 accumulation — use for large candidate sets on device; the
        numpy path remains the exact reference."""
        dev = resolve_device(device)
        n = len(self._doc_lens)
        n_docs = stats.docs_with_text if stats else self._docs_with_text
        if n == 0 or not n_docs:
            return np.zeros(n, dtype=np.float64)
        gathered = [(tok, *self._postings(tok)) for tok in tokens]
        gathered = [(tok, r, t) for tok, r, t in gathered if r.shape[0]]
        if not gathered:
            return np.zeros(n, dtype=np.float64)
        rows = np.concatenate([r for _, r, _ in gathered])
        tfs = np.concatenate([t for _, _, t in gathered]).astype(np.float32)
        idf = np.concatenate([
            np.full(r.shape[0],
                    float(_idf(n_docs,
                               stats.df.get(tok, int(r.shape[0])) if stats
                               else int(r.shape[0]))),
                    dtype=np.float32)
            for tok, r, _ in gathered])
        norm, _ = self._norm(stats.avgdl if stats else None)
        norm_g = norm.astype(np.float32)[rows]
        idf_t, tfs_t, norm_t = (torch.as_tensor(a).to(dev)
                                for a in (idf, tfs, norm_g))
        contrib = idf_t * tfs_t * (self.k1 + 1.0) / (tfs_t + norm_t)
        dense = torch.zeros(n, dtype=torch.float32, device=dev)
        dense.index_add_(0, torch.as_tensor(rows).to(dev), contrib)
        return dense.cpu().numpy().astype(np.float64)

    def search(self, text: str, k: int,
               mask: Optional[np.ndarray] = None,
               backend: str = "numpy",
               stats: Optional[CorpusStats] = None,
               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
        """Top-k BM25 search.  Returns padded (k,) arrays in the engine's
        candidate convention: distances = **negated** scores ascending
        (best first), +inf / row -1 for empty slots; `mask` (row liveness
        and/or a metadata filter) removes candidates but does not change
        the corpus statistics.  Ties break on ascending row id.  `stats`
        scores against global (cross-shard) corpus statistics.
        ``backend="torch"`` scores with `scores_torch` on ``device``."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if backend not in ("numpy", "torch"):
            raise ValueError(f"backend {backend!r}; have numpy, torch")
        tokens = self.config.query_tokens(text)
        if backend == "torch":
            scores = self.scores_torch(tokens, stats=stats, device=device)
        else:
            scores = self.scores(tokens, stats=stats)
        if mask is not None:
            m = np.asarray(mask, dtype=bool)
            scores = np.where(m[:scores.shape[0]], scores, 0.0)
        return rank_scores(scores, k)

    # ------------------------------------------------------------------ misc
    def stats(self) -> Dict[str, Any]:
        return {"docs": len(self._doc_lens),
                "docs_indexed": self.docs_indexed,
                "vocab": self.vocab_size,
                "postings": self.postings,
                "sealed_postings": self.sealed_postings,
                "delta_postings": self.delta_postings,
                "seals": self.seals}

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Packed arrays only — the sealed/delta split survives the
        round-trip, so a loaded index keeps absorbing upserts without a
        rebuild."""
        sealed_vocab = [None] * len(self._vocab)
        for tok, slot in self._vocab.items():
            sealed_vocab[slot] = tok
        d_vocab, d_offsets, d_rows, d_tfs = [], [0], [], []
        for tok in sorted(self._delta):
            rows, tfs = self._delta[tok]
            d_vocab.append(tok)
            d_rows.extend(rows)
            d_tfs.extend(tfs)
            d_offsets.append(len(d_rows))
        return {
            "vocab": np.asarray(sealed_vocab, dtype=object),
            "offsets": self._offsets,
            "rows": self._rows,
            "tfs": self._tfs,
            "delta_vocab": np.asarray(d_vocab, dtype=object),
            "delta_offsets": np.asarray(d_offsets, dtype=np.int64),
            "delta_rows": np.asarray(d_rows, dtype=np.int64),
            "delta_tfs": np.asarray(d_tfs, dtype=np.int64),
            "doc_lens": np.asarray(self._doc_lens, dtype=np.int64),
            "counters": np.asarray([self._total_tokens,
                                    self._docs_with_text,
                                    self._sealed_docs, self.seals],
                                   dtype=np.int64),
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, np.ndarray],
                        config: Optional[TokenizerConfig] = None,
                        k1: float = BM25_K1, b: float = BM25_B
                        ) -> "SparseIndex":
        idx = cls(config, k1=k1, b=b)
        idx._vocab = {str(tok): slot
                      for slot, tok in enumerate(state["vocab"])}
        idx._offsets = np.asarray(state["offsets"], dtype=np.int64)
        idx._rows = np.asarray(state["rows"], dtype=np.int64)
        idx._tfs = np.asarray(state["tfs"], dtype=np.int64)
        d_off = np.asarray(state["delta_offsets"], dtype=np.int64)
        d_rows = np.asarray(state["delta_rows"], dtype=np.int64)
        d_tfs = np.asarray(state["delta_tfs"], dtype=np.int64)
        for i, tok in enumerate(state["delta_vocab"]):
            lo, hi = int(d_off[i]), int(d_off[i + 1])
            idx._delta[str(tok)] = (list(d_rows[lo:hi].tolist()),
                                    list(d_tfs[lo:hi].tolist()))
        idx._delta_postings = int(d_rows.shape[0])
        idx._doc_lens = [int(x) for x in state["doc_lens"]]
        total, with_text, sealed_docs, seals = \
            (int(x) for x in state["counters"])
        idx._total_tokens = total
        idx._docs_with_text = with_text
        idx._sealed_docs = sealed_docs
        idx.seals = seals
        return idx


# ------------------------------------------------------------------ ranking
def rank_scores(scores: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense score vector -> padded (k,) (distances, rows): rows with
    score > 0 ranked by (-score, row id), distances negated float32."""
    scores = np.asarray(scores, dtype=np.float64)
    cand = np.flatnonzero(scores > 0.0)
    if cand.shape[0]:
        order = np.lexsort((cand, -scores[cand]))[:k]
        top = cand[order]
    else:
        top = cand
    d = np.full(k, np.inf, dtype=np.float32)
    rows = np.full(k, -1, dtype=np.int64)
    d[:top.shape[0]] = (-scores[top]).astype(np.float32)
    rows[:top.shape[0]] = top
    return d, rows


# ---------------------------------------------------------------- reference
def bm25_reference(texts: Sequence[Optional[str]], query: str,
                   config: Optional[TokenizerConfig] = None,
                   k1: float = BM25_K1, b: float = BM25_B) -> np.ndarray:
    """Brute-force dense BM25 scores straight from raw texts — no index
    structure at all.  Deliberately mirrors `SparseIndex.scores()`'s
    accumulation order (per deduped query token, ascending row), so the
    incremental index must match it float-for-float, not just rank-wise."""
    config = config or TokenizerConfig()
    doc_tokens = [config.tokenize(t) for t in texts]
    doc_lens = np.asarray([len(t) for t in doc_tokens], dtype=np.float64)
    with_text = int((doc_lens > 0).sum())
    out = np.zeros(len(doc_tokens), dtype=np.float64)
    if with_text == 0:
        return out
    avgdl = float(doc_lens.sum()) / with_text
    norm = k1 * (1.0 - b + b * doc_lens / avgdl)
    counts = [Counter(t) for t in doc_tokens]
    for tok in (config.query_tokens(query)):
        rows = np.asarray([i for i, c in enumerate(counts) if tok in c],
                          dtype=np.int64)
        if rows.shape[0] == 0:
            continue
        tf = np.asarray([counts[i][tok] for i in rows], dtype=np.float64)
        idf = float(_idf(with_text, rows.shape[0]))
        contrib = idf * tf * (k1 + 1.0) / (tf + norm[rows])
        np.add.at(out, rows, contrib)
    return out

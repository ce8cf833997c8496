"""The comparison that decides ``correct``.

Every answer the window returned is compared, once the window has closed,
with the plain reference (``reference/<name>.py``), which works out the
distances and the exact neighbours again from the inputs the benchmark made.
The numbers, each against its limit:

- ``bad_answers`` (limit 0, exact): answered queries whose row holds an id
  outside the corpus, a repeated id, a distance that is not finite or is
  smaller than the one before it;
- ``dist_err``: the widest gap between a returned distance and the
  reference's float64 distance of the returned id, over |q|·|x| for
  squared L2 (the norm expansion's scale) and over 1 for unit rows;
- ``recall_at_10``: the share of the reference's exact top-k found, over
  every query answered, against the recall the configuration guarantees
  (``guarantees.recall_at_10_min``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

#: answered rows compared at a time
CHUNK_ROWS = 1 << 17


def bad_rows(ids: torch.Tensor, d: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(R,) bool: rows of (R, k) answers that break the answer's rules."""
    bad = (ids < 0).any(1) | (ids >= n_rows).any(1)
    bad |= ~torch.isfinite(d).all(1)
    if d.shape[1] > 1:
        bad |= (d[:, 1:] < d[:, :-1]).any(1)
        s = torch.sort(ids, dim=1).values
        bad |= (s[:, 1:] == s[:, :-1]).any(1)
    return bad


def compare(queries: torch.Tensor, ids: torch.Tensor, d: torch.Tensor,
            pair64: Callable[[torch.Tensor, torch.Tensor],
                             Tuple[torch.Tensor, torch.Tensor]],
            n_rows: int, gt_ids: torch.Tensor) -> Dict[str, float]:
    """Sums and maxima over answered rows (queries (R, D), ids (R, k) int64,
    d (R, k) float32).  ``pair64(queries, ids)`` gives the reference's
    float64 distances of valid ids and their scales; ``gt_ids`` (R, k) are
    the reference's exact answers.
    Returns {"rows", "bad", "dist_err", "hits"}."""
    out = {"rows": 0, "bad": 0, "dist_err": 0.0, "hits": 0}
    for lo in range(0, ids.shape[0], CHUNK_ROWS):
        sl = slice(lo, lo + CHUNK_ROWS)
        qi, ii, di = queries[sl], ids[sl], d[sl]
        ok_ids = (ii >= 0) & (ii < n_rows)
        safe = torch.where(ok_ids, ii, 0)
        bad = bad_rows(ii, di, n_rows)
        out["rows"] += ii.shape[0]
        out["bad"] += int(bad.sum())
        d64, scale = pair64(qi, safe)
        good = ok_ids & torch.isfinite(di)
        err = torch.where(good, (di.double() - d64).abs() / scale, 0.0)
        out["dist_err"] = max(out["dist_err"], float(err.max()))
        out["hits"] += int((ii[:, :, None] == gt_ids[sl][:, None, :])
                           .any(2).sum())
    return out


def checks(cmp: Dict[str, float], config: dict,
           k: int) -> Dict[str, Dict[str, float]]:
    """The compared numbers of one run, each with its limit, in the order
    they are printed."""
    return {"bad_answers": {"value": cmp["bad"], "limit": 0},
            "dist_err": {"value": cmp["dist_err"],
                         "limit": config["limits"]["dist_err"]},
            "recall_at_10": {"value": cmp["hits"] / max(1, cmp["rows"] * k),
                             "limit": config["guarantees"]
                             ["recall_at_10_min"]}}


def passed(checks_: Dict[str, Dict[str, float]]) -> bool:
    """Every number within its limit: at most it, a recall at least it."""
    for name, c in checks_.items():
        if name.startswith("recall"):
            if not c["value"] >= c["limit"]:
                return False
        elif not c["value"] <= c["limit"]:
            return False
    return True

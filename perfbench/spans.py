"""The program's spans of a traced window (``repro_torch.tracing``), for
the per-layer metrics that read them.

The program records spans only while a profiler runs, and a recording
starts with an empty buffer, so after a traced run the tracer holds the
window's spans and nothing else.  A program without the tracer, an
untraced run, or a window whose spans did not all fit in the buffer gives
no reading.
"""

from __future__ import annotations

from typing import Optional


def summary(run) -> Optional[dict]:
    """The tracer's summary of the window (``tracing.summary()``), or None:
    an untraced run, a program without the tracer, or spans dropped."""
    if run.trace is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    s = tracing.summary()
    return None if s["dropped"] else s


def of(run, name: str) -> Optional[dict]:
    """The summary's entry for the spans named ``name`` ({"n", "s",
    "wait_s", "counts"}), or None where there is none."""
    s = summary(run)
    return None if s is None else s["spans"].get(name)


def share(run, name: str, part: str, whole: str) -> Optional[float]:
    """100 x the count ``part`` over the count ``whole``, each summed over
    the spans named ``name``."""
    agg = of(run, name)
    if agg is None or part not in agg["counts"] \
            or not agg["counts"].get(whole):
        return None
    return 100.0 * agg["counts"][part] / agg["counts"][whole]


def host_ms(run, name: str, per: str = "batch") -> Optional[float]:
    """Milliseconds of the spans named ``name`` less the wait spans inside
    them, per batch of the window (``per`` "batch") or per span ("span")."""
    agg = of(run, name)
    if agg is None:
        return None
    n = run.batches if per == "batch" else agg["n"]
    return 1e3 * (agg["s"] - agg["wait_s"]) / n

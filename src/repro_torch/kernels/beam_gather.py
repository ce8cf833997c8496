"""Fused gather-distance for wide-beam HNSW traversal: the CUDA kernel's
wrapper (``csrc/beam_gather.cu``, replacing the JAX package's Pallas
``beam_gather_kernel``).

``launches`` counts the kernel's launches in this process; it is bumped at
the launch and nowhere else, so a run can show it went through the kernel.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _launch

MODES = {"l2": 0, "dot": 1}

launches = 0


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("beam_gather"), "beam_gather_f32",
                        n_ptrs=4, n_ints=5)


def beam_gather(q: torch.Tensor, ids: torch.Tensor, corpus: torch.Tensor, *,
                mode: str = "l2") -> torch.Tensor:
    """q (Q, D) f32 × ids (Q, L) i32 × corpus (N, D) f32 -> (Q, L) f32, on
    the card: squared L2 (diff-square-sum) or negated inner product of each
    query against its gathered rows.  ids must lie in [0, N)."""
    global launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    _launch.check_tensors("beam_gather", q=q, ids=ids, corpus=corpus)
    _launch.check_dtypes("beam_gather", q=(q, torch.float32),
                         ids=(ids, torch.int32),
                         corpus=(corpus, torch.float32))
    if q.dim() != 2 or ids.dim() != 2 or corpus.dim() != 2 \
            or ids.shape[0] != q.shape[0] or q.shape[1] != corpus.shape[1]:
        raise ValueError(f"beam_gather: shapes q {tuple(q.shape)}, ids "
                         f"{tuple(ids.shape)}, corpus {tuple(corpus.shape)}")
    (nq, d), l, n = q.shape, ids.shape[1], corpus.shape[0]
    out = torch.empty((nq, l), dtype=torch.float32, device=corpus.device)
    if nq == 0 or l == 0:
        return out
    _launch.launch("beam_gather", _fn(), corpus.device, q.data_ptr(),
                   ids.data_ptr(), corpus.data_ptr(), out.data_ptr(), nq, l,
                   d, n, MODES[mode])
    with _launch.count_lock:
        launches += 1
    return out

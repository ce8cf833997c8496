"""Fused gather + pairwise distances for the bulk build's Alg-4 prune: the
CUDA kernel's wrapper (``csrc/pair_gather.cu``, replacing the JAX package's
Pallas ``pair_gather_kernel``).

``launches`` counts the kernel's launches in this process; it is bumped at
the launch and nowhere else.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _launch

MODES = {"l2": 0, "dot": 1}
MAX_C = 256          # candidates per node the kernel takes

launches = 0


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("pair_gather"), "pair_gather_f32",
                        n_ptrs=3, n_ints=5)


def pair_gather(ids: torch.Tensor, corpus: torch.Tensor, *,
                mode: str = "l2") -> torch.Tensor:
    """ids (B, C) i32 × corpus (N, D) f32 -> (B, C, C) f32 on the card:
    for each node, the clamped squared L2 (norm expansion) or negated inner
    product among its C gathered rows.  ids must lie in [0, N)."""
    global launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    _launch.check_tensors("pair_gather", ids=ids, corpus=corpus)
    _launch.check_dtypes("pair_gather", ids=(ids, torch.int32),
                         corpus=(corpus, torch.float32))
    if ids.dim() != 2 or corpus.dim() != 2:
        raise ValueError(f"pair_gather: shapes ids {tuple(ids.shape)}, "
                         f"corpus {tuple(corpus.shape)}")
    (b, c), (n, d) = ids.shape, corpus.shape
    if c > MAX_C:
        raise ValueError(f"pair_gather: C={c} > {MAX_C}")
    out = torch.empty((b, c, c), dtype=torch.float32, device=corpus.device)
    if b == 0 or c == 0:
        return out
    _launch.launch("pair_gather", _fn(), corpus.device, ids.data_ptr(),
                   corpus.data_ptr(), out.data_ptr(), b, c, d, n, MODES[mode])
    with _launch.count_lock:
        launches += 1
    return out

"""Code-domain fused gather + Hamming distance for the BQ engine's
wide-beam traversal: the CUDA kernel's wrappers
(``csrc/beam_gather_hamming.cu``, replacing the JAX package's Pallas
``beam_gather_hamming_kernel``).

Two entries: `beam_gather_hamming`, the TPU kernel's function, and
`beam_gather_hamming_masked`, the BQ search step's fused form (the beam's
int64 ids with PAD and its fresh mask in, float distances with +inf on
stale slots out).  Packed words are int32 tensors holding the uint32 bits
(torch has no uint32 arithmetic on the CPU); the kernel reads them as
uint32.  ``launches`` and ``masked_launches`` count each entry's launches
in this process; each is bumped at its launch and nowhere else.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _launch

launches = 0
masked_launches = 0


@functools.cache
def _fn():
    return _launch.c_fn(_build.load("beam_gather_hamming"),
                        "beam_gather_hamming_u32", n_ptrs=4, n_ints=4)


@functools.cache
def _masked_fn():
    return _launch.c_fn(_build.load("beam_gather_hamming"),
                        "beam_gather_hamming_masked_u32", n_ptrs=5, n_ints=4)


def _check_shapes(name: str, q: torch.Tensor, ids: torch.Tensor,
                  codes: torch.Tensor) -> None:
    if q.dim() != 2 or ids.dim() != 2 or codes.dim() != 2 \
            or ids.shape[0] != q.shape[0] or codes.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, ids "
                         f"{tuple(ids.shape)}, codes {tuple(codes.shape)}")


def beam_gather_hamming(q: torch.Tensor, ids: torch.Tensor,
                        codes: torch.Tensor) -> torch.Tensor:
    """q (Q, W) × ids (Q, L) i32 × codes (N, W) -> (Q, L) int32 on the card,
    words int32 with uint32 bits: Σ_w popcount(codes[ids[q, l], w] ^ q[q, w]).
    ids must lie in [0, N)."""
    global launches
    name = "beam_gather_hamming"
    _launch.check_tensors(name, q=q, ids=ids, codes=codes)
    _launch.check_dtypes(name, q=(q, torch.int32), ids=(ids, torch.int32),
                         codes=(codes, torch.int32))
    _check_shapes(name, q, ids, codes)
    (nq, w), length, n = q.shape, ids.shape[1], codes.shape[0]
    out = torch.empty((nq, length), dtype=torch.int32, device=q.device)
    if nq == 0 or length == 0:
        return out
    _launch.launch(name, _fn(), q.device, q.data_ptr(), ids.data_ptr(),
                   codes.data_ptr(), out.data_ptr(), nq, length, w, n)
    with _launch.count_lock:
        launches += 1
    return out


def beam_gather_hamming_masked(q: torch.Tensor, ids: torch.Tensor,
                               fresh: torch.Tensor,
                               codes: torch.Tensor) -> torch.Tensor:
    """q (Q, W) i32 × ids (Q, L) i64 × fresh (Q, L) bool × codes (N, W) i32
    -> (Q, L) float32 on the card: float(Σ_w popcount(codes[clamp(id), w]
    ^ q[q, w])) where ``fresh`` is set, +inf where it is not (no row read).
    ids are clamped to [0, N), so PAD (-1) is allowed on any slot."""
    global masked_launches
    name = "beam_gather_hamming_masked"
    _launch.check_tensors(name, q=q, ids=ids, fresh=fresh, codes=codes)
    _launch.check_dtypes(name, q=(q, torch.int32), ids=(ids, torch.int64),
                         fresh=(fresh, torch.bool),
                         codes=(codes, torch.int32))
    _check_shapes(name, q, ids, codes)
    if fresh.shape != ids.shape:
        raise ValueError(f"{name}: fresh {tuple(fresh.shape)} is not ids' "
                         f"shape {tuple(ids.shape)}")
    (nq, w), length, n = q.shape, ids.shape[1], codes.shape[0]
    out = torch.empty((nq, length), dtype=torch.float32, device=q.device)
    if nq == 0 or length == 0:
        return out
    _launch.launch(name, _masked_fn(), q.device, q.data_ptr(), ids.data_ptr(),
                   fresh.data_ptr(), codes.data_ptr(), out.data_ptr(), nq,
                   length, w, n)
    with _launch.count_lock:
        masked_launches += 1
    return out

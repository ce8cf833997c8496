"""Dispatch for the port's kernels.

A tensor on the CPU takes the kernel's plain version (``ref.py``); a tensor
on a card launches the CUDA kernel, or raises: there is no environment
switch and no fallback.  ``force_ref=True`` asks for the plain version
explicitly, which only the tests and ``chip_smoke.py``'s comparison do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .beam_gather import beam_gather
from .beam_gather import beam_gather_lists as _beam_gather_lists
from .beam_gather_adc import beam_gather_adc as _beam_gather_adc
from .beam_gather_hamming import beam_gather_hamming as _beam_gather_hamming
from .beam_gather_hamming import \
    beam_gather_hamming_masked as _beam_gather_hamming_masked
from .bulk_prune import pair_gather
from .hamming import hamming
from .l2 import l2_distance
from .l2 import l2_topk as _l2_topk
from .pq_adc import pq_adc
from .slstm import SLSTMSequence
from .slstm import slstm_sequence as _slstm_sequence


def _plain(t: torch.Tensor, force_ref: bool) -> bool:
    return force_ref or t.device.type == "cpu"


def beam_gather_distances(q: torch.Tensor, ids: torch.Tensor,
                          corpus: torch.Tensor, *, mode: str = "l2",
                          force_ref: bool = False) -> torch.Tensor:
    """q (Q, D) × ids (Q, L) × corpus (N, D) -> (Q, L) float32 (l2 | dot):
    every layer-0 distance of the wide-beam search."""
    if _plain(corpus, force_ref):
        if mode == "l2":
            return ref.beam_gather_l2_ref(q, ids, corpus)
        return ref.beam_gather_dot_ref(q, ids, corpus)
    return beam_gather(q.float().contiguous(),
                       ids.to(torch.int32).contiguous(), corpus, mode=mode)


def beam_gather_lists_distances(q: torch.Tensor, probe: torch.Tensor,
                                lists: torch.Tensor, list_len: torch.Tensor,
                                corpus: torch.Tensor, *,
                                force_ref: bool = False) -> torch.Tensor:
    """q (Q, D) × probe (Q, P) list ids × lists (nlist, M) with PAD ×
    list_len (nlist,) × corpus (N, D) -> (Q, P * M) float32 squared L2
    (diff-square-sum), +inf on PAD slots and past each list's length: the
    IVF search's candidate distances, list-major."""
    if _plain(corpus, force_ref):
        return ref.beam_gather_lists_ref(q, probe, lists, list_len, corpus)
    return _beam_gather_lists(q.float().contiguous(),
                              probe.to(torch.int32).contiguous(), lists,
                              list_len, corpus)


def pair_gather_distances(ids: torch.Tensor, corpus: torch.Tensor, *,
                          mode: str = "l2",
                          force_ref: bool = False) -> torch.Tensor:
    """ids (B, C) × corpus (N, D) -> (B, C, C) float32 pairwise distances
    among each node's gathered rows (l2 | dot): the bulk-prune pair matrix."""
    if _plain(corpus, force_ref):
        if mode == "l2":
            return ref.pair_gather_l2_ref(ids, corpus)
        return ref.pair_gather_dot_ref(ids, corpus)
    return pair_gather(ids.to(torch.int32).contiguous(), corpus, mode=mode)


def beam_gather_adc(lut: torch.Tensor, ids: torch.Tensor,
                    codes: torch.Tensor, *,
                    force_ref: bool = False) -> torch.Tensor:
    """lut (Q, m, k) × ids (Q, L) × codes (N, m) uint8 | int32 -> (Q, L)
    float32 ADC distances: every layer-0 distance of the PQ search."""
    if _plain(codes, force_ref):
        return ref.beam_gather_adc_ref(lut, ids, codes)
    return _beam_gather_adc(lut.float().contiguous(),
                            ids.to(torch.int32).contiguous(), codes)


def beam_gather_hamming(q: torch.Tensor, ids: torch.Tensor,
                        codes: torch.Tensor, *,
                        force_ref: bool = False) -> torch.Tensor:
    """q (Q, W) × ids (Q, L) × codes (N, W), int32 words holding uint32
    bits -> (Q, L) int32 Hamming: every layer-0 distance of the BQ search."""
    if _plain(codes, force_ref):
        return ref.beam_gather_hamming_ref(q, ids, codes)
    return _beam_gather_hamming(q.contiguous(),
                                ids.to(torch.int32).contiguous(), codes)


def beam_gather_hamming_masked(q: torch.Tensor, ids: torch.Tensor,
                               fresh: torch.Tensor, codes: torch.Tensor, *,
                               force_ref: bool = False) -> torch.Tensor:
    """q (Q, W) int32 words × ids (Q, L) int64 as the beam makes them (PAD =
    -1 allowed, clamped to [0, N)) × fresh (Q, L) bool × codes (N, W) ->
    (Q, L) float32 Hamming distances, +inf where ``fresh`` is False: the BQ
    search step's distances in one launch, with no cast or mask around it.
    ids and fresh go to the kernel as they are (contiguous, or it raises)."""
    if _plain(codes, force_ref):
        return ref.beam_gather_hamming_masked_ref(q, ids, fresh, codes)
    return _beam_gather_hamming_masked(q.contiguous(), ids, fresh, codes)


def pq_adc_distances(lut: torch.Tensor, codes: torch.Tensor, *,
                     force_ref: bool = False) -> torch.Tensor:
    """lut (Q, m, k) × codes (N, m) -> (Q, N) float32: the PQ flat scan."""
    if _plain(codes, force_ref):
        return ref.pq_adc_ref(lut, codes)
    return pq_adc(lut.float().contiguous(), codes)


def hamming_distances(q: torch.Tensor, x: torch.Tensor, *,
                      force_ref: bool = False) -> torch.Tensor:
    """q (Q, W) × x (N, W) int32 words -> (Q, N) int32: the BQ flat scan."""
    if _plain(x, force_ref):
        return ref.hamming_ref(q, x)
    return hamming(q.contiguous(), x)


def l2_distances(q: torch.Tensor, x: torch.Tensor, *,
                 force_ref: bool = False) -> torch.Tensor:
    """q (Q, D) × x (N, D) -> (Q, N) float32 squared L2, clamped at 0: the
    exact scan (flat index, flat route, delta segment)."""
    if _plain(x, force_ref):
        return ref.l2_distance_ref(q, x)
    return l2_distance(q.float().contiguous(), x.float().contiguous(),
                       mode="l2")


def dot_distances(q: torch.Tensor, x: torch.Tensor, *,
                  force_ref: bool = False) -> torch.Tensor:
    """q (Q, D) × x (N, D) -> (Q, N) float32 −q·x: the exact scan under
    dot and cosine (on normalized rows)."""
    if _plain(x, force_ref):
        return ref.dot_distance_ref(q, x)
    return l2_distance(q.float().contiguous(), x.float().contiguous(),
                       mode="dot")


def l2_topk(q: torch.Tensor, x: torch.Tensor, k: int, *, mode: str,
            mask: Optional[torch.Tensor] = None,
            force_ref: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (Q, D) × x (N, D) -> the k smallest distances of each query
    (l2 | dot | cosine = 1.0 + dot), rows where ``mask`` is False at +inf:
    (distances (Q, k) ascending, int64 columns (Q, k)), ties to the lowest
    column.  The exact scan on the card, without the (Q, N) matrix."""
    if _plain(x, force_ref):
        return ref.l2_topk_ref(q, x, k, mode, mask)
    return _l2_topk(q.float().contiguous(), x.float().contiguous(), k,
                    mode=mode, mask=None if mask is None
                    else mask.to(torch.bool).contiguous())


def slstm_sequence(gates_x: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                   *, n_heads: int, force_ref: bool = False) -> torch.Tensor:
    """gates_x (B, S, 4d) × r (4, H, blk, blk) × b (4d,) -> h (B, S, d) in
    the gates' dtype: the sLSTM recurrence of every prefill and train step
    (``apply_slstm``).  Under grad, where any input requires it, the call
    goes through ``SLSTMSequence``: B8's saving entry forward and B8ᵀ
    backward on the card, the plain forward and reverse loop on the CPU or
    under ``force_ref``; otherwise B8's serving entry (or its plain
    version), which stores nothing for a backward."""
    plain = _plain(gates_x, force_ref)
    if torch.is_grad_enabled() and (gates_x.requires_grad or r.requires_grad
                                    or b.requires_grad):
        if not plain:
            gates_x = gates_x.contiguous()
            r, b = r.float().contiguous(), b.float().contiguous()
        return SLSTMSequence.apply(gates_x, r, b, n_heads, plain)
    if plain:
        return ref.slstm_sequence_ref(gates_x, r, b, n_heads)
    return _slstm_sequence(gates_x.contiguous(), r.float().contiguous(),
                           b.float().contiguous(), n_heads=n_heads)

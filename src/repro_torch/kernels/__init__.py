"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref``) and the dispatch between them (``ops``)."""

from .ops import beam_gather_distances, pair_gather_distances

__all__ = ["beam_gather_distances", "pair_gather_distances"]

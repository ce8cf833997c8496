"""The port's CUDA kernels and its default collection on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (a CUDA kernel has no
CPU mode).  This file imports no JAX, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, HNSWConfig, QuantixarEngine
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.kernels import beam_gather as bg_mod
from repro_torch.kernels import bulk_prune as pg_mod
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, nq, n, d, length):
    rng = np.random.RandomState(seed)
    corpus = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
    ids = rng.randint(0, n, (nq, length)).astype(np.int32)
    ids[:, ::3] = ids[:, :1]                 # repeated rows, corpus ends
    ids[:, 1::4] = 0
    ids[:, 2::5] = n - 1
    return corpus, q, ids


@pytest.mark.parametrize("d,length", [(128, 1), (128, 128), (784, 256),
                                      (30, 37)])
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_beam_gather(cuda, d, length, mode):
    corpus, q, ids = _inputs(d, 64, 500, d, length)
    args = [torch.as_tensor(a, device=cuda) for a in (q, ids, corpus)]
    before = bg_mod.launches
    got = ops.beam_gather_distances(*args, mode=mode)
    assert bg_mod.launches == before + 1
    want = ops.beam_gather_distances(*args, mode=mode, force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)


@pytest.mark.parametrize("d,c", [(128, 60), (784, 80), (30, 1), (16, 200)])
@pytest.mark.parametrize("mode", ["l2", "dot"])
def test_pair_gather(cuda, d, c, mode):
    corpus, _, ids = _inputs(c, 32, 500, d, c)
    args = [torch.as_tensor(a, device=cuda) for a in (ids, corpus)]
    before = pg_mod.launches
    got = ops.pair_gather_distances(*args, mode=mode)
    assert pg_mod.launches == before + 1
    want = ops.pair_gather_distances(*args, mode=mode, force_ref=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_engine_on_card_matches_cpu(cuda, metric):
    """The default collection built and searched on the card (through both
    kernels) agrees with the same engine on the CPU (plain versions); the
    kernels sum in another order, so near-ties may differ."""
    x = gaussian_mixture(3000, 32, n_clusters=15, scale=0.3, seed=1)
    q = gaussian_mixture(64, 32, n_clusters=15, scale=0.3, seed=2)
    cfg = EngineConfig(dim=32, metric=metric, builder="bulk",
                       hnsw=HNSWConfig(seed=0))
    before = (bg_mod.launches, pg_mod.launches)
    hits = []
    for dev in ("cuda", "cpu"):
        eng = QuantixarEngine(cfg, device=dev)
        eng.add(x)
        hits.append(eng.search(q, 10)[1])
    assert bg_mod.launches > before[0] and pg_mod.launches > before[1]
    assert (hits[0] == hits[1]).all(1).mean() >= 0.9

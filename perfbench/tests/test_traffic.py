"""The traffic generator: seeded, contiguous slices of one permutation."""

import torch

from perfbench.traffic import Mix, Schedule


def test_batches_are_slices_of_one_seeded_permutation():
    mix = Mix.from_spec({"batch": 64, "k": 10})
    a = Schedule(mix, 1000, 2**40 + 17)
    b = Schedule(mix, 1000, 2**40 + 17)
    c = Schedule(mix, 1000, 2**40 + 18)
    assert torch.equal(a.order, b.order)
    assert not torch.equal(a.order, c.order)
    perm = a.order[:1000]
    assert torch.equal(torch.sort(perm).values, torch.arange(1000))
    seen = torch.cat([a.positions(j) for j in range(125)])   # 8 cycles
    assert torch.equal(torch.bincount(seen), torch.full((1000,), 8))


def test_unknown_keys_are_refused():
    import pytest
    for key in ("rate", "loop", "clients", "filter"):
        with pytest.raises(ValueError):
            Mix.from_spec({"batch": 8, "k": 1, key: 3})

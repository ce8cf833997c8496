"""Faults planted underneath the timed path, one a function: each takes the
built system (and the run's context) and returns it broken.  The fault
tests drive a run through each and see ``correct`` come out false."""

import numpy as np


class _Broken:
    def __init__(self, inner):
        self.inner = inner

    def counters(self):
        return self.inner.counters()

    def close(self):
        self.inner.close()


class _Unchanged(_Broken):
    """Each batch gets the answers of the batch before: the search's state
    never moves on."""

    def __init__(self, inner):
        super().__init__(inner)
        self.last = None

    def search(self, queries):
        out = self.inner.search(queries)
        prev, self.last = self.last, out
        return out if prev is None else prev


class _Half(_Broken):
    """Half of the batch left out: its second half gets the first half's
    answers."""

    def search(self, queries):
        h = max(1, len(queries) // 2)
        d, i = self.inner.search(np.ascontiguousarray(queries[:h]))
        rest = len(queries) - h
        return np.concatenate([d, d[:rest]]), np.concatenate([i, i[:rest]])


class _Altered(_Broken):
    """One answer altered where it is produced: the first query's nearest id
    moved to the next row, its distance kept."""

    def __init__(self, inner, n):
        super().__init__(inner)
        self.n = n

    def search(self, queries):
        d, i = self.inner.search(queries)
        i = i.copy()
        i[0, 0] = (int(i[0, 0]) + 1) % self.n
        return d, i


def state_unchanged(system, ctx):
    return _Unchanged(system)


def half_batch(system, ctx):
    return _Half(system)


def answer_altered(system, ctx):
    return _Altered(system, int(ctx.config["rows"]))

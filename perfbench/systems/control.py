"""The control: the plain reference put in the program's place at the
precision below the configuration's float32, TF32 products (``knn.candidates``
with ``tf32=True``).  Every configuration can take it.  ``control.py`` runs
it; the benchmark's own runs never do.  It must come out as not correct."""

from __future__ import annotations

import torch

from ..reference import knn


def build(ctx):
    return Control(ctx)


class Control:
    def __init__(self, ctx):
        self.corpus, self.device = ctx.corpus, ctx.device
        self.k = ctx.mix.k
        self.distance = ctx.config["distance"]

    def search(self, queries):
        q = torch.from_numpy(queries).to(self.device)
        d, ids = knn.candidates(q, self.corpus, self.k, self.distance,
                                tf32=True)
        return d.cpu().numpy(), ids.cpu().numpy()

    def counters(self):
        return {}

    def close(self):
        self.corpus = None

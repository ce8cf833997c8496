"""``QuantixarEngine`` (``repro_torch.core.engine``) as the system: the
configuration's ``engine`` block is its ``EngineConfig``, the corpus is
added as rows, the index is built once, and each batch is one ``search``
call with ``search``'s keywords from the configuration."""

from __future__ import annotations

import dataclasses

from ..datagen import sub_seed
from . import launch_counters


def build(ctx):
    from repro_torch.core import EngineConfig, IVFConfig, QuantixarEngine
    from repro_torch.core.hnsw_build import HNSWConfig

    spec = dict(ctx.config["engine"])
    hnsw = HNSWConfig(**spec.pop("hnsw", {}))
    ivf = IVFConfig(**spec.pop("ivf", {}))
    cfg = EngineConfig(dim=int(ctx.config["dim"]), hnsw=hnsw,
                       ivf=ivf, **spec)
    seed = sub_seed(ctx.seed, "build") % (1 << 31)
    cfg.hnsw = dataclasses.replace(cfg.hnsw, seed=seed)
    eng = QuantixarEngine(cfg, device=ctx.device)
    eng.add(ctx.corpus.cpu().numpy())
    eng.build(seed=seed)
    return EngineSystem(eng, ctx)


class EngineSystem:
    def __init__(self, eng, ctx):
        self.eng = eng
        self.k = ctx.mix.k
        self.kw = dict(ctx.config.get("search", {}))

    def search(self, queries):
        return self.eng.search(queries, self.k, **self.kw)

    def counters(self):
        return launch_counters()

    def close(self):
        self.eng = None

"""Quantixar serving layer in the port: request batching, shard fan-out, and the
service-oriented request plane (`QuantixarService` + embedded HTTP server).

`service`/`http` are re-exported lazily: they import the `repro_torch.api`
package, which itself imports `repro_torch.serving.batcher`, so eager imports
here would cycle during `repro_torch.api` initialization.
"""

from .batcher import BatcherClosed, QuorumFanout, RequestBatcher

__all__ = ["BatcherClosed", "QuorumFanout", "RequestBatcher",
           "QuantixarService", "ServiceConfig", "QuantixarHTTPServer"]


def __getattr__(name):
    if name in ("QuantixarService", "ServiceConfig"):
        from . import service
        return getattr(service, name)
    if name == "QuantixarHTTPServer":
        from .http import QuantixarHTTPServer
        return QuantixarHTTPServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Quantixar serving layer in the port: the request batcher behind every
collection's single-vector query path.  The service plane, the HTTP server
and the shard fan-out are not ported yet (ROADMAP A10)."""

from .batcher import BatcherClosed, RequestBatcher

__all__ = ["BatcherClosed", "RequestBatcher"]

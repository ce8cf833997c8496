"""Embedded REST front-end: `ThreadingHTTPServer` over `QuantixarService`.

Stdlib-only (no new dependencies).  Each route parses into a wire-protocol
request dataclass and goes through `QuantixarService.dispatch`; responses are
always JSON envelopes —

    200  {"ok": true,  "result": {...}}
    4xx/5xx {"ok": false, "error": {"code": ..., "message": ...}}

— never an HTML error page or a traceback body.  Status codes follow the
error taxonomy: SCHEMA_ERROR / INVALID_ARGUMENT -> 400, NOT_FOUND -> 404,
UNAVAILABLE -> 503, INTERNAL -> 500.

Routes (all under /v1):

    GET    /v1/healthz
    GET    /v1/collections
    POST   /v1/collections                      {"schema": {...}}
    GET    /v1/collections/{name}
    DELETE /v1/collections/{name}
    POST   /v1/collections/{name}/points        {"ids", "vectors", "payloads"}
    POST   /v1/collections/{name}/points/delete {"ids": [...]}
    GET    /v1/collections/{name}/points/{id}
    POST   /v1/collections/{name}/search        {"vector", "k", "filter", ...}
                                                or {"text", "text_field", ...}
                                                or {"plan": {...}, "explain"}
    POST   /v1/collections/{name}/count         {"filter": {...}}
    GET    /v1/collections/{name}/count
    POST   /v1/collections/{name}/compact       {"shard": N} (optional)
    POST   /v1/collections/{name}/rebalance     {"shards", "replicas"}
    GET    /v1/collections/{name}/shards
    GET    /v1/collections/{name}/stats
    GET    /v1/stats
    POST   /v1/snapshot                         {"path", "step"}
    POST   /v1/restore                          {"path", "generation"}
    POST   /v1/rpc                              raw protocol envelope

Because `ThreadingHTTPServer` handles each connection on its own thread,
concurrent single-vector searches naturally coalesce in the collection's
`RequestBatcher` behind the service.

Carried across from the JAX package's ``repro.serving.http`` unchanged but
for its imports, which resolve in this package: the same routes, status
codes and JSON bytes.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote

import numpy as np

from ..api import requests as rq
from .service import QuantixarService, ServiceConfig

ERROR_STATUS = {
    rq.SCHEMA_ERROR: 400,
    rq.INVALID_ARGUMENT: 400,
    rq.NOT_FOUND: 404,
    rq.UNAVAILABLE: 503,
    rq.INTERNAL: 500,
}


def _json_default(obj: Any):
    """numpy scalars/arrays inside stats payloads -> plain JSON."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def _invalid(message: str) -> rq.ApiError:
    return rq.error_to_exception(rq.ErrorInfo(rq.INVALID_ARGUMENT, message))


def _query_params(qs: str) -> Dict[str, Any]:
    """`?include_vector=false&k=5` -> typed scalars (GET routes have no
    body; the JSON body still wins on key collisions)."""
    out: Dict[str, Any] = {}
    for key, values in parse_qs(qs).items():
        value = values[-1]
        low = value.lower()
        if low in ("true", "1"):
            out[key] = True
        elif low in ("false", "0"):
            out[key] = False
        else:
            try:
                out[key] = int(value)
            except ValueError:
                try:
                    out[key] = float(value)
                except ValueError:
                    out[key] = value
    return out


def _build(cls, **kw) -> rq.Request:
    """Request constructor that turns bad/missing body keys into
    INVALID_ARGUMENT instead of a TypeError 500."""
    try:
        return cls(**kw)
    except TypeError as exc:
        raise _invalid(f"bad request body for {cls.op!r}: {exc}")


# (method, compiled path regex, builder(body, *path groups) -> Request)
_ROUTES: List[Tuple[str, "re.Pattern[str]", Callable[..., rq.Request]]] = []


def _route(method: str, pattern: str):
    def register(fn):
        _ROUTES.append((method, re.compile(pattern), fn))
        return fn
    return register


@_route("GET", r"^/v1/healthz$")
def _r_health(body):
    return rq.Health()


@_route("GET", r"^/v1/collections$")
def _r_list(body):
    return rq.ListCollections()


@_route("POST", r"^/v1/collections$")
def _r_create(body):
    schema = body.get("schema", body)
    return _build(rq.CreateCollection, schema=schema)


@_route("GET", r"^/v1/collections/([^/]+)$")
def _r_describe(body, name):
    return rq.DescribeCollection(collection=name)


@_route("DELETE", r"^/v1/collections/([^/]+)$")
def _r_drop(body, name):
    return rq.DropCollection(collection=name)


@_route("POST", r"^/v1/collections/([^/]+)/points$")
def _r_upsert(body, name):
    return _build(rq.Upsert, collection=name, **body)


@_route("POST", r"^/v1/collections/([^/]+)/points/delete$")
def _r_delete(body, name):
    return _build(rq.Delete, collection=name, **body)


@_route("GET", r"^/v1/collections/([^/]+)/points/([^/]+)$")
def _r_get(body, name, id_):
    # ?include_vector=false skips serializing the (possibly large) vector
    return rq.Get(collection=name, id=id_,
                  include_vector=bool(body.get("include_vector", True)))


@_route("POST", r"^/v1/collections/([^/]+)/search$")
def _r_search(body, name):
    return _build(rq.Search, collection=name, **body)


# POST carries an optional filter tree in the body; GET counts everything
@_route("POST", r"^/v1/collections/([^/]+)/count$")
@_route("GET", r"^/v1/collections/([^/]+)/count$")
def _r_count(body, name):
    return _build(rq.Count, collection=name, **body)


@_route("POST", r"^/v1/collections/([^/]+)/compact$")
def _r_compact(body, name):
    # ?shard=N (or body {"shard": N}) compacts one shard of a sharded
    # collection instead of the whole thing
    return _build(rq.Compact, collection=name, **body)


@_route("POST", r"^/v1/collections/([^/]+)/rebalance$")
def _r_rebalance(body, name):
    return _build(rq.Rebalance, collection=name, **body)


@_route("GET", r"^/v1/collections/([^/]+)/shards$")
def _r_shard_stats(body, name):
    return rq.ShardStats(collection=name)


@_route("GET", r"^/v1/collections/([^/]+)/stats$")
def _r_col_stats(body, name):
    return rq.Stats(collection=name)


@_route("GET", r"^/v1/stats$")
def _r_stats(body):
    return rq.Stats()


@_route("POST", r"^/v1/snapshot$")
def _r_snapshot(body):
    return _build(rq.Snapshot, **body)


@_route("POST", r"^/v1/restore$")
def _r_restore(body):
    return _build(rq.Restore, **body)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "quantixar"

    # silence per-request stderr logging (opt back in via server attribute)
    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_DELETE(self):
        self._handle("DELETE")

    def send_error(self, code, message=None, explain=None):
        """Stdlib-level failures (unsupported method, malformed request
        line, ...) must keep the JSON error contract — never an HTML page."""
        taxonomy = {404: rq.NOT_FOUND, 501: rq.INVALID_ARGUMENT}
        short = message or self.responses.get(code, ("unknown error",))[0]
        info = rq.ErrorInfo(
            taxonomy.get(code,
                         rq.INVALID_ARGUMENT if code < 500 else rq.INTERNAL),
            f"HTTP {code}: {short}")
        self._reply(code, False, info.to_dict())
        self.close_connection = True

    # ------------------------------------------------------------- internals
    @property
    def _service(self) -> QuantixarService:
        return self.server.quantixar_service

    def _read_body(self) -> Dict[str, Any]:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            raise _invalid("Content-Length header is not an integer")
        if length == 0:
            return {}
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise _invalid(f"request body is not valid JSON: {exc}")
        if not isinstance(body, dict):
            raise _invalid(
                f"request body must be a JSON object, "
                f"got {type(body).__name__}")
        return body

    def _handle(self, method: str) -> None:
        try:
            path, _, qs = self.path.partition("?")
            body = {**_query_params(qs), **self._read_body()}
            if path == "/v1/rpc" and method == "POST":
                ok, payload = self._service.dispatch_dict(body)
                code = 200 if ok else ERROR_STATUS.get(
                    payload.get("code", rq.INTERNAL), 500)
                return self._reply(code, ok, payload)
            for route_method, pattern, builder in _ROUTES:
                if route_method != method:
                    continue
                m = pattern.match(path)
                if m is None:
                    continue
                groups = [unquote(g) for g in m.groups()]
                request = builder(body, *groups)
                out = self._service.dispatch(request)
                if isinstance(out, rq.ErrorInfo):
                    return self._reply(ERROR_STATUS.get(out.code, 500),
                                       False, out.to_dict())
                return self._reply(200, True, out.to_dict())
            info = rq.ErrorInfo(rq.NOT_FOUND,
                                f"no route {method} {path}")
            return self._reply(404, False, info.to_dict())
        except rq.ApiError as exc:
            return self._reply(ERROR_STATUS.get(exc.code, 500), False,
                               exc.info.to_dict())
        except Exception as exc:             # noqa: BLE001 — no tracebacks
            info = rq.ErrorInfo(rq.INTERNAL,
                                f"{type(exc).__name__}: {exc}")
            return self._reply(500, False, info.to_dict())

    def _reply(self, status: int, ok: bool, payload: Dict[str, Any]) -> None:
        envelope = {"ok": ok, ("result" if ok else "error"): payload}
        try:
            data = json.dumps(envelope, default=_json_default).encode("utf-8")
        except TypeError as exc:
            status, data = 500, json.dumps({
                "ok": False,
                "error": rq.ErrorInfo(
                    rq.INTERNAL, f"unserializable response: {exc}").to_dict(),
            }).encode("utf-8")
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass                             # client went away mid-reply


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog is 5; a concurrent client wave
    # (the smoke test fires 100+ simultaneous connects) overflows it while
    # the first requests hold the accept loop, and overflowed connects
    # surface as connection-reset on loaded 1-core boxes
    request_queue_size = 256


class QuantixarHTTPServer:
    """Embedded server: `start()` for a background thread (tests, drivers),
    `serve_forever()` for a foreground process (`repro_torch.launch.serve`)."""

    def __init__(self, service: Optional[QuantixarService] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 config: Optional[ServiceConfig] = None,
                 verbose: bool = False):
        self.service = service or QuantixarService(config=config)
        self._httpd = _Server((host, port), _Handler)
        self._httpd.quantixar_service = self.service
        self._httpd.verbose = verbose
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "QuantixarHTTPServer":
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="quantixar-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def shutdown(self, close_service: bool = True) -> None:
        # BaseServer.shutdown() waits on serve_forever's exit event, which
        # only ever fires if serve_forever ran — guard so shutting down a
        # constructed-but-never-started server cannot hang forever
        if self._serving:
            self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()
        if close_service:
            self.service.close()

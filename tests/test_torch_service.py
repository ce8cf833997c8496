"""The port's service plane and cluster layer against the JAX package's.

Mirrors ``tests/test_service.py``'s classes on the CPU, with both packages
fed the same seeded numpy inputs: every scenario runs against each
package's embedded `Database` and against its `QuantixarClient` -> live
`QuantixarHTTPServer` -> `QuantixarService`, and the port's hits, counts,
entities and errors equal the JAX package's.  The wire is held to bytes:
the same HTTP exchanges against both servers return byte-equal bodies, and
each package's client speaks to the other's server.  Sharded collections
(hash-slot routing, replicas) equal one engine and the JAX package's
sharded collections hit for hit, survive rebalance, slot moves, replica
failover and save / load, and sharded databases saved by either package
load in the other.  Last, ``python -m repro_torch.launch.serve --smoke
--device cpu`` passes as a subprocess.
"""

import json
import os
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.api as japi
import repro.cluster as jcluster
import repro.core as jcore
import repro_torch.api as tapi
import repro_torch.cluster as tcluster
import repro_torch.core as tcore
from repro.api import requests as jrq
from repro.data.synthetic import gaussian_mixture
from repro.serving import batcher as jbatcher
from repro.serving.http import QuantixarHTTPServer as JHTTPServer
from repro.serving.service import QuantixarService as JService
from repro.serving.service import ServiceConfig as JServiceConfig
from repro_torch.api import requests as trq
from repro_torch.serving import batcher as tbatcher
from repro_torch.serving.http import QuantixarHTTPServer as THTTPServer
from repro_torch.serving.service import QuantixarService as TService
from repro_torch.serving.service import ServiceConfig as TServiceConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, SH_N = 200, 24, 160

PKGS = {
    "jax": types.SimpleNamespace(
        api=japi, core=jcore, rq=jrq, cluster=jcluster,
        db=lambda path=None: japi.Database(path),
        load=lambda path, **kw: japi.Database.load(path, **kw),
        service=lambda **kw: JService(japi.Database(), **kw),
        ServiceConfig=JServiceConfig, HTTP=JHTTPServer),
    "torch": types.SimpleNamespace(
        api=tapi, core=tcore, rq=trq, cluster=tcluster,
        db=lambda path=None: tapi.Database(path, device="cpu"),
        load=lambda path, **kw: tapi.Database.load(path, device="cpu", **kw),
        service=lambda **kw: TService(device="cpu", **kw),
        ServiceConfig=TServiceConfig, HTTP=THTTPServer),
}

_TEXTS = ["quick brown fox jumps high", "lazy dog sleeps all day",
          "quick fox and quick hare race", "vector database systems scale",
          "sparse retrieval uses bm25 scoring", "dense vectors meet keywords",
          "fox dens and fox kits", "ranking quality over speed"]


@pytest.fixture(scope="module")
def corpus():
    return gaussian_mixture(N, DIM, n_clusters=6, scale=0.2, seed=0)


@pytest.fixture(scope="module")
def queries():
    return gaussian_mixture(6, DIM, n_clusters=6, scale=0.2, seed=3)


@pytest.fixture()
def servers():
    """A live server of each package, on ephemeral ports."""
    out = {name: p.HTTP(p.service()).start() for name, p in PKGS.items()}
    yield out
    for srv in out.values():
        srv.shutdown()


@pytest.fixture(params=["embedded", "wire"])
def backends(request, servers):
    """Each package's backend of one kind: {"jax": ..., "torch": ...}."""
    if request.param == "embedded":
        out = {name: p.db() for name, p in PKGS.items()}
        yield out
        for db in out.values():
            db.close()
    else:
        yield {name: PKGS[name].api.QuantixarClient(srv.url, timeout=30)
               for name, srv in servers.items()}


def _ids(n=N):
    return [f"item-{i}" for i in range(n)]


def _payloads(n=N, text=False):
    out = [{"category": f"cat-{i % 4}", "price": float(i % 50),
            "in_stock": i % 3 == 0} for i in range(n)]
    if text:
        for i, p in enumerate(out):
            p["body"] = _TEXTS[i % len(_TEXTS)]
    return out


def _make(pkg, backend, corpus, name="items", n=N, shards=1, replicas=1,
          batcher=None, text=False, **vector_kw):
    api = PKGS[pkg].api
    vector_kw.setdefault("dim", DIM)
    vector_kw.setdefault("index", "flat")
    if vector_kw.get("quantization") == "pq":
        vector_kw.setdefault("pq", PKGS[pkg].core.PQConfig(m=8, k=16,
                                                           iters=4))
    fields = (api.KeywordField("category"), api.NumericField("price"),
              api.BoolField("in_stock"))
    if text:
        fields += (api.TextField("body"),)
    col = backend.create_collection(
        name=name, vector=api.VectorField(**vector_kw), fields=fields,
        batcher=batcher, shards=shards, replicas=replicas)
    col.upsert(_ids(n), corpus[:n], _payloads(n, text))
    return col


def _summary(hits):
    """Hits (or rows of hits) as comparable (id, score, payload) tuples."""
    if hits and isinstance(hits[0], list):
        return [_summary(h) for h in hits]
    return [(h.id, h.score, h.payload) for h in hits]


def _same(got, want, tag=""):
    """Equal hit summaries: ids and payloads exactly, scores to 1e-5."""
    assert len(got) == len(want), tag
    for g, w in zip(got, want):
        if isinstance(w, list):
            _same(g, w, tag)
            continue
        assert g[0] == w[0] and g[2] == w[2], tag
        assert g[1] == pytest.approx(w[1], rel=1e-5, abs=1e-6), tag


def _both(fn, backends, *args):
    """Run ``fn(pkg, backend, *args)`` for each package; (jax, torch)."""
    return fn("jax", backends["jax"], *args), \
        fn("torch", backends["torch"], *args)


# ---------------------------------------------------------------- scenarios
class TestBackendParity:
    """Each scenario of tests/test_service.py's TestBackendParity, on both
    packages, embedded and over the wire: the port's outcome equals the
    JAX package's."""

    def test_crud_roundtrip(self, backends, corpus):
        def run(pkg, backend):
            col = _make(pkg, backend, corpus)
            e = col.get("item-7")
            out = [e.id, e.payload, e.vector.tolist(), col.get("missing"),
                   "item-7" in col, "missing" in col]
            col.upsert("item-7", corpus[0], [{"category": "cat-0",
                                              "price": 1.0}])
            e2 = col.get("item-7")
            out += [e2.vector.tolist(), e2.payload, col.delete("item-7"),
                    col.delete("item-7"), col.get("item-7"), len(col)]
            return out
        j, t = _both(run, backends)
        assert t == j and t[-1] == N - 1

    def test_filtered_search(self, backends, corpus, queries):
        def run(pkg, backend):
            p = PKGS[pkg].api
            col = _make(pkg, backend, corpus)
            a = (col.query(queries[0]).filter(category="cat-1")
                 .where("price", "lt", 30).top_k(5).run())
            flt = p.And((p.Predicate("category", "eq", "cat-2"),
                         p.Predicate("in_stock", "eq", True)))
            b = col.query(queries[1]).filter(flt).top_k(4).run()
            return _summary(a), _summary(b)
        j, t = _both(run, backends)
        for g, w in zip(t, j):
            _same(g, w)
        assert all(h[2]["category"] == "cat-1" and h[2]["price"] < 30
                   for h in t[0]) and t[0]

    def test_batch_query_include_vector_and_empty(self, backends, corpus,
                                                  queries):
        def run(pkg, backend):
            col = _make(pkg, backend, corpus)
            rows = col.query(queries).top_k(3).run()
            single = col.query(queries[2]).top_k(3).include("vector").run()
            fresh = backend.create_collection(
                name="fresh",
                vector=PKGS[pkg].api.VectorField(dim=DIM, index="flat"))
            return (_summary(rows), [h.vector.tolist() for h in single],
                    fresh.query(queries[0]).top_k(5).run(),
                    fresh.query(queries[:3]).top_k(5).run())
        j, t = _both(run, backends)
        _same(t[0], j[0])
        assert t[1] == j[1] and t[2] == j[2] == [] \
            and t[3] == j[3] == [[], [], []]

    def test_compact_preserves_results(self, backends, corpus, queries):
        def run(pkg, backend):
            col = _make(pkg, backend, corpus)
            col.delete([f"item-{i}" for i in range(40)])
            before = col.query(queries[2]).top_k(10).run()
            return _summary(before), col.compact(), \
                _summary(col.query(queries[2]).top_k(10).run())
        j, t = _both(run, backends)
        _same(t[0], j[0])
        _same(t[2], t[0])
        assert t[1] == j[1] == 40

    def test_error_parity(self, backends, corpus, queries):
        def run(pkg, backend):
            p = PKGS[pkg].api
            col = _make(pkg, backend, corpus)
            attempts = [
                lambda: col.query(queries[0][:8]),
                lambda: col.query(queries[0]).filter(unknown=1),
                lambda: col.query(queries[0]).where("category", "lt", "x"),
                lambda: col.upsert([""], corpus[:1]),
                lambda: backend.create_collection(
                    name="items", vector=p.VectorField(dim=DIM)),
                lambda: backend.drop_collection("never-existed"),
                lambda: backend.collection("never-existed"),
            ]
            out = []
            for attempt in attempts:
                with pytest.raises((p.SchemaError, KeyError)) as info:
                    attempt()
                out.append(isinstance(info.value, p.SchemaError))
            return out
        j, t = _both(run, backends)
        assert t == j == [True] * 5 + [False] * 2

    def test_management_and_count(self, backends, corpus):
        def run(pkg, backend):
            p = PKGS[pkg].api
            backend.create_collection(name="a", vector=p.VectorField(dim=4))
            backend.create_collection(name="b", vector=p.VectorField(dim=4))
            names = sorted(backend.list_collections())
            backend.drop_collection("a")
            col = _make(pkg, backend, corpus)
            counts = [col.count(),
                      col.count(p.Predicate("category", "eq", "cat-2"))]
            col.delete(["item-2"])
            counts.append(col.count(p.Predicate("category", "eq", "cat-2")))
            return names, sorted(backend.list_collections()), counts
        j, t = _both(run, backends)
        assert t == j and t[2] == [N, N // 4, N // 4 - 1]


class TestQueryPlans:
    """Coarse-to-fine, explain, fusion and sparse / hybrid plans: the port
    equals the JAX package embedded and over the wire."""

    def test_plans_hit_for_hit(self, backends, corpus, queries):
        def run(pkg, backend):
            col = _make(pkg, backend, corpus, text=True)
            builders = [
                lambda c, q: c.query(q).top_k(6).stages(coarse_k=24),
                lambda c, q: (c.query(q).top_k(6)
                              .prefetch(category="cat-1")
                              .prefetch(vector=q, category="cat-2")
                              .fuse("rrf")),
                lambda c, q: (c.query(q).top_k(4)
                              .prefetch(category="cat-0")
                              .prefetch(category="cat-3")
                              .fuse("linear", weights=[0.7, 0.3])),
                lambda c, q: c.query().text("quick fox").top_k(3),
                lambda c, q: c.query(q).text("quick fox").top_k(4),
            ]
            hits = [_summary(b(col, queries[qi]).run())
                    for b in builders for qi in range(2)]
            ex = col.query(queries[0]).top_k(5).stages(oversample=4) \
                .explain()
            shape = [(s["stage"], s["k"], s["candidates_out"])
                     for s in ex.stages]
            return hits, ex.plan, shape, _summary(ex.hits)
        j, t = _both(run, backends)
        for g, w in zip(t[0], j[0]):
            _same(g, w)
        assert t[1] == j[1] and t[2] == j[2]
        _same(t[3], j[3])

    def test_pq_coarse_to_fine_reproduces_rescore(self, backends, corpus,
                                                  queries):
        """tests/test_service.py's coarse-to-fine check on the port: at
        coarse_k == rescore_multiplier * k the staged plan is the legacy
        rescore path hit for hit (codebooks differ between the packages,
        so each is held to itself)."""
        col = _make("torch", backends["torch"], corpus, quantization="pq")
        legacy = [col.query(q).top_k(10).rescore(True).run()
                  for q in queries]
        staged = [col.query(q).top_k(10).stages(coarse_k=40).run()
                  for q in queries]
        assert [[h.id for h in r] for r in staged] \
            == [[h.id for h in r] for r in legacy]


# -------------------------------------------------------------- wire details
def _raw(server, method, path, body=None):
    """(status, body bytes) of one HTTP exchange."""
    data = None if body is None else body.encode()
    req = urllib.request.Request(server.url + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


class TestWireBytes:
    def test_exchanges_byte_equal(self, servers):
        """The same requests against both servers return byte-equal JSON
        bodies and statuses: DDL, upserts, gets, counts, searches (integer
        rows under l2, so distances are exact in both), plans with
        explain's echo, deletes, errors."""
        rng = np.random.RandomState(7)
        x = rng.randint(-3, 4, (40, 8)).astype(float).tolist()
        schema = {"name": "ints", "vector": {"dim": 8, "metric": "l2",
                                             "index": "flat"},
                  "fields": [{"kind": "keyword", "name": "tag"}]}
        exchanges = [
            ("GET", "/v1/healthz", None),
            ("POST", "/v1/collections", json.dumps({"schema": schema})),
            ("GET", "/v1/collections", None),
            ("GET", "/v1/collections/ints", None),
            ("POST", "/v1/collections/ints/points", json.dumps(
                {"ids": [f"p{i}" for i in range(40)], "vectors": x,
                 "payloads": [{"tag": f"t{i % 3}"} for i in range(40)]})),
            ("GET", "/v1/collections/ints/points/p5", None),
            ("GET", "/v1/collections/ints/points/nope", None),
            ("GET", "/v1/collections/ints/count", None),
            ("POST", "/v1/collections/ints/count", json.dumps(
                {"filter": {"pred": {"column": "tag", "op": "eq",
                                     "value": "t1"}}})),
            ("POST", "/v1/collections/ints/search",
             json.dumps({"vector": x[3], "k": 7})),
            ("POST", "/v1/collections/ints/search",
             json.dumps({"vectors": x[:3], "k": 4})),
            ("POST", "/v1/collections/ints/search", json.dumps(
                {"vector": x[9], "k": 5, "include_vector": True,
                 "filter": {"pred": {"column": "tag", "op": "eq",
                                     "value": "t2"}}})),
            ("POST", "/v1/collections/ints/points/delete",
             json.dumps({"ids": ["p3", "p4", "zz"]})),
            ("POST", "/v1/collections/ints/search",
             json.dumps({"vector": x[3], "k": 3})),
            ("POST", "/v1/collections/ints/compact", "{}"),
            ("POST", "/v1/collections/ints/search",
             json.dumps({"vector": [1.0, 2.0], "k": 3})),
            ("GET", "/nope", None),
            ("GET", "/v1/collections/ghost", None),
            ("POST", "/v1/collections", '{"schema": "not-a-dict"}'),
            ("POST", "/v1/collections", "not json at all"),
            ("POST", "/v1/snapshot", '{"bogus_key": 1}'),
            ("POST", "/v1/rpc", '{"op": "no_such_op"}'),
            ("POST", "/v1/rpc", '{"v": 99, "op": "health"}'),
            ("POST", "/v1/collections/ints/rebalance",
             json.dumps({"shards": 2})),
            ("DELETE", "/v1/collections/ints", None),
        ]
        for method, path, body in exchanges:
            want = _raw(servers["jax"], method, path, body)
            got = _raw(servers["torch"], method, path, body)
            assert got == want, (method, path)
            assert b"Traceback" not in got[1]

    def test_request_envelopes_byte_equal(self):
        """Every request type encodes to the same JSON bytes."""
        vec = [0.5, -1.0, 2.0]

        def envelopes(rq, api):
            flt = api.And((api.Predicate("a", "eq", "x"),
                           api.Not(api.Predicate("b", "lt", 3.0))))
            return [
                rq.Health(), rq.ListCollections(),
                rq.CreateCollection(schema={"name": "c",
                                            "vector": {"dim": 3}}),
                rq.Upsert(collection="c", ids=["a"], vectors=[vec],
                          payloads=[{"a": "x"}]),
                rq.Delete(collection="c", ids=["a", "b"]),
                rq.Get(collection="c", id="a"),
                rq.Search(collection="c", vector=vec, k=3,
                          filter=rq.filter_to_dict(flt)),
                rq.Count(collection="c", filter=rq.filter_to_dict(flt)),
                rq.Compact(collection="c", shard=1),
                rq.Rebalance(collection="c", shards=3, replicas=2),
                rq.ShardStats(collection="c"), rq.Stats(),
                rq.Snapshot(path="/p", step=2),
                rq.Restore(path="/p", generation=1)]

        for j, t in zip(envelopes(jrq, japi), envelopes(trq, tapi)):
            assert json.dumps(t.to_dict()).encode() \
                == json.dumps(j.to_dict()).encode()
            assert type(trq.decode_request(j.to_dict())).__name__ \
                == type(j).__name__

    def test_clients_cross_servers(self, servers, corpus, queries):
        """Each package's client drives the other's server with the hits
        the server's own client gets."""
        for client_pkg, server_pkg in (("torch", "jax"), ("jax", "torch")):
            srv = servers[server_pkg]
            own = PKGS[server_pkg].api.QuantixarClient(srv.url, timeout=30)
            other = PKGS[client_pkg].api.QuantixarClient(srv.url, timeout=30)
            _make(client_pkg, other, corpus, name=f"x{client_pkg}", n=80)
            a = own.collection(f"x{client_pkg}").query(queries[0]) \
                .top_k(5).run()
            b = other.collection(f"x{client_pkg}").query(queries[0]) \
                .filter(category="cat-1").top_k(5).run()
            assert [h.id for h in other.collection(f"x{client_pkg}")
                    .query(queries[0]).top_k(5).run()] == [h.id for h in a]
            assert b and all(h.payload["category"] == "cat-1" for h in b)

    def test_single_vector_searches_coalesce(self, servers, corpus,
                                             queries):
        srv = servers["torch"]
        client = tapi.QuantixarClient(srv.url, timeout=30)
        remote = _make("torch", client, corpus, batcher=tapi.BatcherConfig(
            max_batch=16, max_wait_ms=20.0))
        results = [None] * 32

        def worker(base):
            for j in range(8):
                results[base + j] = (remote.query(queries[base % 6])
                                     .top_k(5).run())

        threads = [threading.Thread(target=worker, args=(i * 8,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None for r in results)
        stats = remote.stats()
        assert stats["serving_requests_served"] >= 32
        assert stats["serving_batches_served"] \
            < stats["serving_requests_served"]
        col = srv.service.db.collection("items")
        assert col.batcher.batches_served == stats["serving_batches_served"]

    def test_service_config_snapshot_restore(self, servers, corpus, queries,
                                             tmp_path):
        service = TService(device="cpu", config=TServiceConfig(
            default_max_batch=5, default_max_wait_ms=9.0))
        out = service.dispatch(trq.CreateCollection(
            schema={"name": "c", "vector": {"dim": 4, "index": "flat"}}))
        assert isinstance(out, trq.CollectionInfo)
        assert service.db.collection("c").schema.batcher \
            == tapi.BatcherConfig(max_batch=5, max_wait_ms=9.0)
        service.close()
        client = tapi.QuantixarClient(servers["torch"].url, timeout=30)
        remote = _make("torch", client, corpus)
        remote.delete(["item-0", "item-1"])
        before = [h.id for h in remote.query(queries[0]).top_k(5).run()]
        assert client.snapshot(str(tmp_path), step=2) == 1
        remote.delete([f"item-{i}" for i in range(2, 50)])
        assert client.restore(str(tmp_path)) == ["items"]
        restored = client.collection("items")
        assert len(restored) == N - 2
        assert [h.id for h in
                restored.query(queries[0]).top_k(5).run()] == before
        assert servers["torch"].service.db.device == "cpu"
        # the JAX package's server restores the same snapshot
        jclient = japi.QuantixarClient(servers["jax"].url, timeout=30)
        assert jclient.restore(str(tmp_path)) == ["items"]
        assert [h.id for h in jclient.collection("items").query(queries[0])
                .top_k(5).run()] == before


class TestServerLifecycle:
    def test_shutdown_without_start_does_not_hang(self):
        THTTPServer(TService(device="cpu")).shutdown()

    def test_closed_collection_does_not_resurrect_batcher(self, corpus,
                                                          queries):
        db = tapi.Database(device="cpu")
        col = db.create_collection(
            name="doomed", vector=tapi.VectorField(dim=DIM, index="flat"))
        col.upsert(_ids(20), corpus[:20], None)
        col.query(queries[0]).top_k(2).run()
        db.drop_collection("doomed")
        with pytest.raises(tapi.CollectionClosed):
            col.query(queries[0]).top_k(2).run()
        assert col._batcher is None
        db.close()

    def test_client_timeout_forwarded(self, servers, corpus, queries):
        client = tapi.QuantixarClient(servers["torch"].url, timeout=30)
        col = _make("torch", client, corpus, n=50)
        assert len(col.query(queries[0]).top_k(3).run(timeout=30.0)) == 3


def test_quorum_fanout_matches_reference():
    """QuorumFanout merges what answers within the deadline, as the
    reference's does; a shard that raises drops out; below the quorum it
    raises TimeoutError."""
    rng = np.random.RandomState(2)
    legs = [(np.sort(rng.rand(3, 4).astype(np.float32), 1),
             rng.randint(0, 99, (3, 4))) for _ in range(3)]

    def fns(fail):
        def make(i):
            def fn(q, k):
                if i == fail:
                    raise RuntimeError("down")
                return legs[i]
            return fn
        return [make(i) for i in range(3)]

    for fail in (None, 1):
        want = jbatcher.QuorumFanout(fns(fail), min_quorum=2).search(None, 5)
        fan = tbatcher.QuorumFanout(fns(fail), min_quorum=2)
        got = fan.search(None, 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert fan.last_responders == (3 if fail is None else 2)
    with pytest.raises(TimeoutError):
        tbatcher.QuorumFanout(fns(0), min_quorum=3).search(None, 5)


# ------------------------------------------------------------------ sharding
_SH_QUANTS = {"none": {}, "pq": {"quantization": "pq"},
              "bq": {"quantization": "bq"}}


def _sharded_pair(pkg, backend, corpus, shards=3, replicas=1, **vector_kw):
    return [_make(pkg, backend, corpus, name=name, n=SH_N, shards=s,
                  replicas=r, text=True, **vector_kw)
            for name, s, r in (("sharded_tw", shards, replicas),
                               ("single_tw", 1, 1))]


def _sh_builders(n=SH_N):
    """Exact under every quantization: coarse_k covers the corpus, so the
    exact rescore decides the ranking on every side."""
    return {
        "dense": lambda c, q: c.query(q).top_k(8).stages(coarse_k=n),
        "filtered": lambda c, q: (c.query(q).filter(category="cat-1")
                                  .where("price", "lt", 30).top_k(8)
                                  .stages(coarse_k=n)),
        "hybrid": lambda c, q: (c.query(q).top_k(6)
                                .prefetch(k=n, coarse_k=n)
                                .prefetch(text="quick fox", k=n)
                                .fuse("rrf")),
    }


class TestShardedParity:
    @pytest.mark.parametrize("quant", sorted(_SH_QUANTS))
    def test_sharded_matches_single_and_jax(self, backends, corpus, queries,
                                            quant):
        """The port's sharded collection equals its single-engine twin and
        the JAX package's sharded collection, hit for hit, embedded and
        over the wire, batched queries included."""
        def run(pkg, backend):
            sharded, single = _sharded_pair(pkg, backend, corpus,
                                            **_SH_QUANTS[quant])
            out = []
            for mode, build in _sh_builders().items():
                for qi in range(2):
                    got = _summary(build(sharded, queries[qi]).run())
                    _same(got, _summary(build(single, queries[qi]).run()),
                          f"{pkg}/{quant}/{mode}/q{qi}")
                    out.append(got)
            wide = sharded.query(queries[:3]).top_k(5) \
                .stages(coarse_k=SH_N).run()
            _same(_summary(wide), _summary(
                single.query(queries[:3]).top_k(5).stages(coarse_k=SH_N)
                .run()), f"{pkg}/{quant}/batched")
            return out + [_summary(wide)]
        j, t = _both(run, backends)
        for g, w in zip(t, j):
            _same(g, w, f"torch vs jax, {quant}")

    def test_sharded_crud_stats_and_compact(self, backends, corpus):
        def run(pkg, backend):
            api = PKGS[pkg].api
            sharded, single = _sharded_pair(pkg, backend, corpus)
            e = sharded.get("item-7")
            out = [len(sharded), e.id, e.payload, sharded.get("missing"),
                   sharded.delete(["item-7", "item-8", "missing"]),
                   len(sharded),
                   sharded.count(api.Predicate("category", "eq", "cat-1")),
                   single.count(api.Predicate("category", "eq", "cat-1"))]
            ss = sharded.shard_stats()
            out += [len(ss), sum(s["rows"] for s in ss),
                    sum(s["tombstones"] for s in ss),
                    [s["slots"] for s in ss]]
            sharded.delete([f"item-{i}" for i in range(20)])
            per = [s["tombstones"] for s in sharded.shard_stats()]
            out += [per, sharded.compact(shard=0), sharded.compact(),
                    len(single.shard_stats())]
            return out
        j, t = _both(run, backends)
        assert t == j
        assert t[0] == SH_N and t[8] == 3 and t[9] == SH_N


class TestShardedTopology:
    """Rebalance / split / slot moves / replica failover / save-load on the
    port, each against the JAX package doing the same."""

    def test_rebalance_move_slot_preserve_results(self, corpus, queries,
                                                  tmp_path):
        def run(pkg):
            db = PKGS[pkg].db()
            sharded, single = _sharded_pair(pkg, db, corpus)
            build = _sh_builders()["hybrid"]
            want = [_summary(build(single, q).run()) for q in queries[:2]]
            infos = []
            for step, mutate in (
                    ("grow", lambda: sharded.rebalance(shards=5)),
                    ("shrink", lambda: sharded.rebalance(
                        shards=2, snapshot_dir=str(tmp_path / pkg))),
                    ("split", lambda: sharded.split(0)),
                    ("replicate", lambda: sharded.rebalance(replicas=2))):
                info = mutate()
                infos.append((info["shards"], info["replicas"],
                              info["rows"]))
                for qi in range(2):
                    _same(_summary(build(sharded, queries[qi]).run()),
                          want[qi], f"{pkg} after {step}")
            slot = PKGS[pkg].cluster.slot_of("item-0")
            owner = sharded._router.slot_map[slot]
            before = [h.id for h in sharded.query(queries[0]).top_k(10).run()]
            sharded.move_slot(slot, (owner + 1) % sharded.num_shards)
            after = [h.id for h in sharded.query(queries[0]).top_k(10).run()]
            sharded.upsert("item-0", corpus[1], [{"category": "cat-9",
                                                  "body": "quick fox"}])
            out = (infos, before == after, sharded.num_shards,
                   list(sharded._router.slot_map),
                   sharded.get("item-0").payload["category"])
            db.close()
            return out
        assert run("torch") == run("jax")

    def test_slot_hash_is_the_reference(self):
        ids = [f"item-{i}" for i in range(500)] + ["", "ü-é", "x" * 300]
        assert [tcluster.slot_of(i) for i in ids] \
            == [jcluster.slot_of(i) for i in ids]
        assert tcluster.HASH_SLOTS == jcluster.HASH_SLOTS
        for n in (1, 3, 7):
            assert tcluster.Router.even(n).slot_map \
                == jcluster.Router.even(n).slot_map

    def test_replica_failover(self, corpus, queries):
        db = tapi.Database(device="cpu")
        sharded, single = _sharded_pair("torch", db, corpus, shards=2,
                                        replicas=2)
        want = _summary(single.query(queries[0]).top_k(8).run())
        _same(_summary(sharded.query(queries[0]).top_k(8).run()), want)
        sharded.set_replica_health(0, 0, False)
        _same(_summary(sharded.query(queries[0]).top_k(8).run()), want)
        assert sharded.get("item-0") is not None
        sharded.set_replica_health(0, 1, False)
        with pytest.raises(tapi.ShardUnavailable):
            sharded.query(queries[0]).top_k(8).run()
        sharded.set_replica_health(0, 0, True)
        _same(_summary(sharded.query(queries[0]).top_k(8).run()), want)
        db.close()

    @pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                               ("torch", "jax"),
                                               ("torch", "torch")])
    def test_sharded_checkpoint_crosses_packages(self, corpus, queries,
                                                 tmp_path, writer, reader):
        """A database with a sharded, replicated collection saved by either
        package loads in the other: same routing, rows, tombstones and
        hits, and the restored collection takes writes and rebalances."""
        db = PKGS[writer].db(str(tmp_path))
        sharded, _ = _sharded_pair(writer, db, corpus, shards=3, replicas=2)
        sharded.delete(["item-3"])
        want = _summary(sharded.query(queries[0]).top_k(8).run())
        slot_map = list(sharded._router.slot_map)
        db.save()
        db.close()
        db2 = PKGS[reader].load(str(tmp_path))
        col = db2.collection("sharded_tw")
        assert isinstance(col, PKGS[reader].api.ShardedCollection)
        assert col.num_shards == 3 and col.schema.replicas == 2
        assert list(col._router.slot_map) == slot_map
        assert len(col) == SH_N - 1 and col.get("item-3") is None
        _same(_summary(col.query(queries[0]).top_k(8).run()), want)
        col.upsert("item-new", corpus[0], [{"category": "cat-0",
                                            "body": "quick fox"}])
        col.rebalance(shards=2)
        assert col.get("item-new") is not None
        db2.close()


class TestShardedWire:
    def test_sharded_ops_over_wire(self, servers, corpus, queries):
        """Rebalance / ShardStats / per-shard Compact over the port's
        server, with the JAX server's answers beside them."""
        def run(pkg):
            srv = servers[pkg]
            client = PKGS[pkg].api.QuantixarClient(srv.url, timeout=30)
            remote = _make(pkg, client, corpus, name="swire", n=SH_N,
                           shards=3)
            want = [h.id for h in remote.query(queries[0]).top_k(8).run()]
            ss = remote.shard_stats()
            out = [len(ss), sum(s["rows"] for s in ss),
                   [s["health"] for s in ss]]
            info = remote.rebalance(shards=2)
            out += [info["shards"], info["rows"], len(remote.shard_stats()),
                    [h.id for h in remote.query(queries[0]).top_k(8).run()]
                    == want]
            remote.delete([f"item-{i}" for i in range(10)])
            out += [remote.compact(shard=0) + remote.compact(shard=1),
                    remote.compact()]
            _make(pkg, client, corpus, name="unsharded", n=20)
            for method, path, body in (
                    ("GET", "/v1/collections/swire/shards", None),
                    ("POST", "/v1/collections/unsharded/rebalance",
                     json.dumps({"shards": 2})),
                    ("POST", "/v1/collections/unsharded/compact",
                     json.dumps({"shard": 0}))):
                status, body = _raw(srv, method, path, body)
                out.append((status, json.loads(body)["ok"]))
            stats = remote.stats()
            out += [stats["shards"], stats["live"], len(stats["per_shard"])]
            ex = remote.query(queries[0]).top_k(5).explain()
            ann = next(s for s in ex.stages if s["stage"] == "ann")
            out.append(len(ann["shards"]))
            return out
        assert run("torch") == run("jax")

    def test_sharded_snapshot_restore_over_wire(self, servers, corpus,
                                                queries, tmp_path):
        client = tapi.QuantixarClient(servers["torch"].url, timeout=30)
        remote = _make("torch", client, corpus, name="snapme", n=SH_N,
                       shards=3)
        remote.delete(["item-0"])
        want = [h.id for h in remote.query(queries[1]).top_k(8).run()]
        gen = client.snapshot(str(tmp_path))
        remote.delete([f"item-{i}" for i in range(1, 40)])
        assert "snapme" in client.restore(str(tmp_path), generation=gen)
        restored = client.collection("snapme")
        assert restored.schema.shards == 3 and len(restored) == SH_N - 1
        assert [h.id for h in
                restored.query(queries[1]).top_k(8).run()] == want


def test_serve_smoke_cli_on_cpu():
    """``python -m repro_torch.launch.serve --smoke --device cpu``: server
    on an ephemeral port, concurrent client queries, recall, coalescing,
    plan parity, clean shutdown; the exit code tells."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--n", "600", "--dim", "16", "--index", "flat",
         "--requests", "24"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[smoke] PASSED" in proc.stdout
    check = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch.launch.serve, repro_torch.api, "
         "repro_torch.serving.http, repro_torch.cluster; "
         "print(sorted(m for m in sys.modules "
         "if m == 'jax' or m == 'repro' or m.startswith('repro.')))"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert check.stdout.strip() == "[]", check.stdout + check.stderr

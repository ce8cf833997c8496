"""The port's public API (``repro_torch.api``) against the JAX package's
(``repro.api``) on the CPU.

The same numpy inputs, made from a seed, go through both packages (the port
with ``device="cpu"``, so every kernel takes its plain version): schemas,
compiled plans and wire requests serialize to equal dicts; exact
collections return equal hits; checkpoints written by either package load
in the other with equal hits; the batcher path equals the direct one;
sharded and IVF collections build and load.
"""

import threading
import types

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
import repro_torch.api as tapi
import repro_torch.core as tcore
from repro.api import plan as jplan
from repro.api import requests as jreq
from repro_torch.api import plan as tplan
from repro_torch.api import requests as treq

N, DIM = 600, 16
SCORE_TOL = dict(rtol=2e-4, atol=2e-4)
PACKAGES = {"jax": (japi, jcore), "torch": (tapi, tcore)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    centers = rng.randn(8, DIM).astype(np.float32)
    x = (centers[rng.randint(0, 8, N)]
         + 0.3 * rng.randn(N, DIM)).astype(np.float32)
    q = (centers[rng.randint(0, 8, 12)]
         + 0.3 * rng.randn(12, DIM)).astype(np.float32)
    words = [f"w{i}" for i in range(50)]
    payloads = [{"cat": f"c{i % 4}", "price": float(i % 50),
                 "in_stock": i % 3 == 0,
                 "title": " ".join(rng.choice(words, 4))} for i in range(N)]
    return x, q, [f"id-{i}" for i in range(N)], payloads


def _schema(pkg, name="items", fields=True, **vec):
    api, core = PACKAGES[pkg]
    vec.setdefault("dim", DIM)
    if vec.get("quantization") == "pq":
        vec["pq"] = core.PQConfig(m=8, k=64)
    if vec.get("quantization") == "bq":
        vec["bq"] = core.BQConfig(bits=64)
    flds = (api.KeywordField("cat"), api.NumericField("price"),
            api.BoolField("in_stock"), api.TextField("title")) \
        if fields else ()
    return api.CollectionSchema(name=name, vector=api.VectorField(**vec),
                                fields=flds)


def _db(pkg, path=None):
    return (japi.Database(path) if pkg == "jax"
            else tapi.Database(path, device="cpu"))


def _load(pkg, path):
    return (japi.Database.load(path) if pkg == "jax"
            else tapi.Database.load(path, device="cpu"))


def _hits(hits):
    """(ids, scores) of a hit list, or of each list of a batched result."""
    if hits and isinstance(hits[0], list):
        return [_hits(h) for h in hits]
    return [h.id for h in hits], np.array([h.score for h in hits])


def _assert_same_hits(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_hits(g, w)
        return
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], **SCORE_TOL)


# ---------------------------------------------------------------------------
# wire dicts: schemas, plans, requests
# ---------------------------------------------------------------------------

VECTOR_FIELDS = [{}, {"metric": "l2", "index": "flat"},
                 {"metric": "dot", "ef_search": 99, "builder": "incremental"},
                 {"quantization": "pq"}, {"quantization": "bq"},
                 {"index": "ivf"}, {"metric": "hamming"},
                 {"rescore": False, "rescore_multiplier": 8}]


@pytest.mark.parametrize("vec", VECTOR_FIELDS)
def test_schema_dicts_equal_and_cross_load(vec):
    want = _schema("jax", **dict(vec))
    got = _schema("torch", **dict(vec))
    assert got.to_dict() == want.to_dict()
    assert tapi.CollectionSchema.from_dict(want.to_dict()).to_dict() \
        == want.to_dict()
    assert japi.CollectionSchema.from_dict(got.to_dict()).to_dict() \
        == got.to_dict()


def test_schema_options_and_metrics_equal():
    from repro.api import schema as jschema
    from repro_torch.api import schema as tschema
    assert tcore.available_metrics() == jcore.available_metrics()
    for name in ("INDEXES", "QUANTIZATIONS", "BUILDERS", "RESERVED_NAMES",
                 "FIELD_OPS"):
        assert getattr(tschema, name) == getattr(jschema, name)
    dicts = []
    for api, _ in PACKAGES.values():
        dicts.append(api.CollectionSchema(
            name="b", vector=api.VectorField(dim=4),
            fields=(api.TextField("t", stopwords=("x",), min_token_len=3),),
            batcher=api.BatcherConfig(max_batch=8,
                                      max_wait_ms=1.5)).to_dict())
    assert dicts[0] == dicts[1]
    with pytest.raises(tapi.SchemaError):
        tapi.VectorField(dim=8, metric="nope")


def _fluent(pkg, q, q2):
    """The same fluent queries in either package, compiled to plan dicts."""
    api = PACKAGES[pkg][0]
    schema = _schema(pkg)
    col = types.SimpleNamespace(schema=schema)
    base = api.Query(col, q)
    either = api.Or((api.Predicate("cat", "eq", "c1"),
                     api.Not(api.Predicate("in_stock", "eq", True))))
    queries = [
        base.top_k(5),
        base.filter(cat="c1").where("price", "lt", 20.0).top_k(7).ef(40)
            .expansion_width(2),
        base.filter(either).top_k(3).rescore(False),
        base.stages(coarse_k=30).top_k(5),
        base.stages(oversample=3),
        base.prefetch(q2, k=20, cat="c2").prefetch(text="w3 w4")
            .fuse("rrf", rrf_k=30).top_k(6),
        base.prefetch(q2, coarse_k=40).prefetch(ef=50, filter=either)
            .fuse("linear", weights=(0.7, 0.3)),
        base.text("w1 w2"),
        api.Query(col, None).text("w5", field="title").top_k(4),
        api.Query(col, np.stack([q, q2])).filter(cat="c3").top_k(2),
    ]
    plan = jplan if pkg == "jax" else tplan
    return [plan.plan_to_dict(plan.validate_plan(schema, qq._compile()))
            for qq in queries]


def test_plan_dicts_equal(data):
    _, q, _, _ = data
    want = _fluent("jax", q[0], q[1])
    got = _fluent("torch", q[0], q[1])
    assert got == want
    for d in want:       # a JAX plan dict parses in the port, and back
        assert tapi.plan_to_dict(tapi.plan_from_dict(d)) == d
        assert japi.plan_to_dict(japi.plan_from_dict(
            tapi.plan_to_dict(tapi.plan_from_dict(d)))) == d


def test_request_dicts_equal(data):
    x, q, ids, payloads = data
    assert sorted(treq._REQUEST_TYPES) == sorted(jreq._REQUEST_TYPES)
    assert treq.PROTOCOL_VERSION == jreq.PROTOCOL_VERSION
    plan = _fluent("jax", q[0], q[1])[5]

    def requests(rq, api):
        flt = api.And((api.Predicate("cat", "in", ["c1", "c2"]),
                       api.Predicate("price", "ge", 3.0)))
        return [
            rq.CreateCollection(schema=_schema("jax").to_dict()),
            rq.Upsert(collection="items", ids=ids[:3],
                      vectors=x[:3].tolist(), payloads=payloads[:3]),
            rq.Delete(collection="items", ids=ids[:2]),
            rq.Get(collection="items", id="id-5"),
            rq.Search(collection="items", vector=q[0].tolist(), k=4,
                      filter=rq.filter_to_dict(flt), ef=33),
            rq.Search(collection="items", plan=plan, explain=True),
            rq.Search(collection="items", text="w1", text_field="title"),
            rq.Count(collection="items", filter=rq.filter_to_dict(flt)),
            rq.Compact(collection="items"),
            rq.Stats(), rq.Health(), rq.ListCollections(),
        ]

    for got, want in zip(requests(treq, tapi), requests(jreq, japi)):
        assert got.to_dict() == want.to_dict()
        assert treq.decode_request(want.to_dict()).to_dict() \
            == want.to_dict()
    err = jreq.ErrorInfo(code="NOT_FOUND", message="no such collection")
    assert treq.ErrorInfo.from_dict(err.to_dict()).to_dict() == err.to_dict()


# ---------------------------------------------------------------------------
# hits of an exact collection
# ---------------------------------------------------------------------------

def _exact_scenario(pkg, data, metric):
    """Plain, filtered, batched, count, recommend, delete + compact and
    hybrid queries on a flat collection; returns every result in order."""
    x, q, ids, payloads = data
    api = PACKAGES[pkg][0]
    db = _db(pkg)
    col = db.create_collection(_schema(pkg, index="flat", metric=metric))
    col.upsert(ids, x, payloads)
    out = [_hits(col.query(q[0]).top_k(10).run()),
           _hits(col.query(q).top_k(5).run()),
           _hits(col.query(q[1]).filter(cat="c2")
                 .where("price", "lt", 25.0).top_k(8).run()),
           col.count(), col.count(api.Predicate("in_stock", "eq", True)),
           _hits(col.recommend(["id-3", "id-10"], ["id-7"]).top_k(6).run()),
           _hits(col.query(q[2]).text("w1 w7").top_k(10).run()),
           _hits(col.query(None).text("w4 w9").top_k(10).run())]
    col.delete(ids[:40])
    col.upsert(ids[40:60], x[:20] + 0.01, payloads[:20])   # replaced ids
    out += [_hits(col.query(q).top_k(5).run()), col.count(), len(col)]
    assert col.compact() == 60
    out += [_hits(col.query(q[:4]).filter(cat="c1").top_k(5).run()),
            _hits(col.query(x[0] + 0.01).top_k(3).run()), col.tombstones]
    db.close()
    return out


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_exact_collection_hits_equal(data, metric):
    want = _exact_scenario("jax", data, metric)
    got = _exact_scenario("torch", data, metric)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, int):
            assert g == w
        else:
            _assert_same_hits(g, w)


# ---------------------------------------------------------------------------
# checkpoints cross both ways
# ---------------------------------------------------------------------------

KINDS = {"hnsw": {}, "flat": {"index": "flat"},
         "pq": {"quantization": "pq"}, "bq": {"quantization": "bq"}}


def _populate(pkg, data):
    x, _, ids, payloads = data
    db = _db(pkg)
    for name, vec in KINDS.items():
        col = db.create_collection(_schema(pkg, name=name, **dict(vec)))
        col.upsert(ids[:500], x[:500], payloads[:500])
        col.query(x[0]).top_k(1).run()            # build the index
        col.upsert(ids[500:], x[500:], payloads[500:])   # delta rows
        col.delete(ids[:5])
    return db


def _readings(db, data):
    _, q, _, _ = data
    out = {}
    for name in KINDS:
        col = db[name]
        out[name] = [_hits(col.query(q).top_k(5).run()),
                     _hits(col.query(q[0]).filter(cat="c1").top_k(5).run()),
                     _hits(col.query(q[1]).text("w2 w3").top_k(5).run()),
                     len(col), col.tombstones]
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoint_crosses_packages(data, tmp_path, writer, reader):
    db = _populate(writer, data)
    want = _readings(db, data)
    db.save(str(tmp_path))
    db.close()
    loaded = _load(reader, str(tmp_path))
    assert loaded.list_collections() == sorted(KINDS)
    got = _readings(loaded, data)
    for name in KINDS:
        assert loaded[name].schema.to_dict() == \
            _schema(writer, name=name, **dict(KINDS[name])).to_dict()
        assert loaded[name].stats()["index_builds"] == 0 or \
            KINDS[name].get("index") == "flat"
        for g, w in zip(got[name], want[name]):
            if isinstance(w, int):
                assert g == w
            else:
                _assert_same_hits(g, w)
    loaded.close()


# ---------------------------------------------------------------------------
# the batcher path, devices and what is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", ["flat", "hnsw"])
def test_concurrent_single_queries_equal_direct(data, index):
    x, q, ids, payloads = data
    db = tapi.Database(device="cpu")
    col = db.create_collection(_schema(
        "torch", index=index),
        batcher=tapi.BatcherConfig(max_batch=8, max_wait_ms=20.0))
    col.upsert(ids, x, payloads)
    queries = np.concatenate([q, x[::50] + 0.05])
    direct = [_hits(h) for h in col.query(queries).top_k(6).run()]
    got = [None] * len(queries)

    def one(i):
        got[i] = _hits(col.query(queries[i]).top_k(6).run())

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, direct):
        _assert_same_hits(g, w)
    stats = col.stats()
    assert stats["serving_requests_served"] == len(queries)
    assert stats["serving_batches_served"] < len(queries)   # coalesced
    db.close()


def test_sharded_layout_raises(tmp_path):
    """Sharded layouts (ROADMAP A10) no longer raise: the port creates
    shards > 1 and replicas > 1 collections with the exact hits of one
    engine, and loads a sharded database the JAX package saved, hit for hit
    (tests/test_torch_service.py holds the cluster layer in full).  Named
    for the raise it held before A10, kept so that runs before and after the
    port compare test by test."""
    x, q = _small()
    db = tapi.Database(device="cpu")
    one = db.create_collection(_schema("torch", name="one", fields=False,
                                       index="flat"))
    one.upsert([f"id-{i}" for i in range(len(x))], x)
    want = _hits(one.query(q).top_k(5).run())
    for name, kw in (("s", dict(shards=2)), ("r", dict(replicas=2))):
        col = db.create_collection(_schema("torch", name=name, fields=False,
                                           index="flat"), **kw)
        assert isinstance(col, tapi.ShardedCollection)
        col.upsert([f"id-{i}" for i in range(len(x))], x)
        _assert_same_hits(_hits(col.query(q).top_k(5).run()), want)
    jdb = japi.Database()
    jcol = jdb.create_collection(_schema("jax", fields=False, index="flat"),
                                 shards=2)
    jcol.upsert([f"id-{i}" for i in range(len(x))], x)
    jwant = _hits(jcol.query(q).top_k(5).run())
    jdb.save(str(tmp_path))
    jdb.close()
    loaded = tapi.Database.load(str(tmp_path), device="cpu")
    col = loaded.collection("items")
    assert isinstance(col, tapi.ShardedCollection) and col.num_shards == 2
    _assert_same_hits(_hits(col.query(q).top_k(5).run()), jwant)
    _assert_same_hits(jwant, want)
    loaded.close()
    db.close()


def _small():
    rng = np.random.RandomState(4)
    return (rng.randn(120, DIM).astype(np.float32),
            rng.randn(3, DIM).astype(np.float32))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA the default device raises instead of running on the
    host; an explicit CPU device works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.Database().create_collection(_schema("torch"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.Database().create_collection(_schema("torch"), shards=2)
    col = tapi.Database(device="cpu").create_collection(_schema("torch"))
    assert col.device == torch.device("cpu")
    # an IVF collection (ROADMAP A8, which raised before) on the CPU
    x, q = _small()
    col = tapi.Database(device="cpu").create_collection(
        _schema("torch", name="ivf", fields=False, index="ivf"))
    col.upsert([f"id-{i}" for i in range(len(x))], x)
    hits = col.query(x[:3]).top_k(2).run()
    assert [h[0].id for h in hits] == ["id-0", "id-1", "id-2"]
    assert col.stats()["ivf_lists"] == 64

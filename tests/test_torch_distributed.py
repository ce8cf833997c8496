"""The port's distributed search against the JAX package's, on the CPU.

The JAX reference (``repro.distributed.search``) runs in a subprocess with
``--xla_force_host_platform_device_count=8``, as ``tests/test_distributed.py``
runs it; the port (``repro_torch.distributed.search``) runs as 8 gloo
ranks, one process each, on the same numpy inputs, over the meshes (data
4, model 2) and (pod 2, data 2, model 2) in both modes.  Each rank is
handed its own block (``local_block``) and must return the global top-k.

Integer-valued inputs make every distance exact in fp32, so the ids must
match exactly, ties included (the inputs hold many).  Gaussian inputs are
compared at the stated tolerance: the flat scan at rtol 1e-5 / atol 1e-5
(the two packages' products add in another order), PQ at 1e-4 as the JAX
package's own distributed test; the ids must match wherever no other
candidate lies within that tolerance.  BQ is exact.  The PQ and BQ state is
trained by the JAX package and carried into the port's quantizers by
``load_state_dict``.  The scans run in chunks of 24 rows, so the chunked
merge ("dims" mode's reduce a chunk at a time) is held to the reference's
one top-k over the whole shard.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.distributed import search as dsearch
from repro_torch.launch.mesh import batch_axes, make_local_mesh, \
    mesh_axis_sizes

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "src")
WORLD = 8
CHUNK = 24
TIMEOUT_S = 120
MESHES = {"4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
MODES = ("rows", "dims")
FLAT_TOL = dict(rtol=1e-5, atol=1e-5)
PQ_TOL = dict(rtol=1e-4, atol=1e-4)
# name -> (kind, metric, corpus key, query key, feature dim, k, tolerance);
# None tolerance: ids and distances exact
CASES = {
    "flat_cosine_int": ("flat", "cosine", "xi", "qi", 8, 10, None),
    "flat_l2_int": ("flat", "l2", "xi", "qi", 8, 10, None),
    "flat_cosine_gauss": ("flat", "cosine", "xgn", "qgn", 16, 10, FLAT_TOL),
    "flat_l2_gauss": ("flat", "l2", "xg", "qg", 16, 10, FLAT_TOL),
    # 9 dims over a model axis of 2: whole on every rank, no reduce
    "flat_l2_replicated": ("flat", "l2", "xr", "qr", 9, 10, None),
    # 64 rows: 8 a shard in "rows" mode, 16 in "dims", under k = 20
    "flat_l2_k_past_shard": ("flat", "l2", "xs", "qi", 8, 20, None),
    "pq_int": ("pq", "", "codes_i", "lut_i", 8, 10, None),
    "pq_trained": ("pq", "", "pq_codes", "pq_lut", 8, 10, PQ_TOL),
    "bq": ("hamming", "", "bq_codes", "bq_qcodes", 2, 10, None),
    # 3 words over a model axis of 2: whole on every rank
    "bq_replicated": ("hamming", "", "bq3_codes", "bq3_qcodes", 3, 10, None),
}
# the quantizers' arrays, made by each package from the same state
QUANT_KEYS = ("pq_codes", "pq_lut", "bq_codes", "bq_qcodes", "bq3_codes",
              "bq3_qcodes")

_JAX_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.launch.mesh import make_local_mesh
    from repro.distributed.search import (make_flat_search, make_pq_search,
                                          make_hamming_search)
    from repro.core.pq import ProductQuantizer, PQConfig, build_adc_lut
    from repro.core.bq import BinaryQuantizer, BQConfig

    spec = json.load(open(sys.argv[1]))
    inp = dict(np.load(sys.argv[2]))
    out = {}
    xg, qg = jnp.asarray(inp["xg"]), jnp.asarray(inp["qg"])
    pq = ProductQuantizer(PQConfig(m=8, k=32, iters=6))
    pq.train(xg)
    out["pq_codebooks"] = pq.state_dict()["codebooks"]
    inp["pq_codes"] = np.asarray(pq.encode(xg))
    inp["pq_lut"] = np.asarray(build_adc_lut(qg, pq.codebooks))
    for tag, bits in (("bq", 64), ("bq3", 96)):
        bq = BinaryQuantizer(BQConfig(bits=bits))
        bq.train(xg)
        for name, v in bq.state_dict().items():
            out[f"{tag}_{name}"] = v
        inp[f"{tag}_codes"] = np.asarray(bq.encode(xg))
        inp[f"{tag}_qcodes"] = np.asarray(bq.encode(qg))
    for key in spec["quant_keys"]:
        out["jax_" + key] = inp[key]
    meshes = {"4x2": make_local_mesh(data=4, model=2),
              "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"))}
    for mname, mesh in meshes.items():
        for mode in spec["modes"]:
            for case, (kind, metric, xk, qk, dim, k, _) in spec["cases"].items():
                if kind == "flat":
                    fn = make_flat_search(mesh, k=k, metric=metric, dim=dim,
                                          mode=mode)
                elif kind == "pq":
                    fn = make_pq_search(mesh, k=k, m_subspaces=dim, mode=mode)
                else:
                    fn = make_hamming_search(mesh, k=k, words=dim, mode=mode)
                d, i = fn(jnp.asarray(inp[xk]), jnp.asarray(inp[qk]))
                out[f"{mname}/{mode}/{case}/d"] = np.asarray(d)
                out[f"{mname}/{mode}/{case}/i"] = np.asarray(i)
    np.savez(sys.argv[3], **out)
""")

_TORCH_PROG = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.bq import BinaryQuantizer, BQConfig, from_uint32
    from repro_torch.core.pq import ProductQuantizer, PQConfig
    from repro_torch.distributed import (make_flat_search,
                                         make_hamming_search, make_pq_search)
    from repro_torch.distributed import search
    from repro_torch.distributed.search import local_block
    from repro_torch.launch.mesh import make_local_mesh, mesh_axis_sizes

    spec_path, inp_path, ref_path, store, out_path, rank = sys.argv[1:7]
    rank = int(rank)
    spec = json.load(open(spec_path))
    inp = dict(np.load(inp_path))
    ref = dict(np.load(ref_path))
    search.CHUNK = spec["chunk"]
    timeout = datetime.timedelta(seconds=spec["timeout"])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=spec["world"],
                            timeout=timeout)
    out = {}
    # the JAX package's PQ / BQ state in the port's quantizers
    pq = ProductQuantizer(PQConfig(m=8, k=32), device="cpu")
    pq.load_state_dict({"codebooks": ref["pq_codebooks"]})
    inp["pq_codes"] = pq.encode(inp["xg"]).numpy()
    inp["pq_lut"] = pq.lut(inp["qg"]).numpy()
    for tag, bits in (("bq", 64), ("bq3", 96)):
        bq = BinaryQuantizer(BQConfig(bits=bits), device="cpu")
        bq.load_state_dict({"hyperplanes": ref[tag + "_hyperplanes"],
                            "mean": ref[tag + "_mean"]})
        inp[tag + "_codes"] = bq.encode(inp["xg"]).numpy()
        inp[tag + "_qcodes"] = bq.encode(inp["qg"]).numpy()
    for key in spec["quant_keys"]:
        out["port_" + key] = inp[key]
    meshes = {"4x2": make_local_mesh(4, 2, device="cpu"),
              "2x2x2": init_device_mesh("cpu", (2, 2, 2),
                                        mesh_dim_names=("pod", "data",
                                                        "model"))}
    out["clamped"] = np.array(list(mesh_axis_sizes(
        make_local_mesh(8, 2, device="cpu")).values()))
    for mname, mesh in meshes.items():
        for mode in spec["modes"]:
            for case, (kind, metric, xk, qk, dim, k, _) in spec["cases"].items():
                make = {"flat": make_flat_search, "pq": make_pq_search,
                        "hamming": make_hamming_search}[kind]
                dim_kw = {"flat": "dim", "pq": "m_subspaces",
                          "hamming": "words"}[kind]
                kw = {"metric": metric} if kind == "flat" else {}
                fn = make(mesh, k=k, mode=mode, **{dim_kw: dim}, **kw)
                block = local_block(inp[xk], mesh, mode, dim=dim)
                q = local_block(inp[qk], mesh, mode, rows=False, dim=dim)
                d, i = fn(torch.from_numpy(block), torch.from_numpy(q))
                out[f"{mname}/{mode}/{case}/d"] = d.numpy()
                out[f"{mname}/{mode}/{case}/i"] = i.numpy()
                out[f"{mname}/{mode}/{case}/block_rows"] = np.array(
                    block.shape[0])
    # a second maker call reuses each mesh's row groups
    for mname, mesh in meshes.items():
        for mode in spec["modes"]:
            lay = search.layout(mesh_axis_sizes(mesh), mode)
            out[f"{mname}/{mode}/same_group"] = np.array(
                search._row_group(mesh, lay)[0]
                is search._row_group(mesh, lay)[0])
    np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()
""")


def _inputs():
    rng = np.random.RandomState(0)
    xg = gaussian_mixture(256, 16, seed=0)
    qg = gaussian_mixture(6, 16, seed=1)

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
            np.float32)

    return {
        "xi": rng.randint(-4, 5, (256, 8)).astype(np.float32),
        "qi": rng.randint(-4, 5, (6, 8)).astype(np.float32),
        "xr": rng.randint(-4, 5, (256, 9)).astype(np.float32),
        "qr": rng.randint(-4, 5, (6, 9)).astype(np.float32),
        "xs": rng.randint(-4, 5, (64, 8)).astype(np.float32),
        "codes_i": rng.randint(0, 16, (256, 8)).astype(np.uint8),
        "lut_i": rng.randint(0, 64, (6, 8, 16)).astype(np.float32),
        "xg": xg, "qg": qg, "xgn": unit(xg), "qgn": unit(qg)}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference's results and each port rank's, on one set of
    inputs: (inputs, reference npz, [rank npz])."""
    tmp = tmp_path_factory.mktemp("dsearch")
    spec = {"cases": CASES, "modes": MODES, "chunk": CHUNK, "world": WORLD,
            "timeout": TIMEOUT_S, "quant_keys": QUANT_KEYS}
    spec_path, inp_path = tmp / "spec.json", tmp / "inputs.npz"
    spec_path.write_text(json.dumps(spec))
    inp = _inputs()
    np.savez(inp_path, **inp)
    env = _env()
    ref_path = tmp / "ref.npz"
    out = subprocess.run([sys.executable, "-c", _JAX_PROG, str(spec_path),
                          str(inp_path), str(ref_path)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    ref = dict(np.load(ref_path))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCH_PROG, str(spec_path), str(inp_path),
         str(ref_path), str(tmp / "store"), str(tmp / f"rank{r}.npz"),
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=2 * TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return inp, ref, [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(WORLD)]


def _assert_topk(d, i, d_ref, i_ref, tol):
    """Exact where ``tol`` is None; else distances within ``tol`` and ids
    equal at every position whose reference distance lies farther than
    the tolerance from its neighbours' (the last position's rival past k
    is unseen, so it is held only through its distance)."""
    assert i.dtype == np.int32 and d.dtype == np.float32
    if tol is None:
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_array_equal(d, d_ref)
        return
    np.testing.assert_allclose(d, d_ref, **tol)
    margin = tol["atol"] + tol["rtol"] * np.abs(d_ref)
    gap = np.diff(d_ref, axis=1)
    apart = np.ones_like(d_ref, dtype=bool)
    apart[:, 1:] &= gap > margin[:, 1:]
    apart[:, :-1] &= gap > margin[:, :-1]
    apart[:, -1] = False
    assert apart.mean() >= 0.8       # the check is not vacuous
    np.testing.assert_array_equal(i[apart], i_ref[apart])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_search_matches_reference(runs, mesh, mode, case):
    _, ref, ranks = runs
    key = f"{mesh}/{mode}/{case}"
    _assert_topk(ranks[0][key + "/d"], ranks[0][key + "/i"],
                 ref[key + "/d"], ref[key + "/i"], CASES[case][-1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_rank_returns_the_same(runs, mesh, mode):
    _, _, ranks = runs
    for case in CASES:
        for part in ("d", "i"):
            key = f"{mesh}/{mode}/{case}/{part}"
            for r in range(1, WORLD):
                np.testing.assert_array_equal(ranks[r][key], ranks[0][key],
                                              err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_emulation_is_the_ranks(runs, mesh, mode, case, monkeypatch):
    """One process playing every rank through the module's per-rank
    functions returns the gloo ranks' answer bit for bit (two model shards
    add in either order to the same bits).  One thread, as each rank runs,
    so that the CPU's matrix products add in the ranks' order."""
    inp, _, ranks = runs
    kind, metric, xk, qk, dim, k, _ = CASES[case]
    arrays = {**inp, **{key: ranks[0]["port_" + key] for key in QUANT_KEYS}}
    monkeypatch.setattr(dsearch, "CHUNK", CHUNK)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d, i = dsearch.emulate_search(
            kind, "l2" if metric == "l2" else "dot",
            torch.from_numpy(arrays[xk]), torch.from_numpy(arrays[qk]), k,
            MESHES[mesh], mode, dim)
    finally:
        torch.set_num_threads(threads)
    key = f"{mesh}/{mode}/{case}"
    np.testing.assert_array_equal(i.numpy(), ranks[0][key + "/i"])
    np.testing.assert_array_equal(d.numpy(), ranks[0][key + "/d"])


def test_blocks_have_the_reference_split(runs):
    """Rows over every axis in "rows" mode (8 shards), over the batch axes
    in "dims" mode (4 shards)."""
    _, _, ranks = runs
    for mesh in MESHES:
        assert ranks[0][f"{mesh}/rows/flat_l2_int/block_rows"] == 256 // 8
        assert ranks[0][f"{mesh}/dims/flat_l2_int/block_rows"] == 256 // 4


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_makers_reuse_the_row_group(runs, mesh, mode):
    """The candidates' all_gather group of a mesh is made once: every
    maker call on that mesh gathers over the same group, on every rank."""
    _, _, ranks = runs
    assert all(bool(r[f"{mesh}/{mode}/same_group"]) for r in ranks)


@pytest.mark.parametrize("key", QUANT_KEYS)
def test_quantizer_state_carries_over(runs, key):
    """The port's quantizers, loaded from the JAX state, make the JAX
    package's codes and LUTs (BQ words as int32 holding the uint32 bits)."""
    _, ref, ranks = runs
    got, want = ranks[0]["port_" + key], ref["jax_" + key]
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    if key == "pq_lut":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_make_local_mesh_clamps_to_the_world(runs):
    """(8, 2) at world 8 gives (8, 1), as the reference's clamp."""
    _, _, ranks = runs
    np.testing.assert_array_equal(ranks[0]["clamped"], [8, 1])


def test_world_one_mesh_starts_its_own_group(tmp_path):
    """Without a process group, make_local_mesh starts a single-rank gloo
    one with no network; the mesh clamps to (1, 1) and the search is the
    local scan."""
    prog = textwrap.dedent("""
        import numpy as np, torch, torch.distributed as dist
        from repro_torch.core.flat import flat_search
        from repro_torch.distributed import make_flat_search
        from repro_torch.distributed.search import local_block
        from repro_torch.launch.mesh import make_local_mesh, mesh_axis_sizes
        mesh = make_local_mesh(2, 3, device="cpu")
        assert dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
        rng = np.random.RandomState(0)
        x = rng.randint(-4, 5, (100, 8)).astype(np.float32)
        q = rng.randint(-4, 5, (5, 8)).astype(np.float32)
        assert local_block(x, mesh, "dims").shape == x.shape
        for mode in ("rows", "dims"):
            fn = make_flat_search(mesh, k=7, metric="l2", mode=mode)
            got = fn(torch.from_numpy(x), torch.from_numpy(q))
            want = flat_search(torch.from_numpy(q), torch.from_numpy(x), 7,
                               metric="l2")
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        dist.destroy_process_group()
        print("WORLD1_OK")
    """)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=_env(), timeout=TIMEOUT_S,
                         cwd=tmp_path)
    assert "WORLD1_OK" in out.stdout, out.stdout + out.stderr


def test_make_local_mesh_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mesh would start NCCL here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_local_mesh(1, 1)


class _FakeMesh:
    def __init__(self, names, shape):
        self.mesh_dim_names = names
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)


def test_batch_axes_and_axis_sizes():
    """As tests/test_distributed.py holds the reference's."""
    three = _FakeMesh(("pod", "data", "model"), (2, 4, 2))
    two = _FakeMesh(("data", "model"), (4, 2))
    assert batch_axes(three) == ("pod", "data")
    assert batch_axes(two) == ("data",)
    assert mesh_axis_sizes(three) == {"pod": 2, "data": 4, "model": 2}
    assert mesh_axis_sizes(two) == {"data": 4, "model": 2}


@pytest.mark.parametrize("mode,dim,rows,split", [
    ("rows", 8, ("pod", "data", "model"), False),
    ("dims", 8, ("pod", "data"), True),
    ("dims", 0, ("pod", "data"), True),     # 0: assume model divides it
    ("dims", 9, ("pod", "data"), False),    # 9 over 2: whole on each rank
])
def test_layout(mode, dim, rows, split):
    lay = dsearch.layout(MESHES["2x2x2"], mode, dim)
    assert lay.rows == rows and lay.split == split
    # the shard index is row-major over the row axes
    coord = {"pod": 1, "data": 0, "model": 1}
    assert lay.shard(coord) == (5 if mode == "rows" else 2)


def test_blocks_tile_the_global_array():
    x = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    lay = dsearch.layout(MESHES["4x2"], "dims", 8)
    parts = [[lay.block(x, {"data": s, "model": j}) for j in range(2)]
             for s in range(4)]
    np.testing.assert_array_equal(np.block(parts), x)
    assert all(p.flags.c_contiguous for row in parts for p in row)
    q = torch.arange(3 * 8.0).reshape(3, 8)
    qb = lay.block(q, {"data": 3, "model": 1}, rows=False)
    assert torch.equal(qb, q[:, 4:]) and qb.is_contiguous()


@pytest.mark.parametrize("shape,mode,dim", [
    ((63, 8), "rows", 8),      # 63 rows over 8 shards
    ((64, 9), "dims", 0),      # dim 0 assumes model divides 9
])
def test_unequal_shards_raise(shape, mode, dim):
    lay = dsearch.layout(MESHES["4x2"], mode, dim)
    with pytest.raises(ValueError, match="evenly"):
        lay.block(np.zeros(shape, np.float32), {"data": 0, "model": 0})


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        dsearch.layout(MESHES["4x2"], "cols")


def test_merge_breaks_ties_to_the_lowest_global_id():
    """Equal candidates from two shards: the lower shard's (lower ids)
    come first, as lax.top_k over the tiled all_gather."""
    cand_d = torch.tensor([[1.0, 2.0, 2.0, 0.0, 2.0, 2.0]])
    cand_i = torch.tensor([[3, 4, 7, 10, 11, 12]], dtype=torch.int32)
    d, i = dsearch.merge_shard_topk(cand_d, cand_i, 4)
    assert d.tolist() == [[0.0, 1.0, 2.0, 2.0]]
    assert i.tolist() == [[10, 3, 4, 7]]

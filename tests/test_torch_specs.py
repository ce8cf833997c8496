"""The port's dry-run cell specs (``repro_torch.launch.specs``) and abstract
builders against the reference's (``repro.launch.specs``,
``repro.models.model.abstract_params`` / ``abstract_decode_state``,
``repro.models.steps.abstract_train_state``).

* The 40-cell matrix and ``cell_supported``, cell by cell: the same answer
  and the same skip reason.
* Every spec's shape and dtype, for every arch and shape: the batch specs
  (train, prefill: tokens, targets, segment ids, an encoder-decoder model's
  frames), the decode tokens and every leaf of the decode state (the port's
  per-layer state read as the reference's stacked tree,
  ``models.model.decode_state_shapes``; seamless with its cross K/V), the
  parameters (``models.convert.reference_shapes``) and the train state's
  moments, and the six ``quantixar-db`` specs with their row padding.
* Nothing is allocated: every tensor is on the meta device.
"""

import jax
import jax.numpy as jnp
import pytest

from repro import configs as jconfigs
from repro.configs.quantixar_db import CONFIG as J_DB
from repro.distributed.sharding import _path_str
from repro.launch import specs as JSP
from repro.models import model as jmodel
from repro.models import steps as jsteps
from repro_torch import configs
from repro_torch.configs.quantixar_db import CONFIG as DB
from repro_torch.launch import specs as SP
from repro_torch.models.convert import reference_shapes
from repro_torch.models.model import abstract_params, decode_state_shapes
from repro_torch.models.steps import abstract_train_state

ARCHS = configs.arch_ids()
CELLS = [(a, s) for a in ARCHS for s in SP.SHAPES]


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): (tuple(l.shape), _dtype(jnp.dtype(l.dtype)))
            for p, l in flat}


def test_the_matrix_is_the_references():
    assert ARCHS == jconfigs.arch_ids()
    assert len(ARCHS) * len(SP.SHAPES) == 40
    assert {k: tuple(v.__dict__.values()) for k, v in SP.SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in JSP.SHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_supported_as_the_reference(arch, shape):
    assert SP.cell_supported(configs.get_config(arch), shape) \
        == JSP.cell_supported(jconfigs.get_config(arch), shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_equal_the_references(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    cell, jcell = SP.SHAPES[shape], JSP.SHAPES[shape]
    if cell.kind == "decode":
        tokens, state = SP.lm_decode_specs(cfg, cell)
        jtokens, jstate = JSP.lm_decode_specs(jcfg, jcell)
        assert (tuple(tokens.shape), _dtype(tokens.dtype)) == (
            tuple(jtokens.shape), _dtype(jtokens.dtype))
        got = {k: (s, _dtype(d))
               for k, (s, d) in decode_state_shapes(state, cfg).items()}
        assert got == _jflat(jstate)
        if cfg.is_enc_dec:
            assert "cross_kv/0" in got
        leaves = [t for st in state.block_states for t in st]
        leaves += [state.pos] + [t for kv in state.cross_kv or () for t in kv]
    else:
        specs = SP.lm_train_specs(cfg, cell)
        jspecs = JSP.lm_train_specs(jcfg, jcell)
        assert {k: (tuple(v.shape), _dtype(v.dtype))
                for k, v in specs.items()} == _jflat(jspecs)
        leaves = list(specs.values())
    assert all(t.device.type == "meta" for t in leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_train_state(arch):
    cfg = configs.get_config(arch)
    state = abstract_train_state(cfg)
    model = state.model
    assert model is not None and abstract_params(cfg) is not None
    want = _jflat(jsteps.abstract_train_state(jconfigs.get_config(arch)))
    shapes = reference_shapes(model)

    def flat(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                yield from flat(v, key)
            else:
                yield key, (tuple(v), "float32")

    got = dict(flat(shapes, "params"))
    for part in ("m", "v"):
        got.update(flat(shapes, f"opt/{part}"))
    got["opt/step"] = ((), "int32")
    assert got == want
    tensors = list(model.parameters()) + list(state.opt.m.values()) \
        + list(state.opt.v.values()) + [state.opt.step]
    assert all(t.device.type == "meta" for t in tensors)
    assert {k: tuple(v.shape) for k, v in state.opt.m.items()} \
        == {k: tuple(p.shape) for k, p in model.named_parameters()}


def test_abstract_decode_state_with_cross_kv():
    arch = "seamless-m4t-medium"
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    from repro_torch.models.model import abstract_decode_state
    got = abstract_decode_state(cfg, 4, 256, with_cross_len=96)
    want = jmodel.abstract_decode_state(jcfg, 4, 256, with_cross_len=96)
    shapes = {k: (s, _dtype(d))
              for k, (s, d) in decode_state_shapes(got, cfg).items()}
    assert shapes == _jflat(want)
    assert shapes["cross_kv/1"][0] == (cfg.n_units, 4, 96, cfg.n_kv_heads,
                                       cfg.head_dim)


@pytest.mark.parametrize("mode", ["flat", "pq", "bq"])
@pytest.mark.parametrize("row_multiple", [1, 256, 512, 768])
def test_db_specs_equal_the_references(mode, row_multiple):
    got = SP.db_specs(DB, mode, row_multiple=row_multiple)
    want = JSP.db_specs(J_DB, mode, row_multiple=row_multiple)
    assert {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in got.items()} \
        == _jflat(want)
    assert all(v.device.type == "meta" for v in got.values())
    n = next(iter(got.values())).shape[0]
    assert n % row_multiple == 0 and n - DB.n_vectors < row_multiple

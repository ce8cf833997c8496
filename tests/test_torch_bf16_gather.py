"""``ModelConfig.bf16_weight_gather`` on the port, against the JAX package,
on the CPU, for every family at its smoke config in bf16.

The reference casts each fp32 leaf of its stacked scanned units (decoder
and encoder) with three or more dims -- a layer's tensor of two or more --
to the activation dtype before the scan; norm scales, biases, the tail's
blocks, the embed table and the head stay fp32.  The port casts the same
set before each unit (``models.model.computing_weights``).

* ``forward`` and the loss with the flag on against the reference's with the
  flag on, on the weights the JAX init drew (carried by
  ``from_numpy_params``): logits within 0.15 (the bf16 tolerance of
  tests/test_torch_families.py) with argmax agreement >= 0.9, the loss
  within 2e-2 relative.
* The port's forward with the flag on equals, bit for bit, its forward with
  the flag off on the weights the reference's cast rounds: exactly that set
  rounded to bf16, the rest untouched.  Before the port read the flag this
  failed for xlstm, whose mLSTM gate products and sLSTM recurrence compute
  in fp32 from the weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models.steps import make_loss_fn as j_make_loss_fn
from repro_torch import configs
from repro_torch.models import forward, from_numpy_params, make_loss_fn

BF16_ATOL = 0.15
LOSS_RTOL = 2e-2
FLAG = {"dtype": "bfloat16", "bf16_weight_gather": True}

_TREES = {}


def _tree(arch):
    """The JAX init's weights (PRNGKey(0)) as numpy."""
    if arch not in _TREES:
        jcfg = jconfigs.get_smoke_config(arch)
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        _TREES[arch] = (jp, jax.tree_util.tree_map(np.asarray, jp))
    return _TREES[arch]


def _batch(cfg, seed=0, b=2, s=64):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_enc_dec:
        batch["frames"] = rng.randn(b, 24, cfg.d_model).astype(np.float32)
    return batch


def _reference_cast(tree):
    """The reference's rule on its own tree: the scanned units' fp32
    leaves of ndim >= 3 rounded to bf16 (held in fp32)."""
    out = dict(tree)
    for key in ("units", "enc_units"):
        if key in tree:
            out[key] = jax.tree_util.tree_map(
                lambda a: np.asarray(jnp.asarray(a).astype(
                    jnp.bfloat16).astype(jnp.float32))
                if a.dtype == np.float32 and a.ndim >= 3 else a, tree[key])
    return out


@pytest.mark.parametrize("arch", jconfigs.arch_ids())
def test_forward_and_loss_match_the_reference_with_the_flag(arch):
    jp, tree = _tree(arch)
    jcfg = jconfigs.get_smoke_config(arch).with_overrides(**FLAG)
    cfg = configs.get_smoke_config(arch).with_overrides(**FLAG)
    model = from_numpy_params(tree, cfg, device="cpu")
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    want, _ = jmodels.forward(jp, jbatch, jcfg)
    with torch.no_grad():
        got, _ = forward(model, tbatch, cfg)
        loss, _ = make_loss_fn(cfg)(model, tbatch)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    jloss, _ = j_make_loss_fn(jcfg)(jp, jbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", jconfigs.arch_ids())
def test_the_flag_computes_with_the_reference_cast(arch):
    _, tree = _tree(arch)
    cfg_on = configs.get_smoke_config(arch).with_overrides(**FLAG)
    cfg_off = cfg_on.with_overrides(bf16_weight_gather=False)
    model = from_numpy_params(tree, cfg_on, device="cpu")
    rounded = from_numpy_params(_reference_cast(tree), cfg_off, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg_on, 1).items()}
    with torch.no_grad():
        got, aux = forward(model, batch, cfg_on)
        want, want_aux = forward(rounded, batch, cfg_off)
    assert torch.equal(got, want)
    assert torch.equal(aux, want_aux)
    # the fp32 masters are untouched
    assert all(p.dtype == torch.float32 for p in model.parameters())

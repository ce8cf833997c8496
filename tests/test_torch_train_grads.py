"""The training loss and its gradient on the port, against the JAX package,
for all ten model families, on the CPU.

For each family's smoke config in fp32, the JAX package's ``init_params``
(PRNGKey(0)) is carried over by ``repro_torch.models.from_numpy_params``
and the same seeded numpy batch (tokens, targets, a 0/1 ``segment_ids``
mask; seamless-m4t-medium with frames) goes through the reference's
``make_loss_fn`` under ``jax.value_and_grad`` and through the port's, whose
gradient autograd takes through ``forward`` (each unit recomputed in the
backward; xlstm's sLSTM layers through ``SLSTMSequence``'s plain reverse
loop; the MoE families at the reference's default capacity, tokens past it
dropped in both).  The port's gradients are mapped back to the reference's
stacked tree by the converter.

Tolerances: loss, ce and aux within 1e-5 relative (fp32 sums in another
order); every gradient leaf within 1e-4 of that leaf's largest magnitude
(``GRAD_TOL``: fp32 products and reductions in another order, through up to
four layers and their backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models.steps import cross_entropy as j_cross_entropy
from repro.models.steps import make_loss_fn as j_make_loss_fn
from repro_torch import configs
from repro_torch.kernels import slstm as slstm_mod
from repro_torch.models import from_numpy_params, make_loss_fn
from repro_torch.models.convert import _to_tree
from repro_torch.models.steps import cross_entropy

GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
B, S, FRAMES = 2, 16, 12


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0                    # a padded tail on one row
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
        "targets": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "segment_ids": mask}
    if cfg.is_enc_dec:
        batch["frames"] = rng.randn(B, FRAMES, cfg.d_model).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", jconfigs.arch_ids())
def test_loss_and_grads_match_the_reference(arch):
    jcfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = configs.get_smoke_config(arch).with_overrides(dtype="float32")
    jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    model = from_numpy_params(tree, cfg, device="cpu")
    batch = _batch(cfg, 3)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        j_make_loss_fn(jcfg), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    before = slstm_mod.backward_launches
    loss, m = make_loss_fn(cfg)(model, {k: torch.as_tensor(v)
                                        for k, v in batch.items()})
    loss.backward()
    assert slstm_mod.backward_launches == before     # the CPU: plain loop
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]),
                      (m["aux"], jm["aux"])):
        assert abs(got.item() - float(want)) <= LOSS_RTOL * max(
            abs(float(want)), 1.0), (got.item(), float(want))
    if cfg.moe_experts:
        assert float(jm["aux"]) > 0

    grads = _to_tree({k: p.grad for k, p in model.named_parameters()}, cfg)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = dict(_leaves(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= GRAD_TOL * max(scale, 1e-6), (
            path, np.abs(g - w).max(), scale)


def test_cross_entropy_matches_the_reference():
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(3, 7, 50)).astype(np.float32)
    targets = rng.randint(0, 50, (3, 7)).astype(np.int32)
    for mask in (np.ones((3, 7), np.float32),
                 (rng.rand(3, 7) > 0.4).astype(np.float32),
                 np.zeros((3, 7), np.float32)):   # max(mask.sum(), 1)
        want = float(j_cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(targets),
                                     jnp.asarray(mask)))
        got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(targets),
                            torch.as_tensor(mask)).item()
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (got, want)

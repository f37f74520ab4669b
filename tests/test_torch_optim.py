"""The port's Adam (``OptimizerSpec("adam").make()`` in ``core/optim.py``,
the parameter step of ``train_mcpc``) against ``optax.adam`` on the same
numpy parameters and gradients.

Tolerance: atol 1e-7 on parameters of size ~0.1 after 5 steps of lr 0.01
(both sides do the same f32 operations in the same order; what may differ is
the last bit of ``1 - b**count``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from montecarlopredictivecoding_tpu_torch.core import optim
from montecarlopredictivecoding_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)

SHAPES = [(4, 4), (4, 8), (8, 8), (8, 16)]


def _tree(rng, scale):
    return tuple(
        {"w": (rng.normal(size=s) * scale).astype(np.float32),
         "b": (rng.normal(size=s[1]) * scale).astype(np.float32)}
        for s in SHAPES
    )


@pytest.mark.parametrize("lr,b1,b2,eps", [
    (0.01, 0.9, 0.999, 1e-8),   # train_mcpc
    (0.001, 0.8, 0.99, 1e-6),
])
def test_adam_step_matches_optax(lr, b1, b2, eps):
    rng = np.random.default_rng(0)
    params_np = _tree(rng, 0.1)
    # gradients over many orders of magnitude, and an exact zero
    grads_np = [_tree(rng, 10.0 ** rng.integers(-6, 3)) for _ in range(5)]
    grads_np[2][0]["w"][...] = 0.0

    opt = optax.adam(lr, b1=b1, b2=b2, eps=eps)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstate = opt.init(jparams)
    tparams = params_from_numpy(params_np, "cpu")
    tx = optim.OptimizerSpec("adam", lr=lr, betas=(b1, b2), eps=eps).make()
    tstate = tx.init(tparams)
    for step, g in enumerate(grads_np, start=1):
        updates, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = tparams
        tupdates, tstate = tx.update(params_from_numpy(g, "cpu"), tstate, tparams)
        tparams = optim.apply_updates(tparams, tupdates)
        assert tstate[0].count == step == int(jstate[0].count)
        for i in range(4):
            for k in ("w", "b"):
                np.testing.assert_allclose(tparams[i][k].numpy(), np.asarray(jparams[i][k]),
                                           rtol=0, atol=1e-7)
                np.testing.assert_allclose(tstate[0].mu[i][k].numpy(),
                                           np.asarray(jstate[0].mu[i][k]), rtol=1e-6, atol=0)
                np.testing.assert_allclose(tstate[0].nu[i][k].numpy(),
                                           np.asarray(jstate[0].nu[i][k]), rtol=1e-6, atol=0)
        # the step is pure: its arguments are untouched
        assert before is not tparams and not torch.equal(before[1]["w"], tparams[1]["w"])


def test_adam_first_step_is_lr_times_sign():
    """After one step from zero moments the update is -lr·sign(g) (for
    |g| >> eps), whatever the size of g: the reason a gradient that is only
    rounding noise can still move a parameter by lr."""
    p = ({"w": torch.zeros(3), "b": torch.zeros(1)},)
    g = ({"w": torch.tensor([1e-3, -50.0, 0.0]), "b": torch.tensor([2.0])},)
    tx = optim.OptimizerSpec("adam", lr=0.01).make()
    updates, state = tx.update(g, tx.init(p), p)
    new = optim.apply_updates(p, updates)
    np.testing.assert_allclose(new[0]["w"].numpy(), [-0.01, 0.01, 0.0], rtol=1e-4)
    assert state[0].count == 1


def test_adam_step_refuses_mismatched_grads():
    p = ({"w": torch.zeros(3), "b": torch.zeros(1)},)
    tx = optim.OptimizerSpec("adam", lr=0.01).make()
    with pytest.raises(ValueError, match="structure"):
        tx.update(({"w": torch.zeros(3)},), tx.init(p), p)

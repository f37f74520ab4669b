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


def test_adam_state_is_init_with_moments_and_reads_back():
    """``adam_state`` builds what an ``adam`` spec's ``init`` gives with its
    moments and count replaced, leaf for leaf and in structure, and steps
    alike under ``update``; ``adam_moments`` reads back what was built and
    reads None from any other state or from moments of another shape."""
    gen = torch.Generator().manual_seed(0)
    tree = {"latents": tuple(torch.randn((4, d), generator=gen) for d in (3, 5, 2))}
    mu = {"latents": tuple(torch.randn(x.shape, generator=gen) for x in tree["latents"])}
    nu = {"latents": tuple(torch.rand(x.shape, generator=gen) for x in tree["latents"])}
    tx = optim.OptimizerSpec("adam", lr=0.05).make()
    init = tx.init(tree)
    want = (optim.ScaleByAdamState(7, mu, nu),) + init[1:]
    built = optim.adam_state(mu, nu, 7)
    assert type(built) is type(init) and len(built) == len(init) == 2
    assert type(built[0]) is type(init[0]) and built[1] == init[1] == ()
    assert built[0].count == 7 and type(built[0].count) is type(init[0].count)
    for side in ("mu", "nu"):
        got, ref = getattr(built[0], side), getattr(want[0], side)
        optim.tree_map(lambda a, b: None, got, getattr(init[0], side))  # same structure
        assert type(got["latents"]) is type(init[0].mu["latents"])
        assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(got),
                                                     optim.tree_leaves(ref)))
    g = {"latents": tuple(torch.randn(x.shape, generator=gen) for x in tree["latents"])}
    (u1, s1), (u2, s2) = tx.update(g, built, tree), tx.update(g, want, tree)
    assert all(torch.equal(a, b) for a, b in zip(
        optim.tree_leaves((u1, s1[0].mu, s1[0].nu)), optim.tree_leaves((u2, s2[0].mu, s2[0].nu))))
    assert s1[0].count == s2[0].count == 8

    got = optim.adam_moments(built, tree)
    assert got[0] is mu and got[1] is nu and got[2] == 7
    assert optim.adam_moments(init, tree)[2] == 0
    assert optim.adam_moments(built, {"latents": tree["latents"][:2]}) is None
    assert optim.adam_moments(built, {"latents": tuple(x[:2] for x in tree["latents"])}) is None
    assert optim.adam_moments(None, tree) is None
    for spec in (optim.OptimizerSpec("sgd"), optim.OptimizerSpec("sgd", momentum=0.9),
                 optim.OptimizerSpec("adamw", weight_decay=0.01),
                 optim.OptimizerSpec("adam", weight_decay=0.01)):
        assert optim.adam_moments(spec.make().init(tree), tree) is None, spec

"""The port's seed sweep (``parallel/sweep.py``) against the JAX package's,
on the CPU at 3-4-4-6.

Without noise the JAX sweep (a vmapped engine) and the port's (each seed
through ``PCTrainer`` and the chain's plain version) compute the same
function of the initial latents, which the port is handed.  With noise the
port is held against the JAX per-seed trainer path on its fused chain
(Pallas in interpret mode), whose counter-hash noise the port shares, with
the JAX latents and chain seeds handed over.

Tolerances: atol 2e-5 against the engine (the engine tests' bound), 1e-5
against the fused chain (the same chain, products summed in another order).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.models.factory import get_mcpc_trainer as jget_mcpc_trainer
from montecarlopredictivecoding_tpu.models.factory import get_pc_trainer as jget_pc_trainer
from montecarlopredictivecoding_tpu.parallel import sweep as jsweep
from montecarlopredictivecoding_tpu_torch.parallel import (
    make_seed_states,
    stack_pytrees,
    sweep_warm_langevin_chains,
)
from montecarlopredictivecoding_tpu_torch.utils import params_from_numpy
from torch_streams import on_the_kernel, share_streams

torch.set_num_threads(1)

DIMS = (3, 4, 4, 6)
S, B, STRIDE = 2, 4, 2


def _config(pkg):
    return {
        "input_size": 3, "hidden_size": 4, "hidden2_size": 4, "output_size": 6,
        "loss_fn": pkg.bernoulli_fn, "activation_fn": "relu", "input_var": None,
        "T_pc": 8, "optimizer_x_fn_pc": "adam", "optimizer_x_kwargs_pc": {"lr": 0.1},
        "mixing": 3, "sampling": 7, "optimizer_x_kwargs_mcpc": {"lr": 0.05},
    }


def _setup():
    jmodel = mcpc.make_mlp_model(*DIMS)
    params = [jax.device_get(jmodel.init(jax.random.PRNGKey(i))) for i in range(S)]
    target = np.array(
        (jax.random.uniform(jax.random.PRNGKey(9), (B, 6)) > 0.5).astype(jnp.float32))
    return jmodel, params, target


def test_stack_pytrees_matches_jax():
    Pair = collections.namedtuple("Pair", "a b")
    rng = np.random.default_rng(0)
    trees = [{"x": rng.normal(size=(2, 3)).astype(np.float32),
              "y": (rng.normal(size=(4,)).astype(np.float32),
                    Pair(rng.normal(size=()).astype(np.float32),
                         [rng.normal(size=(1,)).astype(np.float32)]))}
             for _ in range(3)]
    want = jsweep.stack_pytrees(trees)
    got = stack_pytrees(jax.tree_util.tree_map(torch.from_numpy, trees))
    assert isinstance(got["y"][1], Pair) and isinstance(got["y"][1].b, list)
    assert got["x"].shape == (3, 2, 3) and got["y"][1].a.shape == (3,)
    for g, w in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_make_seed_states():
    model = mt.make_mlp_model(*DIMS)
    params = [model.init(torch.Generator().manual_seed(i), device="cpu") for i in range(S)]
    cfg = mt.EngineConfig(plan=mt.core.build_plan(4, "all", "never"),
                          optimizer_x=mt.OptimizerSpec("adam", lr=0.1), optimizer_p=None)
    inputs = torch.zeros(B, 3)
    states = make_seed_states(model, cfg, params, inputs, torch.Generator().manual_seed(3))
    again = make_seed_states(model, cfg, params, inputs, torch.Generator().manual_seed(3))
    assert len(states) == S
    for st, st2, p in zip(states, again, params):
        assert st.params is p and [tuple(x.shape) for x in st.latents] == [(B, 3), (B, 4), (B, 4)]
        assert all(torch.equal(x, y) for x, y in zip(st.latents, st2.latents))
        assert torch.equal(torch.randn(3, generator=st.generator),
                           torch.randn(3, generator=st2.generator))
    assert not torch.equal(states[0].latents[1], states[1].latents[1])
    given = [[np.full((B, d), float(s), np.float32) for d in (3, 4, 4)] for s in range(S)]
    handed = make_seed_states(model, cfg, params, inputs, torch.Generator(), latents=given)
    assert float(handed[1].latents[2][0, 0]) == 1.0
    with pytest.raises(ValueError):
        make_seed_states(model, cfg, params, inputs, torch.Generator(), latents=given[:1])


@pytest.mark.parametrize("clamped", [True, False])
def test_sweep_without_noise_matches_the_jax_sweep(clamped):
    """The JAX sweep (engine, ``langevin_var=0``) against the port's with
    the JAX initial latents handed over, clamped to a target and unclamped."""
    jmodel, params, target = _setup()
    inputs = jnp.zeros((B, 3))
    key = jax.random.PRNGKey(42)
    jtarget = jnp.asarray(target) if clamped else None
    want = jsweep.sweep_warm_langevin_chains(jmodel, params, _config(mcpc), jtarget, inputs,
                                             key, stride=STRIDE, langevin_var=0.0)
    keys = jax.random.split(key, 2 * S)
    latents = [[np.asarray(x) for x in jmodel.init_latents(params[s], inputs, keys[s])]
               for s in range(S)]
    got = sweep_warm_langevin_chains(
        mt.make_mlp_model(*DIMS), [params_from_numpy(p, "cpu") for p in params],
        _config(mt), torch.from_numpy(target) if clamped else None, torch.zeros(B, 3),
        torch.Generator().manual_seed(0), stride=STRIDE, langevin_var=0.0, latents=latents)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (S, 5, B, g.shape[-1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5)


def test_sweep_with_noise_matches_the_jax_trainer_path(monkeypatch):
    """Langevin noise variance 2: each seed's warm start and captured chain
    through the JAX trainers on their fused chain, against the port's sweep
    handed the JAX latents and chain seeds."""
    jmodel, params, target = _setup()
    latents, seeds = share_streams(monkeypatch)
    config = _config(mcpc)
    want = []
    for s in range(S):
        jgen = mcpc.GenerativeModel(jmodel, key=s, params=params[s])
        on_the_kernel(jget_pc_trainer)(jgen, config, is_mcpc=True, training=False).train_on_batch(
            jnp.zeros((B, 3)), loss_fn=mcpc.bernoulli_fn,
            loss_fn_kwargs={"_target": jnp.asarray(target)}, is_return_results_every_t=False)
        res = on_the_kernel(jget_mcpc_trainer)(jgen, config, training=False).train_on_batch(
            jnp.zeros((B, 3)), loss_fn=mcpc.bernoulli_fn,
            loss_fn_kwargs={"_target": jnp.asarray(target)},
            callback_after_t=mcpc.LangevinStep(var=2.0), is_sample_x_at_batch_start=False,
            is_return_xs=True, capture_stride=STRIDE)
        want.append([np.asarray(x) for x in res["xs"]])
    assert len(latents) == S and len(seeds) == 2 * S  # a warm and a chain seed a seed
    monkeypatch.undo()  # the draws are recorded; the port is handed them below
    trainers = []
    orig = mt.PCTrainer.train_on_batch

    def spy(self, *a, **k):
        trainers.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(mt.PCTrainer, "train_on_batch", spy)
    got = sweep_warm_langevin_chains(
        mt.make_mlp_model(*DIMS), [params_from_numpy(p, "cpu") for p in params], _config(mt),
        torch.from_numpy(target), torch.zeros(B, 3), torch.Generator().manual_seed(0),
        stride=STRIDE, latents=latents, chain_seeds=seeds[1::2])
    assert [t.kernel_calls for t in trainers] == [1] * 2 * S
    assert sum(t.engine_calls for t in trainers) == 0
    for li in range(3):
        for s in range(S):
            np.testing.assert_allclose(got[li][s].numpy(), want[s][li], rtol=0, atol=1e-5)
    # the noise moved the chain: a chain without it ends elsewhere
    quiet = sweep_warm_langevin_chains(
        mt.make_mlp_model(*DIMS), [params_from_numpy(p, "cpu") for p in params], _config(mt),
        torch.from_numpy(target), torch.zeros(B, 3), torch.Generator(), stride=STRIDE,
        langevin_var=0.0, latents=latents)
    assert float((quiet[1] - got[1]).abs().max()) > 1e-2
    with pytest.raises(ValueError):
        sweep_warm_langevin_chains(
            mt.make_mlp_model(*DIMS), [params_from_numpy(p, "cpu") for p in params],
            _config(mt), None, torch.zeros(B, 3), torch.Generator(), chain_seeds=[1])

"""The port's parallel modules (``parallel/mesh.py``, ``fused_dp.py``,
``sharding.py``), ``train_mcpc(mesh=N)`` and the dry run, against the JAX
package on the CPU.

The port's ranks are spawned processes under gloo (``torch_dp_ranks``, which
imports no JAX); the JAX side runs here on the conftest's 8 CPU devices.
One spawn of 2 ranks runs every data-parallel check, one of 4 ranks the
sharded engine.

Tolerances: the data-parallel chain against JAX's on a 2-device mesh in
interpret mode, latents atol 1e-5 (the JAX test's 2e-5 halved; measured
9.5e-7) and gradients atol 3e-4 (the JAX test's; measured 1.2e-4 on sums
of up to 1500); the sharded engine against JAX's sharded step and the
port's unsharded engine, ``overall`` rtol 1e-5, parameters and latents atol
1e-5 (the JAX test's 2e-4 and 2e-5 tightened; measured 9e-8, 3e-8 and
1e-6); mesh training against single-device training by the JAX test's
``_quantile_close`` (tol 5e-4, under 1% of the elements beyond it, at most
0.02: Adam's first steps follow rounding where a gradient is near 0); at the
fid preset's full width, by ``chip_smoke.py`` phase 9's rule, which holds
that rule on the entries whose gradient is at least ``P3_CLEAR`` (1e-3) of
its tensor's largest in every batch and sets the others aside.
"""

import importlib
import inspect
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
import torch_dp_ranks
from montecarlopredictivecoding_tpu.core.engine import EngineState as JEngineState
from montecarlopredictivecoding_tpu.core.optim import OptimizerSpec as JOptimizerSpec
from montecarlopredictivecoding_tpu.core.schedule import build_plan as jbuild_plan
from montecarlopredictivecoding_tpu.core.engine import EngineConfig as JEngineConfig
from montecarlopredictivecoding_tpu.parallel import make_mesh as jmake_mesh
from montecarlopredictivecoding_tpu.parallel import shard_train_on_batch as jshard_train_on_batch
from montecarlopredictivecoding_tpu.parallel.fused_dp import make_dp_fused_chain as jmake_dp
from montecarlopredictivecoding_tpu.parallel.fused_dp import place_dp as jplace_dp
from montecarlopredictivecoding_tpu.parallel.mesh import best_mesh_shape as jbest_mesh_shape
from montecarlopredictivecoding_tpu_torch import dryrun
from montecarlopredictivecoding_tpu_torch.core.engine import EngineState, build_train_on_batch
from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
from montecarlopredictivecoding_tpu_torch.parallel import best_mesh_shape, make_mesh
from montecarlopredictivecoding_tpu_torch.parallel.fused_dp import shard_seed
from montecarlopredictivecoding_tpu_torch.utils import latents_from_numpy, params_from_numpy

torch.set_num_threads(1)

DP_DIMS, DP_B = (4, 8, 8, 16), 16
SHARD_DIMS, SHARD_B = (8, 16, 16, 32), 16


def _inputs(dims, B, seed):
    """JAX-initialised parameters, fed-forward latents and a binary target,
    as numpy arrays (the JAX tests' recipe)."""
    model = mcpc.make_mlp_model(*dims)
    key = jax.random.PRNGKey(seed)
    params = jax.device_get(model.init(key))
    latents = [np.asarray(x) for x in model.init_latents(params, jnp.zeros((B, dims[0])), key)]
    target = np.asarray((jax.random.uniform(key, (B, dims[-1])) > 0.5).astype(jnp.float32))
    return model, params, latents, target


def _save(tmp_dir, params, latents, target):
    arrays = {"target": target}
    for i, p in enumerate(params):
        arrays[f"w{i}"], arrays[f"b{i}"] = np.asarray(p["w"]), np.asarray(p["b"])
    for i, x in enumerate(latents):
        arrays[f"x{i}"] = x
    np.savez(os.path.join(tmp_dir, "inputs.npz"), **arrays)


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    """Two gloo ranks: the data-parallel chain's cases, ``place_dp``'s
    refusal, ``train_mcpc(mesh=2)`` (2 batches, a whole epoch, a refused
    size)."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    model, params, latents, target = _inputs(DP_DIMS, DP_B, 0)
    _save(tmp, params, latents, target)
    ranks = torch_dp_ranks.run_ranks(torch_dp_ranks.dp_rank, 2, tmp)
    return (model, params, latents, target), sorted(ranks, key=lambda r: r["data_rank"])


@pytest.fixture(scope="module")
def wide_ranks(tmp_path_factory):
    """Two gloo ranks: ``train_mcpc(mesh=2)`` at 20-128-128-784, B=256, on
    a short schedule (``torch_dp_ranks.WIDE``)."""
    return torch_dp_ranks.run_ranks(torch_dp_ranks.wide_dp_rank, 2,
                                    str(tmp_path_factory.mktemp("wide")))


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    """Four gloo ranks on a (2, 2) mesh: the sharded engine step."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    inputs = _inputs(SHARD_DIMS, SHARD_B, 7)
    _save(tmp, *inputs[1:])
    return inputs, torch_dp_ranks.run_ranks(torch_dp_ranks.sharded_rank, 4, tmp)


@pytest.mark.parametrize("dims", [(8, 16, 16, 32), (20, 128, 128, 784), (10, 256, 256, 784),
                                  (3, 6, 6, 9)])
def test_best_mesh_shape_matches_jax(dims):
    for n in range(1, 9):
        assert best_mesh_shape(n, dims) == jbest_mesh_shape(n, dims)


@pytest.mark.parametrize("kwargs,message", [
    (dict(devices=range(8), model=3), "8 devices not divisible by model=3"),
    (dict(devices=range(8), data=3, model=2), "mesh 3x2 != 8 devices"),
])
def test_make_mesh_refuses_what_jax_refuses(kwargs, message):
    with pytest.raises(ValueError, match=message):
        make_mesh(**kwargs, device="cpu")
    jkwargs = dict(kwargs, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match=message):
        jmake_mesh(**jkwargs)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        make_mesh(device="cpu")


def test_shard_seed_wraps_as_jax_int32():
    for seed in (0, 5, 2**31 - 2, 2**31 - 1):
        for rank in range(4):
            want = int(jnp.int32(seed) + jnp.int32(rank) * jnp.int32(1000003))
            assert shard_seed(seed, rank) == want
    assert shard_seed(2**31 - 2, 1) < 0  # the case the wrap changes


@pytest.mark.parametrize("case", torch_dp_ranks.DP_CASES, ids=lambda c: c[0])
def test_dp_fused_chain_matches_jax(dp_ranks, case):
    """Each rank's shard of the latents and the summed gradients against
    JAX ``make_dp_fused_chain`` on a 2-device mesh (interpret mode), noise
    on and off, with an Adam warm start."""
    (model, params, latents, target), ranks = dp_ranks
    name, noise_var, seed = case
    mesh = jmake_mesh(jax.devices()[:2], data=2, model=1)
    fn = jmake_dp(model, mesh, noise_var=noise_var, interpret=True,
                  **torch_dp_ranks.DP_OPTIONS)
    j_lat, j_pg = fn(*jplace_dp(mesh, params, tuple(latents), target), jnp.int32(seed))
    for i, x in enumerate(j_lat):
        got = np.concatenate([r[name]["latents"][i].numpy() for r in ranks])
        np.testing.assert_allclose(got, np.asarray(x), atol=1e-5)
    for r in ranks:
        for g, jg in zip(r[name]["pgrads"], j_pg):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]), atol=3e-4)
    # the ranks hold the same sums
    for g0, g1 in zip(ranks[0][name]["pgrads"], ranks[1][name]["pgrads"]):
        assert all(torch.equal(g0[k], g1[k]) for k in ("w", "b"))


def test_place_dp_refuses_a_batch_the_axis_does_not_divide(dp_ranks):
    for r in dp_ranks[1]:
        assert "not divisible" in r["place_refusal"]


def _quantile_close(a, b, tol=5e-4, frac=0.01, max_abs=0.02):
    diff = np.abs(np.asarray(a) - np.asarray(b))
    assert np.mean(diff > tol) < frac, (np.mean(diff > tol), diff.max())
    assert diff.max() < max_abs, diff.max()


def test_train_mcpc_mesh_matches_single_device(dp_ranks, tmp_path, monkeypatch):
    """``train_mcpc(mesh=2)`` against ``train_mcpc()`` on the JAX test's tiny
    configuration, 2 batches, noise off: only the order of the gradient
    sums differs."""
    config = train_mnist.mcpc_training_config()
    monkeypatch.setattr(train_mnist, "mcpc_training_config",
                        lambda: {**config, **torch_dp_ranks.TINY})
    from montecarlopredictivecoding_tpu_torch.data import mnist

    monkeypatch.setattr(mnist, "load_mnist_arrays", torch_dp_ranks.small_mnist)
    single = train_mnist.train_mcpc(1, str(tmp_path / "single"), batches_per_epoch=2,
                                    log=False, fused=True, langevin_var=None, device="cpu")
    init = train_mnist.get_model(train_mnist.mcpc_training_config(), 0, device="cpu").params
    ranks = dp_ranks[1]
    for p, p0, q0, q1 in zip(single.params, init, ranks[0]["train_params"],
                             ranks[1]["train_params"]):
        for k in ("w", "b"):
            assert torch.equal(q0[k], q1[k])  # every rank steps alike
            _quantile_close(p[k].numpy(), q0[k].numpy())
        assert not torch.equal(q0["b"], p0["b"])  # training moved them


def _smoke():
    """``chip_smoke.py`` from the repository's root, for its rules."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_train_mcpc_mesh_full_width_by_phase_9_rule(wide_ranks, tmp_path, monkeypatch):
    """``train_mcpc(mesh=2)`` against ``train_mcpc()`` at the fid preset's
    full width (20-128-128-784, B=256), 2 batches of a short schedule,
    noise off, held by ``chip_smoke.py`` phase 9's rule: the entries whose
    gradient is under ``P3_CLEAR`` of its tensor's largest in some batch
    are set aside (Adam's first steps are lr * sign(g) of a sum that the two
    runs take in other orders), the rest held by ``DP_QUANTILE``."""
    smoke = _smoke()
    config = train_mnist.mcpc_training_config()
    monkeypatch.setattr(train_mnist, "mcpc_training_config",
                        lambda: {**config, **torch_dp_ranks.WIDE})
    from montecarlopredictivecoding_tpu_torch.data import mnist

    monkeypatch.setattr(mnist, "load_mnist_arrays", torch_dp_ranks.wide_mnist)
    grads, param_step = [], train_mnist.param_step

    def recording(params, opt_state, pgrads, batch_size, **kw):
        grads.append([{k: v.clone() for k, v in g.items()} for g in pgrads])
        return param_step(params, opt_state, pgrads, batch_size, **kw)

    monkeypatch.setattr(train_mnist, "param_step", recording)
    single = train_mnist.train_mcpc(1, str(tmp_path / "single"),
                                    batches_per_epoch=torch_dp_ranks.WIDE_BATCHES, log=False,
                                    fused=True, langevin_var=None, device="cpu")
    assert len(grads) == torch_dp_ranks.WIDE_BATCHES
    assert [tuple(p["w"].shape) for p in single.params][1:] == [(20, 128), (128, 128),
                                                                 (128, 784)]
    ranks = [r["params"] for r in wide_ranks]
    for p, q in zip(*ranks):
        for k in ("w", "b"):
            assert torch.equal(p[k], q[k])  # every rank steps alike
    clear = smoke.clear_entries(torch, grads)
    far_all, far_clear, n_clear, n_all = smoke.dp_rule(single.params, ranks[0], clear)
    assert 0 < n_clear < n_all
    assert not any(far_clear), (far_clear, far_all)


def test_train_mcpc_mesh_skips_batches_the_mesh_does_not_divide(dp_ranks):
    """A whole epoch of 64, 64 and 33 rows: the 33 is skipped, and only rank
    0 says so, in the JAX package's words."""
    lead, other = dp_ranks[1]
    assert "mesh=2: skipped 1 batch(es) whose size didn't divide the data axis" in \
        lead["epoch_stdout"]
    assert "epoch 1:" in lead["epoch_stdout"]
    assert other["epoch_stdout"] == ""


def test_train_mcpc_mesh_refusals(dp_ranks):
    with pytest.raises(ValueError, match="mesh training requires the fused kernel path"):
        train_mnist.train_mcpc(1, "never", mesh=2, fused=False, device="cpu")
    for r in dp_ranks[1]:
        assert "mesh=3 needs an initialised torch.distributed process group of 3 ranks" in \
            r["size_refusal"]


def _jax_engine_config(langevin_var):
    mixing, sampling = 2, 4
    T = mixing + sampling
    return JEngineConfig(
        plan=jbuild_plan(T, update_x_at="all", update_p_at="last",
                         accumulate_p_at=list(range(mixing, T))),
        optimizer_x=JOptimizerSpec("sgd", lr=0.01),
        optimizer_p=JOptimizerSpec("adam", lr=0.001),
        langevin_var=langevin_var,
        loss_fn=mcpc.bernoulli_fn,
    )


def _port_unsharded(params, latents, target, langevin_var):
    model = mt.make_mlp_model(*SHARD_DIMS)
    cfg = torch_dp_ranks.engine_config(mt, langevin_var)
    p, lat = params_from_numpy(params, "cpu"), latents_from_numpy(latents, "cpu")
    state = EngineState(params=p, latents=lat,
                        opt_x_state=cfg.optimizer_x.make().init({"latents": lat}),
                        opt_p_state=cfg.optimizer_p.make().init(p),
                        lr_scale=torch.ones(()), generator=torch.Generator().manual_seed(3))
    inputs = torch.zeros(SHARD_B, SHARD_DIMS[0])
    return build_train_on_batch(model, cfg)(state, inputs, {"_target": torch.tensor(target)})


def _assert_step_close(got, overall, params, latents):
    np.testing.assert_allclose(got["overall"].numpy(), np.asarray(overall), rtol=1e-5)
    for p, q in zip(got["params"], params):
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(q["w"]), atol=1e-5)
        np.testing.assert_allclose(p["b"].numpy(), np.asarray(q["b"]), atol=1e-5)
    for x, y in zip(got["latents"], latents):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)


def test_shard_train_on_batch_matches_jax_and_unsharded(sharded_ranks):
    """The sharded engine step on a (2, 2) mesh, noise off, against JAX's
    sharded step on a (2, 2) mesh and against the port's unsharded engine."""
    (model, params, latents, target), ranks = sharded_ranks
    mesh = jmake_mesh(jax.devices()[:4], data=2, model=2)
    state = JEngineState(params=params, latents=tuple(latents), opt_x_state=None,
                         opt_p_state=None, lr_scale=jnp.ones(()), key=jax.random.PRNGKey(7))
    fn, s, inp, kw = jshard_train_on_batch(model, _jax_engine_config(None), mesh, state,
                                            jnp.zeros((SHARD_B, SHARD_DIMS[0])),
                                            {"_target": target})
    j_new, j_res = fn(s, inp, kw)
    p_new, p_res = _port_unsharded(params, latents, target, None)
    for r in ranks:
        got = r["noise_None"]
        _assert_step_close(got, j_res["overall"], j_new.params, j_new.latents)
        _assert_step_close(got, p_res["overall"], p_new.params, p_new.latents)
        assert got["local_latent_shape"] == [SHARD_B // 2, SHARD_DIMS[1] // 2]


def test_shard_train_on_batch_noise_matches_unsharded(sharded_ranks):
    """With the Langevin noise on, the sharded step draws the same noise as
    the unsharded engine from a generator in the same state."""
    (_, params, latents, target), ranks = sharded_ranks
    p_new, p_res = _port_unsharded(params, latents, target, 2.0)
    off = ranks[0]["noise_None"]["latents"][1]
    for r in ranks:
        got = r["noise_2.0"]
        _assert_step_close(got, p_res["overall"], p_new.params, p_new.latents)
        assert not torch.allclose(got["latents"][1], off)


def test_shardings_follow_jax_rules(sharded_ranks):
    """Weights replicated over data and split on their output features over
    model, biases likewise, latents split over both (every width here
    divides by 2), as JAX ``param_shardings`` / ``latent_shardings``."""
    (model, params, latents, _), ranks = sharded_ranks
    from montecarlopredictivecoding_tpu.parallel import latent_shardings, param_shardings

    mesh = jmake_mesh(jax.devices()[:4], data=2, model=2)
    name = {None: "Replicate()", "model": "Shard(dim={})", "data": "Shard(dim={})"}

    def placements(spec, ndim):
        axes = list(spec) + [None] * (ndim - len(spec))
        out = {"data": "Replicate()", "model": "Replicate()"}
        for dim, axis in enumerate(axes):
            if axis is not None:
                out[axis] = name[axis].format(dim)
        return [out["data"], out["model"]]

    want_p = [{k: placements(s.spec, 2 if k == "w" else 1) for k, s in d.items()}
              for d in param_shardings(model, mesh)]
    want_l = [placements(s.spec, 2) for s in latent_shardings(model, mesh, latents)]
    for r in ranks:
        assert r["params_placements"] == want_p
        assert r["latent_placements"] == want_l


def test_dryrun_entry_runs():
    fn, args = dryrun.entry("cpu")
    params, opt_state = fn(*args)
    assert all(bool(torch.isfinite(v).all()) for p in params for v in p.values())
    assert not torch.equal(params[3]["b"], args[0][3]["b"])


def test_dryrun_entry_points_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU, as the tests here do."""
    for fn in (dryrun.dryrun_multichip, dryrun.entry):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_dryrun_multichip_spawns_its_ranks(capfd):
    dryrun.dryrun_multichip(2, "cpu")
    assert "dryrun_multichip OK: mesh=(1x2)" in capfd.readouterr().out

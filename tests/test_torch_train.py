"""The port's training path (``experiments/train_mnist.py``) against the
same thing built from the JAX package's parts: ``mcpc_chain_pallas`` in
interpret mode, division by ``sampling·B``, ``optax.adam``.  Latents, data
and chain seeds are numpy's, handed to both sides."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
from montecarlopredictivecoding_tpu.experiments import train_mnist as jtrain
from montecarlopredictivecoding_tpu.models import factory as jfactory
from montecarlopredictivecoding_tpu.ops import mcpc_chain_pallas
from montecarlopredictivecoding_tpu_torch.core import trainer as mt_trainer
from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist
from montecarlopredictivecoding_tpu_torch.experiments import train_mnist as ttrain
from montecarlopredictivecoding_tpu_torch.models import get_model
from montecarlopredictivecoding_tpu_torch.ops import mcpc_chain
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    load_checkpoint,
    params_from_numpy,
)

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)

DIMS = (20, 128, 128, 784)
B = 16


def test_configs_and_presets_match_jax():
    jc, tc = jtrain.mcpc_training_config(), ttrain.mcpc_training_config()
    assert set(jc) == set(tc)
    for k in jc:
        if k != "loss_fn":  # each package's own bernoulli_fn
            assert jc[k] == tc[k], k
    assert tc["loss_fn"].__name__ == jc["loss_fn"].__name__ == "bernoulli_fn"
    for preset in ("fid", "ml", "mse"):
        for model in ("mcpc", "pc"):
            a = jtrain.apply_preset({"input_size": 20, "activation_fn": "relu"}, preset, model)
            b = ttrain.apply_preset({"input_size": 20, "activation_fn": "relu"}, preset, model)
            assert a == b
    opts = ttrain.chain_options(tc, None)
    assert opts == dict(T=150, lr=0.1, noise_var=None, loss="bernoulli", mixing=50,
                        with_pgrads=True, warm_T=250, warm_lr=0.7)


def test_one_batch_matches_jax_over_three_batches():
    """Full width, B=16, the full schedule (250 Adam MAP steps at lr 0.7,
    then 50 + 100 Langevin steps at lr 0.1 with noise), 3 batches.

    Gradients of the first batch, where both sides start from the same
    parameters: each tensor within 2e-6 of its largest entry (measured
    3e-7).  From the second batch on the parameters differ in their last
    bits and the 400-step chain amplifies that (measured up to 2e-4 of the
    largest entry), so later gradients are held to 1e-3.

    Parameters after 3 Adam steps: ALL entries within atol 1e-4 (measured
    1.2e-5).  Adam's first steps are about lr·sign(g) = 0.01 each, so an
    entry whose gradient were only rounding noise could flip sign between
    the two sides and differ by 0.02, 200 times the tolerance.  No entry
    does here: ``gW0`` is exactly zero on both sides (update exactly 0), and
    every other entry's gradient is a sum of 1600 terms far above its
    rounding error.
    """
    config = ttrain.mcpc_training_config()
    scale = config["sampling"] * B
    kw = ttrain.chain_options(config)
    params_np = jax.device_get(mcpc.make_mlp_model(*DIMS).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    opt = optax.adam(config["optimizer_p_kwargs_mcpc"]["lr"])
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstate = opt.init(jparams)
    tparams = params_from_numpy(params_np, "cpu")
    tstate = ttrain.param_optimizer(config).init(tparams)
    for batch in range(3):
        lat = tuple(rng.uniform(-10, 10, (B, d)).astype(np.float32) for d in DIMS[:3])
        data = (rng.random((B, DIMS[3])) > 0.5).astype(np.float32)
        seed = int(rng.integers(0, 2**31 - 1))

        _, jg = mcpc_chain_pallas(jparams, tuple(jnp.asarray(x) for x in lat),
                                  jnp.asarray(data), jnp.int32(seed),
                                  interpret=True, **kw)
        jg = jax.tree_util.tree_map(lambda x: x / scale, jg)
        updates, jstate = opt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

        tlat, tdata = latents_from_numpy(lat, "cpu"), torch.from_numpy(data)
        _, tg = mcpc_chain(tparams, tlat, tdata, seed, **kw)
        rel = 2e-6 if batch == 0 else 1e-3
        for i in range(4):
            for k in ("w", "b"):
                ref = np.asarray(jg[i][k])
                np.testing.assert_allclose(
                    tg[i][k].numpy() / scale, ref, rtol=0,
                    atol=rel * max(float(np.abs(ref).max()), 1e-30))
        before = tparams
        tparams, tstate = ttrain.one_batch(tparams, tstate, tlat, seed, tdata,
                                           config=config)
        assert tstate[0].count == batch + 1
        assert torch.equal(before[0]["w"], tparams[0]["w"])  # gW0 is zero
        assert not torch.equal(before[3]["w"], tparams[3]["w"])
    for i in range(4):
        for k in ("w", "b"):
            np.testing.assert_allclose(tparams[i][k].numpy(), np.asarray(jparams[i][k]),
                                       rtol=0, atol=1e-4)
    # three steps of about lr each really moved the parameters
    assert float((tparams[3]["w"] - torch.from_numpy(params_np[3]["w"])).abs().max()) > 0.02


@pytest.fixture
def small_synthetic(monkeypatch):
    """A 600-image synthetic train split (B=256: two full batches and one of
    88)."""
    orig = tmnist._synthetic_mnist
    monkeypatch.setattr(
        tmnist, "_synthetic_mnist",
        lambda n_train, n_test, seed=0: orig(600, 100, seed),
    )


def test_train_mcpc_writes_a_checkpoint_that_loads(small_synthetic, tmp_path, monkeypatch):
    # the entry point at its real width and batch, with a short schedule
    short = dict(ttrain.mcpc_training_config(), T_pc=6, mixing=2, sampling=4)
    monkeypatch.setattr(ttrain, "mcpc_training_config", lambda: dict(short))
    out = str(tmp_path / "run" / "mcpc")
    gen = ttrain.train_mcpc(1, out, seed=3, batches_per_epoch=2, log=False, device="cpu")
    like = get_model(short, 0, device="cpu").params
    loaded = load_checkpoint(out + ".msgpack", like, device="cpu")
    init = get_model(short, 3, device="cpu").params
    for p, q, p0 in zip(loaded, gen.params, init):
        for k in ("w", "b"):
            assert torch.equal(p[k], q[k]) and torch.isfinite(p[k]).all()
        assert not torch.equal(p["b"], p0["b"])  # training moved them
    assert torch.equal(loaded[0]["w"], init[0]["w"])

    # the same seed gives the same run; snapshots take the place of <out>
    out2 = str(tmp_path / "again")
    gen2 = ttrain.train_mcpc(1, out2, seed=3, batches_per_epoch=2, log=False,
                             snapshot_epochs=(0, 1), device="cpu")
    assert torch.equal(gen2.params[3]["w"], gen.params[3]["w"])
    first = load_checkpoint(out2 + "_epoch_init.msgpack", like, device="cpu")
    assert torch.equal(first[3]["w"], init[3]["w"])
    last = load_checkpoint(out2 + "_epoch1.msgpack", like, device="cpu")
    assert torch.equal(last[3]["w"], gen.params[3]["w"])
    assert not (tmp_path / "again.msgpack").exists()


def test_train_mcpc_runs_the_last_smaller_batch(small_synthetic, tmp_path, monkeypatch):
    short = dict(ttrain.mcpc_training_config(), T_pc=3, mixing=1, sampling=2)
    monkeypatch.setattr(ttrain, "mcpc_training_config", lambda: dict(short))
    sizes = []
    real = ttrain.one_batch

    def spy(params, opt_state, latents, seed, data, **kw):
        sizes.append((data.shape[0], latents[1].shape, seed))
        return real(params, opt_state, latents, seed, data, **kw)

    monkeypatch.setattr(ttrain, "one_batch", spy)
    ttrain.train_mcpc(1, str(tmp_path / "m.msgpack"), log=False, device="cpu",
                      langevin_var=None)
    assert [s[0] for s in sizes] == [256, 256, 88]
    assert sizes[2][1] == (88, 128)
    assert len({s[2] for s in sizes}) == 3 and all(0 <= s[2] < 2**31 - 1 for s in sizes)
    assert (tmp_path / "m.msgpack").exists()


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=2), "needs an initialised torch.distributed process group of 2 ranks"),
])
def test_train_mcpc_unported_paths_name_their_item(kwargs, item, tmp_path):
    """Every path of ``train_mcpc`` is ported; ``mesh=2`` outside a process
    group of 2 ranks is refused before anything is written
    (tests/test_torch_parallel.py trains over 2 ranks)."""
    with pytest.raises(ValueError, match=item):
        ttrain.train_mcpc(1, str(tmp_path / "x"), log=False, device="cpu", **kwargs)
    assert not list(tmp_path.iterdir())


SMALL = dict(input_size=4, hidden_size=8, hidden2_size=8, output_size=16, T_pc=6, mixing=2,
             sampling=3)


def _shared_batch(monkeypatch, params_np, lat, data, made=None):
    """The port's train_mcpc on these numpy parameters, latents and batch:
    its model holds the parameters, its loader yields the one batch, and
    sampling latents gives these; ``made`` collects the trainers it builds."""
    real_get_model = ttrain.get_model

    def get_model_shared(config, seed, device="cuda"):
        gen = real_get_model(config, seed, device=device)
        gen.params = params_from_numpy(params_np, device)
        return gen

    def sample_shared(self, inputs, generator=None):
        self.latents = latents_from_numpy(lat, "cpu")
        return self.latents

    monkeypatch.setattr(ttrain, "get_model", get_model_shared)
    monkeypatch.setattr(ttrain, "get_mnist_data", lambda config, seed=0, device="cpu": (
        [(torch.from_numpy(data), None)], None, None))
    monkeypatch.setattr(mt_trainer.GenerativeModel, "sample_latents", sample_shared)
    if made is not None:
        for name in ("get_pc_trainer", "get_mcpc_trainer"):
            real = getattr(ttrain, name)
            monkeypatch.setattr(ttrain, name, lambda *a, _real=real, **k: (
                made.append(_real(*a, **k)) or made[-1]))


def test_train_mcpc_trainer_path_matches_jax(tmp_path, monkeypatch):
    """One batch of ``train_mcpc(fused=False, langevin_var=None)`` against
    the JAX package's trainer path on the same numpy parameters, latents and
    batch (4-8-8-16, B=8, 6 Adam steps, 2 + 3 SGD steps): its PC warm start
    (``get_pc_trainer(is_mcpc=True)``) and then its MCPC trainer, each
    ``train_on_batch`` with ``use_pallas=True`` (the interpret-mode kernel;
    the warm start takes the shared latents instead of sampling its own).
    Latents and parameters atol 1e-5 (the file's chain tolerance; measured
    at rounding size).  The two trainers make two chain calls and no engine
    call."""
    dims, Bt = (4, 8, 8, 16), 8
    short = dict(ttrain.mcpc_training_config(), **SMALL)
    monkeypatch.setattr(ttrain, "mcpc_training_config", lambda: dict(short))
    params_np = jax.device_get(mcpc.make_mlp_model(*dims).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    lat = tuple(rng.uniform(-10, 10, (Bt, d)).astype(np.float32) for d in dims[:3])
    data = (rng.random((Bt, dims[3])) > 0.5).astype(np.float32)
    made, chain_calls = [], []
    _shared_batch(monkeypatch, params_np, lat, data, made)
    real_chain = chain_mod.mcpc_chain
    monkeypatch.setattr(chain_mod, "mcpc_chain", lambda *a, **k: (
        chain_calls.append(k), real_chain(*a, **k))[1])
    gen = ttrain.train_mcpc(1, str(tmp_path / "m"), log=False, fused=False,
                            langevin_var=None, device="cpu")

    jconfig = dict(jtrain.mcpc_training_config(), **SMALL)
    jgen = mcpc.GenerativeModel(mcpc.make_mlp_model(*dims), key=0, params=params_np)
    pc_warm = jfactory.get_pc_trainer(jgen, jconfig, is_mcpc=True, training=True)
    mc = jfactory.get_mcpc_trainer(jgen, jconfig, training=True)
    pc_warm.use_pallas = mc.use_pallas = True
    jgen.latents = tuple(jnp.asarray(x) for x in lat)
    pseudo, target = jnp.zeros((Bt, dims[0])), jnp.asarray(data)
    pc_warm.train_on_batch(pseudo, loss_fn=jconfig["loss_fn"],
                           loss_fn_kwargs={"_target": target},
                           is_sample_x_at_batch_start=False, is_return_results_every_t=False)
    mc.train_on_batch(pseudo, loss_fn=jconfig["loss_fn"], loss_fn_kwargs={"_target": target},
                      callback_after_t=None, is_sample_x_at_batch_start=False,
                      is_return_results_every_t=False)

    assert [k["warm_T"] if "warm_T" in k else 0 for k in chain_calls] == [6, 0]
    assert [k["T"] for k in chain_calls] == [0, 5]
    assert [(t.kernel_calls, t.engine_calls) for t in made] == [(1, 0), (1, 0)]
    for a, b in zip(gen.latents, jgen.latents):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for pa, pb, p0 in zip(gen.params, jgen.params, params_np):
        for k in ("w", "b"):
            np.testing.assert_allclose(pa[k].numpy(), np.asarray(pb[k]), rtol=0, atol=1e-5)
        assert not np.array_equal(pa["b"].numpy(), p0["b"])
    assert (tmp_path / "m.msgpack").exists()


def test_train_mcpc_trainer_path_takes_the_noise(tmp_path, monkeypatch):
    """With the noise on, the MCPC trainer's chain gets ``noise_var`` =
    ``langevin_var`` (the warm start none) and a seed drawn from the model's
    generator, so two runs with one seed give the same parameters."""
    short = dict(ttrain.mcpc_training_config(), **SMALL)
    monkeypatch.setattr(ttrain, "mcpc_training_config", lambda: dict(short))
    rng = np.random.default_rng(2)
    params_np = jax.device_get(mcpc.make_mlp_model(4, 8, 8, 16).init(jax.random.PRNGKey(1)))
    lat = tuple(rng.uniform(-10, 10, (8, d)).astype(np.float32) for d in (4, 8, 8))
    data = (rng.random((8, 16)) > 0.5).astype(np.float32)
    _shared_batch(monkeypatch, params_np, lat, data)
    calls = []
    real_chain = chain_mod.mcpc_chain
    monkeypatch.setattr(chain_mod, "mcpc_chain", lambda *a, **k: (
        calls.append((a[3], k)), real_chain(*a, **k))[1])
    runs = [ttrain.train_mcpc(1, str(tmp_path / f"r{i}"), seed=5, log=False, fused=False,
                              langevin_var=1.5, device="cpu") for i in range(2)]
    assert [k.get("noise_var") for _, k in calls] == [None, 1.5, None, 1.5]
    assert calls[1][0] == calls[3][0]
    for pa, pb in zip(runs[0].params, runs[1].params):
        assert torch.equal(pa["w"], pb["w"]) and torch.equal(pa["b"], pb["b"])


@pytest.mark.parametrize("model,item", [
    ("dlgm", "item 10"), ("resnet9", "item 5"),
])
def test_main_refuses_unported_models(model, item, tmp_path, capsys):
    """The models of ROADMAP queue 1 items 10 and 5 are ported: the command
    line no longer refuses them, only what stays unported for them,
    ``--mesh`` (data parallelism is MCPC's, item 8)."""
    with pytest.raises(SystemExit):
        ttrain.main(["--model", model, "--mesh", "2", "--out", str(tmp_path / "x"),
                     "--device", "cpu"])
    err = capsys.readouterr().err
    assert "--mesh is only supported for --model mcpc" in err and item not in err
    assert not list(tmp_path.iterdir())


def test_main_trains_mcpc_on_the_cpu(small_synthetic, tmp_path, monkeypatch):
    short = dict(ttrain.mcpc_training_config(), T_pc=3, mixing=1, sampling=2)
    monkeypatch.setattr(ttrain, "mcpc_training_config", lambda: dict(short))
    out = tmp_path / "cli" / "mcpc_mse.msgpack"
    ttrain.main(["--model", "mcpc", "--epochs", "1", "--batches-per-epoch", "1",
                 "--preset", "mse", "--out", str(out), "--device", "cpu"])
    like = get_model(dict(short, input_size=10, hidden_size=256, hidden2_size=256),
                     0, device="cpu").params
    loaded = load_checkpoint(str(out), like, device="cpu")
    assert tuple(loaded[1]["w"].shape) == (10, 256)


MSE_DIMS = (10, 256, 256, 784)
# the mse preset's schedule, shortened: 20 Adam MAP steps at lr 0.7, then
# 3 + 5 Langevin steps at lr 0.1 with noise
MSE_SHORT = dict(T_pc=20, mixing=3, sampling=5)


def test_train_mcpc_mse_preset_matches_jax(tmp_path, monkeypatch):
    """``train_mcpc(preset="mse")`` through its entry point at the preset's
    full widths (10-256-256-784 relu), B=8, two batches of a short schedule
    (``MSE_SHORT``), against the JAX package's training step built from its
    parts (``mcpc_chain_pallas`` in interpret mode with the JAX
    ``train_mcpc``'s chain keywords, division by ``sampling·B``,
    ``optax.adam``) on the same numpy parameters, batches and latents; each
    batch's chain seed is the one the port drew, handed to the JAX side.

    Gradients of the first batch, where both sides start from the same
    parameters: each tensor within 2e-6 of its largest entry; of the second,
    whose parameters differ in their last bits, 1e-4.  Parameters after the
    two Adam steps: every entry within 1e-4, the tolerance of the three-batch
    test above (measured: 1.9e-5 on 2 of the 200,704 entries of W3, where
    the two batches' gradients nearly cancel in Adam's first moment, and
    below 1e-5 elsewhere; the steps are about lr = 0.01 each).  gW0 is
    exactly zero on both sides, and the checkpoint holds the port's
    parameters."""
    Bm = 8
    short = dict(ttrain.mcpc_training_config(), **MSE_SHORT)
    monkeypatch.setattr(ttrain, "mcpc_training_config", lambda: dict(short))
    config = ttrain.apply_preset(dict(short), "mse", "mcpc")
    jconfig = jtrain.apply_preset(dict(jtrain.mcpc_training_config(), **MSE_SHORT), "mse", "mcpc")
    assert (jconfig["input_size"], jconfig["hidden_size"], jconfig["hidden2_size"],
            jconfig["output_size"]) == MSE_DIMS
    params_np = jax.device_get(mcpc.make_mlp_model(*MSE_DIMS).init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    lats = [tuple(rng.uniform(-10, 10, (Bm, d)).astype(np.float32) for d in MSE_DIMS[:3])
            for _ in range(2)]
    batches = [(rng.random((Bm, MSE_DIMS[3])) > 0.5).astype(np.float32) for _ in range(2)]
    real_get_model, real_one_batch = ttrain.get_model, ttrain.one_batch
    handed, seeds, tgrads = list(lats), [], []

    def get_model_shared(cfg, seed, device="cuda"):
        gen = real_get_model(cfg, seed, device=device)
        gen.params = params_from_numpy(params_np, device)
        gen.model.init_latents = lambda params, inputs, generator: latents_from_numpy(
            handed.pop(0), "cpu")
        return gen

    def one_batch_seen(params, opt_state, latents, seed, data, **kw):
        seeds.append(seed)
        tgrads.append(mcpc_chain(params, latents, data, seed,
                                 **ttrain.chain_options(kw["config"]))[1])
        return real_one_batch(params, opt_state, latents, seed, data, **kw)

    monkeypatch.setattr(ttrain, "get_model", get_model_shared)
    monkeypatch.setattr(ttrain, "one_batch", one_batch_seen)
    monkeypatch.setattr(ttrain, "get_mnist_data", lambda cfg, seed=0, device="cpu": (
        [(torch.from_numpy(d), None) for d in batches], None, None))
    gen = ttrain.train_mcpc(1, str(tmp_path / "mse"), seed=2, log=False, preset="mse",
                            device="cpu")
    assert not handed and len(seeds) == 2

    scale = jconfig["sampling"] * Bm
    jkw = dict(T=jconfig["mixing"] + jconfig["sampling"],
               lr=jconfig["optimizer_x_kwargs_mcpc"]["lr"], noise_var=2.0, loss="bernoulli",
               mixing=jconfig["mixing"], with_pgrads=True, warm_T=jconfig["T_pc"],
               warm_lr=jconfig["optimizer_x_kwargs_pc"]["lr"], interpret=True)
    assert {k: v for k, v in jkw.items() if k != "interpret"} == ttrain.chain_options(config)
    opt = optax.adam(jconfig["optimizer_p_kwargs_mcpc"]["lr"])
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstate = opt.init(jparams)
    for batch, (lat, data, seed) in enumerate(zip(lats, batches, seeds)):
        _, jg = mcpc_chain_pallas(jparams, tuple(jnp.asarray(x) for x in lat),
                                  jnp.asarray(data), jnp.int32(seed), **jkw)
        rel = 2e-6 if batch == 0 else 1e-4
        for i in range(4):
            for k in ("w", "b"):
                want = np.asarray(jg[i][k])
                np.testing.assert_allclose(tgrads[batch][i][k].numpy(), want, rtol=0,
                                           atol=rel * max(float(np.abs(want).max()), 1e-30))
        updates, jstate = opt.update(jax.tree_util.tree_map(lambda x: x / scale, jg), jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
    for i in range(4):
        for k in ("w", "b"):
            np.testing.assert_allclose(gen.params[i][k].numpy(), np.asarray(jparams[i][k]),
                                       rtol=0, atol=1e-4)
    assert np.array_equal(gen.params[0]["w"].numpy(), params_np[0]["w"])
    loaded = load_checkpoint(str(tmp_path / "mse.msgpack"), gen.params, device="cpu")
    assert all(torch.equal(p[k], q[k]) for p, q in zip(loaded, gen.params) for k in q)

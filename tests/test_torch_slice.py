"""The port's serving path end to end (get_model -> params_from_numpy ->
data -> init_latents -> mcpc_chain) against the JAX package's, and the
port's isolation from JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.data import mnist as jmnist
from montecarlopredictivecoding_tpu.models import get_model as jax_get_model
from montecarlopredictivecoding_tpu.ops import mcpc_chain_pallas
from montecarlopredictivecoding_tpu_torch.data import get_mnist_data
from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist
from montecarlopredictivecoding_tpu_torch.models import get_model
from montecarlopredictivecoding_tpu_torch.ops import mcpc_chain
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    params_from_numpy,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "montecarlopredictivecoding_tpu_torch"

# the canonical inference model (experiments/figure_2.py, train_mnist.py)
CONFIG = {
    "input_size": 20, "hidden_size": 128, "hidden2_size": 128,
    "output_size": 784, "activation_fn": "relu",
    "batch_size_train": 16, "batch_size_val": 16, "batch_size_test": 16,
}


@pytest.fixture
def small_synthetic(monkeypatch):
    """A 1000-image synthetic train split for both packages (the test split
    keeps its 10000 images)."""
    for mod in (tmnist, jmnist):
        orig = mod._synthetic_mnist
        monkeypatch.setattr(
            mod, "_synthetic_mnist",
            lambda n_train, n_test, seed=0, orig=orig: orig(1000, n_test, seed),
        )


def test_serving_path_matches_jax(small_synthetic):
    """Full width 20-128-128-784, B=16: Adam warm start then a Langevin
    chain with noise, Bernoulli loss.  Latents atol 1e-5, scalars rtol 1e-5
    (the same f32 arithmetic summed in another order)."""
    jgen = jax_get_model(dict(CONFIG, loss_fn=mcpc.bernoulli_fn), 0)
    gen = get_model(dict(CONFIG, loss_fn=mt.bernoulli_fn), 0, device="cpu")
    params_np = jax.device_get(jgen.params)
    gen.params = params_from_numpy(params_np, "cpu")

    _, _, t_test = get_mnist_data(dict(CONFIG, loss_fn=mt.bernoulli_fn), device="cpu")
    _, _, j_test = jmnist.get_mnist_data(dict(CONFIG, loss_fn=mcpc.bernoulli_fn))
    t_data, _ = next(iter(t_test))
    j_data, _ = next(iter(j_test))
    assert np.array_equal(t_data.numpy(), np.asarray(j_data))

    rng = np.random.default_rng(5)
    latents = tuple(rng.uniform(-10, 10, (16, d)).astype(np.float32)
                    for d in (20, 128, 128))
    kw = dict(T=25, lr=0.03, noise_var=2.0, loss="bernoulli", warm_T=6,
              warm_lr=0.1, return_scalars=True)
    jout = mcpc_chain_pallas(params_np, tuple(jnp.asarray(x) for x in latents),
                             j_data, jnp.int32(123), interpret=True, **kw)
    tout = mcpc_chain(gen.params, latents_from_numpy(latents, "cpu"), t_data,
                      123, **kw)
    for a, b in zip(tout[0], jout[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for k in ("loss", "energy"):
        np.testing.assert_allclose(tout[2][k].numpy(), np.asarray(jout[2][k]),
                                   rtol=1e-5)
    # the energy fell from the uniform(-10, 10) start
    res = gen.model.apply(gen.params, latents_from_numpy(latents, "cpu"),
                          torch.zeros(16, 20))
    assert float(sum(res.energies)) > float(tout[2]["energy"])


def test_port_path_runs_on_its_own(small_synthetic):
    """The port's own entry points, as a user calls them: model from a seed,
    latents from a torch.Generator, a binarized test batch."""
    gen = get_model(dict(CONFIG, loss_fn=mt.bernoulli_fn), 1, device="cpu")
    _, _, test = get_mnist_data(dict(CONFIG, loss_fn=mt.bernoulli_fn), device="cpu")
    data, _ = next(iter(test))
    lat = gen.sample_latents(torch.zeros(16, 20), torch.Generator().manual_seed(2))
    out, pgrads, scal = mcpc_chain(gen.params, lat, data, 7, T=10, lr=0.01,
                                   return_scalars=True)
    assert pgrads is None
    assert [tuple(x.shape) for x in out] == [(16, 20), (16, 128), (16, 128)]
    assert all(torch.isfinite(x).all() for x in out)
    assert torch.isfinite(scal["loss"]).all() and torch.isfinite(scal["energy"]).all()
    assert gen.predict(torch.zeros(16, 20)).shape == (16, 784)


_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "matplotlib",
             "montecarlopredictivecoding_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import montecarlopredictivecoding_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # 26 with the trainer, its engine and schedules, the probe, the plotting
    # geometry, the experiments' plumbing and figure 2; matplotlib is blocked
    # too, as the GPU machine has none
    assert int(proc.stdout.strip().splitlines()[-1]) >= 26


def test_port_sources_never_name_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu*"))
    assert len(sources) > 20
    assert {p.name for p in sources} >= {"mcpc_chain_unpacked.cu", "mcpc_common.cuh"}
    pkg = re.compile(r"montecarlopredictivecoding_tpu(?!_torch)")
    imp = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|msgpack)\b", re.M)
    for path in sources:
        text = path.read_text()
        assert not pkg.search(text), path
        assert not imp.search(text), path
    # chip_smoke.py names the TPU kernel it replaces, but imports neither
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not re.search(
        r"^\s*(import|from)\s+(jax|montecarlopredictivecoding_tpu)([\s.,]|$)",
        smoke, re.M)
    assert not re.search(r"import_module\(\s*['\"](jax|montecarlopredictivecoding_tpu)['\".]",
                         smoke)

"""Figure 4 in the port against the JAX package's, on the CPU.

The landscapes are numpy in both packages.  The 1-D training runs go
through ``PCTrainer``'s step engine in both; they get the same data batches
and, through ``torch_streams``, the latents the JAX package samples.  PC
training is then the same computation; MCPC training is the same with the
Langevin noise switched off in both, and is held in distribution with it
on.  Panel (e) runs the fused chain (Pallas in interpret mode on the JAX
side, the chain's plain version in the port) on the same masked batch, and
its DLGM row the port's DLGM.  The JAX functions draw and return little, so
the tests read the trajectories and images they draw.

Tolerances: landscapes 1e-12; engine trajectories and parameters atol 2e-5
(the engine tests' bound); with noise, each start's final (W, mu) within
(0.3, 0.1) of the JAX run's and each model's sample variance within 10% of
it (two seeds of the port part by up to 0.09 and 0.03, and 1%, measured on
10 batches); the reconstructions atol 5e-5 (f32 chains, sums in another
order, after 10 Adam steps at lr 0.7, which amplify rounding: measured up
to 1.1e-5 on ``pc_mse_1``, 2.4e-6 elsewhere).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopredictivecoding_tpu.experiments import common as jcommon
from montecarlopredictivecoding_tpu.experiments import figure_4 as jfigure_4
from montecarlopredictivecoding_tpu_torch.experiments import common, figure_4
from torch_streams import langevin_off, on_the_kernel, share_streams

torch.set_num_threads(1)


class Recorder:
    """Stands in for matplotlib axes: keeps the arguments of every call of
    the methods it is asked to record, forwards the rest to ``ax`` (or
    ignores them without one)."""

    def __init__(self, ax=None, record=("plot", "quiver", "scatter", "imshow")):
        self._ax, self._record, self.calls = ax, record, []

    def __getattr__(self, name):
        if name in self._record:
            def record(*args, **kwargs):
                self.calls.append((name, args, kwargs))
                return getattr(self._ax, name)(*args, **kwargs) if self._ax else None
            return record
        return getattr(self._ax, name) if self._ax else (lambda *a, **k: None)


def _datas(n):
    rng = np.random.default_rng(4)
    return [(1.0 + np.sqrt(5.0) * rng.normal(size=(256, 1))).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("name", ["mcpc_landscape", "pc_landscape"])
def test_landscapes_equal_jax(name):
    got, want = Recorder(), Recorder()
    getattr(figure_4, name)(got, 1.0, 5.0)
    getattr(jfigure_4, name)(want, 1.0, 5.0)
    assert [c[0] for c in got.calls] == [c[0] for c in want.calls]
    for (_, ga, gk), (_, wa, wk) in zip(got.calls, want.calls):
        for a, b in zip(ga, wa):
            np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                                       rtol=0, atol=1e-12)
        assert gk.keys() == wk.keys()


def _jax_trajectories(monkeypatch, landscape, color):
    """Run the JAX learning panel with its trajectories recorded off the
    axes it draws them on: ``[(W, mu) arrays]`` a start."""
    recorders = []
    orig = getattr(jfigure_4, landscape)

    def recorded(ax, *args):
        recorders.append(Recorder(orig(ax, *args), record=("plot",)))
        return recorders[-1]

    monkeypatch.setattr(jfigure_4, landscape, recorded)
    return recorders, lambda: [np.stack([np.asarray(a[0]), np.asarray(a[1])], axis=1)
                               for _, a, _ in recorders[0].calls if a[2:] == (color,)]


def _run_learning(monkeypatch, tmp_path, which, datas, noise):
    """The JAX panel, then the port's on the same data and latents."""
    monkeypatch.setattr(jfigure_4, "_make_datas", lambda *a, **k: [jnp.asarray(d) for d in datas])
    if not noise:
        langevin_off(monkeypatch, figure_4)
    latents, _ = share_streams(monkeypatch)
    landscape, color = (("mcpc_landscape", "C0") if which == "mcpc" else ("pc_landscape", "r"))
    _, trajectories = _jax_trajectories(monkeypatch, landscape, color)
    jctx = jcommon.ExperimentContext("models", str(tmp_path / "jax"), scale=0.01)
    getattr(jfigure_4, f"{which}_linear_learning")(jctx)
    want = trajectories()
    if noise:
        monkeypatch.undo()  # the port draws its own latents and noise
    ctx = common.ExperimentContext("models", str(tmp_path / "port"), scale=0.01, device="cpu")
    got = getattr(figure_4, f"{which}_linear_learning")(ctx, datas=datas)
    if not noise:
        assert latents == []  # every JAX draw was replayed
    return got, want


def test_pc_linear_learning_matches_jax(monkeypatch, tmp_path):
    """Four starts, 3 epochs of 3 batches, 20 Adam steps a batch."""
    got, want = _run_learning(monkeypatch, tmp_path, "pc", _datas(3), noise=False)
    assert len(got["trajectories"]) == len(want) == 4
    for g, w, start in zip(got["trajectories"], want, got["starts"]):
        assert g.shape == w.shape == (10, 2) and tuple(g[0]) == (start[1], start[0])
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
    figure_4.draw_pc_linear_learning(common.ExperimentContext(
        "models", str(tmp_path), device="cpu"), got)
    assert (tmp_path / "4c.svg").exists()


def test_mcpc_linear_learning_without_noise_matches_jax(monkeypatch, tmp_path):
    """Four starts, 3 epochs of 3 batches, 150 + 1 Langevin steps a batch
    and a parameter step, noise variance 0 in both packages."""
    got, want = _run_learning(monkeypatch, tmp_path, "mcpc", _datas(3), noise=False)
    for g, w in zip(got["trajectories"], want):
        assert g.shape == w.shape == (10, 2)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)


def test_mcpc_linear_learning_with_noise_follows_jax(monkeypatch, tmp_path):
    got, want = _run_learning(monkeypatch, tmp_path, "mcpc", _datas(3), noise=True)
    for g, w in zip(got["trajectories"], want):
        assert abs(g[-1, 0] - w[-1, 0]) <= 0.3 and abs(g[-1, 1] - w[-1, 1]) <= 0.1, (g[-1], w[-1])
        assert np.abs(g[-1] - g[0]).max() > 0.1  # it learned
    figure_4.draw_mcpc_linear_learning(common.ExperimentContext(
        "models", str(tmp_path), device="cpu"), got)
    assert (tmp_path / "4b.svg").exists()


@pytest.mark.parametrize("noise", [False, True])
def test_comparison_linear_model_matches_jax(noise, monkeypatch, tmp_path):
    """Panel (a) on 3 batches: without noise both models' final parameters
    equal the JAX package's, with noise the PC model's still do (it has
    none) and the MCPC model's sample variance follows JAX's."""
    datas = _datas(3)
    monkeypatch.setattr(jfigure_4, "_make_datas", lambda *a, **k: [jnp.asarray(d) for d in datas])
    if not noise:
        langevin_off(monkeypatch, figure_4)
    share_streams(monkeypatch)
    gens = []
    make = jfigure_4._one_d_model
    monkeypatch.setattr(jfigure_4, "_one_d_model",
                        lambda start, key: gens.append(make(start, key)) or gens[-1])
    jctx = jcommon.ExperimentContext("models", str(tmp_path / "jax"), scale=0.01)
    want = jfigure_4.comparison_linear_model(jctx)
    ctx = common.ExperimentContext("models", str(tmp_path / "port"), scale=0.01, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # T=1 below the stack's minimum
        got = figure_4.comparison_linear_model(ctx, datas=datas, num_samples=15000)
    (j_pc, j_mc) = [(float(g.params[0]["b"][0]), float(g.params[1]["w"][0, 0])) for g in gens]
    np.testing.assert_allclose(got["pc_params"], j_pc, rtol=0, atol=2e-5)
    assert got["mcpc_samples"].shape == got["pc_samples"].shape == (15000, 1)
    if noise:
        for k in ("mcpc_var", "pc_var"):
            assert abs(got[k] - want[k]) <= 0.1 * want[k], (k, got[k], want[k])
        assert got["mcpc_var"] > got["pc_var"]
        figure_4.draw_comparison_linear_model(ctx, got)
        assert (tmp_path / "port" / "4a.svg").exists()
    else:
        np.testing.assert_allclose(got["mcpc_params"], j_mc, rtol=0, atol=2e-5)


def test_image_reconstruction_matches_jax(monkeypatch, tmp_path):
    """Panel (e) on one batch of 30 binary images, 10 Adam steps: the JAX
    figure's 40 drawn images (input, PC, MCPC and DLGM of one image a digit)
    against the port's, on the same latents and chain seeds."""
    rng = np.random.default_rng(5)
    data = (rng.random((30, 784)) > 0.7).astype(np.float32)
    label = np.arange(30) % 10
    monkeypatch.setattr(jfigure_4, "get_mnist_data", lambda config: (
        None, None, [(jnp.asarray(data), jnp.asarray(label))]))
    monkeypatch.setattr(jfigure_4, "get_pc_trainer", on_the_kernel(jfigure_4.get_pc_trainer))
    latents, seeds = share_streams(monkeypatch)
    grid = [[Recorder(record=("imshow",)) for _ in range(10)] for _ in range(4)]
    subplots = jfigure_4.plt.subplots
    monkeypatch.setattr(jfigure_4.plt, "subplots", lambda *a, **k: (None, grid))
    jctx = jcommon.ExperimentContext("models", str(tmp_path / "jax"), scale=0.04)
    jfigure_4.image_reconstruction(jctx)
    monkeypatch.setattr(jfigure_4.plt, "subplots", subplots)

    trainers = []
    orig = figure_4.get_pc_trainer
    monkeypatch.setattr(figure_4, "get_pc_trainer",
                        lambda *a, **k: trainers.append(orig(*a, **k)) or trainers[-1])
    ctx = common.ExperimentContext("models", str(tmp_path / "port"), scale=0.04, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the checkpoints load: no random init
        got = figure_4.image_reconstruction(ctx, batch=(torch.from_numpy(data),
                                                        torch.from_numpy(label)))
    assert (latents, seeds) == ([], [])
    assert [t.T for t in trainers] == [10, 10]
    assert [(t.kernel_calls, t.engine_calls) for t in trainers] == [(1, 0), (1, 0)]
    for name in ("img_pc", "img_mc", "img_dlgm"):
        assert got[name].shape == (30, 784)
        np.testing.assert_array_equal(got[name][:, -392:], data[:, -392:])
    for i in range(10):
        idx = np.where(label == i)[0][-1]
        shown = [c[1][0] for c in (grid[r][i].calls[0] for r in range(4))]
        masked = data[idx].reshape(28, 28).copy()
        masked[:14] = 0.0
        np.testing.assert_array_equal(shown[0], masked)
        for r, name in enumerate(("img_pc", "img_mc", "img_dlgm"), start=1):
            np.testing.assert_allclose(got[name][idx].reshape(28, 28), np.asarray(shown[r]),
                                       rtol=0, atol=5e-5, err_msg=f"{name}, digit {i}")
    figure_4.draw_image_reconstruction(ctx, got)
    assert (tmp_path / "port" / "4e.svg").exists()


def test_image_generation_end_to_end(tmp_path):
    """Panel (d) on the shipped ``pc_fid_1`` and ``dlgm_fid_1``: 256
    samples of each, probabilities in [0, 1]."""
    ctx = common.ExperimentContext("models", str(tmp_path), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = figure_4.image_generation(ctx)
    for k in ("pc", "dlgm"):
        assert got[k].shape == (256, 28, 28) and np.isfinite(got[k]).all()
        assert got[k].min() >= 0.0 and got[k].max() <= 1.0
    assert not np.array_equal(got["pc"][0], got["pc"][1])
    figure_4.draw_image_generation(ctx, got)
    assert (tmp_path / "4d.svg").exists()


@pytest.mark.parametrize("direction", ["right", "left"])
def test_plot_line_with_arrow_matches_jax(direction):
    """The trajectory helpers of ``utils/plotting``: the same line and the
    same arrow polygon (1e-12) as the JAX package's."""
    from montecarlopredictivecoding_tpu.utils import plotting as jplotting
    from montecarlopredictivecoding_tpu_torch.utils import plotting

    plt = plotting.pyplot()
    x = np.linspace(-3.0, 4.0, 40)
    y = np.sin(x)
    arrows = []
    for pkg in (plotting, jplotting):
        fig, ax = plt.subplots()
        line = pkg.plot_line_with_arrow(x, y, ax=ax, label="t", dx=3, color="C1")
        pkg.add_arrow(line, ax, position=1.0, direction=direction, dx=2)
        arrows.append([p.get_xy() for p in ax.patches])
        np.testing.assert_array_equal(line.get_xdata(), x)
        plt.close(fig)
    assert len(arrows[0]) == len(arrows[1]) == 2
    for a, b in zip(*arrows):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)

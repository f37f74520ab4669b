"""Figure 4: learning dynamics.

(a) PC and MCPC 1-D models trained from the same start: the density each
    learned against the data's (``comparison_linear_model``);
(b, c) the analytic parameter flow of MCPC and of PC on the 1-D model
    (``mcpc_landscape``, ``pc_landscape``: quiver, nullclines, fixed points)
    with training trajectories from four starts (``mcpc_linear_learning``,
    ``pc_linear_learning``);
(d) samples of the PC model ``pc_fid_1`` beside the DLGM's prior samples
    (``image_generation``);
(e) masked-digit reconstruction: input, PC (``pc_mse_1``), MCPC
    (``mcpc_mse_1``) and the DLGM (``dlgm_mse_1``) (``image_reconstruction``).

    python3 -m montecarlopredictivecoding_tpu_torch.experiments.figure_4 --full

The 1-D model is outside the fused chain's family, so ``PCTrainer`` runs
(a)-(c) in its step engine; (e)'s MAP inference at B=1024 runs in the chain
(the kernel on CUDA).  The compute functions return arrays; the ``draw_*``
functions draw them (they alone import matplotlib).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..core.losses import bernoulli_fn, bernoulli_fn_mask, fe_fn
from ..core.model import PCModel
from ..core.modules import PC, Linear, random_tensor, sample_x_fn_normal
from ..core.trainer import GenerativeModel, LangevinStep
from ..data import get_mnist_data
from ..eval.metrics import decode_from_deepest_latent
from ..eval.sampling import sample_pc
from ..models.dlgm import generative_forward, recognition_forward
from ..models.factory import get_mcpc_trainer, get_pc_trainer
from ..utils.plotting import pyplot, setup_fig
from ..utils.precision import full_f32_matmul
from .common import ExperimentContext, context_from_args, load_generative_checkpoint, standard_parser
from .table_1 import _load_dlgm

# the data of panels (a)-(c): y ~ N(DATA_MU, DATA_VAR), batches of 256
DATA_MU, DATA_VAR, BATCH_1D, EPOCHS_1D = 1.0, 5.0, 256, 3


# -- analytic landscapes ------------------------------------------------------


def mcpc_landscape(ax, x_mean=1.0, x_var=5.0):
    """The expected MCPC parameter flow of the 1-D model on ``ax``: the
    quiver of (dW, dmu), the nullclines and the fixed points W = ±sqrt(var-1),
    mu = x_mean/W."""

    def w_dot(w, mu):
        return (1 / (1 + w**2) ** 2) * (
            w * (x_var + x_mean**2) + x_mean * mu * (1 - w**2) - w * mu**2 - w - w**3
        )

    def mu_dot(w, mu):
        return w * (x_mean - w * mu) / (w**2 + 1)

    w = np.arange(-10, 10.01, 0.01)
    W, MU = np.meshgrid(np.arange(-10, 11, 2), np.arange(-10, 11, 2))
    W_dot = w_dot(W, MU)
    MU_dot = mu_dot(W, MU)

    n_mu = x_mean / w
    with np.errstate(invalid="ignore", divide="ignore"):
        disc = ((w**2 - 1) * x_mean) ** 2 - 4 * w * (w**3 + w * (1 - x_var - x_mean**2))
        root = np.sqrt(disc)
        n_w_1 = (-(w**2 - 1) * x_mean + root) / (2 * w)
        n_w_2 = (-(w**2 - 1) * x_mean - root) / (2 * w)

    alpha = 0.5
    ax.quiver(W[W != 0], MU[W != 0], W_dot[W != 0] * 0.3, MU_dot[W != 0] * 0.3,
              color=[0.5, 0.5, 0.5], label=r"$\Delta \theta$")
    for sign in (w > 0, w < 0):
        ax.plot(w[sign], n_mu[sign], linewidth=1.6, color=[0, 0.5, 0, alpha])
        ax.plot(w[sign], n_w_1[sign], linewidth=1.6, color=[0.8, 0.6, 1.0, alpha])
        ax.plot(w[sign], n_w_2[sign], linewidth=1.6, color=[0.8, 0.6, 1.0, alpha])
    ax.scatter(
        np.sqrt(x_var - 1) * np.array([1, -1]),
        np.array([1, -1]) * x_mean / np.sqrt(x_var - 1),
        color="k", linewidth=2, facecolors="none", label="data",
    )
    return ax


def pc_landscape(ax, x_mean=1.0, x_var=5.0, cov0=1.0, cov1=1.0):
    """The expected PC (MAP-EM) parameter flow of the 1-D model on ``ax``,
    as ``mcpc_landscape`` draws MCPC's."""

    def w_dot(w, mu):
        return (1 / (cov0 + cov1 * w**2) ** 2) * (
            cov1 * w * (x_var + x_mean**2)
            + x_mean * mu * (cov0 - cov1 * w**2)
            - cov0 * w * mu**2
        )

    def mu_dot(w, mu):
        return w * (x_mean - w * mu) / (cov0 + cov1 * w**2)

    w = np.arange(-10, 10.01, 0.01)
    W, MU = np.meshgrid(np.arange(-10, 11, 2), np.arange(-10, 11, 2))
    with np.errstate(invalid="ignore", divide="ignore"):
        disc = ((cov0 - cov1 * w**2) * x_mean) ** 2 + 4 * cov0 * cov1 * w**2 * (
            x_var + x_mean**2
        )
        root = np.sqrt(disc)
        n_w_1 = (-(cov0 - cov1 * w**2) * x_mean + root) / (-2 * cov0 * w)
        n_w_2 = (-(cov0 - cov1 * w**2) * x_mean - root) / (-2 * cov0 * w)
        n_mu = x_mean / w

    alpha = 0.5
    ax.quiver(W[W != 0], MU[W != 0], w_dot(W, MU)[W != 0] * 0.5,
              mu_dot(W, MU)[W != 0] * 0.5, color=[0.5, 0.5, 0.5],
              label=r"$\Delta \theta$")
    for sign in (w > 0, w < 0):
        ax.plot(w[sign], n_mu[sign], linewidth=1.6, color=[0, 0.5, 0, alpha])
        ax.plot(w[sign], n_w_2[sign], linewidth=1.6, color=[0.8, 0.6, 1.0, alpha])
    ax.plot(w, n_w_1, linewidth=1.6, color=[0.8, 0.6, 1.0, alpha])
    ax.scatter(
        np.sqrt(x_var - 1) * np.array([1, -1]),
        np.array([1, -1]) * x_mean / np.sqrt(x_var - 1),
        color="k", linewidth=2, facecolors="none", label="data",
    )
    return ax


# -- 1-D training runs ----------------------------------------------------------


def _one_d_model(start, generator: torch.Generator, device) -> GenerativeModel:
    """``Linear(1,1) -> PC (standard-normal latent init) -> Linear(1,1), no
    bias`` with prior mean ``start[0]`` and weight ``start[1]``."""
    device = torch.device(device)
    model = PCModel([
        Linear(1, 1),
        PC(sample_x_fn=sample_x_fn_normal),
        Linear(1, 1, use_bias=False),
    ])
    params = ({"w": torch.zeros((1, 1), device=device),
               "b": torch.tensor([float(start[0])], device=device)},
              {"w": torch.tensor([[float(start[1])]], device=device)})
    return GenerativeModel(model, generator, params=params, device=device)


def _make_datas(ctx: ExperimentContext, n: int, batch_size: int, mu: float = DATA_MU,
                var: float = DATA_VAR, fold: int = 4) -> tp.List[torch.Tensor]:
    """``n`` batches ``[batch_size, 1]`` of y ~ N(mu, var) on ``ctx.device``,
    drawn from ``ctx.generator(fold)``."""
    g = ctx.generator(fold)
    return [mu + var**0.5 * random_tensor("normal", (batch_size, 1), g, torch.float32,
                                          ctx.device)
            for _ in range(n)]


def _as_batches(datas, device) -> tp.List[torch.Tensor]:
    """Given batches (tensors, or arrays copied) as f32 on ``device``."""
    return [(d if isinstance(d, torch.Tensor) else torch.from_numpy(np.array(d)))
            .to(device=device, dtype=torch.float32) for d in datas]


def _params_1d(gen: GenerativeModel) -> tp.Tuple[float, float]:
    """(prior mean mu, weight W) of a 1-D model."""
    return float(gen.params[0]["b"][0]), float(gen.params[1]["w"][0, 0])


def mcpc_linear_learning(ctx: ExperimentContext, datas=None) -> dict:
    """Panel (b): MCPC training of the 1-D model from four starts, one
    parameter step a batch (150 + 1 Langevin steps at lr 0.01, SGD with
    momentum 0.2 at lr 0.07 on the parameters), ``3 x n`` batches of 256
    (``n`` = 125 scaled; ``datas`` if given).  Returns the starts and, per
    start, the trajectory ``[3n + 1, 2]`` of (W, mu)."""
    n = ctx.steps(125, minimum=10)
    datas = (_make_datas(ctx, n, BATCH_1D) if datas is None
             else _as_batches(datas, ctx.device))
    pseudo = torch.zeros((datas[0].shape[0], 1), device=datas[0].device)
    config = {
        "input_var": 1.0,
        "mixing": 150,
        "sampling": 1,
        "optimizer_x_kwargs_mcpc": {"lr": 0.01},
        "optimizer_p_fn_mcpc": "sgd",
        "optimizer_p_kwargs_mcpc": {"lr": 0.07, "momentum": 0.2},
        "loss_fn": fe_fn,
    }
    starts = [(1, 7), (7, -7), (-8, 5), (-8, -4)]
    trajectories = []
    for si, start in enumerate(starts):
        gen = _one_d_model(start, ctx.generator(10 + si), ctx.device)
        trainer = get_mcpc_trainer(gen, config, training=True)
        traj = [(start[1], start[0])]
        for _ in range(EPOCHS_1D):
            for data in datas:
                trainer.train_on_batch(
                    pseudo, loss_fn=fe_fn,
                    loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
                    callback_after_t=LangevinStep(var=2.0),
                    is_sample_x_at_batch_start=False,
                    is_return_results_every_t=False,
                )
                mu, w = _params_1d(gen)
                traj.append((w, mu))
        trajectories.append(np.array(traj))
    return {"starts": starts, "trajectories": trajectories}


def pc_linear_learning(ctx: ExperimentContext, datas=None) -> dict:
    """Panel (c): PC training of the 1-D model from four starts (``T_pc`` =
    150 scaled Adam steps at lr 0.1 on the latent, then SGD with momentum 0.1
    at lr 0.4 on the parameters), ``3 x n`` batches (``n`` = 300 scaled).
    They converge to PC's fixed points, which are not the data's.  Returns
    as ``mcpc_linear_learning``."""
    n = ctx.steps(300, minimum=10)
    datas = (_make_datas(ctx, n, BATCH_1D) if datas is None
             else _as_batches(datas, ctx.device))
    pseudo = torch.zeros((datas[0].shape[0], 1), device=datas[0].device)
    config = {
        "input_var": 1.0,
        "T_pc": ctx.steps(150, minimum=20),
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.1},
        "optimizer_p_fn": "sgd",
        "optimizer_p_kwargs": {"lr": 0.4, "momentum": 0.1},
        "loss_fn": fe_fn,
    }
    starts = [(-8, -4), (1, 7), (-8, 5), (7, -7)]
    trajectories = []
    for si, start in enumerate(starts):
        gen = _one_d_model(start, ctx.generator(20 + si), ctx.device)
        trainer = get_pc_trainer(gen, config, is_mcpc=False, training=True)
        traj = [(start[1], start[0])]
        for _ in range(EPOCHS_1D):
            for data in datas:
                trainer.train_on_batch(
                    pseudo, loss_fn=fe_fn,
                    loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
                    is_return_results_every_t=False,
                )
                mu, w = _params_1d(gen)
                traj.append((w, mu))
        trajectories.append(np.array(traj))
    return {"starts": starts, "trajectories": trajectories}


def _draw_learning(ctx, result, landscape, color, label, name):
    plt = pyplot()
    plt.figure()
    setup_fig(zero=True)
    fig, ax = plt.subplots(figsize=(4.5, 4.0))
    landscape(ax, DATA_MU, DATA_VAR)
    for si, traj in enumerate(result["trajectories"]):
        ax.plot(traj[:, 0], traj[:, 1], color, linewidth=2.0,
                label=label if si == 0 else None)
    ax.set_xlabel(r"weight $W_0$")
    ax.set_ylabel(r"prior mean $\mu$")
    ax.set_xlim([-10, 10])
    ax.set_ylim([-10, 10])
    plt.legend(loc=1)
    plt.tight_layout()
    plt.savefig(ctx.fig_path(name))
    plt.close("all")


def draw_mcpc_linear_learning(ctx: ExperimentContext, result: dict) -> None:
    """Panel (b), ``4b.svg``: MCPC's trajectories over its landscape."""
    _draw_learning(ctx, result, mcpc_landscape, "C0", "MCPC", "4b.svg")


def draw_pc_linear_learning(ctx: ExperimentContext, result: dict) -> None:
    """Panel (c), ``4c.svg``: PC's trajectories over its landscape."""
    _draw_learning(ctx, result, pc_landscape, "r", "PC", "4c.svg")


def comparison_linear_model(ctx: ExperimentContext, datas=None,
                            num_samples: int = 15000) -> dict:
    """Panel (a): a PC model (``T_pc`` Adam steps at lr 0.5, Adam at lr 0.15
    on the parameters) and an MCPC model (1 Adam step, then 199 + 1 Langevin
    steps at lr 0.005, Adam at lr 0.07) trained from (mu, W) = (-7, -5) on
    ``3 x n`` batches (``n`` = 125 scaled), then ``num_samples`` ancestral
    samples of each.  Returns the samples (numpy), their variances, the
    data's variance and each model's final (mu, W)."""
    n = ctx.steps(125, minimum=10)
    start = (-7, -5)
    datas = (_make_datas(ctx, n, BATCH_1D) if datas is None
             else _as_batches(datas, ctx.device))
    pseudo = torch.zeros((datas[0].shape[0], 1), device=datas[0].device)
    config_pc = {
        "input_size": 1,
        "input_var": 1.0,
        "T_pc": ctx.steps(150, minimum=20),
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.5},
        "optimizer_p_fn": "adam",
        "optimizer_p_kwargs": {"lr": 0.15},
        "loss_fn": fe_fn,
    }
    config_mcpc = {
        "input_size": 1,
        "input_var": 1.0,
        "T_pc": 1,
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.5},
        "mixing": 199,
        "sampling": 1,
        "optimizer_x_kwargs_mcpc": {"lr": 0.005},
        "optimizer_p_fn_mcpc": "adam",
        "optimizer_p_kwargs_mcpc": {"lr": 0.07},
        "loss_fn": fe_fn,
    }
    gen_pc = _one_d_model(start, ctx.generator(30), ctx.device)
    gen_mc = _one_d_model(start, ctx.generator(31), ctx.device)
    pc_trainer = get_pc_trainer(gen_pc, config_pc, is_mcpc=False, training=True)
    pc_warm_mc = get_pc_trainer(gen_mc, config_mcpc, is_mcpc=True, training=True)
    mc_trainer = get_mcpc_trainer(gen_mc, config_mcpc, training=True)

    for _ in range(EPOCHS_1D):
        for data in datas:
            kwargs = {"_target": data, "_var": 1.0}
            pc_trainer.train_on_batch(pseudo, loss_fn=fe_fn, loss_fn_kwargs=kwargs,
                                      is_return_results_every_t=False)
            pc_warm_mc.train_on_batch(pseudo, loss_fn=fe_fn, loss_fn_kwargs=kwargs,
                                      is_return_results_every_t=False)
            mc_trainer.train_on_batch(
                pseudo, loss_fn=fe_fn, loss_fn_kwargs=kwargs,
                callback_after_t=LangevinStep(var=2.0),
                is_sample_x_at_batch_start=False, is_return_results_every_t=False,
            )

    pc_samples = sample_pc(num_samples, gen_pc, config_pc,
                           generator=ctx.generator(32)).cpu().numpy()
    mc_samples = sample_pc(num_samples, gen_mc, config_mcpc,
                           generator=ctx.generator(33)).cpu().numpy()
    return {
        "mcpc_samples": mc_samples,
        "pc_samples": pc_samples,
        "mcpc_var": float(mc_samples.var()),
        "pc_var": float(pc_samples.var()),
        "data_var": DATA_VAR,
        "mcpc_params": _params_1d(gen_mc),
        "pc_params": _params_1d(gen_pc),
    }


def draw_comparison_linear_model(ctx: ExperimentContext, result: dict) -> None:
    """Panel (a), ``4a.svg``: both models' sample histograms over the data's
    density."""
    plt = pyplot()
    y = np.linspace(-10, 10, 500)
    gen_pdf = np.exp(-0.5 * (y - DATA_MU) ** 2 / DATA_VAR) / np.sqrt(2 * np.pi * DATA_VAR)
    plt.figure()
    setup_fig(zero=True)
    plt.plot(y, gen_pdf, "k", label=r"$p(y)$", linewidth=3)
    plt.hist(result["mcpc_samples"].ravel(), bins=20, density=True, label="MCPC")
    plt.hist(result["pc_samples"].ravel(), bins=20, density=True, label="PC", color="r",
             alpha=0.6)
    plt.xlabel("$x_0$, y")
    plt.ylabel("probability density " + r"$p(x_0;\theta)$")
    plt.xlim([-12, 12])
    plt.legend(loc=0)
    plt.tight_layout()
    plt.savefig(ctx.fig_path("4a.svg"))
    plt.close()


# -- MNIST panels -----------------------------------------------------------------


def reconstruction_configs(ctx: ExperimentContext) -> tp.Tuple[dict, dict]:
    """Panel (e)'s MAP inference: ``mcpc_mse_1`` (10-256-256-784 relu) and
    ``pc_mse_1`` (30-256-256-784 tanh), ``T_pc`` = 250 scaled Adam steps at
    lr 0.7, Bernoulli, test batches of 1024."""
    config_mcpc = {
        "input_size": 10, "hidden_size": 256, "hidden2_size": 256,
        "output_size": 784, "loss_fn": bernoulli_fn, "activation_fn": "relu",
        "input_var": None,
        "T_pc": ctx.steps(250), "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.7},
        "mixing": ctx.steps(50), "sampling": ctx.steps(100),
        "optimizer_x_kwargs_mcpc": {"lr": 0.03},
    }
    config_pc = {
        "batch_size_train": 1024, "batch_size_val": 1024, "batch_size_test": 1024,
        "input_size": 30, "hidden_size": 256, "hidden2_size": 256,
        "output_size": 784, "loss_fn": bernoulli_fn, "activation_fn": "tanh",
        "input_var": None,
        "T_pc": ctx.steps(250), "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.7},
    }
    return config_mcpc, config_pc


def image_reconstruction(ctx: ExperimentContext, batch=None) -> dict:
    """Panel (e): the first test batch (or ``batch = (data, label)``) with
    its top half hidden, reconstructed by MAP inference of ``mcpc_mse_1``
    and ``pc_mse_1`` through ``PCTrainer`` (the masked Bernoulli loss on the
    visible half) and by the DLGM ``dlgm_mse_1``'s recognition means; each
    reconstruction keeps the visible half of the data.  Returns ``data``,
    ``label`` and the images ``img_pc``, ``img_mc``, ``img_dlgm`` ``[B,
    784]`` (numpy)."""
    config_mcpc, config_pc = reconstruction_configs(ctx)
    gen_mcpc = load_generative_checkpoint(ctx, "mcpc_mse_1", config_mcpc)
    gen_pc = load_generative_checkpoint(ctx, "pc_mse_1", config_pc)
    dlgm = _load_dlgm(ctx, "dlgm_mse_1")
    if batch is None:
        _, _, test_loader = get_mnist_data(config_pc, device=ctx.device)
        batch = next(iter(test_loader))
    data, label = (torch.as_tensor(t).to(ctx.device) for t in batch)
    k = round(data.shape[1] / 2)

    for gen, config in ((gen_mcpc, config_mcpc), (gen_pc, config_pc)):
        trainer = get_pc_trainer(gen, config, training=False, is_mcpc=True)
        trainer.train_on_batch(
            torch.zeros((data.shape[0], config["input_size"]), device=data.device),
            loss_fn=bernoulli_fn_mask, loss_fn_kwargs={"_target": data},
            is_return_results_every_t=False,
        )
    masked = data.clone()
    masked[:, :-k] = 0.0
    with torch.no_grad(), full_f32_matmul():
        img_mc = torch.sigmoid(decode_from_deepest_latent(gen_mcpc))
        img_pc = torch.sigmoid(decode_from_deepest_latent(gen_pc))
        mus, _ = recognition_forward(dlgm.rec_params, dlgm.factors, masked)
        img_dlgm = generative_forward(dlgm.gen_params, mus)
    out = {"data": data.cpu().numpy(), "label": label.cpu().numpy()}
    for name, img in (("img_mc", img_mc), ("img_pc", img_pc), ("img_dlgm", img_dlgm)):
        img = img.clone()
        img[:, -k:] = data[:, -k:]
        out[name] = img.cpu().numpy()
    return out


def draw_image_reconstruction(ctx: ExperimentContext, result: dict) -> None:
    """Panel (e), ``4e.svg``: for each digit one image, as input (top half
    hidden), PC, MCPC and DLGM."""
    plt = pyplot()
    _, axs = plt.subplots(4, 10, sharey=True, sharex=True)
    for i in range(10):
        rows = np.where(result["label"] == i)[0]
        idx = rows[min(5, len(rows) - 1)] if len(rows) else 0
        d = result["data"][idx].reshape(28, 28).copy()
        d[: 28 - round(28 / 2), :] = 0.0
        for r, img in enumerate([d, result["img_pc"][idx].reshape(28, 28),
                                 result["img_mc"][idx].reshape(28, 28),
                                 result["img_dlgm"][idx].reshape(28, 28)]):
            axs[r][i].imshow(img, cmap="gray")
            axs[r][i].set_xticks([])
            axs[r][i].set_yticks([])
    for r, name in enumerate(["input", "PC", "MCPC", "DLGM"]):
        axs[r][0].set_ylabel(name)
    plt.savefig(ctx.fig_path("4e.svg"))
    plt.close()


def image_generation(ctx: ExperimentContext, num: int = 256) -> dict:
    """Panel (d): ``num`` ancestral samples of ``pc_fid_1`` (sigmoid of the
    logits) and ``num`` prior samples of the DLGM ``dlgm_fid_1``
    (probabilities), ``[num, 28, 28]`` numpy each."""
    config_pc = {
        "input_size": 20, "hidden_size": 128, "hidden2_size": 128,
        "output_size": 784, "loss_fn": bernoulli_fn, "activation_fn": "relu",
        "T_pc": 250, "optimizer_x_fn_pc": "adam", "optimizer_x_kwargs_pc": {"lr": 0.1},
    }
    gen_pc = load_generative_checkpoint(ctx, "pc_fid_1", config_pc)
    dlgm = _load_dlgm(ctx, "dlgm_fid_1")
    with torch.no_grad(), full_f32_matmul():
        pc_samples = torch.sigmoid(sample_pc(num, gen_pc, config_pc,
                                             generator=ctx.generator(42),
                                             is_return_hidden=True))
    dlgm.generator = ctx.generator(43)
    dlgm_samples = dlgm.generate_samples(num, is_return_hidden=True)
    return {"pc": pc_samples.reshape(-1, 28, 28).cpu().numpy(),
            "dlgm": dlgm_samples.cpu().numpy()}


def draw_image_generation(ctx: ExperimentContext, result: dict, n: int = 8) -> None:
    """Panel (d), ``4d.svg``: ``n`` samples of each model, PC above DLGM."""
    plt = pyplot()
    num = len(result["pc"])
    _, axs = plt.subplots(2, n, sharey=True, sharex=True)
    for i in range(n):
        axs[0][i].imshow(result["pc"][(num // n) * i], cmap="gray")
        axs[1][i].imshow(result["dlgm"][(num // n) * i], cmap="gray")
        for r in range(2):
            axs[r][i].set_xticks([])
            axs[r][i].set_yticks([])
    axs[0][0].set_ylabel("PC")
    axs[1][0].set_ylabel("DLGM")
    plt.savefig(ctx.fig_path("4d.svg"))
    plt.close()


if __name__ == "__main__":
    args = standard_parser(__doc__).parse_args()
    ctx = context_from_args(args)
    draw_comparison_linear_model(ctx, comparison_linear_model(ctx))
    draw_mcpc_linear_learning(ctx, mcpc_linear_learning(ctx))
    draw_pc_linear_learning(ctx, pc_linear_learning(ctx))
    draw_image_reconstruction(ctx, image_reconstruction(ctx))
    draw_image_generation(ctx, image_generation(ctx))

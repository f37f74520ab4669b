"""Figure 2 (a, b): the 1-D linear-Gaussian model, whose MCPC Langevin
samples match the closed-form posterior while PC lands on its mode; (c, d):
the nonlinear MNIST model's class posteriors for a masked digit, PC's MAP
against MCPC's Langevin samples, read through a linear probe of the first
latent; (e): how far each is from the ResNet-9 ideal observer's posterior
(KL).

    python3 -m montecarlopredictivecoding_tpu_torch.experiments.figure_2 --full

``posterior_linear_model``, ``posterior_non_linear_model`` and
``comparison_ideal_observer`` compute; ``draw_posterior_linear_model``,
``draw_posteriors`` and ``draw_ideal_observer`` draw (they alone import
matplotlib).  The 1-D model is outside the fused chain's family, so
``PCTrainer`` runs panels (a, b) in its step engine, on ``ctx.device``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.losses import bernoulli_fn, bernoulli_fn_mask, fe_fn
from ..core.model import PCModel
from ..core.modules import PC, Linear, sample_x_fn_cte
from ..core.trainer import GenerativeModel, LangevinStep
from ..data import get_mnist_data
from ..eval.classifier import get_representations, train_linear_classifier
from ..eval.metrics import kl_divergence_discrete
from ..models.factory import get_mcpc_trainer, get_pc_trainer
from ..utils.plotting import animate_frames, proba_to_coordinate, pyplot, setup_fig
from .common import ExperimentContext, context_from_args, load_generative_checkpoint, standard_parser


# panels (a, b): prior mean, weight, observation variance and the observation
POST_MU0, POST_W, POST_VAR, POST_Y = 0.2, 2.0, 1.0, 1.0


def linear_posterior_density(x: np.ndarray) -> np.ndarray:
    """The closed-form posterior p(x1 | y) of the 1-D model at ``x``: a
    Gaussian of mean 0.44 and variance 0.2."""
    mu0, w, var, y = POST_MU0, POST_W, POST_VAR, POST_Y
    return (np.sqrt(w**2 + var) / np.sqrt(2 * np.pi * var)
            * np.exp(-0.5 * ((x - mu0) ** 2 + (y - w * x) ** 2 / var
                             - (y - w * mu0) ** 2 / (w**2 + var))))


def posterior_linear_model(ctx: ExperimentContext) -> dict:
    """Panels (a, b): the model x1 ~ N(0.2, 1), y ~ N(2 x1, 1), observed
    y = 1, latent started at 3.  ``T_pc`` Adam steps (lr 0.02) find the MAP;
    then, from 3 again, ``sampling`` Langevin steps (lr 0.02, noise variance
    2) sample the posterior N(0.44, 0.2).  Returns the MAP, the samples after
    the mixing steps, both trajectories (numpy) and the samples' mean and
    variance."""
    device = torch.device(ctx.device)
    model = PCModel([
        Linear(1, 1),
        PC(sample_x_fn=sample_x_fn_cte),
        Linear(1, 1, use_bias=False),
    ])
    params = ({"w": torch.zeros((1, 1), device=device),
               "b": torch.tensor([POST_MU0], device=device)},
              {"w": torch.tensor([[POST_W]], device=device)})
    gen = GenerativeModel(model, ctx.generator(0), params=params, device=device)
    config = {
        "input_var": POST_VAR,
        "T_pc": ctx.steps(2000),
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.02},
        "mixing": 0,
        "sampling": ctx.steps(10000),
        "optimizer_x_kwargs_mcpc": {"lr": 0.02},
        "optimizer_p_fn_mcpc": "adam",
        "loss_fn": fe_fn,
    }
    pc_trainer = get_pc_trainer(gen, config, is_mcpc=True, training=False)
    mcpc_trainer = get_mcpc_trainer(gen, config, training=False)

    data = torch.full((1, 1), POST_Y, device=device)
    pseudo = torch.zeros((1, 1), device=device)
    kwargs = {"_target": data, "_var": POST_VAR}
    pc_results = pc_trainer.train_on_batch(
        pseudo, loss_fn=fe_fn, loss_fn_kwargs=kwargs, is_return_representations=True)
    map_est = float(gen.latents[0][0, 0])
    mc_results = mcpc_trainer.train_on_batch(
        pseudo, loss_fn=fe_fn, loss_fn_kwargs=kwargs,
        callback_after_t=LangevinStep(var=2.0),
        is_sample_x_at_batch_start=True, is_return_representations=True,
    )
    mc_traj = mc_results["representations"][:, 0, 0].cpu().numpy()
    samples = mc_traj[config["mixing"]:]
    return {
        "map": map_est,
        "samples": samples,
        "mc_traj": mc_traj,
        "pc_traj": pc_results["representations"][:, 0, 0].cpu().numpy(),
        "samples_mean": float(samples.mean()),
        "samples_var": float(samples.var()),
    }


def draw_posterior_linear_model(ctx: ExperimentContext, result: dict) -> None:
    """Panel b (``2b.svg``: the samples' histogram over the posterior, the
    MAP), panel a (``2a.svg``: both trajectories) and ``2b.gif`` (the
    histogram building up over the chain)."""
    plt = pyplot()
    x_post = np.linspace(-10, 10, 1000)
    post = linear_posterior_density(x_post)
    samples = result["samples"]

    plt.figure()
    setup_fig(zero=False)
    plt.plot(x_post, post, "k", label=r"$p(x_1|y;\theta)$", linewidth=3)
    plt.hist(samples, bins=20, density=True, label="MCPC")
    plt.vlines(result["map"], 0, 1, colors="r", label="PC", linewidth=3)
    plt.xlabel(r"$x_1$")
    plt.ylabel("probability density")
    plt.xlim([-2, 4.5])
    plt.ylim([0, 1.0])
    plt.legend(loc=1)
    plt.tight_layout()
    plt.savefig(ctx.fig_path("2b.svg"))
    plt.close()

    plt.figure()
    setup_fig()
    mc_traj = result["mc_traj"]
    plt.plot(mc_traj, "C0", label="MCPC", linewidth=2.5)
    plt.plot(result["pc_traj"], "red", label="PC", linewidth=3)
    plt.xlim([-5, min(1000, len(mc_traj))])
    plt.ylim([-1.1, 3.1])
    plt.xlabel("time (AU)")
    plt.ylabel(r"$x_1$")
    plt.legend()
    plt.tight_layout()
    plt.savefig(ctx.fig_path("2a.svg"))
    plt.close()

    anim = samples[:: max(len(samples) // 100, 1)][:100]

    def frame(i, ax):
        ax.hist(anim[: i + 1], density=True, bins=np.linspace(-1.5, 2.5, 20),
                label=r"hist($x_1(t)$), [0, t]")
        ax.plot(x_post, post, "k", label=r"$p(x_1|y;\theta)$", linewidth=3)
        ax.scatter(anim[i], 0, c="orange", s=70, label=r"$x_1$(t)")
        ax.set_xlabel(r"$x_1$")
        ax.set_ylabel("probability")
        ax.set_xlim([-1.5, 3.5])
        ax.set_ylim([-0.1, 1.4])
        ax.legend(loc=1)

    animate_frames(frame, len(anim), ctx.fig_path("2b.gif"), fps=25)


def _mnist_config(ctx: ExperimentContext) -> dict:
    """The nonlinear-inference configuration (20-128-128-784, relu,
    Bernoulli; 2000 Adam MAP steps at lr 0.1, then 1000 + 9000 Langevin steps
    at lr 0.03), step counts scaled by ``ctx.scale``."""
    return {
        "batch_size_train": 1024,
        "batch_size_val": 1024,
        "batch_size_test": 1024,
        "input_size": 20,
        "hidden_size": 128,
        "hidden2_size": 128,
        "output_size": 784,
        "loss_fn": bernoulli_fn,
        "activation_fn": "relu",
        "input_var": None,
        "T_pc": ctx.steps(2000),
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.1},
        "mixing": ctx.steps(1000),
        "sampling": ctx.steps(9000),
        "optimizer_x_kwargs_mcpc": {"lr": 0.03},
    }


def _train_probe(ctx, gen, config, n_batches: int = 2):
    """MAP representations of (a slice of) the training set, then the linear
    classifier probe."""
    train_loader, _, _ = get_mnist_data(config, device=ctx.device)
    batches = []
    for i, b in enumerate(train_loader):
        if i >= n_batches:
            break
        batches.append(b)
    pc_trainer = get_pc_trainer(gen, config, training=False, is_mcpc=True)
    reps, labels = get_representations(gen, config, [pc_trainer], batches, rep_type="MAP")
    clf, acc = train_linear_classifier(reps, labels, epochs=10, device=ctx.device)
    print(f"linear probe train accuracy: {acc:.3f}")
    return clf


def posterior_non_linear_model(ctx: ExperimentContext, img_kept: float = 0.5,
                               digit: int = 4, n_images: int = 16):
    """Class posteriors of up to ``n_images`` test images of ``digit`` whose
    last ``img_kept`` of the pixels are clamped.  Returns ``(preds_pc,
    preds_mc)``: the probe's softmax over PC's MAP trajectory ``[T_pc, B,
    10]`` and over MCPC's samples after the mixing steps ``[sampling, B,
    10]``."""
    config = _mnist_config(ctx)
    gen = load_generative_checkpoint(ctx, "mcpc_ml_2", config)
    gen.generator = ctx.generator(1)
    clf = _train_probe(ctx, gen, config)

    _, _, test_loader = get_mnist_data(config, device=ctx.device)
    data, label = next(iter(test_loader))
    sel = torch.nonzero(label == digit)[:n_images, 0]
    data = data[sel]

    pc_trainer = get_pc_trainer(gen, config, training=False, is_mcpc=True)
    mcpc_trainer = get_mcpc_trainer(gen, config, training=False)
    pseudo = torch.zeros((data.shape[0], config["input_size"]), device=data.device)
    kwargs = {"_target": data, "_var": config["input_var"], "perc": img_kept}
    pc_results = pc_trainer.train_on_batch(
        pseudo, loss_fn=bernoulli_fn_mask, loss_fn_kwargs=kwargs,
        is_return_representations=True,
    )
    mc_results = mcpc_trainer.train_on_batch(
        pseudo, loss_fn=bernoulli_fn_mask, loss_fn_kwargs=kwargs,
        callback_after_t=LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False, is_return_representations=True,
    )
    w = clf.params["w"].cpu().numpy()
    b = clf.params["b"].cpu().numpy()

    def probs(reps):  # [T, B, d] -> [T, B, 10] softmax of the probe
        return _softmax(reps.cpu().numpy() @ w + b)

    preds_pc = probs(pc_results["representations"])
    preds_mc = probs(mc_results["representations"])[config["mixing"]:]
    return preds_pc, preds_mc


def draw_posteriors(ctx: ExperimentContext, preds_pc, preds_mc, img_kept: float = 0.5):
    """The simplex plots of ``posterior_non_linear_model``'s output: one per
    image under ``digit_posteriors/``, and the fifth as 2c (full image) or
    2d (masked)."""
    plt = pyplot()

    file_type = "full" if img_kept == 1.0 else "masked"
    os.makedirs(ctx.fig_path("digit_posteriors"), exist_ok=True)
    for idx in range(min(10, preds_pc.shape[1])):
        coor_pc, _ = proba_to_coordinate(preds_pc[-1, idx])
        coor_prev, class_coor = proba_to_coordinate(preds_mc[:, idx])
        fig, axs = plt.subplots(1, 1, constrained_layout=True)
        axs.set_aspect("equal")
        plt.axis("off")
        axs.hexbin(coor_prev[0], coor_prev[1], gridsize=20, cmap="Blues",
                   extent=(-1, 1, -1, 1), label="MCPC")
        for d in range(10):
            axs.text(1.15 * class_coor[0][d] - 0.038, 1.15 * class_coor[1][d] - 0.04,
                     str(d), fontsize=20)
        axs.scatter(coor_pc[0], coor_pc[1], edgecolors="red", linewidths=6, marker="o",
                    facecolors="none", label="PC")
        axs.set_xlim([-1.2, 1.2])
        axs.set_ylim([-1.2, 1.2])
        plt.legend(fontsize=14, loc=3)
        plt.savefig(os.path.join(ctx.fig_path("digit_posteriors"), f"{file_type}_{idx}.svg"))
        if idx == 4:
            plt.savefig(ctx.fig_path("2c.svg" if img_kept == 1.0 else "2d.svg"))
        plt.close(fig)


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _norm(p):
    return p / p.sum(-1, keepdims=True)


def comparison_ideal_observer(ctx: ExperimentContext, resnet_state=None) -> dict:
    """KL(ideal observer ‖ posterior) on one test batch of 128 images whose
    top half is hidden: the PC MAP posterior and the MCPC sample posterior
    of ``mcpc_ml_2`` through the linear probe, and each with its rows
    shuffled as the chance level.  Returns ``{"MCPC", "PC", "MC shuffled",
    "PC shuffled"}``.

    ``resnet_state`` is a full-image ResNet-9 state (for example
    ``models.resnet9.load_resnet9("models/resnet9.msgpack")[1]``); without
    one a ResNet-9 is trained for an epoch."""
    from ..models.resnet9 import ResNet9, make_eval_fn, train_resnet9

    config = _mnist_config(ctx)
    config["batch_size_test"] = 128
    gen = load_generative_checkpoint(ctx, "mcpc_ml_2", config)
    gen.generator = ctx.generator(2)
    clf = _train_probe(ctx, gen, config)

    _, _, test_loader = get_mnist_data(config, device=ctx.device)
    if resnet_state is None:
        train_loader, _, _ = get_mnist_data(config, device=ctx.device)
        model, resnet_state = train_resnet9(train_loader, generator=ctx.generator(3),
                                            epochs=1, device=ctx.device)
    else:
        model = ResNet9().to(ctx.device)
    logits_fn = make_eval_fn(model)

    pc_trainer = get_pc_trainer(gen, config, is_mcpc=True, training=False)
    mcpc_trainer = get_mcpc_trainer(gen, config, training=False)
    w = clf.params["w"].cpu().numpy()
    b = clf.params["b"].cpu().numpy()

    # the reference iterates the whole test loader; one batch here, as in
    # the JAX package
    data, _ = next(iter(test_loader))
    pseudo = torch.zeros((data.shape[0], config["input_size"]), device=data.device)
    kwargs = {"_target": data, "_var": config["input_var"]}
    pc_trainer.train_on_batch(pseudo, loss_fn=bernoulli_fn_mask, loss_fn_kwargs=kwargs)
    p_pc = _norm(_softmax(gen.latents[0].cpu().numpy() @ w + b) + 1e-4)
    res = mcpc_trainer.train_on_batch(
        pseudo, loss_fn=bernoulli_fn_mask, loss_fn_kwargs=kwargs,
        callback_after_t=LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False, is_return_representations=True,
    )
    reps = res["representations"][config["mixing"]:].cpu().numpy()
    p_mc = _norm(_softmax(reps @ w + b).mean(0) + 1e-4)

    imgs = data.reshape(-1, 1, 28, 28).clone()
    imgs[:, :, :14, :] = 0.0  # the ideal observer sees the masked image
    p_cnn = _softmax(logits_fn(resnet_state, imgs).cpu().numpy())

    rng = np.random.RandomState(ctx.seed)
    return {
        "MCPC": kl_divergence_discrete(p_cnn, p_mc),
        "PC": kl_divergence_discrete(p_cnn, p_pc),
        "MC shuffled": kl_divergence_discrete(p_cnn, p_mc[rng.permutation(len(p_mc))]),
        "PC shuffled": kl_divergence_discrete(p_cnn, p_pc[rng.permutation(len(p_pc))]),
    }


def draw_ideal_observer(ctx: ExperimentContext, kls: dict):
    """Panel e: the KL bars of MCPC, PC and the shuffled mean, as 2e.svg."""
    plt = pyplot()

    for name, kl in kls.items():
        print(f"{name:12s} KL {kl:.6f}")
    fig = plt.figure()
    setup_fig()
    vals = [kls["MCPC"], kls["PC"], (kls["MC shuffled"] + kls["PC shuffled"]) / 2]
    bars = plt.bar(["MCPC", "PC", "random"], vals, width=0.6)
    for bar, c in zip(bars, ["C0", "r", "grey"]):
        bar.set_color(c)
    plt.ylabel("KL divergence")
    plt.tight_layout()
    plt.savefig(ctx.fig_path("2e.svg"))
    plt.close(fig)


if __name__ == "__main__":
    args = standard_parser(__doc__).parse_args()
    ctx = context_from_args(args)
    draw_posterior_linear_model(ctx, posterior_linear_model(ctx))
    for kept in (0.5, 1.0):
        draw_posteriors(ctx, *posterior_non_linear_model(ctx, img_kept=kept), img_kept=kept)
    draw_ideal_observer(ctx, comparison_ideal_observer(ctx))

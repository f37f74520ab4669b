"""Figure 2 (c, d): the nonlinear MNIST model's class posteriors for a
masked digit, PC's MAP against MCPC's Langevin samples, read through a
linear probe of the first latent; (e): how far each is from the ResNet-9
ideal observer's posterior (KL).

    python3 -m montecarlopredictivecoding_tpu_torch.experiments.figure_2 --full

``posterior_non_linear_model`` and ``comparison_ideal_observer`` compute;
``draw_posteriors`` and ``draw_ideal_observer`` draw (they alone import
matplotlib).  Panels (a, b), the 1-D linear-Gaussian model, wait for their
ROADMAP.md item.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.losses import bernoulli_fn, bernoulli_fn_mask
from ..core.trainer import LangevinStep
from ..data import get_mnist_data
from ..eval.classifier import get_representations, train_linear_classifier
from ..eval.metrics import kl_divergence_discrete
from ..models.factory import get_mcpc_trainer, get_pc_trainer
from ..utils.plotting import proba_to_coordinate
from .common import ExperimentContext, context_from_args, load_generative_checkpoint, standard_parser


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
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.plotting import setup_fig

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
    for kept in (0.5, 1.0):
        draw_posteriors(ctx, *posterior_non_linear_model(ctx, img_kept=kept), img_kept=kept)
    draw_ideal_observer(ctx, comparison_ideal_observer(ctx))

"""Figure 3: generation by unclamped Langevin sampling.

(a) A 1-D linear model with a trailing PC site at the output (the sensory
    unit itself is an unclamped latent): the chain's x0 samples match the
    closed-form marginal p(x0) = N(w*mu, w^2 + var).  The model is outside
    the fused chain's family, so ``PCTrainer`` runs it in its step engine.
(b) MNIST: a long unclamped chain (1000 + 30000 Langevin steps, B=1) on a
    trained relu model (checkpoint ``mcpc_fid_3``) wanders across digit
    classes; the captured outputs become a grid of frames and a GIF.  Both
    trainers run the fused chain (the kernel on CUDA).

    python3 -m montecarlopredictivecoding_tpu_torch.experiments.figure_3 --full

``generation_linear_model`` and ``generation_non_linear_model`` compute and
return their numbers; ``draw_linear_model`` and ``draw_non_linear_model``
draw them (they alone import matplotlib).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.losses import zero_fn
from ..core.model import PCModel
from ..core.modules import PC, Linear, sample_x_fn, scaled_gaussian_energy
from ..core.trainer import GenerativeModel, LangevinStep
from ..models.factory import get_mcpc_trainer, get_pc_trainer
from ..utils.plotting import animate_frames, generate_video, pyplot, setup_fig
from .common import ExperimentContext, context_from_args, load_generative_checkpoint, standard_parser

# panel (a): prior mean, weight and output variance of the 1-D model
MU0, W, INPUT_VAR = 0.5, 2.0, 1.0


def generation_linear_model(ctx: ExperimentContext) -> dict:
    """Panel (a): ``T_pc`` Adam steps (lr 0.5) then ``sampling`` unclamped
    Langevin steps (lr 0.3, noise variance 2) on the 1-D model with an
    output PC site of energy (1/var)*0.5*(mu-x)^2.  Returns the sensory
    samples ``x0`` (numpy) and their mean and variance; the marginal they
    sample is N(w*mu0, w^2 + var) = N(1, 5)."""
    model = PCModel([
        Linear(1, 1),
        PC(sample_x_fn=sample_x_fn),
        Linear(1, 1, use_bias=False),
        PC(energy_fn=scaled_gaussian_energy(INPUT_VAR), sample_x_fn=sample_x_fn),
    ])
    device = torch.device(ctx.device)
    params = ({"w": torch.zeros((1, 1), device=device),
               "b": torch.tensor([MU0], device=device)},
              {"w": torch.tensor([[W]], device=device)})
    gen = GenerativeModel(model, ctx.generator(1), params=params, device=device)
    config = {
        "T_pc": ctx.steps(250),
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.5},
        "mixing": 0,
        "sampling": ctx.steps(10000),
        "optimizer_x_kwargs_mcpc": {"lr": 0.3},
        "input_var": INPUT_VAR,
    }
    pc_trainer = get_pc_trainer(gen, config, is_mcpc=True, training=False)
    mcpc_trainer = get_mcpc_trainer(gen, config, training=False)

    pseudo = torch.zeros((1, 1), device=device)
    pc_trainer.train_on_batch(pseudo, loss_fn=None)
    mc_results = mcpc_trainer.train_on_batch(
        pseudo,
        loss_fn=None,
        callback_after_t=LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False,
        is_return_xs=True,
    )
    # the sensory samples are the second PC latent (x0)
    x0 = mc_results["xs"][1][config["mixing"]:, 0, 0].cpu().numpy()
    return {"x0": x0, "mean": float(x0.mean()), "var": float(x0.var())}


def non_linear_config(ctx: ExperimentContext) -> dict:
    """Panel (b)'s configuration: 20-128-128-784 relu, no sensory loss,
    ``T_pc`` Adam steps at lr 0.7, then 1000 + 30000 Langevin steps at lr
    0.1, step counts scaled by ``ctx.scale``."""
    return {
        "input_size": 20,
        "hidden_size": 128,
        "hidden2_size": 128,
        "output_size": 784,
        "activation_fn": "relu",
        "loss_fn": zero_fn,
        "T_pc": ctx.steps(250),
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.7},
        "mixing": ctx.steps(1000),
        "sampling": ctx.steps(30000),
        "optimizer_x_kwargs_mcpc": {"lr": 0.1},
    }


def generation_non_linear_model(ctx: ExperimentContext) -> dict:
    """Panel (b): a PC warm start, then an unclamped Langevin chain of
    ``mixing + sampling`` steps on one sample of the ``mcpc_fid_3`` model,
    capturing the outputs about 600 times.  Returns the frames ``ims``
    (sigmoid of the captured outputs, ``[n, 28, 28]`` numpy), the capture
    ``stride`` and the index of the first frame after the mixing steps."""
    config = non_linear_config(ctx)
    gen = load_generative_checkpoint(ctx, "mcpc_fid_3", config)
    pc_trainer = get_pc_trainer(gen, config, training=False, is_mcpc=True)
    mcpc_trainer = get_mcpc_trainer(gen, config, training=False)

    pseudo = torch.zeros((1, config["input_size"]), device=torch.device(ctx.device))
    pc_trainer.train_on_batch(pseudo, loss_fn=None)
    stride = max((config["mixing"] + config["sampling"]) // 600, 1)
    mc_results = mcpc_trainer.train_on_batch(
        pseudo,
        loss_fn=config["loss_fn"],
        loss_fn_kwargs={},
        callback_after_t=LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False,
        is_return_outputs=True,
        capture_stride=stride,
    )
    outputs = mc_results["outputs"]  # [T / stride, 1, 784]
    ims = torch.sigmoid(outputs[:, 0, :]).reshape(-1, 28, 28).cpu().numpy()
    return {"ims": ims, "stride": stride, "start": config["mixing"] // stride}


def draw_linear_model(ctx: ExperimentContext, result: dict) -> None:
    """Panel (a): the histogram of the samples over the marginal's density
    (``3a.svg``) and its build-up over the chain (``3a.gif``)."""
    plt = pyplot()

    x0 = result["x0"]
    y = np.linspace(-10, 10, 500)
    var = W**2 + INPUT_VAR
    gen_pdf = np.exp(-0.5 * (y - MU0 * W) ** 2 / var) / np.sqrt(2 * np.pi * var)

    plt.figure()
    setup_fig(zero=True)
    plt.plot(y, gen_pdf, "k", label=r"$p(x_0;\theta)$", linewidth=3)
    plt.hist(x0, bins=20, density=True, label="MCPC")
    plt.xlabel("$x_0$")
    plt.ylabel("probability density")
    plt.xlim([-6, 9])
    plt.ylim([0, 0.22])
    plt.legend(loc=1)
    plt.tight_layout()
    plt.savefig(ctx.fig_path("3a.svg"))
    plt.close()

    anim = x0[:: max(len(x0) // 100, 1)][:100]

    def frame(i, ax):
        ax.hist(anim[: i + 1], density=True, bins=np.linspace(-12, 12, 20),
                label="hist($x_0(t)$), [0, t]")
        ax.plot(y, gen_pdf, "k", label=r"$p(x_0;\theta)$", linewidth=3)
        ax.scatter(anim[i], 0, c="orange", s=70, label=r"x$_0$(t)")
        ax.set_xlabel("$x_0$")
        ax.set_ylabel("probability density")
        ax.set_xlim([-10, 10])
        ax.set_ylim([-0.025, 0.3])
        ax.legend(loc=0)

    animate_frames(frame, len(anim), ctx.fig_path("3a.gif"), fps=25)


def draw_non_linear_model(ctx: ExperimentContext, result: dict) -> None:
    """Panel (b): ten frames after the mixing steps as a 2x5 grid
    (``3b_and_4d.svg``) and the chain as a GIF (``3b_and_4d.gif``)."""
    plt = pyplot()

    ims, start = result["ims"], result["start"]
    nrow, ncol = 2, 5
    _, axs = plt.subplots(nrow, ncol, sharey=True)
    indent = max((len(ims) - start) // (nrow * ncol), 1)
    for i in range(nrow * ncol):
        idx = min(start + i * indent, len(ims) - 1)
        axs[i // ncol, i % ncol].imshow(ims[idx], cmap="gray")
        axs[i // ncol][i % ncol].axis("off")
    plt.suptitle("Generated with sampler")
    plt.savefig(ctx.fig_path("3b_and_4d.svg"))
    plt.close()

    os.makedirs(ctx.path_figures, exist_ok=True)
    generate_video(
        ims[:: max(len(ims) // 150, 1)],
        save=True,
        title="input neuron activity",
        file_name="3b_and_4d",
        out_dir=ctx.path_figures,
    )


if __name__ == "__main__":
    args = standard_parser(__doc__).parse_args()
    ctx = context_from_args(args)
    draw_linear_model(ctx, generation_linear_model(ctx))
    draw_non_linear_model(ctx, generation_non_linear_model(ctx))

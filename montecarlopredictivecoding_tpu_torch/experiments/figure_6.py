"""Figure 6: robustness to the Langevin noise's variance.

For each noise variance of a sweep, train the 1-D model with one-sample
MCPC, then sample the trained generative model with a trailing output PC
site; (a) the generated density at four variances, (b) the generated
variance and (c) the learned |W| against the noise variance.  The ideal
curve is |W| = sqrt(2 var / sigma^2 - 1), and learning degrades away from
the correct noise variance 2.

    python3 -m montecarlopredictivecoding_tpu_torch.experiments.figure_6 --full

Both models are outside the fused chain's family, so ``PCTrainer`` runs
them in its step engine, on ``ctx.device``.  ``varying_langevin_noise``
computes; ``draw_varying_langevin_noise`` draws (it alone imports
matplotlib).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.losses import fe_fn
from ..core.model import PCModel
from ..core.modules import PC, Linear, sample_x_fn_normal, scaled_gaussian_energy
from ..core.trainer import GenerativeModel, LangevinStep
from ..models.factory import get_mcpc_trainer_one_sample
from ..utils.plotting import pyplot, setup_fig
from .common import ExperimentContext, context_from_args, standard_parser
from .figure_4 import _as_batches, _make_datas, _params_1d

# the data y ~ N(DATA_MU, DATA_VAR) in batches of 2048, and the start (mu, W)
DATA_MU, DATA_VAR, BATCH, START = 1.0, 5.0, 2048, (-7.0, -5.0)


def varying_langevin_noise(ctx: ExperimentContext, noise_vars, datas=None) -> dict:
    """For each noise variance: ``epochs`` (10 scaled) passes over ``n``
    (25 scaled) batches (``datas`` if given), each batch ``K`` (150 scaled)
    Langevin steps from a fresh standard-normal latent and one Adam step on
    the parameters from the last sample (the Langevin lr and the parameter
    lr coupled to the noise variance); then ``K_gen`` (10,000 scaled)
    Langevin steps of the model with an output PC site of variance 1 from
    fresh latents, whose last output is the generated batch.  Returns the
    noise variances, the generated batches ``[len, 2048]``, their variances
    and the learned (mu, W) ``[len, 2]`` (numpy)."""
    noise_vars = np.asarray(noise_vars, dtype=np.float64)
    n = ctx.steps(25, minimum=4)
    epochs = ctx.steps(10, minimum=2)
    datas = (_make_datas(ctx, n, BATCH, DATA_MU, DATA_VAR, fold=6) if datas is None
             else _as_batches(datas, ctx.device))
    device = datas[0].device
    pseudo = torch.zeros((datas[0].shape[0], 1), device=device)

    generated, weights = [], []
    for idx, noise_var in enumerate(noise_vars):
        noise_var = float(noise_var)
        model = PCModel([
            Linear(1, 1),
            PC(sample_x_fn=sample_x_fn_normal),
            Linear(1, 1, use_bias=False),
        ])
        params = ({"w": torch.zeros((1, 1), device=device),
                   "b": torch.tensor([START[0]], device=device)},
                  {"w": torch.tensor([[START[1]]], device=device)})
        gen = GenerativeModel(model, ctx.generator(100 + idx), params=params, device=device)
        config = {
            "input_var": 1.0,
            "K": ctx.steps(150, minimum=20),
            "optimizer_x_kwargs_mcpc": {"lr": float(np.clip(0.01 * noise_var / 2, 0.001, 0.05))},
            "optimizer_p_fn_mcpc": "adam",
            "optimizer_p_kwargs_mcpc": {"lr": float(np.clip(0.3 / noise_var, 0.5, 3))},
            "loss_fn": fe_fn,
        }
        trainer = get_mcpc_trainer_one_sample(gen, config, training=True)
        for _ in range(epochs):
            for data in datas:
                trainer.train_on_batch(
                    pseudo, loss_fn=fe_fn,
                    loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
                    callback_after_t=LangevinStep(var=noise_var),
                    is_sample_x_at_batch_start=True,
                    is_return_results_every_t=False,
                )

        # generation: the trained stack with an output PC site appended
        gen_model = PCModel(list(model.modules) + [
            PC(energy_fn=scaled_gaussian_energy(config["input_var"]),
               sample_x_fn=sample_x_fn_normal),
        ])
        gen_sample = GenerativeModel(gen_model, ctx.generator(200 + idx), params=gen.params,
                                     device=device)
        config_gen = dict(config, K=ctx.steps(10000, minimum=500), optimizer_x_kwargs_mcpc={
            "lr": max(0.01, config["optimizer_x_kwargs_mcpc"]["lr"])})
        sampler = get_mcpc_trainer_one_sample(gen_sample, config_gen, training=False)
        res = sampler.train_on_batch(
            pseudo, loss_fn=None,
            callback_after_t=LangevinStep(var=noise_var),
            is_sample_x_at_batch_start=True,
            is_return_results_every_t=False,
            is_return_outputs=True,
        )
        generated.append(res["outputs"][-1].reshape(-1).cpu().numpy())
        mu, w = _params_1d(gen)
        weights.append((mu, w))
    generated = np.stack(generated)
    return {"noise_vars": noise_vars, "generated": generated,
            "gen_vars": generated.var(axis=1), "weights": np.array(weights)}


def draw_varying_langevin_noise(ctx: ExperimentContext, result: dict) -> None:
    """Four or fewer variances: one density panel each (``6a_<i>.svg``);
    more: the generated variance (``6b.svg``) and the learned |W| beside the
    ideal curve (``6c.svg``) against the noise variance."""
    plt = pyplot()
    noise_vars, gen_vars = result["noise_vars"], result["gen_vars"]
    weights = result["weights"]
    if len(noise_vars) <= 4:
        y = np.linspace(-10, 10, 500)
        data_pdf = np.exp(-0.5 * (y - DATA_MU) ** 2 / DATA_VAR) / np.sqrt(2 * np.pi * DATA_VAR)
        for idx, noise_var in enumerate(noise_vars):
            plt.figure()
            setup_fig(zero=True)
            plt.plot(y, data_pdf, "k", label=r"$p(y)$", linewidth=3)
            plt.hist(result["generated"][idx], bins=np.linspace(-12, 12, 21), density=True,
                     label="MCPC")
            plt.xlabel("$x_0$, y")
            plt.ylabel("probability " + r"$p(x_0;\theta)$")
            plt.xlim([-12, 12])
            plt.title(r"$\sigma^2$ : " + str(noise_var / 2))
            plt.legend()
            plt.tight_layout()
            plt.savefig(ctx.fig_path(f"6a_{idx}.svg"))
            plt.close()
        return

    plt.figure()
    setup_fig(zero=True)
    plt.plot(noise_vars, gen_vars, linewidth=3, label="MCPC")
    plt.hlines(DATA_VAR, noise_vars.min(), noise_vars.max(), colors="black", label="data")
    plt.vlines(2 * DATA_VAR, gen_vars.min(), gen_vars.max(), colors="grey",
               linestyles="dashed", label="learning limit")
    plt.xlabel(r"Langevin noise variance $2\sigma^2$")
    plt.ylabel(r"variance of x$_0$, y")
    plt.xscale("log")
    plt.legend(loc=0)
    plt.tight_layout()
    plt.savefig(ctx.fig_path("6b.svg"))
    plt.close()

    plt.figure()
    setup_fig(zero=True)
    mask = noise_vars <= 10
    ideal = np.sqrt(2 * DATA_VAR / noise_vars[mask] - 1)
    w_abs = np.abs(weights[:, 1])
    plt.plot(noise_vars[mask], ideal, "--k", label="ideal", linewidth=4)
    plt.plot(noise_vars, w_abs, "C0", linewidth=3, label="MCPC")
    plt.vlines(2 * DATA_VAR, w_abs.min(), w_abs.max(), colors="grey", linestyles="dashed",
               label="learning limit")
    plt.xlabel(r"Langevin noise variance $2\sigma^2$")
    plt.ylabel(r"learned |$W_0$|")
    plt.xscale("log")
    plt.ylim(0, 10)
    plt.legend(loc=0)
    plt.tight_layout()
    plt.savefig(ctx.fig_path("6c.svg"))
    plt.close()


if __name__ == "__main__":
    args = standard_parser(__doc__).parse_args()
    ctx = context_from_args(args)
    # the sweep (6b, 6c), then the four variances of the density panels (6a)
    n_points = 40 if args.full else 8
    draw_varying_langevin_noise(ctx, varying_langevin_noise(ctx, np.logspace(-1, 1.5, n_points)))
    draw_varying_langevin_noise(ctx, varying_langevin_noise(ctx, np.array([0.2, 2.0, 8.0, 20.0])))

"""Figure 5: neural variability.

(b) KL(spontaneous ‖ evoked) of the deepest latent's activity across
    training epochs, for natural, noise and grating stimuli, over seed
    models (the ``models/epoch_save/mcpc_aging_<seed>_<epoch>`` checkpoints),
    beside Berkes et al. 2011;
(a) variability quenching at stimulus onset: the rolling-window standard
    deviation of the latents across an unclamped chain and a clamped one
    that continues it, for MCPC and PC, beside Churchland et al. 2010.

    python3 -m montecarlopredictivecoding_tpu_torch.experiments.figure_5 --full

Every chain runs through ``PCTrainer`` in the fused chain (the kernel on
CUDA); panel (b)'s seeds run in turn (``parallel/sweep.py``), one warm
start and one captured chain a seed, stimulus and epoch.  The compute
functions return arrays; the ``draw_*`` functions and ``berkes_2011`` and
``churchland_2010`` draw (they alone import matplotlib).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..core.losses import bernoulli_fn, zero_fn
from ..core.trainer import LangevinStep
from ..data import get_mnist_data, grating_dataset, noise_dataset
from ..eval.metrics import KLdivergence, get_paired_stat
from ..models.factory import get_mcpc_trainer, get_pc_trainer
from ..parallel.sweep import sweep_warm_langevin_chains
from ..utils.plotting import pyplot, setup_fig
from .common import ExperimentContext, context_from_args, load_generative_checkpoint, standard_parser
from .neuro_data import BERKES_AGES, BERKES_KLS, BERKES_KLS_SEM_COORD, churchland_2010_curves

STIMULI = ("natural ", "noise", "gratings")


def _base_config(ctx: ExperimentContext) -> dict:
    """20-128-128-784 relu, Bernoulli; ``T_pc`` = 1000 Adam steps at lr 0.7,
    then 500 + 9500 Langevin steps at lr 0.05 (scaled), batches of 256."""
    return {
        "batch_size_train": 256,
        "batch_size_val": 1024,
        "batch_size_test": 256,
        "input_size": 20,
        "hidden_size": 128,
        "hidden2_size": 128,
        "output_size": 784,
        "loss_fn": bernoulli_fn,
        "activation_fn": "relu",
        "input_var": None,
        "T_pc": ctx.steps(1000),
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.7},
        "mixing": ctx.steps(500),
        "sampling": ctx.steps(9500),
        "optimizer_x_kwargs_mcpc": {"lr": 0.05},
    }


def _neuron_idx(config: dict) -> np.ndarray:
    """The 5 units of the deepest latent that panel (b) reads."""
    return np.random.RandomState(1).choice(config["hidden2_size"], 5, replace=False)


def _stride(config: dict) -> int:
    """About 500 captures a chain."""
    return max((config["mixing"] + config["sampling"]) // 500, 1)


def _sample_latent_chain(ctx, gen, config, target, neuron_idx, stride) -> np.ndarray:
    """One seed's chain through two trainers: a PC warm start, then a
    captured Langevin chain (clamped to ``target``, or unclamped with
    ``None``).  Returns the deepest latent's activity at ``neuron_idx``
    after the mixing steps, ``[n_cap * B, len(neuron_idx)]`` (numpy)."""
    pc_trainer = get_pc_trainer(gen, config, is_mcpc=True, training=False)
    mcpc_trainer = get_mcpc_trainer(gen, config, training=False)
    pseudo = torch.zeros((config["batch_size_test"], config["input_size"]),
                         device=gen.params[0]["b"].device)
    if target is None:
        loss_fn, kwargs = zero_fn, {}
    else:
        loss_fn, kwargs = config["loss_fn"], {"_target": target}
    pc_trainer.train_on_batch(pseudo, loss_fn=loss_fn, loss_fn_kwargs=kwargs,
                              is_return_results_every_t=False)
    res = mcpc_trainer.train_on_batch(
        pseudo, loss_fn=loss_fn, loss_fn_kwargs=kwargs,
        callback_after_t=LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False, is_return_xs=True, capture_stride=stride,
    )
    post = res["xs"][2][config["mixing"] // stride:][:, :, torch.as_tensor(neuron_idx)]
    return post.reshape(-1, len(neuron_idx)).cpu().numpy()


def digit_stimuli(config: dict, device) -> tp.List[tp.Tuple[int, tp.Optional[torch.Tensor]]]:
    """(index, target) of the four conditions: spontaneous (no target), the
    first test batch, one binary-noise image, gratings of 16 orientations."""
    _, _, test_loader = get_mnist_data(config, device=device)
    natural, _ = next(iter(test_loader))
    b = config["batch_size_test"]
    gratings = torch.from_numpy(grating_dataset(b, num_orientations=16)).to(device)
    noise = torch.from_numpy(noise_dataset(b)).to(device)
    return [(0, None), (1, natural), (2, noise), (3, gratings)]


def epoch_checkpoint(seed: int, epoch: int) -> str:
    return f"epoch_save/mcpc_aging_{seed}_" + (f"epoch{epoch}" if epoch != 0 else "epoch_init")


def digit_chains(ctx: ExperimentContext, config: dict, epoch: int, ei: int, seeds,
                 stimuli) -> tp.Dict[int, np.ndarray]:
    """Every seed's chain at ``epoch`` for each stimulus, through the sweep
    (seed models loaded from their checkpoints; latents and chain seeds from
    ``ctx.generator(500 + 11 ei + index)``).  Returns, per stimulus index,
    the deepest latent at the 5 units after the mixing steps, ``[S, n_cap *
    B, 5]`` (numpy)."""
    neuron_idx = torch.as_tensor(_neuron_idx(config))
    stride = _stride(config)
    gens = [load_generative_checkpoint(ctx, epoch_checkpoint(s, epoch), config) for s in seeds]
    model = gens[0].model
    pseudo = torch.zeros((config["batch_size_test"], config["input_size"]),
                         device=torch.device(ctx.device))
    chains = {}
    for li, target in stimuli:
        xs = sweep_warm_langevin_chains(model, [g.params for g in gens], config, target,
                                        pseudo, ctx.generator(500 + 11 * ei + li),
                                        stride=stride)
        post = xs[2][:, config["mixing"] // stride:][:, :, :, neuron_idx]
        chains[li] = post.reshape(len(gens), -1, len(neuron_idx)).cpu().numpy()
    return chains


def similarity_increase_digit(ctx: ExperimentContext, epochs=(0, 5, 10, 15),
                              seeds=range(10)) -> np.ndarray:
    """Panel (b): for each epoch and seed, KL(spontaneous ‖ evoked) of the
    deepest latent's 5 units (at most about 2000 samples of each chain) for
    natural, noise and grating stimuli.  Returns ``[3, epochs, seeds]``."""
    config = _base_config(ctx)
    seeds = list(seeds)
    stimuli = digit_stimuli(config, ctx.device)
    kls = np.zeros((3, len(epochs), len(seeds)))
    for ei, epoch in enumerate(epochs):
        chains = digit_chains(ctx, config, epoch, ei, seeds, stimuli)
        for si in range(len(seeds)):
            prior = chains[0][si]
            sub = max(len(prior) // 2000, 1)
            for k in range(3):
                kls[k, ei, si] = KLdivergence(prior[::sub], chains[k + 1][si, ::sub])
    return kls


def draw_similarity_increase_digit(ctx: ExperimentContext, kls: np.ndarray, epochs,
                                   ax=None):
    """Panel (b)'s bars: the mean KL over seeds per epoch and stimulus, with
    the published figure's error bars (std/n, kept as the original computes
    them, so the bars match the published figure), and, with more than two
    seeds, paired tests at the last epoch.  Without ``ax``, ``5b_digit.svg``."""
    plt = pyplot()
    kls_mean = kls.mean(-1)
    kls_sem = kls.std(-1) / kls.shape[-1]
    own = ax is None
    if own:
        fig, ax = plt.subplots()
    index = np.arange(len(epochs))
    bw = 0.2
    for i, t in enumerate(STIMULI):
        ax.bar(index + i * bw, kls_mean[i], bw, label=t, color=f"C{i}",
               yerr=[np.zeros_like(kls_sem[i]) + 0.05, kls_sem[i]], zorder=2,
               error_kw=dict(capsize=4, zorder=1))
    ax.set_xlabel("epoch")
    ax.set_ylabel("KL divergence")
    ax.set_xticks(index + bw)
    ax.set_xticklabels([str(e) for e in epochs])
    if kls.shape[2] > 2:
        for j, other in enumerate((1, 2)):
            p = get_paired_stat(kls[0, -1, :], kls[other, -1, :], type="less")
            stars = "***" if p < 0.001 else "**" if p < 0.01 else "*" if p < 0.05 else f"{p:.2e}"
            x1, x2 = len(epochs) - 1, len(epochs) - 1 + (j + 1) * bw
            y = (kls_mean + kls_sem)[:, -1].max() + 0.1 + 0.4 * j
            ax.plot([x1, x1, x2, x2], [y, y + 0.1, y + 0.1, y], lw=1.5, c="k")
            ax.text((x1 + x2) * 0.5, y + 0.1, stars, ha="center", va="bottom")
        ax.set_ylim(bottom=0)
    if own:
        plt.savefig(ctx.fig_path("5b_digit.svg"))
        plt.close(fig)
    return ax


def berkes_2011(ax=None):
    """The published panel: KL(spontaneous ‖ evoked) across ferret
    development (Berkes et al. 2011)."""
    sem = BERKES_KLS_SEM_COORD - BERKES_KLS
    if ax is None:
        _, ax = pyplot().subplots()
    index = np.arange(len(BERKES_AGES))
    bw = 0.2
    for i, t in enumerate(["natural stimuli", "noise", "gratings"]):
        ax.bar(index + i * bw, BERKES_KLS[:, i], bw, label=t, color=f"C{i}",
               yerr=[np.zeros_like(sem[:, i]) + 50, sem[:, i]], zorder=2,
               error_kw=dict(capsize=4, zorder=1))
    ax.set_xlabel("postnatal age (days)")
    ax.set_ylabel("KL divergence")
    ax.set_xticks(index + bw)
    ax.set_xticklabels(BERKES_AGES)
    ax.legend()
    return ax


def _rolling_variability(xs_flat, window: int, chunk: int = 8192):
    """The rolling-window standard deviation of every column of ``xs_flat``
    ``[time, units]`` (ddof 1, NaN for the first ``window - 1`` rows), then
    its mean over the units and its standard deviation over them (ddof 1)
    over sqrt(units): ``(mean, sem)``, ``[time]`` float64 numpy each.

    ``xs_flat`` is an array or a tensor; a tensor is reduced on its device.
    Each window's variance comes from cumulative sums of the data centred
    per column, in float64, a chunk of columns at a time; the statistics over
    the units combine the chunks (Chan's update), so memory stays a few
    chunks.  A variance that rounds below zero (a window of equal values)
    is 0."""
    xs = xs_flat if isinstance(xs_flat, torch.Tensor) else torch.from_numpy(np.asarray(xs_flat))
    n, units = xs.shape
    if window < 2:
        raise ValueError(f"window {window}: a standard deviation needs 2 samples")
    mean = np.full(n, np.nan)
    sem = np.full(n, np.nan)
    if n < window:
        return mean, sem
    count = 0
    row_mean = torch.zeros(n - window + 1, dtype=torch.float64, device=xs.device)
    row_m2 = torch.zeros_like(row_mean)
    for s in range(0, units, chunk):
        x = xs[:, s : s + chunk].to(torch.float64)
        x = x - x.mean(dim=0)
        zero = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
        c1 = torch.cat([zero, torch.cumsum(x, dim=0)])
        c2 = torch.cat([zero, torch.cumsum(x * x, dim=0)])
        s1 = c1[window:] - c1[:-window]
        s2 = c2[window:] - c2[:-window]
        std = torch.sqrt(torch.clamp((s2 - s1 * s1 / window) / (window - 1), min=0.0))
        k = std.shape[1]
        m_chunk = std.mean(dim=1)
        m2_chunk = ((std - m_chunk[:, None]) ** 2).sum(dim=1)
        delta = m_chunk - row_mean
        total = count + k
        row_mean += delta * k / total
        row_m2 += m2_chunk + delta**2 * count * k / total
        count = total
    mean[window - 1:] = row_mean.cpu().numpy()
    sem[window - 1:] = (torch.sqrt(row_m2 / (units - 1)) / units**0.5).cpu().numpy()
    return mean, sem


def _flat_xs(res) -> torch.Tensor:
    """A call's captured latents ``[n_cap, B, d_l]`` side by side, ``[n_cap,
    B * sum(d_l)]``."""
    return torch.cat([x.reshape(x.shape[0], -1) for x in res["xs"]], dim=1)


def variability_stimulus_onset_nonlinear(ctx: ExperimentContext, mode: str = "mcpc") -> dict:
    """Panel (a) for ``mode`` "mcpc" or "pc", on ``mcpc_fid_1``: a warm
    start, then (MCPC) an unclamped Langevin chain to equilibrium, or (PC)
    nothing more; then, captured every ``stride`` steps, an unclamped call
    and a call clamped to the first test batch (input variance 0.3) that
    continues it (``sampling`` = 8000 steps each, scaled; MCPC B=256 at lr
    0.05 with noise variance 2, PC B=100 Adam at lr 0.05).  The rolling
    standard deviation of all latents over a window of 1000 steps (fewer in
    short runs) falls at the onset for MCPC.  Returns its ``mean`` and
    ``sem`` over the units, the ``time`` axis, the ``onset`` and ``mode``."""
    config = _base_config(ctx)
    config["batch_size_test"] = 100 if mode == "pc" else 256
    config["input_var"] = 0.3
    config["mixing"] = 0
    config["sampling"] = ctx.steps(8000)
    config["optimizer_x_kwargs_mcpc"] = {"lr": 0.05}
    config["T_pc"] = ctx.steps(8000) if mode == "pc" else ctx.steps(250)
    if mode == "pc":
        config["optimizer_x_kwargs_pc"] = {"lr": 0.05}

    gen = load_generative_checkpoint(ctx, "mcpc_fid_1", config)
    _, _, test_loader = get_mnist_data(config, device=ctx.device)
    data, _ = next(iter(test_loader))
    pseudo = torch.zeros((data.shape[0], config["input_size"]), device=data.device)
    stride = max(config["sampling"] // 2000, 1)
    captured = dict(is_sample_x_at_batch_start=False, is_return_xs=True,
                    capture_stride=stride)

    if mode == "mcpc":
        pc_tr = get_pc_trainer(gen, config, is_mcpc=True, training=False)
        mc_tr = get_mcpc_trainer(gen, config, training=False)
        pc_tr.train_on_batch(pseudo, loss_fn=None, is_return_results_every_t=False)
        mc_tr.train_on_batch(
            pseudo, loss_fn=None, callback_after_t=LangevinStep(var=2.0),
            is_sample_x_at_batch_start=False, is_return_results_every_t=False)
        res_no = mc_tr.train_on_batch(pseudo, loss_fn=zero_fn, loss_fn_kwargs={},
                                      callback_after_t=LangevinStep(var=2.0), **captured)
        res_in = mc_tr.train_on_batch(
            pseudo, loss_fn=config["loss_fn"],
            loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
            callback_after_t=LangevinStep(var=2.0), **captured)
        lr = config["optimizer_x_kwargs_mcpc"]["lr"]
    elif mode == "pc":
        pc_tr = get_pc_trainer(gen, config, is_mcpc=False, training=False)
        pc_tr.train_on_batch(pseudo, loss_fn=None, is_return_results_every_t=False)
        res_no = pc_tr.train_on_batch(pseudo, loss_fn=zero_fn, loss_fn_kwargs={}, **captured)
        res_in = pc_tr.train_on_batch(pseudo, loss_fn=config["loss_fn"],
                                      loss_fn_kwargs={"_target": data}, **captured)
        lr = config["optimizer_x_kwargs_pc"]["lr"]
    else:
        raise ValueError(f"mode {mode!r}: 'mcpc' or 'pc'")

    flat_no = _flat_xs(res_no)
    xs = torch.cat([flat_no, _flat_xs(res_in)])
    # a window of 1000 steps; at least 2 samples in short runs
    window = max(min(1000 // stride, xs.shape[0] // 4), 2)
    mean, sem = _rolling_variability(xs, window)
    time = np.linspace(0, len(mean) * lr * stride, len(mean)) - 203
    onset = len(flat_no) * lr * stride - 203
    return {"mean": mean, "sem": sem, "time": time, "onset": onset, "mode": mode}


def draw_variability(axs, result: dict):
    """Panel (a)'s curve of one mode on ``axs``: the mean with its band and
    the onset."""
    mean, sem, time = result["mean"], result["sem"], result["time"]
    color, label = ("C0", "MCPC") if result["mode"] == "mcpc" else ("r", "PC")
    axs.plot(time, mean, color, linewidth=2, label=label)
    axs.fill_between(time, mean + sem, mean - sem, alpha=0.2, color=color)
    axs.vlines(result["onset"], np.nanmin(mean - sem) - 0.1, np.nanmax(mean + sem) + 0.1,
               linestyles="dashed", colors="grey", linewidth=2.0)
    axs.set_xlabel("time (AU)")
    axs.set_ylabel(r"variance of $x$")
    axs.set_xlim(0, 600)
    axs.legend()
    return axs


def churchland_2010(axs=None):
    """The published panel: membrane-potential variance around stimulus
    onset (Churchland et al. 2010), its SEM envelope closed into one polygon
    (the digitized curves have their own time grids)."""
    plt = pyplot()
    from matplotlib.patches import Polygon

    if axs is None:
        _, axs = plt.subplots()
    mx, m, spx, sp, snx, sn, onset = churchland_2010_curves()
    t0 = min(mx.min(), spx.min(), snx.min())
    axs.plot(mx - t0, m, "k", linewidth=2, label="membrane potential")
    verts = [(x - t0, y) for x, y in zip(spx, sp)] + [
        (x - t0, y) for x, y in zip(snx[::-1], sn[::-1])
    ]
    axs.add_patch(Polygon(verts, facecolor="k", alpha=0.2))
    axs.vlines(onset - t0, 7, 17, linestyles="dashed", colors="grey",
               linewidth=2.0, label="stimulus onset")
    axs.set_xlabel("time (ms)")
    axs.set_ylabel(r"variance of $V_m$ $(mV^2)$")
    axs.set_xlim(0, 600)
    axs.set_ylim(7.65, 16.47)
    axs.legend()
    return axs


def similarity_increase(ctx: ExperimentContext, epochs=(0, 5, 10, 15), seeds=range(10)):
    """Panel (b), ``5b.svg``: Berkes et al. above the port's KLs.  Returns
    the KLs."""
    kls = similarity_increase_digit(ctx, epochs=epochs, seeds=seeds)
    plt = pyplot()
    setup_fig()
    _, axs = plt.subplots(2, 1, figsize=(5.8, 4.8))
    berkes_2011(axs[0])
    draw_similarity_increase_digit(ctx, kls, epochs, axs[1])
    plt.tight_layout()
    plt.savefig(ctx.fig_path("5b.svg"))
    plt.close()
    return kls


def variability_quenching(ctx: ExperimentContext):
    """Panel (a), ``5a.svg``: Churchland et al. above MCPC and PC.  Returns
    both modes' results."""
    results = [variability_stimulus_onset_nonlinear(ctx, mode) for mode in ("mcpc", "pc")]
    plt = pyplot()
    setup_fig()
    _, axs = plt.subplots(3, 1, figsize=(5.8, 4.8))
    churchland_2010(axs[0])
    for ax, result in zip(axs[1:], results):
        draw_variability(ax, result)
    plt.tight_layout()
    plt.savefig(ctx.fig_path("5a.svg"))
    plt.close()
    return results


if __name__ == "__main__":
    args = standard_parser(__doc__).parse_args()
    ctx = context_from_args(args)
    variability_quenching(ctx)
    if args.full:
        # every seed and every epoch snapshot in models/epoch_save
        similarity_increase(ctx, seeds=range(10), epochs=(0, 5, 10, 15, 30, 35))
    else:
        similarity_increase(ctx, seeds=range(3))

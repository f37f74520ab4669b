"""Table 1 — the quantitative comparison: FID, masked-reconstruction MSE and
marginal likelihood of MCPC, PC and the DLGM over seeds, with mean ± std per
model family.

    python3 -m montecarlopredictivecoding_tpu_torch.experiments.table_1 --full

The configurations are the reference's, per metric (the JAX package's
``experiments/table_1.py``).  The MSE column runs MAP inference through
``PCTrainer``, so through the chain kernel on the card; FID samples
ancestrally and scores against the cached MNIST statistics
(``eval/fid.py``); the marginal likelihood is Monte Carlo from prior samples.
"""

from __future__ import annotations

import itertools
import os
import warnings
import zlib

import numpy as np

from ..core.losses import bernoulli_fn
from ..data import get_mnist_data
from ..eval.fid import get_fid, pixel_features
from ..eval.metrics import get_marginal_likelihood, get_mse_rec
from ..models.dlgm import DLGM
from ..utils.checkpoint import load_checkpoint
from .common import ExperimentContext, context_from_args, load_generative_checkpoint, standard_parser


def _config_mcpc(ctx, input_size=20, hidden=128):
    return {
        "batch_size_train": 256, "batch_size_val": 1024, "batch_size_test": 1024,
        "input_size": input_size, "hidden_size": hidden, "hidden2_size": hidden,
        "output_size": 784, "loss_fn": bernoulli_fn, "activation_fn": "relu",
        "input_var": None,
        "T_pc": ctx.steps(250), "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.7},
        "mixing": ctx.steps(50), "sampling": ctx.steps(100),
        "optimizer_x_kwargs_mcpc": {"lr": 0.1},
    }


def _config_pc(ctx, input_size=20, hidden=128, activation="relu", lr=0.1):
    return {
        "batch_size_train": 128, "batch_size_val": 1024, "batch_size_test": 1024,
        "input_size": input_size, "hidden_size": hidden, "hidden2_size": hidden,
        "output_size": 784, "loss_fn": bernoulli_fn, "activation_fn": activation,
        "input_var": None,
        "T_pc": ctx.steps(250), "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": lr},
    }


def _load_dlgm(ctx: ExperimentContext, name: str, hidden=256, latent=20) -> DLGM:
    """The native checkpoint ``<ctx.path_models>/<name>.msgpack`` in a DLGM
    of the given widths (recognition width factor 1), on ``ctx.device``;
    without it a fresh model, with a warning, as for the other families."""
    dlgm = DLGM(784, hidden, latent, factor_recog=1,
                seed=ctx.generator(zlib.crc32(name.encode()) % 997), device=ctx.device)
    path = os.path.join(ctx.path_models, name + ".msgpack")
    if os.path.isfile(path):
        dlgm.gen_params, dlgm.rec_params = load_checkpoint(
            path, (dlgm.gen_params, dlgm.rec_params), device=ctx.device)
    else:
        warnings.warn(f"checkpoint {name!r} not found in {ctx.path_models}; using "
                      "random initialization. Train one with experiments/train_mnist.py.",
                      RuntimeWarning)
    return dlgm


def _report(name, table):
    for col, model in enumerate(["MCPC", "PC", "DLGM"]):
        print(f"{name} {model}: {table[:, col].mean():.4f} +/- {table[:, col].std():.4f}")


def get_models_fids(ctx: ExperimentContext, seeds=(1, 2, 3), n_samples=5000,
                    feature_fn=None) -> np.ndarray:
    """FID ``[seeds, (MCPC, PC, DLGM)]`` of ``n_samples`` samples against
    the test statistics (pixel features unless ``feature_fn``)."""
    if feature_fn is None:
        feature_fn = pixel_features
    fids = np.zeros((len(seeds), 3))
    for i, s in enumerate(seeds):
        cfg_m = _config_mcpc(ctx)
        cfg_p = _config_pc(ctx)
        gen_m = load_generative_checkpoint(ctx, f"mcpc_fid_{s}", cfg_m)
        gen_p = load_generative_checkpoint(ctx, f"pc_fid_{s}", cfg_p)
        dlgm = _load_dlgm(ctx, f"dlgm_fid_{s}")
        fids[i, 0] = get_fid(gen_m, cfg_m, n_samples=n_samples, is_test=True,
                             feature_fn=feature_fn, generator=ctx.generator(300 + s))
        fids[i, 1] = get_fid(gen_p, cfg_p, n_samples=n_samples, is_test=True,
                             feature_fn=feature_fn, generator=ctx.generator(310 + s))
        fids[i, 2] = dlgm.get_fid(n_samples, is_test=True, feature_fn=feature_fn)
    _report("FID", fids)
    return fids


def get_models_mse(ctx: ExperimentContext, seeds=(1, 2, 3), n_batches=None) -> np.ndarray:
    """Masked-reconstruction MSE ``[seeds, 3]`` on the test split: MCPC
    10-256-256 relu (Adam lr 0.7), PC 30-256-256 tanh (Adam lr 0.7), the
    DLGM's posterior means; ``n_batches`` of 1024 cut it."""
    mses = np.zeros((len(seeds), 3))
    for i, s in enumerate(seeds):
        cfg_m = _config_mcpc(ctx, input_size=10, hidden=256)
        cfg_m["optimizer_x_kwargs_mcpc"] = {"lr": 0.03}
        cfg_p = _config_pc(ctx, input_size=30, hidden=256, activation="tanh", lr=0.7)
        gen_m = load_generative_checkpoint(ctx, f"mcpc_mse_{s}", cfg_m)
        gen_p = load_generative_checkpoint(ctx, f"pc_mse_{s}", cfg_p)
        dlgm = _load_dlgm(ctx, f"dlgm_mse_{s}")
        _, _, test_loader = get_mnist_data(cfg_p, device=ctx.device)
        batches = list(itertools.islice(test_loader, n_batches))
        mses[i, 0] = get_mse_rec(gen_m, cfg_m, batches)
        mses[i, 1] = get_mse_rec(gen_p, cfg_p, batches)
        mses[i, 2] = dlgm.get_mse_rec(batches)
    _report("MSE", mses)
    return mses


def get_models_ml(ctx: ExperimentContext, seeds=(1, 2, 3), n_samples=5000,
                  n_batches=None) -> np.ndarray:
    """Marginal likelihood ``[seeds, 3]`` on the validation split: MCPC
    20-128-128 relu, PC 25-128-128 tanh, the DLGM at hidden 128 / latent 10;
    ``n_batches`` of 1024 cut it."""
    mls = np.zeros((len(seeds), 3))
    for i, s in enumerate(seeds):
        cfg_m = _config_mcpc(ctx)
        cfg_m["optimizer_x_kwargs_mcpc"] = {"lr": 0.03}
        cfg_p = _config_pc(ctx, input_size=25, activation="tanh", lr=0.3)
        gen_m = load_generative_checkpoint(ctx, f"mcpc_ml_{s}", cfg_m)
        gen_p = load_generative_checkpoint(ctx, f"pc_ml_{s}", cfg_p)
        dlgm = _load_dlgm(ctx, f"dlgm_ml_{s}", hidden=128, latent=10)
        _, val_loader, _ = get_mnist_data(cfg_p, device=ctx.device)
        batches = list(itertools.islice(val_loader, n_batches))
        mls[i, 0] = get_marginal_likelihood(gen_m, cfg_m, batches, n_samples=n_samples,
                                            generator=ctx.generator(400 + s))
        mls[i, 1] = get_marginal_likelihood(gen_p, cfg_p, batches, n_samples=n_samples,
                                            generator=ctx.generator(410 + s))
        mls[i, 2] = dlgm.get_marginal_likelihood(batches, n_samples=n_samples)
    _report("marginal likelihood", mls)
    return mls


if __name__ == "__main__":
    p = standard_parser(__doc__)
    p.add_argument("--n-samples", type=int, default=None)
    args = p.parse_args()
    ctx = context_from_args(args)
    n = args.n_samples or (5000 if args.full else 500)
    get_models_fids(ctx, n_samples=n)
    get_models_mse(ctx)
    get_models_ml(ctx, n_samples=n)

"""DLGM evaluation: the importance-sampled -ln p(v) of a checkpoint on the
validation split: every datum repeated ``particle_size`` times, posterior
particles from the recognition model, the logsumexp of the importance
weights.

Usage:
    python3 -m montecarlopredictivecoding_tpu_torch.experiments.dlgm_evaluate \\
        --checkpoint models/dlgm_ml_1.msgpack --hidden-dim 128 --latent-dim 10
    python3 -m ...dlgm_evaluate --checkpoint <reference torch file> --torch
"""

from __future__ import annotations

import argparse
import itertools
import typing as tp

from ..core.losses import bernoulli_fn
from ..data import get_mnist_data
from ..models.dlgm import DLGM
from ..utils.checkpoint import load_checkpoint, load_torch_dlgm


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> float:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--torch", action="store_true",
                   help="checkpoint is a reference torch state dict")
    p.add_argument("--particle-size", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--n-batches", type=int, default=None)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--latent-dim", type=int, default=20)
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = p.parse_args(argv)

    dlgm = DLGM(784, args.hidden_dim, args.latent_dim, factor_recog=1, seed=0,
                device=args.device)
    if args.torch:
        dlgm.gen_params, dlgm.rec_params = load_torch_dlgm(args.checkpoint, args.device)
        if "fc3" in dlgm.gen_params:
            # the simple one-level topology: the factor from the cov head's width
            from ..models.cholesky import factor_from_free_size

            latent = int(dlgm.gen_params["fc3"]["w"].shape[0])
            dlgm.latent_dim_list = [latent]
            dlgm.factors = [factor_from_free_size(
                latent, int(dlgm.rec_params["nets"][0]["cov"]["w"].shape[1]))]
    else:
        dlgm.gen_params, dlgm.rec_params = load_checkpoint(
            args.checkpoint, (dlgm.gen_params, dlgm.rec_params), device=args.device)

    config = {"loss_fn": bernoulli_fn, "batch_size_train": args.batch_size,
              "batch_size_val": args.batch_size, "batch_size_test": args.batch_size}
    _, val_loader, _ = get_mnist_data(config, device=args.device)
    batches = list(itertools.islice(val_loader, args.n_batches))
    nll = dlgm.evaluate_importance_nll(batches, particle_size=args.particle_size)
    print(f"-ln p(v) = {nll:.4f} nats/datum ({args.particle_size} particles)")
    return nll


if __name__ == "__main__":
    main()

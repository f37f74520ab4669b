"""Evaluation metrics, as the JAX package's ``eval/metrics.py`` defines them:

* masked-reconstruction MSE: clamp the last half of each image, MAP-infer
  the latents (``PCTrainer``, so the fused chain), decode the deepest latent
  through the remaining layers, threshold, MSE on the hidden half;
* marginal likelihood: Monte-Carlo log-mean-exp estimate of log p(data) from
  ancestral logit samples (Bernoulli sensory model);
* sample-based KL (the Pérez-Cruz 2008 nearest-neighbour estimator) with
  brute-force pairwise distances;
* discrete KL and the paired statistical test (Shapiro, then a paired t-test
  or Wilcoxon).

The pairwise and BCE products are plain ``torch.matmul`` at full float32
(TF32 off for them).  scipy is imported only by :func:`get_paired_stat`.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..core.losses import bernoulli_fn, bernoulli_fn_mask, fe_fn, fe_fn_mask
from ..core.modules import PC, Linear
from ..core.trainer import GenerativeModel
from ..utils.observability import span
from ..utils.precision import full_f32_matmul
from .sampling import sample_pc


# -- masked reconstruction -----------------------------------------------------


def decode_from_deepest_latent(gen: GenerativeModel) -> torch.Tensor:
    """Decode the deepest PC latent through the trailing non-PC modules."""
    last_pc = gen.model.pc_indices[-1]
    h = gen.latents[-1]
    li = sum(1 for i in gen.model.linear_indices if i < last_pc)
    with torch.no_grad():
        for m in gen.model.modules[last_pc + 1 :]:
            if isinstance(m, PC):
                raise ValueError("decode_from_deepest_latent assumes a trailing stack")
            if isinstance(m, Linear):
                h = m.apply(gen.params[li], h)
                li += 1
            else:
                h = m.apply(h)
    return h


def get_mse_rec(
    gen: GenerativeModel,
    config: dict,
    batches,
    trainer_factory=None,
) -> float:
    """Masked-reconstruction MSE: MAP inference with only the last half of
    the pixels clamped (``T_pc`` steps of the config's PC optimizer), then
    the MSE over the hidden half, averaged over images.  The batches' sums
    are read back to the host once, after the last batch.  ``trainer_factory(gen,
    config)`` replaces the default PC trainer."""
    from ..models.factory import get_pc_trainer

    loss_fn = config["loss_fn"]
    masked_loss = bernoulli_fn_mask if loss_fn is bernoulli_fn else fe_fn_mask
    trainer = (
        trainer_factory(gen, config)
        if trainer_factory is not None
        else get_pc_trainer(gen, config, is_mcpc=True, training=False)
    )

    # each batch's squared-error sum stays on the device until the last batch
    # is queued, so the next batch's latent draws overlap the chain
    sums, n_data = [], 0
    for data, _ in batches:
        pseudo = torch.zeros((data.shape[0], config["input_size"]), dtype=data.dtype,
                             device=data.device)
        trainer.train_on_batch(
            pseudo,
            loss_fn=masked_loss,
            loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
            is_return_results_every_t=False,
        )
        with span("mcpc.mse_rec.score"):
            img = decode_from_deepest_latent(gen)
            if loss_fn is bernoulli_fn:
                img = (img > 0).to(img.dtype)  # logits: threshold at 0
            k = round(data.shape[1] / 2)
            sums.append(torch.sum(torch.mean((img[:, :-k] - data[:, :-k]) ** 2, dim=1)))
        n_data += data.shape[0]
    mse = 0.0
    if sums:
        with span("mcpc.mse_rec.readback"):
            values = torch.stack(sums).tolist()
        for value in values:  # in batch order, in float64, as one float() a batch
            mse += value
    return mse / n_data


# -- marginal likelihood --------------------------------------------------------


def get_marginal_likelihood(
    gen: GenerativeModel,
    config: dict,
    batches,
    n_samples: int = 5000,
    generator: tp.Optional[torch.Generator] = None,
    chunk: int = 100,
) -> float:
    """Monte-Carlo marginal likelihood: ``n_samples`` ancestral logit samples
    (clamped to ±20), -BCE(sample logits, datum) summed over the features for
    every (datum, sample) pair, then the log-mean-exp over the samples,
    stabilised by each datum's least loss, averaged over the data.  The
    Gaussian sensory model raises ``NotImplementedError``, as in the JAX
    package."""
    if config["loss_fn"] is fe_fn:
        raise NotImplementedError(
            "Gaussian marginal likelihood is not implemented (as in the JAX package)"
        )
    logits = sample_pc(n_samples, gen, config, generator=generator, is_return_hidden=True)
    z = torch.clamp(logits, -20.0, 20.0)  # [S, D]
    # sum_d max(z,0) - z*y + log1p(exp(-|z|)) = pos - data @ z^T
    pos = torch.sum(torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z))), dim=1)

    losses = []
    with torch.no_grad(), full_f32_matmul():
        for data, _ in batches:
            data = data.to(device=z.device, dtype=z.dtype)
            for s in range(0, data.shape[0], chunk):
                part = pos[None, :] - torch.matmul(data[s : s + chunk], z.T)
                losses.append(part.cpu().numpy())
    losses = np.concatenate(losses, axis=0)  # [N, S]
    m = losses.min(axis=1)
    p = np.exp(-(losses - m[:, None])).mean(axis=1)
    return float((np.log(p) - m).mean())


# -- KL estimators ---------------------------------------------------------------


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = torch.sum(a * a, dim=1)[:, None]
    bb = torch.sum(b * b, dim=1)[None, :]
    with full_f32_matmul():
        prod = torch.matmul(a, b.T)
    return torch.clamp(aa + bb - 2.0 * prod, min=0.0)


def KLdivergence(x, y, chunk: int = 2048) -> float:
    """Pérez-Cruz (2008) nearest-neighbour KL estimate D(P||Q) from samples
    x ~ P [n, d], y ~ Q [m, d]:

        KL ≈ -(d/n) Σ log(r_i / s_i) + log(m / (n-1))

    where r_i is the distance from x_i to its nearest *other* point in x and
    s_i the distance to its nearest point in y.  Brute-force pairwise
    distances on the device of ``x`` (a tensor) or the CPU (an array)."""
    x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
    y = torch.atleast_2d(torch.as_tensor(y, dtype=torch.float32, device=x.device))
    n, d = x.shape
    m, dy = y.shape
    assert d == dy
    # center jointly (KL is translation-invariant): keeps the f32
    # aa+bb-2ab cancellation error proportional to the data's spread rather
    # than its distance from the origin
    mu = (torch.sum(x, dim=0) + torch.sum(y, dim=0)) / (n + m)
    x = x - mu
    y = y - mu

    total = 0.0
    cols = torch.arange(n, device=x.device)[None, :]
    with torch.no_grad():
        for s in range(0, n, chunk):
            xc = x[s : s + chunk]
            dxx = _pairwise_sq_dists(xc, x)
            rows = torch.arange(xc.shape[0], device=x.device)[:, None] + s
            dxx = torch.where(rows == cols, torch.full_like(dxx, float("inf")), dxx)
            r2 = torch.min(dxx, dim=1).values
            s2 = torch.min(_pairwise_sq_dists(xc, y), dim=1).values
            r = np.sqrt(r2.cpu().numpy().astype(np.float64))
            ss = np.sqrt(s2.cpu().numpy().astype(np.float64))
            total += float(np.log(r / ss).sum())
    return -total * d / n + float(np.log(m / (n - 1.0)))


def kl_divergence_discrete(p, q) -> float:
    """KL between two discrete distributions (each normalised first)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum(np.where(p != 0, -p * np.log(q / p), 0.0)))


def get_paired_stat(before, after, type: str = "two-sided") -> float:
    """Paired test with a normality gate: Shapiro on the differences; a
    paired t-test if they look normal (p > .05), Wilcoxon signed-rank
    otherwise.  Returns the p-value."""
    from scipy import stats

    diffs = [a - m for (a, m) in zip(before, after)]
    _, p_norm = stats.shapiro(diffs)
    if p_norm > 0.05:
        _, p = stats.ttest_rel(before, after, alternative=type)
    else:
        _, p = stats.wilcoxon(before, after, alternative=type)
    return float(p)

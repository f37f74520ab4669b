"""The stacked DLGM: the upstream module zoo's deep latent Gaussian model.

* generative: ``h₀ = G₀(z₀)``, ``h ← relu(T_b(relu(T_a(h)))) + G_l(z_l)``
  for the deeper levels, then ``sigmoid(final_b(relu(final_a(h))))``, a
  standard-normal prior at every level; MNIST presets;
* recognition: one net per level (fc1 → relu → mu head and a covariance
  head of a Cholesky-family factor), ``z = mu + R eps``, and the exact
  log-density of N(mu, R Rᵀ);
* ``stacked_loss``: the summed-BCE plus full-covariance-KL ELBO of
  ``models/dlgm.py``;
* :class:`StackedMetrics`: FID, the linear probe, masked-reconstruction MSE,
  the marginal likelihood and the importance-sampled NLL.

Parameters are trees of tensors of the JAX package's structure (weights
``[in, out]``), and every function that draws takes its draws as an
optional argument (``eps``: standard normals, ``u``: uniforms) besides a
``torch.Generator``, as in ``models/dlgm.py``.  Products run at full f32.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..core.modules import random_tensor
from ..utils.precision import full_f32_matmul
from .cholesky import CholeskyFactor
from .dlgm import (
    _apply,
    _bce_logs,
    _linear_init,
    dlgm_loss,
    marginal_likelihood_of,
    recognition_sample,
    sample_prior,
)

Tensor = torch.Tensor

# -- generative --------------------------------------------------------------------


def init_generative_stacked(generator, hidden_dim_list, latent_dim_list, T_hidden_dim_list,
                            output_dim: int, device="cuda") -> dict:
    """``{"G": [...], "T": [{"a", "b"}, ...], "final": {"a", "b"},
    "latent_dim_list"}``, drawn from ``generator`` in that order."""
    G = [_linear_init(generator, ld, hd, device)
         for hd, ld in zip(hidden_dim_list, latent_dim_list)]
    T = [{"a": _linear_init(generator, h_prev, t_h, device),
          "b": _linear_init(generator, t_h, h_next, device)}
         for h_prev, h_next, t_h in zip(hidden_dim_list[:-1], hidden_dim_list[1:],
                                        T_hidden_dim_list[:-1])]
    final = {"a": _linear_init(generator, hidden_dim_list[-1], T_hidden_dim_list[-1], device),
             "b": _linear_init(generator, T_hidden_dim_list[-1], output_dim, device)}
    return {"G": G, "T": T, "final": final, "latent_dim_list": tuple(latent_dim_list)}


def generative_stacked_forward(params: dict, z_list) -> Tensor:
    """Probabilities ``[B, output_dim]`` of the latents ``z_list``."""
    h = _apply(params["G"][0], z_list[0])
    for G_p, T_p, z in zip(params["G"][1:], params["T"], z_list[1:]):
        h = torch.relu(_apply(T_p["b"], torch.relu(_apply(T_p["a"], h))))
        h = h + _apply(G_p, z)
    logits = _apply(params["final"]["b"], torch.relu(_apply(params["final"]["a"], h)))
    return torch.sigmoid(logits)


# standard-normal latents of every level: ``eps`` if given, else drawn
sample_prior_stacked = sample_prior


def log_prob_prior(z_list) -> Tensor:
    """The standard-normal log-density of the latents, summed over the
    levels, ``[B]``."""
    out = 0.0
    for z in z_list:
        out = out + torch.sum(-0.5 * z**2 - 0.5 * math.log(2 * math.pi), dim=-1)
    return out


MNIST_PRESETS = {
    "mnist": dict(hidden_dim_list=[201, 200], latent_dim_list=[201, 200],
                  T_hidden_dim_list=[203, 202], output_dim=784),
    "mnist_large": dict(hidden_dim_list=[201, 200], latent_dim_list=[201, 200],
                        T_hidden_dim_list=[1002, 1001], output_dim=784),
    "mnist_vae": dict(hidden_dim_list=[20], latent_dim_list=[20],
                      T_hidden_dim_list=[400], output_dim=784),
    "mnist_vae_large": dict(hidden_dim_list=[200], latent_dim_list=[200],
                            T_hidden_dim_list=[1000], output_dim=784),
}

RECOGNITION_PRESETS = {
    "mnist": dict(latent_dim_list=[201, 200], hidden_dim_list=[400, 400]),
    "mnist_vae": dict(latent_dim_list=[20], hidden_dim_list=[400]),
    "mnist_vae_large": dict(latent_dim_list=[200], hidden_dim_list=[1000]),
}


# -- recognition -------------------------------------------------------------------


def init_recognition_stacked(generator, latent_dim_list, hidden_dim_list,
                             factor_cls=CholeskyFactor, input_dim: int = 784, device="cuda"):
    """``({"nets": [...]}, factors)``: per level fc1, the mu head and the
    covariance head, drawn in that order."""
    nets, factors = [], []
    for ld, hd in zip(latent_dim_list, hidden_dim_list):
        factor = factor_cls(ld)
        nets.append({
            "fc1": _linear_init(generator, input_dim, hd, device),
            "mu": _linear_init(generator, hd, ld, device),
            "cov": _linear_init(generator, hd, factor.free_parameter_size(), device),
        })
        factors.append(factor)
    return {"nets": nets}, factors


def recognition_stacked_forward(params: dict, factors, x: Tensor):
    """``(mus, Rs)`` of every level."""
    mus, Rs = [], []
    for net, factor in zip(params["nets"], factors):
        h = torch.relu(_apply(net["fc1"], x))
        mus.append(_apply(net["mu"], h))
        Rs.append(factor.parameterize(_apply(net["cov"], h)))
    return mus, Rs


# ``z = mu + R eps`` at every level: ``eps`` if given, else drawn
recognition_sample_stacked = recognition_sample


def recognition_log_prob(z_list, mus, Rs) -> Tensor:
    """The exact log-density of z under N(mu, R Rᵀ), summed over the levels,
    ``[B]``: a dense solve with R and its log-determinant."""
    out = 0.0
    for z, mu, R in zip(z_list, mus, Rs):
        y = torch.linalg.solve(R, (z - mu)[..., None])[..., 0]
        _, logdet = torch.linalg.slogdet(R)
        out = out + (-0.5 * torch.sum(y * y, dim=-1) - logdet
                     - 0.5 * z.shape[-1] * math.log(2 * math.pi))
    return out


stacked_loss = dlgm_loss  # the same ELBO as the one-level chain's


# -- metrics -----------------------------------------------------------------------


class StackedMetrics:
    """Metrics of a (generative, recognition) stacked pair.  ``seed`` is an
    int or a ``torch.Generator``: every draw not handed in comes from it."""

    def __init__(self, gen_params: dict, rec_params: dict, factors,
                 seed: tp.Union[int, torch.Generator] = 0):
        self.gen_params = gen_params
        self.rec_params = rec_params
        self.factors = factors
        self.generator = (seed if isinstance(seed, torch.Generator)
                          else torch.Generator().manual_seed(int(seed)))
        self.device = gen_params["G"][0]["w"].device

    def generate(self, num_samples: int, is_return_hidden: bool = False, eps=None,
                 u=None) -> Tensor:
        """Probabilities (``is_return_hidden``) or Bernoulli samples ``[n,
        output_dim]`` of the prior's latents (``eps``, one ``[n, d]`` a
        level, else drawn); the Bernoulli draw compares uniforms ``u`` (else
        drawn) with the probabilities."""
        z = sample_prior_stacked(num_samples, self.gen_params["latent_dim_list"],
                                 self.generator, eps, self.device)
        with torch.no_grad(), full_f32_matmul():
            probs = generative_stacked_forward(self.gen_params, z)
        if is_return_hidden:
            return probs
        if u is None:
            u = random_tensor("uniform", probs.shape, self.generator, probs.dtype, probs.device)
        u = torch.as_tensor(u, dtype=probs.dtype).to(probs.device)
        return (u <= probs).to(torch.float32)

    def get_fid(self, num_samples: int = 5000, is_test: bool = False, feature_fn=None,
                root: str = "MNIST_data") -> float:
        from ..eval.fid import compute_fid, compute_stats, make_mnist_fid_stats, pixel_features

        feature_fn = feature_fn or pixel_features
        val_stats, test_stats = make_mnist_fid_stats(feature_fn, root=root)
        images = self.generate(num_samples, is_return_hidden=True).cpu().numpy()
        stats = compute_stats(feature_fn(images))
        return compute_fid(stats, test_stats if is_test else val_stats)

    def get_acc(self, batches):
        """Linear-probe accuracy on the first level's posterior mean (20
        epochs): ``(best accuracy, classifier)``."""
        from ..eval.classifier import train_linear_classifier

        reps, labels = [], []
        with torch.no_grad(), full_f32_matmul():
            for data, label in batches:
                mus, _ = recognition_stacked_forward(self.rec_params, self.factors, data)
                reps.append(mus[0].cpu().numpy())
                labels.append(np.asarray(torch.as_tensor(label).cpu()))
        clf, best = train_linear_classifier(np.concatenate(reps), np.concatenate(labels),
                                            epochs=20, device=self.device)
        return best, clf

    def get_mse_rec(self, batches) -> float:
        """Masked-reconstruction MSE: zero all but the last half of each
        image, recognise, decode the posterior means, threshold at 0.5, MSE
        on the hidden part, averaged over images."""
        mse, n = 0.0, 0
        with torch.no_grad(), full_f32_matmul():
            for data, _ in batches:
                k = round(data.shape[1] / 2)
                masked = data.clone()
                masked[:, :-k] = 0.0
                mus, _ = recognition_stacked_forward(self.rec_params, self.factors, masked)
                x_hat = generative_stacked_forward(self.gen_params, mus)
                x_hat = (x_hat > 0.5).to(x_hat.dtype)
                mse += float(torch.sum(torch.mean((x_hat[:, :-k] - data[:, :-k]) ** 2, dim=1)))
                n += data.shape[0]
        return mse / n

    def get_marginal_likelihood(self, batches, n_samples: int = 5000, chunk: int = 100,
                                probs=None) -> float:
        """The Monte-Carlo marginal likelihood of ``n_samples`` prior samples'
        probabilities (``probs`` if given); see ``models.dlgm``."""
        if probs is None:
            probs = self.generate(n_samples, is_return_hidden=True)
        return marginal_likelihood_of(probs, batches, chunk, self.device)

    def importance_nll(self, batches, particle_size: int = 16, eps=None) -> float:
        """Importance-sampled -ln p(v) a datum: every datum repeated over
        ``particle_size`` particles of the recognition posterior (``eps[i]``:
        batch i's draws, one ``[B*P, d]`` a level), torch's BCE clamp on the
        likelihood, the exact q-density, logsumexp over the particles."""
        total, n = 0.0, 0
        with torch.no_grad(), full_f32_matmul():
            for i, (data, _) in enumerate(batches):
                B = data.shape[0]
                rep = torch.repeat_interleave(data, particle_size, dim=0)
                mus, Rs = recognition_stacked_forward(self.rec_params, self.factors, rep)
                z = recognition_sample_stacked(mus, Rs, self.generator,
                                               None if eps is None else eps[i])
                log_r, log_1mr = _bce_logs(generative_stacked_forward(self.gen_params, z))
                log_px_z = torch.sum(rep * log_r + (1 - rep) * log_1mr, dim=1)
                log_w = log_px_z + log_prob_prior(z) - recognition_log_prob(z, mus, Rs)
                log_w = log_w.reshape(B, particle_size)
                log_px = torch.logsumexp(log_w, dim=1) - math.log(particle_size)
                total += float(-torch.sum(log_px))
                n += B
        return total / n


__all__ = [
    "MNIST_PRESETS",
    "RECOGNITION_PRESETS",
    "StackedMetrics",
    "generative_stacked_forward",
    "init_generative_stacked",
    "init_recognition_stacked",
    "log_prob_prior",
    "recognition_log_prob",
    "recognition_sample_stacked",
    "recognition_stacked_forward",
    "sample_prior_stacked",
    "stacked_loss",
]

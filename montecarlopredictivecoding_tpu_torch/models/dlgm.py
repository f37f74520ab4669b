"""Deep Latent Gaussian Model (DLGM), the VAE-family baseline of table 1.

The JAX package's ``models/dlgm.py`` in tensor code:

* generative chain: a learned bias b₀, ``h ← T_l(relu(h)) + z_l`` with
  ``T_l`` a Linear, the output ``sigmoid(Linear(relu(h)))``, a
  standard-normal prior at every level; or the simple one-level topology
  (``fc3``/``fc4``) of the reference's torch checkpoints;
* recognition: one net per latent level (fc1 → relu → mu head and a
  covariance head), ``z = mu + R eps`` with R from a Cholesky-family factor
  (rank one by default);
* loss: summed BCE plus the full-covariance KL of every level to the prior.

Parameters are trees of tensors of the JAX package's structure
(``gen_params = {"bias", "T": [{"w", "b"}, ...], "final"}``, ``rec_params =
{"nets": [{"fc1", "mu", "cov"}, ...]}``, weights ``[in, out]``), so the
native checkpoints ``models/dlgm_*.msgpack`` load as they are.

``jax.random`` streams cannot be reproduced in torch, so every function that
draws takes its draws as an optional argument (``eps``: standard normals,
``u``: uniforms) besides a ``torch.Generator``.  Products run at full f32
(TF32 off), as the JAX package's do.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..core.modules import random_tensor
from ..core.optim import OptimizerSpec, apply_updates, tree_leaves, tree_unflatten
from ..utils.precision import full_f32_matmul
from .cholesky import RankOneFactor

Tensor = torch.Tensor


def _linear_init(generator, din: int, dout: int, device) -> dict:
    """Uniform ±1/sqrt(din) weight, then bias, drawn from ``generator``."""
    bound = 1.0 / (din ** 0.5)

    def uniform(shape):
        u = random_tensor("uniform", shape, generator, torch.float32, device)
        return -bound + 2.0 * bound * u

    return {"w": uniform((din, dout)), "b": uniform((dout,))}


def _apply(p: dict, x: Tensor) -> Tensor:
    return x @ p["w"] + p["b"]


def _normals(eps, generator, shapes, device) -> tp.List[Tensor]:
    """The given standard normals (one tensor a shape, moved to ``device``),
    or fresh ones from ``generator``."""
    if eps is not None:
        if len(eps) != len(shapes):
            raise ValueError(f"{len(eps)} noise tensors for {len(shapes)} levels")
        out = [torch.as_tensor(e, dtype=torch.float32).to(device) for e in eps]
        for e, shape in zip(out, shapes):
            if tuple(e.shape) != tuple(shape):
                raise ValueError(f"noise of shape {tuple(e.shape)}, expected {tuple(shape)}")
        return out
    return [random_tensor("normal", s, generator, torch.float32, device) for s in shapes]


# -- generative chain ------------------------------------------------------------


def init_generative(generator: tp.Optional[torch.Generator], input_dim: int = 784,
                    dim_list=(20, 128, 128), device="cuda") -> dict:
    return {
        "bias": torch.zeros((dim_list[0],), device=device),
        "T": [_linear_init(generator, dim_list[i], dim_list[i + 1], device)
              for i in range(len(dim_list) - 1)],
        "final": _linear_init(generator, dim_list[-1], input_dim, device),
    }


def generative_forward(params: dict, z_list) -> Tensor:
    """Probabilities ``[B, D]``: h₀ = b + z₀, h_{l+1} = T_l(relu(h_l)) +
    z_{l+1}, sigmoid(final(relu(h))).  Params with ``fc3``/``fc4`` are the
    simple one-level model: sigmoid(fc4(relu(fc3(z)))), no relu on z."""
    if "fc3" in params:
        z = z_list[0] if isinstance(z_list, (list, tuple)) else z_list
        h = torch.relu(_apply(params["fc3"], z))
        return torch.sigmoid(_apply(params["fc4"], h))
    h = params["bias"][None, :] + z_list[0]
    for T_p, z in zip(params["T"], z_list[1:]):
        h = _apply(T_p, torch.relu(h)) + z
    return torch.sigmoid(_apply(params["final"], torch.relu(h)))


def sample_prior(batch: int, dim_list, generator: tp.Optional[torch.Generator] = None,
                 eps=None, device="cuda") -> tp.List[Tensor]:
    """Standard-normal latents ``[batch, d]`` for every level: ``eps`` if
    given, else drawn from ``generator``."""
    return _normals(eps, generator, [(batch, d) for d in dim_list], device)


# -- recognition -----------------------------------------------------------------


def init_recognition(generator, input_dim: int, latent_dim_list, hidden_dim: int,
                     factor_cls=RankOneFactor, device="cuda"):
    """``({"nets": [...]}, factors)``: per level fc1, the mu head and the
    covariance head, drawn in that order."""
    nets, factors = [], []
    for d in latent_dim_list:
        factor = factor_cls(d)
        nets.append({
            "fc1": _linear_init(generator, input_dim, hidden_dim, device),
            "mu": _linear_init(generator, hidden_dim, d, device),
            "cov": _linear_init(generator, hidden_dim, factor.free_parameter_size(), device),
        })
        factors.append(factor)
    return {"nets": nets}, factors


def recognition_forward(params: dict, factors, x: Tensor):
    """``(mus, Rs)`` of every level; a ``"body"`` entry is the shared-input
    variant's one Linear in place of each net's fc1."""
    mus, Rs = [], []
    shared = params.get("body")
    for net, factor in zip(params["nets"], factors):
        h = torch.relu(_apply(shared if shared is not None else net["fc1"], x))
        mus.append(_apply(net["mu"], h))
        Rs.append(factor.parameterize(_apply(net["cov"], h)))
    return mus, Rs


def init_recognition_shared(generator, input_dim: int, latent_dim_list, hidden_dim: int,
                            factor_cls=RankOneFactor, device="cuda"):
    """Shared-body recognition: one Linear body (drawn first), per-level mu
    and covariance heads."""
    body = _linear_init(generator, input_dim, hidden_dim, device)
    params, factors = init_recognition(generator, input_dim, latent_dim_list, hidden_dim,
                                       factor_cls, device)
    for net in params["nets"]:
        del net["fc1"]
    params["body"] = body
    return params, factors


def recognition_sample(mus, Rs, generator: tp.Optional[torch.Generator] = None,
                       eps=None) -> tp.List[Tensor]:
    """``z = mu + R eps`` at every level (the full R, as the reference's
    sampler uses it)."""
    device = mus[0].device
    eps = _normals(eps, generator, [tuple(mu.shape) for mu in mus], device)
    return [mu + torch.einsum("bij,bj->bi", R, e) for mu, R, e in zip(mus, Rs, eps)]


# -- the loss ----------------------------------------------------------------------


def _bce_logs(recon: Tensor):
    """``(log recon, log(1-recon))`` with torch ``binary_cross_entropy``'s
    clamp: each log floored at -100.  Saturated probabilities (exactly 0 or
    1 in f32) take the constant branch, whose gradient is 0, so no 0·inf
    reaches a gradient."""
    one = torch.ones_like(recon)
    floor = torch.full_like(recon, -100.0)
    log_r = torch.where(recon > 0.0,
                        torch.clamp(torch.log(torch.where(recon > 0.0, recon, one)), min=-100.0),
                        floor)
    om = 1.0 - recon
    log_1mr = torch.where(om > 0.0,
                          torch.clamp(torch.log(torch.where(om > 0.0, om, one)), min=-100.0),
                          floor)
    return log_r, log_1mr


def dlgm_loss(recon: Tensor, x: Tensor, mus, Rs) -> Tensor:
    """Summed BCE plus, per level, the KL of N(mu, RRᵀ) to N(0, I):
    ``0.5 Σ_batch (|mu|² + tr(RRᵀ) - 2 Σ log diag R - 1)``.

    The reference's quirk is kept: it subtracts 1 per datum, not the latent
    dimension d.  That is a constant 0.5·(d-1) per datum, no gradient, but
    the reported ELBO matches the reference only with it."""
    log_r, log_1mr = _bce_logs(recon)
    bce = -torch.sum(x * log_r + (1.0 - x) * log_1mr)
    kld = 0.0
    for mu, R in zip(mus, Rs):
        tr = torch.sum(R * R, dim=(-2, -1))
        logdiag = torch.log(torch.diagonal(R, dim1=-2, dim2=-1))
        kld = kld + 0.5 * torch.sum(
            torch.sum(mu * mu, dim=-1) + tr - 2.0 * torch.sum(logdiag, dim=-1) - 1.0)
    return bce + kld


def _elbo_loss(gen_params, rec_params, factors, x, generator=None, eps=None) -> Tensor:
    mus, Rs = recognition_forward(rec_params, factors, x)
    z = recognition_sample(mus, Rs, generator=generator, eps=eps)
    return dlgm_loss(generative_forward(gen_params, z), x, mus, Rs)


def marginal_likelihood_of(probs, batches, chunk: int = 100, device="cuda") -> float:
    """The Monte-Carlo marginal likelihood of the data in ``batches`` under
    generated probabilities ``probs [n, D]`` (or ``[n, 28, 28]``): the
    probabilities as logits clamped to ±20, -BCE of every (datum, sample)
    pair ``chunk`` data at a time, log-mean-exp over the samples (float64),
    mean over the data."""
    probs = torch.as_tensor(probs, dtype=torch.float32).to(device)
    probs = probs.reshape(probs.shape[0], -1)
    p = torch.clamp(probs, 1e-7, 1 - 1e-7)
    logits = torch.clamp(torch.log(p / (1 - p)), -20.0, 20.0)
    pos = torch.sum(torch.clamp(logits, min=0) + torch.log1p(torch.exp(-torch.abs(logits))),
                    dim=1)
    losses = []
    with torch.no_grad(), full_f32_matmul():
        for data, _ in batches:
            data = data.to(device=logits.device, dtype=logits.dtype)
            for s in range(0, data.shape[0], chunk):
                part = pos[None, :] - torch.matmul(data[s : s + chunk], logits.T)
                losses.append(part.cpu().numpy())
    losses = np.concatenate(losses, axis=0)
    m = losses.min(axis=1)
    pm = np.exp(-(losses - m[:, None])).mean(axis=1)
    return float((np.log(pm) - m).mean())


# -- facade ------------------------------------------------------------------------


def optimal_hidden_dim_recog(latent_dim_list, n_gen: int, input_dim: int = 784,
                             factor: int = 3) -> int:
    """The recognition hidden width for which the recognition parameters are
    about ``factor`` times the generative ones."""
    L = len(latent_dim_list)
    s = sum(latent_dim_list)
    return (factor * n_gen - 3 * s) // (L * input_dim + 3 * s + L)


def _n_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))


class DLGM:
    """Train, evaluate, generate and score a DLGM.

    ``seed`` is an int or a ``torch.Generator``: the initial parameters and
    every later draw come from it unless a method is given its draws.
    """

    def __init__(
        self,
        input_dim: int = 784,
        hidden_dim: int = 128,
        latent_dim: int = 20,
        factor_recog: int = 3,
        lr: float = 1e-3,
        factor_cls=RankOneFactor,
        seed: tp.Union[int, torch.Generator] = 0,
        device="cuda",
    ):
        self.generator = (seed if isinstance(seed, torch.Generator)
                          else torch.Generator().manual_seed(int(seed)))
        self.device = torch.device(device)
        self.input_dim = input_dim
        self.latent_dim_list = [latent_dim, hidden_dim, hidden_dim]
        self.gen_params = init_generative(self.generator, input_dim,
                                          tuple(self.latent_dim_list), self.device)
        h = optimal_hidden_dim_recog(self.latent_dim_list, _n_params(self.gen_params),
                                     input_dim, factor_recog)
        self.rec_params, self.factors = init_recognition(
            self.generator, input_dim, self.latent_dim_list, h, factor_cls, self.device)
        self.set_optimizer(lr)

    def set_optimizer(self, lr: float, decay: float = 0.0):
        """Adam at ``lr``, behind ``add_decayed_weights(decay)`` when
        ``decay`` is not 0 (optax's ``chain``, in its order)."""
        self.tx = OptimizerSpec("adam", lr=lr, weight_decay=decay).make()
        self.opt_state = self.tx.init((self.gen_params, self.rec_params))

    def get_nparameters(self) -> dict:
        ng, nr = _n_params(self.gen_params), _n_params(self.rec_params)
        return {"#total": ng + nr, "#generative": ng, "#recognition": nr}

    def loss_and_grads(self, x: Tensor, eps=None):
        """The summed loss of batch ``x`` and its gradients ``(gen, rec)``,
        with the recognition draws ``eps`` (one ``[B, d]`` a level) or fresh
        ones."""
        params = (self.gen_params, self.rec_params)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        gp, rp = tree_unflatten(params, leaves)
        with torch.enable_grad(), full_f32_matmul():
            loss = _elbo_loss(gp, rp, self.factors, x, self.generator, eps)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, list(grads))

    def train_step(self, x: Tensor, eps=None) -> Tensor:
        """One Adam step on the batch's summed loss; returns the loss before
        the step."""
        loss, grads = self.loss_and_grads(x, eps)
        params = (self.gen_params, self.rec_params)
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state, params)
            self.gen_params, self.rec_params = apply_updates(params, updates)
        return loss

    def train(self, train_batches, epochs: int, log: bool = True):
        for epoch in range(1, epochs + 1):
            total, count = 0.0, 0
            for data, _ in train_batches:
                total += float(self.train_step(data))
                count += data.shape[0]
            if log:
                print(f"====> Epoch: {epoch} Average loss: {total / count:.4f}")

    def test_elbo(self, batches, eps=None) -> float:
        """Mean loss a datum; ``eps`` gives one list of draws a batch."""
        total, count = 0.0, 0
        with torch.no_grad(), full_f32_matmul():
            for i, (data, _) in enumerate(batches):
                total += float(_elbo_loss(self.gen_params, self.rec_params, self.factors,
                                          data, self.generator,
                                          None if eps is None else eps[i]))
                count += data.shape[0]
        return total / count

    def generate_samples(self, num_samples: int, is_return_hidden: bool = False,
                         eps=None, u=None) -> Tensor:
        """Probabilities (``is_return_hidden``) or Bernoulli samples of the
        prior's latents (``eps``, one ``[num_samples, d]`` a level, else
        drawn), shaped ``[-1, 28, 28]`` for square inputs; the Bernoulli
        draw compares uniforms ``u`` (else drawn) with the probabilities."""
        z = sample_prior(num_samples, self.latent_dim_list, self.generator, eps, self.device)
        with torch.no_grad(), full_f32_matmul():
            probs = generative_forward(self.gen_params, z)
        side = int(round(self.input_dim ** 0.5))
        shape = (-1, side, side) if side * side == self.input_dim else (-1, self.input_dim)
        if is_return_hidden:
            return probs.reshape(shape)
        if u is None:
            u = random_tensor("uniform", probs.shape, self.generator, probs.dtype, probs.device)
        u = torch.as_tensor(u, dtype=probs.dtype).to(probs.device)
        return (u <= probs).to(torch.float32).reshape(shape)

    def get_fid(self, num_samples: int = 5000, is_test: bool = False, feature_fn=None,
                root: str = "MNIST_data") -> float:
        from ..eval.fid import compute_fid, compute_stats, make_mnist_fid_stats, pixel_features

        if feature_fn is None:
            feature_fn = pixel_features
        val_stats, test_stats = make_mnist_fid_stats(feature_fn, root=root)
        images = self.generate_samples(num_samples, is_return_hidden=True).cpu().numpy()
        stats = compute_stats(feature_fn(images))
        return compute_fid(stats, test_stats if is_test else val_stats)

    def get_acc(self, batches) -> tp.Tuple[float, tp.Any]:
        """Linear-probe accuracy on the first level's posterior mean."""
        from ..eval.classifier import train_linear_classifier

        reps, labels = [], []
        with torch.no_grad(), full_f32_matmul():
            for data, label in batches:
                mus, _ = recognition_forward(self.rec_params, self.factors, data)
                reps.append(mus[0].cpu().numpy())
                labels.append(label.cpu().numpy())
        clf, best = train_linear_classifier(np.concatenate(reps), np.concatenate(labels),
                                            epochs=50, device=self.device)
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
                mus, _ = recognition_forward(self.rec_params, self.factors, masked)
                x_hat = generative_forward(self.gen_params, mus)
                x_hat = (x_hat > 0.5).to(x_hat.dtype)
                mse += float(torch.sum(torch.mean((x_hat[:, :-k] - data[:, :-k]) ** 2, dim=1)))
                n += data.shape[0]
        return mse / n

    def get_marginal_likelihood(self, batches, n_samples: int = 5000, chunk: int = 100,
                                probs=None) -> float:
        """``marginal_likelihood_of`` the probabilities of ``n_samples``
        prior samples (``probs [n_samples, D]`` if given)."""
        if probs is None:
            probs = self.generate_samples(n_samples, is_return_hidden=True)
        return marginal_likelihood_of(probs, batches, chunk, self.device)

    def evaluate_importance_nll(self, batches, particle_size: int = 16, eps=None) -> float:
        """Importance-sampled -ln p(v) a datum: every datum repeated over
        ``particle_size`` particles of the recognition posterior
        (``eps[i]``: batch i's draws, one ``[B*P, d]`` a level), logsumexp
        of the weights over the particles.

        The q-density is the reference's: ``MultivariateNormal(scale_tril=
        R).log_prob``, whose triangular solve reads only ``tril(R)``, while
        the sampler uses the full R.  For the dense rank-one R the two do not
        describe one density; parity means a lower-triangular solve on the
        full R and the diagonal's log-determinant, not a dense solve."""
        total, n = 0.0, 0
        log2pi = math.log(2 * math.pi)
        with torch.no_grad(), full_f32_matmul():
            for i, (data, _) in enumerate(batches):
                B = data.shape[0]
                rep = torch.repeat_interleave(data, particle_size, dim=0)
                mus, Rs = recognition_forward(self.rec_params, self.factors, rep)
                z = recognition_sample(mus, Rs, self.generator,
                                       None if eps is None else eps[i])
                log_r, log_1mr = _bce_logs(generative_forward(self.gen_params, z))
                log_px_z = torch.sum(rep * log_r + (1 - rep) * log_1mr, dim=1)
                log_prior = sum(-0.5 * torch.sum(zz * zz, dim=1) - 0.5 * zz.shape[1] * log2pi
                                for zz in z)
                log_q = 0.0
                for zz, mu, R in zip(z, mus, Rs):
                    y = torch.linalg.solve_triangular(R, (zz - mu)[..., None],
                                                      upper=False)[..., 0]
                    logdet = torch.sum(torch.log(torch.abs(
                        torch.diagonal(R, dim1=-2, dim2=-1))), dim=1)
                    log_q = log_q + (-0.5 * torch.sum(y * y, dim=1) - logdet
                                     - 0.5 * zz.shape[1] * log2pi)
                log_w = (log_px_z + log_prior - log_q).reshape(B, particle_size)
                log_px = torch.logsumexp(log_w, dim=1) - math.log(particle_size)
                total += float(-torch.sum(log_px))
                n += B
        return total / n


__all__ = [
    "DLGM",
    "dlgm_loss",
    "generative_forward",
    "init_generative",
    "init_recognition",
    "init_recognition_shared",
    "marginal_likelihood_of",
    "optimal_hidden_dim_recog",
    "recognition_forward",
    "recognition_sample",
    "sample_prior",
]

"""Linear classifier probe on latent representations.

``LinearClassifier`` with ``train_linear_classifier`` / ``test_classifier``,
and ``get_representations``: the MAP / full-chain / expectation posterior
representations of the first PC layer, computed through ``PCTrainer``.
Representations and labels cross the API as numpy arrays, as in the JAX
package; the probe trains on ``device``.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..core.modules import random_tensor
from ..core.optim import OptimizerSpec, apply_updates
from ..core.trainer import GenerativeModel, LangevinStep


class LinearClassifier:
    """rep_size -> num_classes linear head trained with cross-entropy and
    Adam (optax's order).  Weights are uniform ±1/sqrt(rep_size), drawn from
    ``generator``, or taken from ``params`` (``{"w": [rep, classes], "b":
    [classes]}``, numpy arrays or tensors)."""

    def __init__(self, rep_size: int, num_classes: int = 10, lr: float = 0.05,
                 generator: tp.Optional[torch.Generator] = None, params=None,
                 device="cuda"):
        device = torch.device(device)
        if params is None:
            bound = 1.0 / (rep_size ** 0.5)

            def uniform(shape):
                u = random_tensor("uniform", shape, generator, torch.float32, device)
                return -bound + 2.0 * bound * u

            params = {"w": uniform((rep_size, num_classes)), "b": uniform((num_classes,))}
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
                       for k, v in params.items()}
        self.device = device
        self.tx = OptimizerSpec("adam", lr=lr).make()
        self.opt_state = self.tx.init(self.params)

    def __call__(self, x):
        return x @ self.params["w"] + self.params["b"]

    def train_step(self, x, y):
        """One Adam step on the mean cross-entropy of ``(x, y)``; returns the
        loss before the step."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        with torch.enable_grad():
            loss = F.cross_entropy(x @ leaves["w"] + leaves["b"], y)
            gw, gb = torch.autograd.grad(loss, [leaves["w"], leaves["b"]])
        with torch.no_grad():
            updates, self.opt_state = self.tx.update({"w": gw, "b": gb},
                                                     self.opt_state, self.params)
            self.params = apply_updates(self.params, updates)
        return loss.detach()


def train_linear_classifier(
    reps: np.ndarray,
    labels: np.ndarray,
    epochs: int = 50,
    batch_size: int = 128,
    lr: float = 0.05,
    seed: int = 0,
    params=None,
    device="cuda",
) -> tp.Tuple[LinearClassifier, float]:
    """Train the probe; returns (classifier, best train accuracy over the
    epochs).  Weights come from a ``torch.Generator`` seeded with ``seed``
    unless ``params`` gives them; the batches' order from numpy's
    ``RandomState(seed)``, as in the JAX package."""
    clf = LinearClassifier(reps.shape[1], lr=lr,
                           generator=torch.Generator().manual_seed(seed),
                           params=params, device=device)
    rng = np.random.RandomState(seed)
    n = len(reps)
    x_all = torch.as_tensor(np.asarray(reps, dtype=np.float32)).to(clf.device)
    y_all = torch.as_tensor(np.asarray(labels, dtype=np.int64)).to(clf.device)
    best = 0.0
    for _ in range(epochs):
        idx = rng.permutation(n)
        for s in range(0, n, batch_size):
            sel = torch.as_tensor(idx[s : s + batch_size]).to(clf.device)
            clf.train_step(x_all[sel], y_all[sel])
        acc = test_classifier(clf, reps, labels, batch_size)
        best = max(best, acc)
    return clf, best


def test_classifier(clf, reps, labels, batch_size: int = 1000) -> float:
    """Accuracy of the probe."""
    correct = 0
    with torch.no_grad():
        for s in range(0, len(reps), batch_size):
            x = torch.as_tensor(np.asarray(reps[s : s + batch_size],
                                           dtype=np.float32)).to(clf.device)
            pred = torch.argmax(clf(x), dim=-1).cpu().numpy()
            correct += int((pred == np.asarray(labels[s : s + batch_size])).sum())
    return correct / len(reps)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_representations(
    gen: GenerativeModel,
    config: dict,
    trainers,
    batches,
    rep_type: str = "MAP",
    n: tp.Optional[int] = None,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Posterior representations of the first PC layer.

    rep_type:
      * "MAP":          PC MAP inference; one representation per datum;
      * "full":         all post-burn-in Langevin samples (thinned to ``n``
                        per datum when given), labels repeated;
      * "expectation":  mean over the sampling window.
    ``batches`` yields ``(data, label)`` tensors.  Returns (representations
    [N, d], labels [N]) as numpy arrays.
    """
    reps_out, labels_out = [], []
    input_size = config["input_size"]

    def pseudo(data):
        return torch.zeros((data.shape[0], input_size), dtype=data.dtype,
                           device=data.device)

    if rep_type == "MAP":
        pc_trainer = trainers[0]
        for data, label in batches:
            pc_trainer.train_on_batch(
                pseudo(data),
                loss_fn=config["loss_fn"],
                loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
                is_return_results_every_t=False,
            )
            reps_out.append(_numpy(gen.latents[0]))
            labels_out.append(_numpy(label))
        return np.concatenate(reps_out), np.concatenate(labels_out)

    if rep_type not in ("full", "expectation") or len(trainers) != 2:
        raise NotImplementedError(rep_type)
    pc_trainer, mcpc_trainer = trainers

    mixing, sampling = config["mixing"], config["sampling"]
    stride = 1
    if rep_type == "full" and n is not None:
        stride = max(int(sampling / n), 1)

    for data, label in batches:
        pc_trainer.train_on_batch(
            pseudo(data),
            loss_fn=config["loss_fn"],
            loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
            is_return_results_every_t=False,
        )
        results = mcpc_trainer.train_on_batch(
            pseudo(data),
            loss_fn=config["loss_fn"],
            loss_fn_kwargs={"_target": data, "_var": config["input_var"]},
            callback_after_t=LangevinStep(var=2.0),
            is_sample_x_at_batch_start=False,
            is_return_representations=True,
            capture_stride=stride,
        )
        reps = _numpy(results["representations"])  # [T/stride, B, d]
        # the post-burn-in window anchored at the mixing step: the LAST
        # sampling//stride captures
        n_keep = max(sampling // stride, 1)
        post = reps[len(reps) - n_keep :]
        if rep_type == "expectation":
            reps_here = reps.mean(axis=0)
            labels_here = _numpy(label)
        else:
            reps_here = post.reshape(-1, post.shape[-1])
            labels_here = np.tile(_numpy(label), post.shape[0])
        reps_out.append(reps_here)
        labels_out.append(labels_here)
    return np.concatenate(reps_out), np.concatenate(labels_out)

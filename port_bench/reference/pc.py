"""The plain PC training arithmetic the benchmark holds the port's
``train_pc`` to: table 1's PC reconstruction model, trained a batch at a
time by MAP inference on the latents and one Adam step on the parameters.

Plain PyTorch, float64 by default, on any device, written from the model's
equations and importing nothing of the program.  The generative MLP

    zeros -> Linear(d0,d0) -> PC(x0) -> tanh -> Linear(d0,d1) -> PC(x1)
          -> tanh -> Linear(d1,d2) -> PC(x2) -> tanh -> Linear(d2,D) -> Bernoulli

has the energy gradient of the latents X = [x0 | x1 | x2]

    err0 = x0 - b0;  e1 = x1 - (tanh(x0) W1 + b1);  e2 = x2 - (tanh(x1) W2 + b2)
    S    = sigmoid(tanh(x2) W3 + b3) - y
    G    = [err0 | e1 | e2] - (1 - tanh(X)^2) * [e1 W1^T | e2 W2^T | -S W3^T]

A training batch takes ``steps`` Adam MAP steps on the latents from zero
moments (optax's order, its float32 constants: ``mcpc.adam_constants``),
then the Hebbian parameter gradients of the last step, from the state
before its update, summed over the batch,

    gW1 = -tanh(x0)^T e1   gW2 = -tanh(x1)^T e2   gW3 = tanh(x2)^T S
    gb0 = sum -err0        gb1 = sum -e1          gb2 = sum -e2    gb3 = sum S

(gW0 is zero: the first layer's input is zeros), divided by the batch and
handed to optax's Adam on the parameters (``mcpc.adam_params``).

Departures from the published description (the reference repository's
``table_1.py`` loads the trained ``pc_mse_{1,2,3}`` checkpoints and ships
no training script):

* the gradients are written in closed form, where the reference's library
  takes them by automatic differentiation of the same energy;
* the Bernoulli loss enters only through its gradient ``S``;
* the training's hyperparameters (batch, lrs, steps, the update at the
  last step) are the port's ``pc_training_config``, not published ones;
* the latents' uniform(-10, 10) initialisation is not drawn here: callers
  pass the latents the program drew.

Importing the module turns TF32 matrix products off, so a float32 caller
on a card gets float32 products (the control turns them on again to make
its lower-precision run); the reference computes no convolution, so
cuDNN's flag is left as it is.
"""

from __future__ import annotations

import typing as tp

import torch

from port_bench.reference import mcpc

torch.backends.cuda.matmul.allow_tf32 = False

Tensor = torch.Tensor


class Chain(mcpc.Chain):
    """:class:`mcpc.Chain` with tanh in relu's place."""

    def terms(self, X: Tensor):
        """(G, tanh(X) by layer, err0, e1, e2, S) at latents ``X`` [..., N]."""
        mm = self.mm
        x0, x1, x2 = self.split(X)
        h0, h1, h2 = torch.tanh(x0), torch.tanh(x1), torch.tanh(x2)
        err0 = x0 - self.b0
        e1 = x1 - (mm(h0, self.w1) + self.b1)
        e2 = x2 - (mm(h1, self.w2) + self.b2)
        S = torch.sigmoid(mm(h2, self.w3) + self.b3) - self.y
        if self.clamped is not None:
            S = S * self.clamped
        back = torch.cat([mm(e1, self.w1.T), mm(e2, self.w2.T), -mm(S, self.w3.T)], dim=-1)
        dH = 1.0 - torch.cat([h0, h1, h2], dim=-1) ** 2
        G = torch.cat([err0, e1, e2], dim=-1) - dH * back
        return G, (h0, h1, h2), err0, e1, e2, S


def adam_states(chain: Chain, X: Tensor, steps: int, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> Tensor:
    """Every state of ``steps`` Adam MAP steps from ``X`` [B, N] and zero
    moments: [steps + 1, B, N], ``X`` first."""
    (w1, w1c, w2, w2c), cs = mcpc.adam_constants(b1, b2, steps)
    out = X.new_empty((steps + 1,) + tuple(X.shape))
    out[0] = X
    m = torch.zeros_like(X)
    v = torch.zeros_like(X)
    for t, (c1, c2) in enumerate(cs):
        G = chain.terms(X)[0]
        m = w1 * m + w1c * G
        v = w2 * v + w2c * G * G
        X = X - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        out[t + 1] = X
    return out


def hebbian_sums(chain: Chain, X: Tensor) -> tp.List[Tensor]:
    """The parameter gradients at the state ``X`` [B, N], summed over the
    batch: (gW1, gW2, gW3, gb0, gb1, gb2, gb3), ``mcpc.pgrads_tree``'s order."""
    _, (h0, h1, h2), err0, e1, e2, S = chain.terms(X)
    mm = chain.mm
    return [-mm(h0.T, e1), -mm(h1.T, e2), mm(h2.T, S),
            -err0.sum(0), -e1.sum(0), -e2.sum(0), S.sum(0)]


def train_batch(params, X: Tensor, y: Tensor, steps: int, lr: float, dtype=torch.float64,
                mm=torch.matmul) -> tp.Tuple[Tensor, tp.List[dict]]:
    """One batch's inference from the latents ``X`` [B, N] on the target
    ``y``: (every state, [steps + 1, B, N]; the last step's gradient sums as
    the parameters' tree, not divided by the batch)."""
    chain = Chain(params, y, dtype=dtype, mm=mm)
    states = adam_states(chain, X.to(dtype), steps, lr)
    return states, mcpc.pgrads_tree(hebbian_sums(chain, states[-2]), chain.dims)


def param_step(params, state, pgrads, batch: int, lr: float):
    """optax's Adam on the parameters from the gradient sums ``pgrads`` over
    ``batch`` rows, with its float32 decay rates: (params', state')."""
    grads = [{k: v / batch for k, v in g.items()} for g in pgrads]
    return mcpc.adam_params(params, state, grads, lr, b1=mcpc.f32(0.9), b2=mcpc.f32(0.999))

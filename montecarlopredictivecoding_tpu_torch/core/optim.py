"""Optimizers in optax's order of operations, over trees of tensors.

:class:`OptimizerSpec` describes an optimizer the way the trainer takes it
(``('sgd'|'adam'|'adamw', kwargs)`` in torch style) and :meth:`make` builds
a :class:`Transform` with ``init(tree)`` and ``update(grads, state, tree) ->
(updates, state)``, the optax shape: ``sgd`` (``trace`` then ``-lr``),
``adam`` (``scale_by_adam`` then ``-lr``), ``adamw``, and torch's
``weight_decay`` as ``add_decayed_weights`` in front.  The engine uses them
for the latents and the parameters, ``train_mcpc`` for its parameter step.
A tree is a tensor, or a dict, tuple or list of trees.  The layout of an
``adam`` state is known here only: :func:`adam_moments` reads its moments and
count, :func:`adam_state` builds one from them (the trainer's warm chain
resumes and hands back the latents' Adam state through the two).

Adam is optax's:

    mu    = b1·mu + (1-b1)·g
    nu    = b2·nu + (1-b2)·g²
    count = count + 1
    p     = p + (-lr) · (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count)) + eps)

with ``eps`` outside the root.  ``torch.optim.Adam`` folds the two bias
corrections into the step size and the root, which rounds differently, so it
is not used.  ``update`` is pure: it returns new updates and a new state and
changes neither argument.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` and of the trees in ``rest``, which
    share its structure; None stays None."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or set(r) != set(tree) for r in rest):
            raise ValueError("the trees do not share one structure")
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        if any(not isinstance(r, (tuple, list)) or len(r) != len(tree) for r in rest):
            raise ValueError("the trees do not share one structure")
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> tp.List[torch.Tensor]:
    """The tensors of ``tree`` in the order :func:`tree_map` visits them."""
    out: tp.List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves: tp.Sequence[torch.Tensor]):
    """``tree``'s structure with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _foreach(fn, tree, *rest):
    """``fn`` over the lists of leaves of ``tree`` and of the trees in
    ``rest``, which share its structure, paired as :func:`tree_map` pairs
    them: ``torch._foreach_*`` ops launch one kernel an op, not one a
    tensor.  The result has ``tree``'s structure."""
    lists: tp.List[tp.List[torch.Tensor]] = [[] for _ in range(1 + len(rest))]

    def gather(*leaves):
        for out, leaf in zip(lists, leaves):
            out.append(leaf)

    tree_map(gather, tree, *rest)
    return tree_unflatten(tree, fn(*lists))


# -- the transforms (optax's GradientTransformation, in tensor code) --------


@dataclasses.dataclass(frozen=True)
class ScaleByAdamState:
    """``count`` steps taken, and the moments, shaped like the tree."""

    count: int
    mu: tp.Any
    nu: tp.Any


@dataclasses.dataclass(frozen=True)
class TraceState:
    trace: tp.Any


@dataclasses.dataclass(frozen=True)
class Transform:
    """``init(tree) -> state``; ``update(grads, state, tree) -> (updates,
    state)``.  ``tree + updates`` (:func:`apply_updates`) is the step."""

    init: tp.Callable
    update: tp.Callable


def _chain(*transforms: Transform) -> Transform:
    def init(tree):
        return tuple(t.init(tree) for t in transforms)

    def update(grads, state, tree=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, tree)
            new.append(s)
        return grads, tuple(new)

    return Transform(init, update)


def _scale(step_size: float) -> Transform:
    return Transform(lambda tree: (), lambda g, s, tree=None: (
        _foreach(lambda u: torch._foreach_mul(u, step_size), g), s))


def _trace(decay: float) -> Transform:
    def update(g, state, tree=None):
        new = tree_map(lambda u, t: u + decay * t, g, state.trace)
        return new, TraceState(new)

    return Transform(lambda tree: TraceState(tree_map(torch.zeros_like, tree)), update)


def _add_decayed_weights(weight_decay: float) -> Transform:
    return Transform(lambda tree: (), lambda g, s, tree=None: (
        tree_map(lambda u, p: u + weight_decay * p, g, tree), s))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


def _scale_by_adam(b1: float, b2: float, eps: float) -> Transform:
    def init(tree):
        return ScaleByAdamState(0, tree_map(torch.zeros_like, tree),
                                tree_map(torch.zeros_like, tree))

    def update(g, state, tree=None):
        mu = _foreach(lambda u, t: torch._foreach_add(
            torch._foreach_mul(u, 1.0 - b1), torch._foreach_mul(t, b1)), g, state.mu)
        nu = _foreach(lambda u, t: torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(u, u), 1.0 - b2),
            torch._foreach_mul(t, b2)), g, state.nu)
        count = state.count + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        updates = _foreach(lambda m, v: torch._foreach_div(
            torch._foreach_div(m, c1),
            torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, c2)), eps)), mu, nu)
        return updates, ScaleByAdamState(count, mu, nu)

    return Transform(init, update)


def apply_updates(tree, updates):
    return _foreach(torch._foreach_add, tree, updates)


def adam_state(mu, nu, count: int) -> tuple:
    """The state ``OptimizerSpec("adam").make().init(tree)`` gives, holding
    the moments ``mu`` and ``nu`` (trees shaped like ``tree``) and ``count``
    in place of zeros and 0."""
    return (ScaleByAdamState(count, mu, nu), ())


def adam_moments(state, tree) -> tp.Optional[tuple]:
    """``(mu, nu, count)`` of ``state`` when it is a state of
    ``OptimizerSpec("adam").make()`` (no weight decay) over a tree shaped
    like ``tree``, else None."""
    if not (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[0], ScaleByAdamState) and state[1] == ()):
        return None
    s = state[0]

    def same_shape(x, m, v):
        if not all(isinstance(t, torch.Tensor) and t.shape == x.shape for t in (m, v)):
            raise ValueError("the moments are not shaped like the tree")

    try:
        tree_map(same_shape, tree, s.mu, s.nu)
    except ValueError:
        return None
    return s.mu, s.nu, s.count


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str  # 'sgd' | 'adam' | 'adamw'
    lr: float = 0.1
    momentum: float = 0.0
    betas: tp.Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0

    @staticmethod
    def from_torch_style(name_or_spec, kwargs: tp.Optional[dict] = None) -> "OptimizerSpec":
        """Build a spec from ``(optimizer_fn, kwargs)`` pairs: the strings
        'sgd'/'adam'/'adamw', an OptimizerSpec (passed through), or a class
        whose ``__name__`` names one (``torch.optim.Adam``)."""
        if isinstance(name_or_spec, OptimizerSpec):
            return name_or_spec
        kwargs = dict(kwargs or {})
        if isinstance(name_or_spec, str):
            name = name_or_spec.lower()
        else:
            name = getattr(name_or_spec, "__name__", str(name_or_spec)).lower()
        if name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unsupported optimizer {name!r}")
        spec = {"name": name}
        if "lr" in kwargs:
            spec["lr"] = float(kwargs["lr"])
        if "momentum" in kwargs:
            spec["momentum"] = float(kwargs["momentum"])
        if "betas" in kwargs:
            spec["betas"] = tuple(float(b) for b in kwargs["betas"])
        if "eps" in kwargs:
            spec["eps"] = float(kwargs["eps"])
        if "weight_decay" in kwargs:
            spec["weight_decay"] = float(kwargs["weight_decay"])
        return OptimizerSpec(**spec)

    def make(self) -> Transform:
        """The transform, in optax's order: torch's ``weight_decay`` adds
        ``wd * param`` to the gradient first (``adamw`` decays after the
        Adam scaling)."""
        if self.name == "sgd":
            parts = [_trace(self.momentum)] if self.momentum else []
            tx = _chain(*parts, _scale(-self.lr))
        elif self.name == "adam":
            tx = _chain(_scale_by_adam(self.betas[0], self.betas[1], self.eps),
                        _scale(-self.lr))
        elif self.name == "adamw":
            return _chain(_scale_by_adam(self.betas[0], self.betas[1], self.eps),
                          _add_decayed_weights(self.weight_decay), _scale(-self.lr))
        else:
            raise ValueError(f"unsupported optimizer {self.name!r}")
        if self.weight_decay:
            tx = _chain(_add_decayed_weights(self.weight_decay), tx)
        return tx

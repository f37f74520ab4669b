"""Module specs for predictive-coding stacks (PyTorch).

A model is a static sequence of module specs (:class:`Linear`,
:class:`Activation`, :class:`PC`).  The specs hold no state: parameters and
latents are explicit tuples of tensors that the caller passes in, so every
public function keeps the JAX package's layout (weights ``w`` are
``[in, out]``, ``y = x @ w + b``, latents are ``[batch, dim]`` tensors) and
the two packages can be compared on the same arrays.

* ``PC`` captures the incoming prediction ``mu``, contributes the layer
  energy ``energy_fn({'mu': mu, 'x': x})`` (default ``0.5*(mu-x)**2``) and
  forwards ``x`` instead of ``mu`` in train mode; in eval mode it is the
  identity.
* ``S`` mask: interactive all-to-all energy between expanded ``mu``/``x``;
  ``M`` mask: elementwise energy selection.  ``S`` overrides ``M``.
* ``sample_x_fn`` variants draw from an explicit ``torch.Generator`` passed
  as ``inputs['generator']``.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Energy functions (elementwise, reduced by the model).  A dict with 'mu' and
# 'x' (plus any additional inputs) -> elementwise energy tensor.
# ---------------------------------------------------------------------------


def gaussian_energy(inputs: dict) -> Tensor:
    """Default PC energy: ``0.5 * (mu - x)**2``."""
    return 0.5 * (inputs["mu"] - inputs["x"]) ** 2


gaussian_energy.gaussian_var = 1.0


def scaled_gaussian_energy(var: float) -> tp.Callable[[dict], Tensor]:
    """Gaussian energy with variance ``var``: ``(1/var)*0.5*(mu-x)**2`` (the
    "generative PC layer at the output" pattern)."""

    def _fn(inputs: dict) -> Tensor:
        return (1.0 / var) * 0.5 * (inputs["mu"] - inputs["x"]) ** 2

    # introspection hook: lets a kernel eligibility check read the variance
    # off an output-PC site
    _fn.gaussian_var = float(var)
    return _fn


# ---------------------------------------------------------------------------
# Latent initialisers (sample_x_fn variants).  ``inputs`` carries 'mu', 'x'
# (previous latent or None) and 'generator' (None for deterministic fns).
# ---------------------------------------------------------------------------


def random_tensor(kind: str, shape, generator: tp.Optional[torch.Generator],
                  dtype: torch.dtype, device) -> Tensor:
    """``torch.rand``/``torch.randn`` drawn on the generator's own device and
    moved to ``device``: the same generator state gives the same numbers
    whichever device the result lives on.

    A CPU generator's draw for a CUDA device is made in pinned host memory
    and copied on the current stream without a host wait: the caching host
    allocator hands the block out again only after that copy has run.
    ``random_tensor.staged`` counts those draws; assign 0 to reset it."""
    gen_device = generator.device if generator is not None else device
    fn = torch.rand if kind == "uniform" else torch.randn
    if (generator is not None and gen_device.type == "cpu"
            and torch.device(device).type == "cuda"):
        out = fn(tuple(shape), generator=generator, dtype=dtype, pin_memory=True)
        random_tensor.staged += 1
        return out.to(device, non_blocking=True)
    out = fn(tuple(shape), generator=generator, dtype=dtype, device=gen_device)
    return out.to(device)


random_tensor.staged = 0


def forward_init(inputs: dict) -> Tensor:
    """Default: feed-forward init ``x = mu``."""
    return inputs["mu"]


def uniform_init(inputs: dict) -> Tensor:
    """Uniform init on [-10, 10]."""
    mu = inputs["mu"]
    u = random_tensor("uniform", mu.shape, inputs["generator"], mu.dtype,
                      mu.device)
    return -10.0 + 20.0 * u


def normal_init(inputs: dict) -> Tensor:
    """Standard-normal init."""
    mu = inputs["mu"]
    return random_tensor("normal", mu.shape, inputs["generator"], mu.dtype,
                         mu.device)


def constant_init(inputs: dict) -> Tensor:
    """Constant-3 init."""
    return 3.0 * torch.ones_like(inputs["mu"])


# Aliases matching the reference names.
sample_x_fn = uniform_init
sample_x_fn_normal = normal_init
sample_x_fn_cte = constant_init


# ---------------------------------------------------------------------------
# Module specs.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Linear:
    """Dense layer ``y = x @ w + b`` with ``w`` of shape ``[in, out]``.

    Initialisation is uniform ±1/sqrt(in_dim), the ``torch.nn.Linear``
    distribution.
    """

    in_dim: int
    out_dim: int
    use_bias: bool = True

    def init(self, generator: tp.Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, device="cuda") -> dict:
        bound = 1.0 / (self.in_dim ** 0.5)

        def uniform(shape):
            u = random_tensor("uniform", shape, generator, dtype, device)
            return -bound + 2.0 * bound * u

        params = {"w": uniform((self.in_dim, self.out_dim))}
        if self.use_bias:
            params["b"] = uniform((self.out_dim,))
        return params

    def apply(self, params: dict, x: Tensor) -> Tensor:
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y


def _mish(x: Tensor) -> Tensor:
    return x * torch.tanh(F.softplus(x))


_ACTIVATIONS: dict[str, tp.Callable[[Tensor], Tensor]] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "mish": _mish,
}


def activation_fn(name: str) -> tp.Callable[[Tensor], Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Activation:
    name: str

    def apply(self, x: Tensor) -> Tensor:
        return activation_fn(self.name)(x)


@dataclasses.dataclass(frozen=True)
class PC:
    """Predictive-coding latent site.

    Attributes:
        energy_fn: elementwise energy of (mu, x); default Gaussian.
        sample_x_fn: latent initialiser given the incoming prediction.
        S: optional [size_mu, size_x] interactive-energy mask.  Overrides M.
        M: optional elementwise energy-selection mask.
        is_holding_error: store ``x - mu`` during forward.
    """

    energy_fn: tp.Callable[[dict], Tensor] = gaussian_energy
    sample_x_fn: tp.Callable[[dict], Tensor] = forward_init
    S: tp.Optional[tuple] = None  # stored as nested tuples to stay hashable
    M: tp.Optional[tuple] = None
    is_holding_error: bool = False

    def _masks(self, like: Tensor):
        def as_tensor(m):
            if m is None:
                return None
            return torch.as_tensor(m, dtype=like.dtype, device=like.device)

        return as_tensor(self.S), as_tensor(self.M)

    def energy(self, mu: Tensor, x: Tensor, extra: tp.Optional[dict] = None) -> Tensor:
        """Elementwise energy with S/M-mask semantics applied."""
        S, M = self._masks(mu)
        if S is not None:
            if mu.ndim != 2 or x.ndim != 2:
                raise ValueError("S-mask energies require 2-D [batch, dim] mu/x")
            size_mu, size_x = mu.shape[1], x.shape[1]
            if tuple(S.shape) != (size_mu, size_x):
                raise ValueError(
                    f"S must be [{size_mu}, {size_x}], got {tuple(S.shape)}"
                )
            mu_e = mu[:, :, None].expand(mu.shape[0], size_mu, size_x)
            x_e = x[:, None, :].expand(x.shape[0], size_mu, size_x)
            inputs = {"mu": mu_e, "x": x_e}
            if extra:
                inputs.update(extra)
            return self.energy_fn(inputs) * S[None]
        inputs = {"mu": mu, "x": x}
        if extra:
            inputs.update(extra)
        e = self.energy_fn(inputs)
        if M is not None:
            e = e * M[None]
        return e

    def sample(self, mu: Tensor, x_prev: tp.Optional[Tensor],
               generator: tp.Optional[torch.Generator]) -> Tensor:
        x = self.sample_x_fn({"mu": mu, "x": x_prev, "generator": generator})
        return x.detach()

"""PCModel: a predictive-coding stack over explicit parameter and latent
tuples.

A model is a static tuple of specs plus two explicit tuples:

* ``params``  — one ``{"w": [in, out], "b": [out]}`` dict per :class:`Linear`;
* ``latents`` — one ``[batch, dim]`` tensor per :class:`PC` site.

The forward walk runs eagerly over the static module list.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from .modules import PC, Activation, Linear, random_tensor, uniform_init
from ..utils.observability import span

Tensor = torch.Tensor
Params = tp.Tuple[dict, ...]
Latents = tp.Tuple[Tensor, ...]


@dataclasses.dataclass(frozen=True)
class ForwardResult:
    output: Tensor
    energies: tp.Tuple[Tensor, ...]  # per-PC-layer scalar energies (summed)
    energies_per_datapoint: tp.Tuple[Tensor, ...]  # per-PC [batch, 1]
    mus: tp.Tuple[Tensor, ...]  # per-PC incoming prediction
    errors: tp.Tuple[tp.Optional[Tensor], ...]  # x - mu where is_holding_error


class PCModel:
    """A static stack of Linear / Activation / PC specs."""

    def __init__(self, modules: tp.Sequence):
        self.modules = tuple(modules)
        self.linear_indices = tuple(
            i for i, m in enumerate(self.modules) if isinstance(m, Linear)
        )
        self.pc_indices = tuple(
            i for i, m in enumerate(self.modules) if isinstance(m, PC)
        )

    # -- structure ---------------------------------------------------------

    @property
    def num_pc_layers(self) -> int:
        return len(self.pc_indices)

    @property
    def pc_layers(self) -> tp.Tuple[PC, ...]:
        return tuple(self.modules[i] for i in self.pc_indices)

    def get_least_T(self) -> int:
        """Minimum sensible inference-step count: one per PC layer plus one."""
        return self.num_pc_layers + 1

    # -- parameters ---------------------------------------------------------

    def init(self, generator: tp.Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, device="cuda") -> Params:
        return tuple(
            m.init(generator, dtype, device)
            for m in self.modules
            if isinstance(m, Linear)
        )

    def num_parameters(self, params: Params, exclude_first_linear: bool = False) -> int:
        """Parameter count, optionally excluding the first Linear (the
        learned top-layer prior)."""
        start = 1 if exclude_first_linear else 0
        return sum(t.numel() for p in params[start:] for t in p.values())

    def weight_norms(self, params: Params) -> tp.Tuple[Tensor, ...]:
        """Frobenius norm of each Linear weight."""
        return tuple(torch.linalg.norm(p["w"]) for p in params)

    # -- forward ------------------------------------------------------------

    def _walk(
        self,
        params: Params,
        inputs: Tensor,
        on_pc: tp.Callable[[int, PC, Tensor], Tensor],
    ) -> Tensor:
        """Shared forward walk: ``on_pc(pc_idx, spec, mu) -> x`` decides what a
        PC site emits."""
        h = inputs
        li = 0
        pi = 0
        for m in self.modules:
            if isinstance(m, Linear):
                h = m.apply(params[li], h)
                li += 1
            elif isinstance(m, Activation):
                h = m.apply(h)
            elif isinstance(m, PC):
                h = on_pc(pi, m, h)
                pi += 1
            else:
                raise TypeError(f"unknown module spec {m!r}")
        return h

    def apply(
        self,
        params: Params,
        latents: Latents,
        inputs: Tensor,
        energy_fn_additional_inputs: tp.Optional[dict] = None,
    ) -> ForwardResult:
        """Train-mode forward: PC sites emit their latent ``x`` and record the
        layer energy."""
        energies: list = []
        energies_pd: list = []
        mus: list = []
        errors: list = []

        def on_pc(pi: int, spec: PC, mu: Tensor) -> Tensor:
            x = latents[pi]
            e = spec.energy(mu, x, energy_fn_additional_inputs)
            energies.append(torch.sum(e))
            # per-datapoint energy: sum over all non-batch dims -> [B, 1]
            energies_pd.append(
                torch.sum(e, dim=tuple(range(1, e.ndim)))[:, None]
            )
            mus.append(mu)
            errors.append((x - mu).detach() if spec.is_holding_error else None)
            return x

        output = self._walk(params, inputs, on_pc)
        return ForwardResult(
            output=output,
            energies=tuple(energies),
            energies_per_datapoint=tuple(energies_pd),
            mus=tuple(mus),
            errors=tuple(errors),
        )

    def predict(self, params: Params, inputs: Tensor) -> Tensor:
        """Eval-mode forward: PC sites are the identity."""
        return self._walk(params, inputs, lambda pi, spec, mu: mu)

    def init_latents(
        self,
        params: Params,
        inputs: Tensor,
        generator: tp.Optional[torch.Generator] = None,
        latents_prev: tp.Optional[Latents] = None,
    ) -> Latents:
        """Sample fresh latents via each PC site's ``sample_x_fn`` during a
        forward pass: later predictions are computed from the freshly sampled
        latents.  The sites draw from ``generator`` in order."""
        out: list = []

        def on_pc(pi: int, spec: PC, mu: Tensor) -> Tensor:
            prev = latents_prev[pi] if latents_prev is not None else None
            x = spec.sample(mu, prev, generator)
            out.append(x)
            return x

        with span("mcpc.init_latents"), torch.no_grad():
            self._walk(params, inputs, on_pc)
        return tuple(out)

    def ancestral_sample(
        self,
        params: Params,
        generator: tp.Optional[torch.Generator],
        num_samples: int,
        input_dim: tp.Optional[int] = None,
    ) -> Tensor:
        """Prior -> data ancestral sampling: at each PC site draw
        ``x ~ N(mu, I)``; return the pre-sensory activations."""
        if input_dim is None:
            first = self.modules[self.linear_indices[0]]
            input_dim = first.in_dim
        w = params[0]["w"]

        def on_pc(pi: int, spec: PC, mu: Tensor) -> Tensor:
            return mu + random_tensor("normal", mu.shape, generator, mu.dtype,
                                      mu.device)

        zeros = torch.zeros((num_samples, input_dim), dtype=w.dtype,
                            device=w.device)
        with torch.no_grad():
            return self._walk(params, zeros, on_pc)


def make_mlp_model(
    input_size: int,
    hidden_size: int,
    hidden2_size: int,
    output_size: int,
    activation: str = "relu",
    sample_x_fn=None,
    output_pc: tp.Optional[PC] = None,
) -> PCModel:
    """The canonical 4-Linear generative MLP:

    ``Linear(d0,d0) -> PC -> act -> Linear(d0,d1) -> PC -> act
    -> Linear(d1,d2) -> PC -> act -> Linear(d2,out)``

    fed a zeros pseudo-input so the first Linear outputs its learned bias
    (the top-layer prior mean).  ``output_pc`` optionally appends a trailing
    PC site so the sensory layer itself becomes an unclamped latent.
    """
    if sample_x_fn is None:
        sample_x_fn = uniform_init
    mods: list = [
        Linear(input_size, input_size),
        PC(sample_x_fn=sample_x_fn),
        Activation(activation),
        Linear(input_size, hidden_size),
        PC(sample_x_fn=sample_x_fn),
        Activation(activation),
        Linear(hidden_size, hidden2_size),
        PC(sample_x_fn=sample_x_fn),
        Activation(activation),
        Linear(hidden2_size, output_size),
    ]
    if output_pc is not None:
        mods.append(output_pc)
    return PCModel(mods)

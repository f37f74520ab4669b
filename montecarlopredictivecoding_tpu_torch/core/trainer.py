"""The MCPC Langevin configuration and the shared model-state handle.

``PCTrainer`` (the general inference/learning trainer) is not part of this
package yet; see ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from .model import PCModel


@dataclasses.dataclass(frozen=True)
class LangevinStep:
    """After each deterministic x-step, add Gaussian noise ``N(0, lr0 * var)``
    to every latent.  ``var=2.0`` yields exact unadjusted Langevin dynamics
    with stationary distribution ∝ exp(-E)."""

    var: float = 2.0


class GenerativeModel:
    """Holds a PCModel spec plus its explicit state (params, latents, RNG).

    Plays the role of the reference's stateful ``nn.Sequential`` model that
    both trainers share.  ``generator`` is a ``torch.Generator`` or an int
    seed for a new CPU generator; parameters and latents are drawn from it
    in call order.
    """

    def __init__(
        self,
        model: PCModel,
        generator: tp.Union[torch.Generator, int],
        params=None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.model = model
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        self.generator = generator
        if params is None:
            params = model.init(generator, dtype, device)
        self.params = params
        self.latents: tp.Optional[tuple] = None

    # reference-parity helpers ------------------------------------------------

    def get_model_xs(self):
        """All latent value nodes."""
        return self.latents

    def get_x(self, index: int = 0):
        """Latent of the index-th PC layer."""
        return self.latents[index]

    def predict(self, inputs: torch.Tensor) -> torch.Tensor:
        """Eval-mode forward (PC layers are identity)."""
        return self.model.predict(self.params, inputs)

    def sample_latents(self, inputs: torch.Tensor,
                       generator: tp.Optional[torch.Generator] = None):
        self.latents = self.model.init_latents(
            self.params, inputs, generator or self.generator, self.latents
        )
        return self.latents

    def ancestral_sample(self, num_samples: int,
                         generator: tp.Optional[torch.Generator] = None):
        return self.model.ancestral_sample(
            self.params, generator or self.generator, num_samples
        )

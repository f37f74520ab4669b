"""montecarlopredictivecoding_tpu_torch — the PyTorch/CUDA port of the
JAX package beside it in this repository.

Same subpackages and module names as the JAX package, so each part has a
findable counterpart.  Plain tensor code is PyTorch.  ``PCTrainer`` runs a
configuration in the general step engine or, where it can, in the fused MCPC
chain (``ops.mcpc_chain``), which runs as a hand-written CUDA kernel for Hopper
(``ops/csrc/mcpc_chain.cu``) on CUDA tensors and as its plain PyTorch
version on CPU tensors.  Entry points default to ``device="cuda"``; pass
``device="cpu"`` to run on the CPU.  This package imports neither JAX nor
the JAX package.
"""

from . import core
from .core import (
    PC,
    Activation,
    EngineConfig,
    GenerativeModel,
    LangevinStep,
    Linear,
    OptimizerSpec,
    PCModel,
    PCTrainer,
    bernoulli_fn,
    bernoulli_fn_mask,
    fe_fn,
    fe_fn_mask,
    gaussian_energy,
    make_mlp_model,
    sample_x_fn,
    sample_x_fn_cte,
    sample_x_fn_normal,
    scaled_gaussian_energy,
    zero_fn,
)

__version__ = "0.1.0"

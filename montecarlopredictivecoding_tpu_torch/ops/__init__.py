from .mcpc_chain import (
    aligned_layout,
    mcpc_chain,
    mcpc_chain_reference,
    model_activation,
    supports_model,
)

__all__ = [
    "aligned_layout",
    "mcpc_chain",
    "mcpc_chain_reference",
    "model_activation",
    "supports_model",
]

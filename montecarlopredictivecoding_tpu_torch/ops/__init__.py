from .mcpc_chain import (
    aligned_layout,
    mcpc_chain,
    mcpc_chain_reference,
    model_activation,
    output_pc_var,
    sum_block_partials,
    sum_block_partials_reference,
    supports_model,
)

__all__ = [
    "aligned_layout",
    "mcpc_chain",
    "mcpc_chain_reference",
    "model_activation",
    "output_pc_var",
    "sum_block_partials",
    "sum_block_partials_reference",
    "supports_model",
]

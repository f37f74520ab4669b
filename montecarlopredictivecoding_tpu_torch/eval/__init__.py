from .classifier import (
    LinearClassifier,
    get_representations,
    test_classifier,
    train_linear_classifier,
)
from .metrics import (
    KLdivergence,
    decode_from_deepest_latent,
    get_marginal_likelihood,
    get_mse_rec,
    get_paired_stat,
    kl_divergence_discrete,
)
from .sampling import sample_pc

__all__ = [
    "LinearClassifier",
    "get_representations",
    "test_classifier",
    "train_linear_classifier",
    "KLdivergence",
    "decode_from_deepest_latent",
    "get_marginal_likelihood",
    "get_mse_rec",
    "get_paired_stat",
    "kl_divergence_discrete",
    "sample_pc",
]

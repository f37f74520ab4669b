from .classifier import (
    LinearClassifier,
    get_representations,
    test_classifier,
    train_linear_classifier,
)
from .fid import (
    FIDStats,
    compute_fid,
    compute_stats,
    get_fid,
    make_inception_features,
    make_mnist_fid_stats,
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
    "FIDStats",
    "compute_fid",
    "compute_stats",
    "get_fid",
    "make_inception_features",
    "make_mnist_fid_stats",
    "KLdivergence",
    "decode_from_deepest_latent",
    "get_marginal_likelihood",
    "get_mse_rec",
    "get_paired_stat",
    "kl_divergence_discrete",
    "sample_pc",
]

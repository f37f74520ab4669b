from .classifier import (
    LinearClassifier,
    get_representations,
    test_classifier,
    train_linear_classifier,
)

__all__ = [
    "LinearClassifier",
    "get_representations",
    "test_classifier",
    "train_linear_classifier",
]

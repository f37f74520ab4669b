from .mnist import Batches, get_mnist_data, load_mnist_arrays, mnist_source_fingerprint
from .synthetic import chunk_dataset, grating_dataset, noise_dataset

__all__ = [
    "Batches",
    "get_mnist_data",
    "load_mnist_arrays",
    "mnist_source_fingerprint",
    "chunk_dataset",
    "grating_dataset",
    "noise_dataset",
]

from .mnist import Batches, get_mnist_data, load_mnist_arrays, mnist_source_fingerprint

__all__ = [
    "Batches",
    "get_mnist_data",
    "load_mnist_arrays",
    "mnist_source_fingerprint",
]

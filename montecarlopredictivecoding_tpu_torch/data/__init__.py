from .mnist import Batches, get_mnist_data, load_mnist_arrays

__all__ = [
    "Batches",
    "get_mnist_data",
    "load_mnist_arrays",
]

"""Experiment entry points of the port (``train_mnist``)."""

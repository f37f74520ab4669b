"""Benchmarks of the port, beside the JAX package's ``benchmarks/`` folder.

``vpu_op_bench`` is the counterpart of ``benchmarks/vpu_op_bench.py``: the
per-op cost probe of the chain kernel's elementwise paths, a hand-written
CUDA kernel (``ops/csrc/op_probe.cu``) with its plain PyTorch versions.
"""

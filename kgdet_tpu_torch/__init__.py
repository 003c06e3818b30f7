"""kgdet_tpu_torch: the KGDet serving path in PyTorch, with hand-written
CUDA kernels for an NVIDIA Hopper GPU.

A port of ``kgdet_tpu`` (the JAX/Pallas reference, which stays beside it).
Each module sits at the same path as its JAX counterpart. The package imports
``torch`` and never ``jax`` or ``flax``; from ``kgdet_tpu`` it shares only the
config dataclasses, the DeepFashion2 metadata and the .pth converter.

Kernel wrappers (ops/deform_kernels.py, ops/stem_kernels.py) run their plain
PyTorch version on CPU tensors and their CUDA kernel on CUDA tensors; the
kernels are compiled from ``csrc/`` with nvcc at first use (ops/_build.py).
"""

__version__ = '0.1.0'

"""kgdet_tpu_torch: KGDet, RepPoints and the reference zoo's single-stage,
two-stage and mask detectors serving and training in PyTorch, with
hand-written CUDA kernels for an NVIDIA Hopper GPU.

A port of ``kgdet_tpu`` (the JAX/Pallas reference, which stays beside it).
Each module sits at the same path as its JAX counterpart. The package imports
``torch`` and never ``jax``, ``flax`` or anything of ``kgdet_tpu``: it keeps
its own copies of the config dataclasses, the DeepFashion2 metadata, the
host-side transforms, dataset and loader, the COCO evaluator, the RLE mask
code (native/, host C++ built with g++ at first use) and the .pth loader; images are read and resized with OpenCV where it imports and with
the package's own NumPy code where it does not (data/image_io.py).

Kernel wrappers (ops/deform_kernels.py, ops/stem_kernels.py, ops/resblock.py,
ops/nms.py) launch their CUDA kernel on CUDA tensors and run their plain
PyTorch version on CPU tensors or inside ``ops.plain_kernels()``, the one
rule of ops/__init__.py; the kernels are compiled from ``csrc/`` with nvcc
at first use (ops/_build.py).
"""

__version__ = '0.1.0'

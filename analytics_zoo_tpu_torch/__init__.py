"""PyTorch / CUDA port of ``analytics_zoo_tpu`` for an NVIDIA H100.

It mirrors the JAX package's module paths and public names, imports
``torch`` and numpy and never ``jax`` or ``analytics_zoo_tpu``.  Every
Pallas kernel of the JAX package on a ported path is a hand-written CUDA
kernel here (``ops/csrc``), built at first use.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no card and no
device given they raise.

Importing this package imports none of its submodules.
"""

__version__ = "0.1.0"

"""suitesparse_tpu_torch: the PyTorch/CUDA port of suitesparse_tpu.

A second package beside the JAX reference, written for an NVIDIA H100.
Host analysis (orderings, elimination tree, supernodes, static plans) is
the reference's NumPy code, copied; the numeric programs are PyTorch on an
explicit device, and each Pallas TPU kernel of the reference becomes a
hand-written CUDA kernel (``csrc/``) with a plain PyTorch version beside
it.  Entry points run on the card ("cuda") unless the caller asks for the
CPU, and raise when no card is present.

This package imports neither ``jax`` nor ``suitesparse_tpu``.
"""
__version__ = "0.1.0"

from .core.common import Common, default_common
from .core.sparse import SparseCSC, Triplet, eye, spzeros
from .core.status import SparseError, Status

__all__ = [
    "Common", "default_common", "SparseCSC", "Triplet", "eye", "spzeros",
    "SparseError", "Status", "__version__",
]

"""Device and dtype choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  With no
card present they raise: nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.complex128): torch.complex128}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means the card ("cuda")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_of(*objs, device=None) -> torch.device:
    """Where a call runs: the device of the first of ``objs`` that lives on
    one (a tensor, or an object with a ``device``), else ``device``
    resolved as above (None: the card)."""
    for o in objs:
        dev = getattr(o, "device", None)
        if isinstance(dev, torch.device):
            return dev
    return resolve_device(device)


def default_dtype(device: torch.device, complex_: bool = False):
    """float64 on the CPU, float32 on the card (the reference's rule:
    f64 where the platform runs it at full rate, f32 on the accelerator);
    complex128 and complex64 for complex values."""
    if complex_:
        return np.complex128 if device.type == "cpu" else np.complex64
    return np.float64 if device.type == "cpu" else np.float32


def torch_dtype(dtype) -> torch.dtype:
    """Map a numpy-style float or complex dtype (or a torch dtype) to a
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    got = _TORCH_DTYPES.get(np.dtype(dtype))
    if got is None:
        raise TypeError(f"unsupported factor dtype {dtype!r} "
                        "(float32, float64, complex64 or complex128)")
    return got


def numpy_dtype(dtype) -> np.dtype:
    """Inverse of torch_dtype."""
    if isinstance(dtype, torch.dtype):
        for k, v in _TORCH_DTYPES.items():
            if v == dtype:
                return k
        raise TypeError(f"unsupported factor dtype {dtype!r}")
    return np.dtype(dtype)

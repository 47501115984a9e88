"""The error and the speed of each float32 matmul precision on one
product: the counterpart of tools/probe_precision.py.

    python -m suitesparse_tpu_torch.tools.probe_precision

A 2048^3 float32 product under ``torch.set_float32_matmul_precision``
"highest" (full float32), "high" (TF32 on the tensor cores) and "medium"
(bfloat16 internally where torch has such a path; on CUDA it is TF32, as
"high"), and a bfloat16 product (inputs rounded to
bfloat16, float32 accumulation and output, as the reference's
``precision="bfloat16"`` with ``preferred_element_type=float32``).  Each
line gives the relative error max|C - C64| / max|C64| against the float64
product of the same inputs on the host, and the rate on CUDA events over
a chain of calls.  A rate above 105% of the H100's peak for that mode
(67 / 495 / 495 / 989 TFLOP/s) raises.  The process-wide settings are
restored on exit, so a device program can be captured after it (they
refuse to capture with TF32 on).  Runs on the card unless ``device="cpu"``
is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .microbench import check_peak, matmul_precision, per_call_s

__all__ = ["MODES", "main"]

# each mode: the matmul precision setting and the peak that bounds it
# ("medium" runs a float32 product as TF32 on CUDA)
MODES = (("highest", "highest", "float32"), ("high", "high", "tf32"),
         ("medium", "medium", "tf32"), ("bfloat16", "highest", "bfloat16"))


def _bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.bmm(a16[None], b16[None], out_dtype=torch.float32)[0]
    return a16.float() @ b16.float()   # exact products, float32 sums


def main(device=None, m: int = 2048, reps: int = 20) -> dict:
    """Probe every mode on ``device`` (the card unless "cpu" is asked
    for); returns {mode: {relerr, tflops}}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, m)).astype(np.float32)
    b = rng.standard_normal((m, m)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    ad, bd = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    print(f"device={dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else " (host times)"), flush=True)
    out = {}
    for mode, setting, peak in MODES:
        fn = (lambda: _bf16_product(ad, bd)) if mode == "bfloat16" else (
            lambda: ad @ bd)
        with matmul_precision(setting):
            c = fn().double().cpu().numpy()
            t = per_call_s(fn, dev, reps)
        err = float(np.abs(c - ref).max() / np.abs(ref).max())
        rate = check_peak(2 * m ** 3 / t, peak, f"{mode} {m}^3 product")
        out[mode] = dict(relerr=err, tflops=rate / 1e12, ms=t * 1e3)
        print(f"  precision={mode:9s} relerr={err:.3e}  "
              f"{rate / 1e12:.2f} TF/s", flush=True)
    return out


if __name__ == "__main__":
    main()

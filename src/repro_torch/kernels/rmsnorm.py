"""RMSNorm: wrapper around the hand-written CUDA kernel ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_rmsnorm_kernel``). On the H100 it is bound by bytes (x read once, y
written once); the kernel keeps it to one pass over device memory with
16-byte vector loads and one block per row, so no row padding is needed.
See the source for the design.

A CPU tensor takes the plain version :func:`repro_torch.kernels.ref.rmsnorm_ref`;
a CUDA tensor launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_ref

# kernel launches since the last reset (CUDA tensors only)
launches = 0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16, contiguous; w: (D,) float32."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: x on {x.device}; expected cuda or cpu")
    d = x.shape[-1]
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, x on {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"rmsnorm: x dtype {x.dtype}; the kernel takes "
                        f"{tuple(build.DTYPE_CODES)}")
    if w.dtype != torch.float32:
        raise TypeError(f"rmsnorm: w dtype {w.dtype}; the kernel reads w in float32")
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)}; expected ({d},)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    lib = build.library("rmsnorm")
    err = lib.rmsnorm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
        build.DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_launch")
    launches += 1
    return y

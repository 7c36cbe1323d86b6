"""RMSNorm and its fused forms: wrappers around the hand-written CUDA
kernel ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_rmsnorm_kernel``) and folds in the compositions the models put around
it: the residual add before a norm (:func:`add_rmsnorm`) and the Mamba2 gate
(:func:`gated_rmsnorm`). The gated norm of a row whose channels lie on
several ranks runs as two passes of the same kernel around a sum over the
ranks: :func:`gated_rmsnorm_ssq` (each row's sum of squares) and
:func:`gated_rmsnorm_scale` (the norm from the summed squares). On the
H100 every form is bound by bytes (each input read once, each output
written once) and, at the decode wave, by the
launch, which the fused forms save around the kernel. One CTA holds a row
in registers; its shape depends on D alone (the kernel's launch picks it),
so every form reduces in the same order for the same D. See the source for
the design.

A CPU tensor takes the plain versions in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (add_rmsnorm_ref, gated_rmsnorm_ref,
                                     gated_rmsnorm_scale_ref, gated_rmsnorm_ssq_ref,
                                     rmsnorm_ref)

# kernel launches by form since the last reset (CUDA tensors only)
launches: Dict[str, int] = {"plain": 0, "residual": 0, "gated": 0, "gated_ssq": 0,
                            "gated_scale": 0}

_FORM_CODES = {"plain": 0, "residual": 1, "gated": 2, "gated_ssq": 3, "gated_scale": 4}


def _row_stride(t: torch.Tensor, what: str) -> int:
    """The row stride of ``t`` read as (rows, D): unit stride along D and
    leading dims that collapse to one stride (a view, never a copy)."""
    d = t.shape[-1]
    if t.is_contiguous():
        return d
    if d > 1 and t.stride(-1) != 1:
        raise ValueError(f"rmsnorm: {what} has stride {t.stride(-1)} along D; expected 1")
    try:
        return t.view(-1, d).stride(0)
    except RuntimeError:
        raise ValueError(f"rmsnorm: the leading dims of {what} (shape {tuple(t.shape)}, "
                         f"strides {t.stride()}) do not collapse to one row stride") from None


def _check(x: torch.Tensor, other: Optional[torch.Tensor], w: Optional[torch.Tensor],
           name: str, other_name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}; expected cuda or cpu")
    d = x.shape[-1]
    if (w is not None and w.device != x.device) or (other is not None
                                                    and other.device != x.device):
        raise ValueError(f"{name}: tensors on different devices (x on {x.device}, w on "
                         f"{w.device if w is not None else None}"
                         + (f", {other_name} on {other.device})" if other is not None else ")"))
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: x dtype {x.dtype}; the kernel takes "
                        f"{tuple(build.DTYPE_CODES)}")
    if w is None:
        return
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: w dtype {w.dtype}; the kernel reads w in float32")
    if w.shape != (d,):
        raise ValueError(f"{name}: w shape {tuple(w.shape)}; expected ({d},)")
    if not w.is_contiguous():
        raise ValueError(f"{name}: w must be contiguous")


def _check_pair(x: torch.Tensor, other: torch.Tensor, name: str, other_name: str) -> None:
    if other.dtype != x.dtype:
        raise TypeError(f"{name}: dtypes differ (x {x.dtype}, {other_name} {other.dtype}); "
                        f"the kernel takes one dtype")
    if other.shape != x.shape:
        raise ValueError(f"{name}: {other_name} shape {tuple(other.shape)} != x shape "
                         f"{tuple(x.shape)}")


def _launch(form: str, x: torch.Tensor, other: Optional[torch.Tensor],
            w: Optional[torch.Tensor], eps: float, ssq: Optional[torch.Tensor] = None,
            dn: int = 0):
    """Launch one form on CUDA tensors already checked; returns (y, s or
    None), y being ``gated_ssq``'s float32 sums of the rows. ``ssq`` and
    ``dn``: ``gated_scale``'s sums over every rank and the width they
    cover. This runs once a norm on every pass, so it does no host work the
    launch does not need."""
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    sx = _row_stride(x, "x")
    sh = _row_stride(other, "h" if form == "residual" else "z") if other is not None else 0
    if form == "gated_ssq":
        y = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    else:
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
    s = torch.empty_like(y) if form == "residual" else ssq
    if rows == 0:
        return y, s
    err = build.library("rmsnorm").rmsnorm_launch(
        x.data_ptr(), other.data_ptr() if other is not None else None,
        w.data_ptr() if w is not None else None, y.data_ptr(),
        s.data_ptr() if s is not None else None, sx, sh, rows, d, dn or d, eps,
        _FORM_CODES[form], build.DTYPE_CODES[x.dtype],
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        build.check(err, f"rmsnorm_launch ({form}, rows {rows}, D {d}, {x.dtype}; the kernel "
                         f"takes rows of up to 16384 bf16 or 8192 fp32 elements)")
    launches[form] += 1
    return y, s


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16 with unit stride along D; w: (D,)
    float32. Returns a fresh contiguous y in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    _check(x, None, w, "rmsnorm", "")
    return _launch("plain", x, None, w, eps)[0]


def add_rmsnorm(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y): s = x + h, rounded to the dtype as ``torch.add`` rounds it,
    and y = :func:`rmsnorm` of s, both fresh and contiguous; nothing is
    written in place. x and h share shape and dtype."""
    _check_pair(x, h, "add_rmsnorm", "h")
    if x.device.type == "cpu":
        return add_rmsnorm_ref(x, h, w, eps)
    _check(x, h, w, "add_rmsnorm", "h")
    y, s = _launch("residual", x, h, w, eps)
    return s, y


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gated norm: rmsnorm(x * silu(z)), silu(z) and the product
    each rounded to x's dtype. z may be a strided view (a column slice of
    the in_proj output): it is read through its row stride, never copied.
    x and z share shape and dtype."""
    _check_pair(x, z, "gated_rmsnorm", "z")
    if x.device.type == "cpu":
        return gated_rmsnorm_ref(x, z, w, eps)
    _check(x, z, w, "gated_rmsnorm", "z")
    return _launch("gated", x, z, w, eps)[0]


def gated_rmsnorm_ssq(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pass A of the gated norm split over ranks: each row's float32 sum of
    squares of x * silu(z), silu(z) and the product rounded to x's dtype as
    :func:`gated_rmsnorm` rounds them (shape ``x.shape[:-1]``). z may be a
    strided view, as there."""
    _check_pair(x, z, "gated_rmsnorm_ssq", "z")
    if x.device.type == "cpu":
        return gated_rmsnorm_ssq_ref(x, z)
    _check(x, z, None, "gated_rmsnorm_ssq", "z")
    return _launch("gated_ssq", x, z, None, 0.0)[0]


def gated_rmsnorm_scale(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor, ssq: torch.Tensor,
                        d: int, eps: float = 1e-5) -> torch.Tensor:
    """Pass B: (x * silu(z)) * rsqrt(ssq / d + eps) * w, the product
    recomputed as pass A computes it, ``ssq`` (float32, ``x.shape[:-1]``)
    the rows' sums of squares over every rank and ``d`` the row's width
    over every rank. On one rank (``d = x.shape[-1]``, ``ssq`` pass A's
    own) it is :func:`gated_rmsnorm`, bit for bit on the card."""
    _check_pair(x, z, "gated_rmsnorm_scale", "z")
    if ssq.shape != x.shape[:-1] or ssq.dtype != torch.float32:
        raise ValueError(f"gated_rmsnorm_scale: ssq {tuple(ssq.shape)} {ssq.dtype}; expected "
                         f"{tuple(x.shape[:-1])} float32")
    if x.device.type == "cpu":
        return gated_rmsnorm_scale_ref(x, z, w, ssq, d, eps)
    _check(x, z, w, "gated_rmsnorm_scale", "z")
    if ssq.device != x.device:
        raise ValueError(f"gated_rmsnorm_scale: ssq on {ssq.device}, x on {x.device}")
    return _launch("gated_scale", x, z, w, eps, ssq.contiguous(), int(d))[0]

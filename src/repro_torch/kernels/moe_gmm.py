"""Grouped (expert) matmul: wrapper around the hand-written CUDA kernel
``csrc/moe_gmm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py`` (``moe_gmm`` /
``_gmm_kernel``): rows of ``lhs`` sorted by expert in whole row tiles of
``block_t`` rows, row tile i multiplied by ``rhs[tile_expert[i]]``. On the
H100 the serving path's calls are bound by bytes (the expert weights are
read once a call); each CTA reads its own tile's expert id. See the source
for the design.

A CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.moe_gmm_tiles_ref`; a CUDA tensor launches
the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_gmm_tiles_ref

# kernel launches since the last reset (CUDA tensors only)
launches = 0


def moe_gmm(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert, *,
            block_t: int) -> torch.Tensor:
    """lhs: (T, D) expert-sorted rows, T % block_t == 0; rhs: (E, D, F) in
    lhs's dtype (float32 or bfloat16), both contiguous; tile_expert:
    (T // block_t,) integer expert id per row tile (ids outside [0, E-1]
    are clamped). Returns (T, F) in lhs's dtype, accumulated in fp32."""
    global launches
    if lhs.device.type == "cpu":
        return moe_gmm_tiles_ref(lhs, rhs, torch.as_tensor(tile_expert), block_t)
    if lhs.device.type != "cuda":
        raise ValueError(f"moe_gmm: lhs on {lhs.device}; expected cuda or cpu")
    if lhs.ndim != 2 or rhs.ndim != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"moe_gmm: lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} "
                         f"must be (T, D) and (E, D, F)")
    t, d = lhs.shape
    e, _, f = rhs.shape
    if block_t < 1 or t % block_t:
        raise ValueError(f"moe_gmm: T={t} is not a multiple of block_t={block_t}")
    if e < 1:
        raise ValueError("moe_gmm: rhs has no expert")
    if rhs.device != lhs.device:
        raise ValueError(f"moe_gmm: rhs on {rhs.device}, lhs on {lhs.device}")
    if lhs.dtype not in build.DTYPE_CODES or rhs.dtype != lhs.dtype:
        raise TypeError(f"moe_gmm: dtypes {lhs.dtype}/{rhs.dtype}; the kernel takes "
                        f"one of {tuple(build.DTYPE_CODES)} for both")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("moe_gmm: lhs and rhs must be contiguous")
    te = torch.as_tensor(tile_expert, device=lhs.device)
    if te.dtype.is_floating_point or te.dtype == torch.bool or te.is_complex():
        raise TypeError(f"moe_gmm: tile_expert dtype {te.dtype}; expected integers")
    te = te.to(torch.int32).contiguous()
    if te.shape != (t // block_t,):
        raise ValueError(f"moe_gmm: tile_expert {tuple(te.shape)}, expected "
                         f"({t // block_t},)")
    out = torch.empty((t, f), dtype=lhs.dtype, device=lhs.device)
    lib = build.library("moe_gmm")
    err = lib.moe_gmm_launch(
        lhs.data_ptr(), rhs.data_ptr(), te.data_ptr(), out.data_ptr(), t, d, f, e,
        block_t, build.DTYPE_CODES[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    build.check(err, "moe_gmm_launch")
    launches += 1
    return out

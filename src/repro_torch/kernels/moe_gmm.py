"""Grouped (expert) matmul: wrapper around the hand-written CUDA kernel
``csrc/moe_gmm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py`` (``moe_gmm`` /
``_gmm_kernel``): rows of ``lhs`` sorted by expert in whole row tiles of
``block_t`` rows, row tile i multiplied by ``rhs[tile_expert[i]]``. On the
H100 the serving path's calls are bound by bytes (the expert weights are
read once a call); each CTA reads its own tile's expert id. At bf16 the
products run on the tensor cores in one of two row tiles
(:func:`row_tile`; ``ref.moe_gmm_schedule_ref`` is the same partition in
plain PyTorch); at float32 on the CUDA cores. See the source for the
design.

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


def row_tile(t: int, e: int) -> int:
    """Rows of the bf16 kernel's tile, from the shapes alone: 192 (wide)
    where the experts average at least 32 rows (a prefill), else 8
    (narrow: a decode wave, each expert's rows streaming its weights
    once)."""
    return 192 if t >= 32 * e else 8


def moe_gmm(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert, *,
            block_t: int) -> torch.Tensor:
    """lhs: (T, D) expert-sorted rows, T % block_t == 0; rhs: (E, D, F) in
    lhs's dtype (float32 or bfloat16), both contiguous; tile_expert:
    (T // block_t,) integer expert id per row tile (ids outside [0, E-1]
    are clamped). Returns (T, F) in lhs's dtype, accumulated in fp32."""
    if lhs.device.type == "cpu":
        return moe_gmm_tiles_ref(lhs, rhs, torch.as_tensor(tile_expert), block_t)
    if lhs.device.type != "cuda":
        raise ValueError(f"moe_gmm: lhs on {lhs.device}; expected cuda or cpu")
    if lhs.ndim != 2 or rhs.ndim != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"moe_gmm: lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} "
                         f"must be (T, D) and (E, D, F)")
    t = lhs.shape[0]
    e = rhs.shape[0]
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
    return _launch(lhs, rhs, te, block_t, row_tile(t, e))


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, te: torch.Tensor, block_t: int,
            tile_rows: int) -> torch.Tensor:
    """The kernel on checked CUDA inputs (``te`` contiguous int32 on the
    card), bf16 in row tiles of ``tile_rows`` (8 or 192; float32 takes its
    own tile). The card-only tests call it to drive each row tile."""
    global launches
    t, d = lhs.shape
    e, _, f = rhs.shape
    out = torch.empty((t, f), dtype=lhs.dtype, device=lhs.device)
    lib = build.library("moe_gmm")
    err = lib.moe_gmm_launch(
        lhs.data_ptr(), rhs.data_ptr(), te.data_ptr(), out.data_ptr(), t, d, f, e, block_t,
        tile_rows, build.DTYPE_CODES[lhs.dtype],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    build.check(err, "moe_gmm_launch")
    launches += 1
    return out

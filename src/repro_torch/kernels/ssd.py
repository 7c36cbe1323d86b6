"""Mamba2 SSD chunked scan: wrapper around the hand-written CUDA kernels
``csrc/ssd.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py`` (``ssd`` /
``_ssd_kernel``): the SSD scan from the zero state, chunk by chunk with the
(P, N) state carried between chunks. On the H100 a prefill's call is bound
by bytes, by a little. In bf16 one call runs three kernels on the tensor
cores: each chunk's own contribution to the state, the states entering the
chunks (sequential over chunks, elementwise over P x N), and y in 64-row
tiles of every chunk (``ref.ssd_passes_ref`` is the same decomposition in
plain PyTorch); in float32 it keeps one CTA per (batch, head) walking the
chunks with fp32 FMAs. See the source for the design.

A CPU tensor takes the plain version :func:`repro_torch.kernels.ref.ssd_chunk_ref`;
a CUDA tensor launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import check_ssd_shapes, ssd_chunk_ref

# largest head and state widths the kernels are instantiated for (csrc/ssd.cu)
MAX_HEADDIM = 64
MAX_STATE = 128

# kernel launches since the last reset (CUDA tensors only)
launches = 0


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
        c_mat: torch.Tensor, chunk: int):
    """SSD scan. x: (B,S,H,P) float32 or bfloat16; dt: (B,S,H) float32 (>= 0,
    already softplus'ed); a: (H,) float32 (negative); b_mat/c_mat: (B,S,G,N)
    in x's dtype, head h reading group h // (H/G). S % chunk == 0 and
    H % G == 0, else ``ValueError``. Returns (y (B,S,H,P) fp32, final_state
    (B,H,P,N) fp32).

    x, dt, b_mat and c_mat may be strided views (the slices of the
    in-projection): x, b_mat and c_mat need a unit stride in their last dim."""
    global launches
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, a, b_mat, c_mat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: x on {x.device}; expected cuda or cpu")
    check_ssd_shapes(x, dt, a, b_mat, c_mat, chunk)
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if any(t.device != x.device for t in (dt, a, b_mat, c_mat)):
        raise ValueError("ssd: x, dt, a, b_mat, c_mat on different devices")
    if x.dtype not in build.DTYPE_CODES or not (b_mat.dtype == c_mat.dtype == x.dtype):
        raise TypeError(f"ssd: dtypes x {x.dtype}, b_mat {b_mat.dtype}, c_mat {c_mat.dtype}; "
                        f"the kernel takes one of {tuple(build.DTYPE_CODES)} for all three")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd: dt {dt.dtype} and a {a.dtype}; the kernel reads both in float32")
    if p > MAX_HEADDIM or n > MAX_STATE:
        raise ValueError(f"ssd: head_dim {p} and state {n}; the kernel is built for "
                         f"head_dim <= {MAX_HEADDIM} and state <= {MAX_STATE}")
    if any(t.stride(-1) != 1 for t in (x, b_mat, c_mat)):
        raise ValueError("ssd: the last dim of x, b_mat and c_mat must have stride 1")
    lib = build.library("ssd")
    code = build.DTYPE_CODES[x.dtype]
    smem, limit = lib.ssd_smem_bytes(p, n, chunk, code), lib.ssd_smem_limit()
    if smem > limit:
        raise ValueError(f"ssd: chunk {chunk} at head_dim {p}, state {n} needs {smem} bytes "
                         f"of shared memory; a block may use {limit}")
    a = a.contiguous()
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    scratch = None   # bf16: per chunk, its entering state (bf16 hi, lo), its own
    if x.dtype == torch.bfloat16:   # contribution (fp32) and its total of dt * a
        scratch = torch.empty((bsz * h * (s // chunk) * (2 * p * n + 1),), dtype=torch.float32,
                              device=x.device)
    strides = [st for t in (x, dt, b_mat, c_mat) for st in t.stride()[:3]]
    err = lib.ssd_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        y.data_ptr(), fin.data_ptr(), None if scratch is None else scratch.data_ptr(),
        bsz, s, h, p, g, n, chunk, *strides, code,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_launch")
    launches += 1
    return y, fin

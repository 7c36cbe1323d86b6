"""Paged decode attention: wrapper around the hand-written CUDA kernel
``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention`` / ``_paged_kernel``): one query token per sequence
attends over K/V that live in fixed-size blocks of a shared pool, reachable
only through the sequence's block table, with an online softmax over the
blocks. On the H100 it is bound by bytes (each valid K/V position read
once). Each row's table is cut into splits of :func:`blocks_per_split`
blocks, one CTA per (kv head, row, split), and a second pass merges the
splits' fp32 partials in a fixed order (``ref.paged_attention_split_ref``
is the same partition in plain PyTorch). See the source for the design.

A CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.paged_attention_ref`; a CUDA tensor launches
the kernel or raises. There is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

# head dims the kernel is instantiated for (csrc/paged_attention.cu): every
# head_dim an attention config in repro's configs uses
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 160)
MAX_GROUP = 32  # query heads per kv head
SMS = 132       # the H100's streaming multiprocessors
SPLIT_POSITIONS = 32  # positions a split covers, about
MAX_SPLITS = 256

# kernel launches since the last reset (CUDA tensors only)
launches = 0


def _index(x, name: str, device: torch.device) -> torch.Tensor:
    """An integer table or length vector (numpy or torch, any integer
    dtype) as contiguous int32 on ``device``: no host sync for a tensor
    already on the card."""
    t = torch.as_tensor(x, device=device)
    if t.dtype.is_floating_point or t.dtype == torch.bool or t.is_complex():
        raise TypeError(f"paged_attention: {name} dtype {t.dtype}; expected integers")
    return t.to(torch.int32).contiguous()


def blocks_per_split(b: int, kv: int, bs: int, maxb: int) -> int:
    """Table blocks a split covers, from what the host knows (never the
    lengths): about SPLIT_POSITIONS positions, halved while the grid of
    (kv, b, splits) CTAs would leave SMs empty, grown where a row would
    need more than MAX_SPLITS splits. The main decode wave (b 8, kv 2, bs 16,
    maxb 40) gets 2 blocks: 20 splits, 320 CTAs on 132 SMs."""
    bps = max(1, -(-SPLIT_POSITIONS // bs))
    while bps > 1 and b * kv * -(-maxb // bps) < SMS:
        bps //= 2
    return max(bps, -(-maxb // MAX_SPLITS))


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables, context_lens, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,D); k_pool/v_pool: (NB,BS,KV,D), H % KV == 0; block_tables:
    (B,MAXB) integer; context_lens: (B,) integer, valid positions per row
    including the query token (a row with 0 gives zeros). Returns (B,H,D)
    in q's dtype. q and the pools may have any strides with a unit
    last-dim stride."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, torch.as_tensor(block_tables),
                                   torch.as_tensor(context_lens), scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: q on {q.device}; expected cuda or cpu")
    if q.ndim != 3 or k_pool.ndim != 4 or v_pool.ndim != 4:
        raise ValueError("paged_attention: q must be (B,H,D) and the pools (NB,BS,KV,D)")
    b, h, d = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape[3] != d or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if kv == 0 or h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"paged_attention: H={h}, KV={kv}: H must be a multiple of "
                         f"KV with at most {MAX_GROUP} query heads per kv head")
    if not (k_pool.device == v_pool.device == q.device):
        raise ValueError("paged_attention: q and the pools on different devices")
    if q.dtype not in build.DTYPE_CODES or not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise TypeError(f"paged_attention: dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}; "
                        f"the kernel takes one of {tuple(build.DTYPE_CODES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: the last dim of q and the pools must have "
                         "stride 1")
    tables = _index(block_tables, "block_tables", q.device)
    lens = _index(context_lens, "context_lens", q.device)
    if tables.ndim != 2 or tables.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"paged_attention: block_tables {tuple(tables.shape)} and "
                         f"context_lens {tuple(lens.shape)} must be ({b}, MAXB) and ({b},)")
    scale = scale if scale is not None else d ** -0.5
    return _launch(q, k_pool, v_pool, tables, lens, scale,
                   blocks_per_split(b, kv, bs, tables.shape[1]))


def _launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
            tables: torch.Tensor, lens: torch.Tensor, scale: float,
            bps: int) -> torch.Tensor:
    """The kernel on checked CUDA inputs (``tables``/``lens`` contiguous
    int32 on the card) in splits of ``bps`` table blocks. The card-only
    tests call it to drive split sizes the rule would not pick."""
    global launches
    b, h, d = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    maxb = tables.shape[1]
    n_splits = max(1, -(-maxb // bps))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part = None
    if n_splits > 1:   # fp32 (acc, then (m, l)) of every split, merged by the second pass
        part = torch.empty((b * h * n_splits * (d + 2),), dtype=torch.float32,
                           device=q.device)
    lib = build.library("paged_attention")
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        b, h, kv, d, bs, maxb, bps, n_splits,
        q.stride(0), q.stride(1), *k_pool.stride()[:3], *v_pool.stride()[:3],
        tables.stride(0), out.stride(0), out.stride(1), float(scale),
        build.DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention_launch")
    launches += 1
    return out

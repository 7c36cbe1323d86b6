"""Flash attention: wrapper around the hand-written CUDA kernel
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``): online-softmax GQA attention,
causal and sliding-window masks by absolute index. On the H100 the FLOP and
byte bounds are close at the main path's 512-token prefill and longer
prompts are bound by operations. In bf16 the kernel runs both products on
the tensor cores (``mma.sync``, fp32 accumulators) over 64-row q tiles and
64-key K/V tiles; in float32 it keeps fp32 FMAs. Either walks only the k
tiles that the causal and window masks leave. See the source for the design.

A CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`; a CUDA tensor launches
the kernel or raises. There is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

# head dims the kernel is instantiated for (csrc/flash_attention.cu): every
# head_dim an attention config in repro's configs uses
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 160)

# kernel launches since the last reset (CUDA tensors only)
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KV,Sk,D), H % KV == 0. Returns (B,H,Sq,D).

    Any strides with a unit last-dim stride are taken as they are (a
    transposed (B,S,H,D) view needs no copy). On the card the result is a
    (B,H,Sq,D) view of (B,Sq,H,D) memory, so ``out.transpose(1, 2)`` is
    contiguous.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q on {q.device}; expected cuda or cpu")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B,H,S,D)")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, kv, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: H={h} is not a multiple of KV={kv}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in build.DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        f"the kernel takes one of {tuple(build.DTYPE_CODES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d}; the kernel is built "
                         f"for {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dim of q, k, v must have "
                         "stride 1")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = build.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kv, sq, sk, d, *strides, int(causal),
        0 if window is None else int(window), float(scale),
        build.DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_launch")
    launches += 1
    return out

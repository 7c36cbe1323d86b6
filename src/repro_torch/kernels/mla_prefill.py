"""Causal MLA prefill attention: wrapper around the hand-written CUDA
kernel ``csrc/mla_prefill.cu``.

Replaces no TPU kernel: ``repro`` leaves MLA's attention products to XLA
(``supported_kernel_sites`` has no MLA site). It computes the attention
core of ``models/attention.py``'s decompressed MLA prefill without writing
the (B, H, S, S) scores to device memory: QK depth 192 (128 nope + 64
rope, the rope key shared by every head) and V width 128, causal by index.
On the H100 the call is bound by operations (85.9 GFLOP at one 4096-token
prompt of 16 heads, 0.087 ms at 989 TFLOP/s), so both products run on
``wgmma``. See the source for the design.

A CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.mla_prefill_attention_ref`; a CUDA tensor
launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mla_prefill_attention_ref

# the widths the kernel is built for: DeepSeek-V2's qk_nope_head_dim,
# qk_rope_head_dim and v_head_dim
NOPE_DIM, ROPE_DIM, V_DIM = 128, 64, 128

# kernel launches since the last reset (CUDA tensors only)
launches = 0


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where TMA can read it (base address and every stride of a
    dim longer than 1 a positive multiple of 16 bytes), else a contiguous
    copy."""
    if t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0 for n, st in
                                      zip(t.shape[:-1], t.stride()[:-1]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def mla_prefill_attention(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor,
                          k_rope: torch.Tensor, v: torch.Tensor, *,
                          scale: float) -> torch.Tensor:
    """q_nope, k_nope: (B,S,H,128); q_rope: (B,S,H,64) rope'd; k_rope:
    (B,S,64) rope'd, shared by every head; v: (B,S,H,128). Returns
    ``softmax(scale * (q_nope k_nope^T + q_rope k_rope^T), causal) v`` as
    (B,S,H,128), contiguous, so ``reshape(B, S, H * 128)`` is a view.

    On the card every input is bfloat16 with a unit last-dim stride and is
    read through its strides; one whose base address or strides are not
    multiples of 16 bytes is copied first (the kernel's TMA loads need
    them)."""
    global launches
    if q_nope.device.type == "cpu":
        return mla_prefill_attention_ref(q_nope, q_rope, k_nope, k_rope, v, scale)
    if q_nope.device.type != "cuda":
        raise ValueError(f"mla_prefill_attention: q_nope on {q_nope.device}; expected cuda "
                         f"or cpu")
    ins = (q_nope, q_rope, k_nope, k_rope, v)
    if q_nope.ndim != 4:
        raise ValueError("mla_prefill_attention: q_nope must be 4-D (B,S,H,D)")
    b, s, h, _ = q_nope.shape
    want = ((b, s, h, NOPE_DIM), (b, s, h, ROPE_DIM), (b, s, h, NOPE_DIM), (b, s, ROPE_DIM),
            (b, s, h, V_DIM))
    if tuple(tuple(t.shape) for t in ins) != want:
        raise ValueError(f"mla_prefill_attention: shapes {[tuple(t.shape) for t in ins]}; the "
                         f"kernel takes {list(want)}")
    if any(t.device != q_nope.device for t in ins):
        raise ValueError("mla_prefill_attention: inputs on different devices")
    if any(t.dtype != torch.bfloat16 for t in ins):
        raise TypeError(f"mla_prefill_attention: dtypes {[t.dtype for t in ins]}; the kernel "
                        f"takes bfloat16")
    if any(t.stride(-1) != 1 for t in ins):
        raise ValueError("mla_prefill_attention: the last dim of every input must have "
                         "stride 1")
    q_nope, q_rope, k_nope, k_rope, v = ins = tuple(_tma_ready(t) for t in ins)
    out = torch.empty((b, s, h, V_DIM), dtype=torch.bfloat16, device=q_nope.device)
    strides = [x for t in (q_nope, q_rope, k_nope) for x in t.stride()[:3]]
    strides += list(k_rope.stride()[:2]) + list(v.stride()[:3]) + list(out.stride()[:3])
    lib = build.library("mla_prefill")
    err = lib.mla_prefill_launch(
        *(t.data_ptr() for t in ins), out.data_ptr(), b, s, h, *strides, float(scale),
        torch.cuda.current_stream(q_nope.device).cuda_stream)
    build.check(err, "mla_prefill_launch")
    launches += 1
    return out

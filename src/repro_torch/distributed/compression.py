"""Int8 error-feedback gradient compression for the DP all-reduce — the port
of ``repro.distributed.compression``.

The wire format is an all-gather of per-shard int8 tensors plus fp32 scales:
collective bytes drop ~2x vs a bf16 ring all-reduce and ~4x vs fp32. The
quantization residual is carried in an error-feedback buffer so the *average*
gradient remains unbiased over steps (standard EF-SGD argument).

``ef_allreduce`` runs over a ``torch.distributed`` process group the caller
passes (``repro`` calls its twin inside ``shard_map`` over the DP axes);
``quantize`` / ``dequantize`` are the pure building blocks used by tests and
the serving hand-off (compressed KV migration). All arithmetic is float32,
and ``torch.round`` rounds half to even as ``jnp.round`` does, so the int8
codes and scales are ``repro``'s bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32 scalar).
    ``amax``: the largest magnitude of the tensor ``x`` is a piece of (its
    scale then is the whole tensor's, so a tensor quantised piece by piece
    gets the codes of one call on the whole); None takes ``x``'s own."""
    if amax is None:
        amax = torch.max(torch.abs(x.to(torch.float32)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(x: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantization: returns (q, scale, new_err)."""
    target = x.to(torch.float32) + err
    q, scale = quantize(target)
    new_err = target - dequantize(q, scale)
    return q, scale, new_err


def ef_allreduce(x: torch.Tensor, err: torch.Tensor, group=None):
    """All-reduce-mean of x over the ranks of ``group`` (``None``: the
    default group) with int8 wire format. Every rank calls it with its own
    shard. Returns (mean f32, new_err)."""
    import torch.distributed as dist

    q, scale, new_err = ef_compress(x, err)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    scales = [torch.empty(1, dtype=scale.dtype, device=scale.device) for _ in range(n)]
    dist.all_gather(qs, q, group=group)                    # int8 on the wire
    dist.all_gather(scales, scale.reshape(1), group=group)  # tiny f32 sideband
    summed = torch.tensordot(torch.cat(scales), torch.stack(qs).to(torch.float32),
                             dims=([0], [0]))
    return summed / n, new_err

"""The kernel ops the models dispatch to under ``kernel_impls``, the host
helpers of the MoE grouped matmul, and the launch counters a run reads to
show that its path went through the kernels.

No op has a backward, as ``repro``'s Pallas kernels define no VJP: each
refuses, before it launches anything, a call that autograd would have to
differentiate (:func:`_refuse_grad`). Training runs under
``kernel_impls="reference"``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mla_prefill as _mla
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd as _ssd


def _refuse_grad(op: str, *tensors) -> None:
    """Raise when autograd would record ``op``: grad mode is on and an
    input requires grad. The kernels write into fresh tensors through
    ``ctypes``, so the result would carry no ``grad_fn`` and a backward
    would silently skip every parameter upstream of the op. The plain
    versions on the CPU are refused too, so both devices do what ``repro``
    does."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{op}: an input requires grad, and the kernel ops have no backward "
            f"(repro's kernels define no VJP). Differentiate under "
            f"kernel_impls=\"reference\", or call under torch.no_grad().")


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    _refuse_grad("rmsnorm_op", x, w)
    return _rmsnorm.rmsnorm(x, w, eps=eps)


def add_rmsnorm_op(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    _refuse_grad("add_rmsnorm_op", x, h, w)
    return _rmsnorm.add_rmsnorm(x, h, w, eps=eps)


def gated_rmsnorm_op(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    _refuse_grad("gated_rmsnorm_op", x, z, w)
    return _rmsnorm.gated_rmsnorm(x, z, w, eps=eps)


def gated_rmsnorm_ssq_op(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    _refuse_grad("gated_rmsnorm_ssq_op", x, z)
    return _rmsnorm.gated_rmsnorm_ssq(x, z)


def gated_rmsnorm_scale_op(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                           ssq: torch.Tensor, d: int, eps: float = 1e-5) -> torch.Tensor:
    _refuse_grad("gated_rmsnorm_scale_op", x, z, w)
    return _rmsnorm.gated_rmsnorm_scale(x, z, w, ssq, d, eps=eps)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    _refuse_grad("flash_attention_op", q, k, v)
    return _flash.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def mla_prefill_attention_op(q_nope: torch.Tensor, q_rope: torch.Tensor,
                             k_nope: torch.Tensor, k_rope: torch.Tensor, v: torch.Tensor, *,
                             scale: float) -> torch.Tensor:
    _refuse_grad("mla_prefill_attention_op", q_nope, q_rope, k_nope, k_rope, v)
    return _mla.mla_prefill_attention(q_nope, q_rope, k_nope, k_rope, v, scale=scale)


def paged_attention_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                       block_tables, context_lens, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    _refuse_grad("paged_attention_op", q, k_pool, v_pool)
    return _paged.paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                                  scale=scale)


def moe_gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert, *,
               block_t: int = 128) -> torch.Tensor:
    _refuse_grad("moe_gmm_op", lhs, rhs)
    return _gmm.moe_gmm(lhs, rhs, tile_expert, block_t=block_t)


def ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
           c_mat: torch.Tensor, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    _refuse_grad("ssd_op", x, dt, a, b_mat, c_mat)
    return _ssd.ssd(x, dt, a, b_mat, c_mat, chunk=chunk)


def pad_group_sizes(group_sizes: torch.Tensor,
                    block_t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round each group size up to a multiple of block_t; returns
    (padded_sizes, padded_offsets (E+1,)), both int32. Padding rows must be
    zero-filled by the caller so they contribute nothing downstream."""
    padded = (group_sizes + block_t - 1) // block_t * block_t
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=padded.device),
                      torch.cumsum(padded, 0, dtype=torch.int32)])
    return padded.to(torch.int32), offs


def tile_experts_for_capacity(n_experts: int, capacity: int, block_t: int,
                              device=None) -> torch.Tensor:
    """Tile->expert map (int32) for the capacity-padded (E*C, D) dispatch
    buffer."""
    if capacity % block_t:
        raise ValueError(f"capacity {capacity} is not a multiple of block_t {block_t}")
    return torch.arange(n_experts, dtype=torch.int32, device=device).repeat_interleave(
        capacity // block_t)


def moe_gmm_capacity(buf: torch.Tensor, rhs: torch.Tensor, *,
                     block_t: int = 128) -> torch.Tensor:
    """Expert matmul over the (E, C, D) capacity dispatch buffer -> (E, C, F)."""
    _refuse_grad("moe_gmm_capacity", buf, rhs)
    e, c, d = buf.shape
    block_t = min(block_t, c)
    if c % block_t:
        raise ValueError(f"capacity {c} is not a multiple of block_t {block_t}")
    te = tile_experts_for_capacity(e, c, block_t, device=buf.device)
    out = _gmm.moe_gmm(buf.reshape(e * c, d), rhs, te, block_t=block_t)
    return out.reshape(e, c, rhs.shape[2])


_COUNTERS = {"flash_attention": _flash, "paged_attention": _paged, "ssd": _ssd,
             "mla_prefill": _mla}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`
    (``rmsnorm`` counts all five of its forms, ``moe_gmm`` all three)."""
    return {"rmsnorm": sum(_rmsnorm.launches.values()),
            "moe_gmm": sum(_gmm.launches.values()),
            **{k: m.launches for k, m in _COUNTERS.items()}}


def rmsnorm_form_counts() -> Dict[str, int]:
    """The rmsnorm kernel's launches by form (plain, residual, gated, and
    the gated norm's two passes across ranks, gated_ssq and gated_scale)
    since the last :func:`reset_launch_counts`; they sum to its count
    there."""
    return dict(_rmsnorm.launches)


def moe_gmm_form_counts() -> Dict[str, int]:
    """The moe_gmm kernel's launches by form (the bf16 row tiles ``wide``
    and ``narrow``, and ``float32``) since the last
    :func:`reset_launch_counts`; they sum to its count there."""
    return dict(_gmm.launches)


def launch_state() -> Dict[str, int]:
    """Every launch counter, the rmsnorm and moe_gmm kernels' also by form
    (``rmsnorm.<form>``, ``moe_gmm.<form>``): what :func:`add_launches`
    takes the difference of two readings as."""
    return {**{f"rmsnorm.{k}": v for k, v in _rmsnorm.launches.items()},
            **{f"moe_gmm.{k}": v for k, v in _gmm.launches.items()},
            **{k: m.launches for k, m in _COUNTERS.items()}}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (keys of :func:`launch_state`) to the counters: a
    replayed CUDA graph launches what its capture counted, and runs none of
    the Python that counts."""
    for k, n in delta.items():
        if k.startswith("rmsnorm."):
            _rmsnorm.launches[k[len("rmsnorm."):]] += n
        elif k.startswith("moe_gmm."):
            _gmm.launches[k[len("moe_gmm."):]] += n
        else:
            _COUNTERS[k].launches += n


def reset_launch_counts() -> None:
    add_launches({k: -n for k, n in launch_state().items()})

"""Mixture-of-Experts FFN — the port of ``repro.models.moe``.

Three reference dispatch paths, as in ``repro``:

- ``dense``   : every expert computes every token, masked combine (the oracle).
- ``scatter`` : capacity-bounded scatter/gather dispatch (Switch-style), with
                ``repro``'s capacity, slot and drop bookkeeping.
- ``ragged``  : sort by expert, one product per expert over its rows (torch
                has no ``ragged_dot``), exact active FLOPs.

and their two twins on the ``moe_gmm`` kernel, picked by
``kernel_impls['moe']``: the capacity twin of ``scatter`` and the dropless
twin of ``ragged``/``dense``. The kernel twins take no host sync: every
index they build stays on the device.

Under a tensor-parallel group ``tp`` (``distributed.tensor_parallel``) every
rank routes all of its (replicated) tokens on the whole router, so the
picks, the capacity (from the GLOBAL expert count), the slots and the drops
are one device's. Then each rank runs its own share: under expert
parallelism its run of whole experts (``expert_span``; the impls take the
first one, ``e0``, and read the local count from the weights): the dense
oracle's experts, the capacity buffer's slab, the sorted rows of its
groups; under in-expert parallelism its ``moe_d_ff`` columns of every
expert. The shared experts are column- and row-parallel. Each rank adds
its routed and shared partials, and one float32 sum over the group per
MoE block gives the output, as after a row-parallel product.

Under a grid (``distributed.data_parallel``) a rank routes only its rows
of the global batch: the load-balance statistics and the capacity
dispatch count the whole batch's tokens through the grid's ``(pod,
data)`` group (:func:`route`, :func:`_capacity_place`), so the same picks
drop as on one device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, kernel_impl
from repro_torch.distributed.tensor_parallel import (all_gather, all_sum, copy_in, expert_span,
                                                      partial_f32, tp_size)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot by comparison: no bounds check, so no host sync on the card."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig, dp=None):
    """Returns (weights (T,k), expert_idx (T,k), aux) for flattened tokens.

    Top-k by a stable descending sort, so equal probabilities pick the lower
    expert first, as ``jax.lax.top_k`` does. ``dp``: a grid's ``(pod,
    data)`` group (``Grid.batch``), whose ranks hold the other tokens of
    the global batch: the load-balance statistics ``f_e`` and ``p_e`` are
    means over all of them, the ranks' sums summed by ``all_sum`` (whose
    backward is the identity: each rank back-propagates its own tokens'
    share, and the gradients' reduce-scatter adds the shares once)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :cfg.top_k], idx[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = cfg.n_experts
    assign = _one_hot(idx[:, 0], e, torch.float32)   # top-1 assignment fraction
    if tp_size(dp) == 1:
        f_e, p_e = assign.mean(dim=0), probs.mean(dim=0)
    else:
        f_e, p_e = all_sum(torch.stack([assign.sum(dim=0), probs.sum(dim=0)]),
                           dp).div(x.shape[0] * dp.size).unbind(0)
    aux = {"lb_loss": e * (f_e * p_e).sum(), "router_probs_mean": p_e}
    return weights, idx, aux


def _expert_ffn(w_gate, w_up, w_down, x: torch.Tensor) -> torch.Tensor:
    """x: (..., C, D) with expert-major weights (..., D, F)/(..., F, D)."""
    dt = x.dtype
    g = F.silu(torch.einsum("...cd,...df->...cf", x, w_gate.to(dt)))
    u = torch.einsum("...cd,...df->...cf", x, w_up.to(dt))
    return torch.einsum("...cf,...fd->...cd", g * u, w_down.to(dt))


def _shared_ffn(p, x: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """The shared experts' SwiGLU; with ``f32`` its down product left at
    float32 (:func:`partial_f32`, a rank's partial)."""
    dt = x.dtype
    g = F.silu(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    if f32:
        return partial_f32(g * u, p["w_down"].to(dt))
    return (g * u) @ p["w_down"].to(dt)


def _local_experts(p) -> int:
    """Experts whose weights this rank holds (all of them on one device)."""
    return p["w_gate"].shape[0]


# --- reference impls -----------------------------------------------------------
def _moe_dense(p, x, weights, idx, cfg: ModelConfig, e0: int = 0):
    t, d = x.shape
    e = _local_experts(p)
    # (E, T, D): every expert computes every token — oracle only.
    h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], x.expand(e, t, d))
    combine = torch.zeros((t, e), dtype=x.dtype, device=x.device)
    for k in range(cfg.top_k):
        combine = combine + _one_hot(idx[:, k] - e0, e, x.dtype) * weights[:, k:k + 1].to(x.dtype)
    return torch.einsum("te,etd->td", combine, h)


def _capacity(t: int, cfg: ModelConfig) -> int:
    cap = int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor + 0.999)
    return max(8, min(t, (cap + 7) // 8 * 8))


def _capacity_place(idx, cfg: ModelConfig, dp=None):
    """(cap, offset): the capacity from the token count, and where this
    rank's picks start within each expert (None: at 0). Under a grid's
    ``(pod, data)`` group ``dp`` the count is the global batch's, and a
    rank's picks follow those of the lower ranks of ``dp``, whose rows come
    first in ``repro``'s one batch-major order: the offset is their
    per-expert counts (an all-gather of an ``E``-long vector), so the same
    picks drop as on one device."""
    t = idx.shape[0]
    if tp_size(dp) == 1:
        return _capacity(t, cfg), None
    counts = _one_hot(idx.reshape(-1), cfg.n_experts, torch.int32).sum(dim=0, dtype=torch.int32)
    lower = all_gather(counts, dp)[:dp.rank]
    offset = torch.stack(lower).sum(dim=0, dtype=torch.int32) if lower else torch.zeros_like(counts)
    return _capacity(t * dp.size, cfg), offset


def _capacity_dispatch(x, idx, cfg: ModelConfig, cap: int, offset=None):
    """``repro``'s capacity bookkeeping: each (token, pick) takes the next
    row of its expert in (T*k) order, after ``offset[e]`` rows (the picks
    of a grid's lower ranks, :func:`_capacity_place`); picks past ``cap``
    go to the dump row ``e*cap``. Returns (buf (E, cap, D), slot (T*k,),
    keep (T*k,))."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    flat_e = idx.reshape(-1)                          # (T*k,) assignment -> expert
    onehot = _one_hot(flat_e, e, torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot        # position within expert
    pos = (pos * onehot).sum(dim=-1)                  # (T*k,)
    if offset is not None:
        pos = pos + offset[flat_e]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(flat_e, e * cap))
    x_rep = x.repeat_interleave(k, dim=0)             # (T*k, D)
    # only the dump row takes more than one addend
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device).index_add_(
        0, slot, x_rep)
    return buf[:-1].reshape(e, cap, d), slot, keep


def _capacity_combine(h, slot, keep, weights, t: int, cap: int, cfg: ModelConfig,
                      e0: int = 0):
    """Each kept pick's row of ``h``, the expert outputs of experts ``e0``
    on (``h.shape[0]`` of them, every expert on one device), weighted and
    summed over the picks; a pick of another expert adds nothing. ``slot``
    indexes the GLOBAL (E * cap) buffer."""
    e, d = h.shape[0], h.shape[-1]
    local = slot - e0 * cap
    mine = keep & (local >= 0) & (local < e * cap)
    y_rep = h.reshape(e * cap, d)[local.clamp(0, e * cap - 1)]
    y_rep = torch.where(mine[:, None], y_rep, torch.zeros((), dtype=h.dtype, device=h.device))
    y_rep = y_rep * weights.reshape(-1, 1).to(h.dtype)
    return y_rep.reshape(t, cfg.top_k, d).sum(dim=1)


def _shard(cfg: ModelConfig, x: torch.Tensor, *axes) -> torch.Tensor:
    if not cfg.shard_activations:
        return x
    from repro_torch.distributed.sharding import maybe_shard
    return maybe_shard(x, *axes)


def _expert_parallel(cfg: ModelConfig) -> bool:
    """True when experts shard over the ambient mesh's "model" axis."""
    from repro_torch.distributed.sharding import ambient_mesh_sizes
    sizes = ambient_mesh_sizes()
    if sizes is None:
        return False
    m = sizes.get("model", 1)
    return m > 1 and cfg.n_experts % m == 0


def _moe_scatter(p, x, weights, idx, cfg: ModelConfig, e0: int = 0, dp=None):
    t = x.shape[0]
    cap, offset = _capacity_place(idx, cfg, dp)
    buf3, slot, keep = _capacity_dispatch(x, idx, cfg, cap, offset)
    buf3 = buf3[e0:e0 + _local_experts(p)]   # this rank's slab (all of it on one device)
    # repro's dispatch-buffer constraints (its M1-M3 notes): under
    # moe_dispatch_constraints with expert parallelism the capacity buffer
    # and the expert outputs are constrained to the experts' "model" axis
    if cfg.moe_dispatch_constraints and cfg.shard_activations and _expert_parallel(cfg):
        buf3 = _shard(cfg, buf3, "model", None, None)
        h = _shard(cfg, _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], buf3),
                   "model", None, None)
    else:
        h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], buf3)
    return _capacity_combine(h, slot, keep, weights, t, cap, cfg, e0)


def _ragged_dot(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ragged_dot``'s plain twin: rows ``[off_e, off_e + n_e)`` times
    ``w[e]``. On real tensors one product per group, the sizes read on the
    host. On ``meta`` (the dry run) no size can be read: each row's product
    with its expert's weight, through a per-row expert index, gives the same
    shape and the same ``2 * rows * d * f`` FLOPs. The per-row form is not
    the real tensors' path, because a row's float32 bits from the CPU's GEMM
    depend on how many rows share its product."""
    if xs.device.type == "meta":
        experts = torch.arange(w.shape[0], device=xs.device)
        row_expert = torch.repeat_interleave(experts, group_sizes, output_size=xs.shape[0])
        return torch.bmm(xs[:, None, :], w[row_expert])[:, 0]
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=xs.dtype, device=xs.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        out[start:start + n] = xs[start:start + n] @ w[e]
        start += n
    return out


def _sort_by_expert(x, idx, cfg: ModelConfig):
    """(flat_e, order, inv, xs, group_sizes): the (T*k) picks sorted by
    expert (stable), its inverse, the rows in that order and the group sizes."""
    e, k = cfg.n_experts, cfg.top_k
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order, stable=True)
    xs = x.repeat_interleave(k, dim=0)[order]
    group_sizes = _one_hot(flat_e, e, torch.int32).sum(dim=0, dtype=torch.int32)
    return flat_e, order, inv, xs, group_sizes


def _moe_ragged(p, x, weights, idx, cfg: ModelConfig, e0: int = 0):
    t, d = x.shape
    dt = x.dtype
    _, _, inv, xs, group_sizes = _sort_by_expert(x, idx, cfg)
    e = _local_experts(p)
    if e != cfg.n_experts:
        # expert-parallel: the sorted rows of this rank's groups only, the
        # other rows' outputs zero (the other ranks add them)
        sizes = group_sizes.tolist()
        lo, n = sum(sizes[:e0]), sum(sizes[e0:e0 + e])
        xs, group_sizes = xs[lo:lo + n], group_sizes[e0:e0 + e]
    g = F.silu(_ragged_dot(xs, p["w_gate"].to(dt), group_sizes))
    u = _ragged_dot(xs, p["w_up"].to(dt), group_sizes)
    ys = _ragged_dot(g * u, p["w_down"].to(dt), group_sizes)
    if e != cfg.n_experts:
        mine, ys = ys, torch.zeros((inv.shape[0], d), dtype=dt, device=x.device)
        ys[lo:lo + n] = mine
    y_rep = ys[inv] * weights.reshape(-1, 1).to(dt)
    return y_rep.reshape(t, cfg.top_k, d).sum(dim=1)


# --- kernel twins -------------------------------------------------------------------
def _moe_gmm_capacity(p, x, weights, idx, cfg: ModelConfig, e0: int = 0, dp=None):
    """Kernel twin of ``_moe_scatter``: the same capacity, slot and keep math
    (so the drop set matches token for token), with the (E, C, D) expert FFN
    (this rank's slab of it) computed by three ``moe_gmm`` launches."""
    from repro_torch.kernels.ops import moe_gmm_capacity
    t = x.shape[0]
    cap, offset = _capacity_place(idx, cfg, dp)
    buf3, slot, keep = _capacity_dispatch(x, idx, cfg, cap, offset)
    buf3 = buf3[e0:e0 + _local_experts(p)]
    # one tile-map entry per expert: the kernel cuts its row tiles per run
    # of equal expert, so a finer map gives the same products and bits but
    # more CTAs that walk the map (at block_t 8 under deepseek's forward,
    # cap 120, a launch took 27x torch.bmm on an H100; PERF.md)
    dt = x.dtype
    g = F.silu(moe_gmm_capacity(buf3, p["w_gate"].to(dt), block_t=cap))
    u = moe_gmm_capacity(buf3, p["w_up"].to(dt), block_t=cap)
    h = moe_gmm_capacity(g * u, p["w_down"].to(dt), block_t=cap)
    return _capacity_combine(h, slot, keep, weights, t, cap, cfg, e0)


def _moe_gmm_dropless(p, x, weights, idx, cfg: ModelConfig, e0: int = 0):
    """Kernel twin of ``_moe_ragged``: dropless sort-by-expert dispatch with
    each expert's rows padded up to a ``block_t`` multiple (zero rows) so
    every tile belongs to one expert, at the static worst-case length, so the
    host never waits for the group sizes. Under expert parallelism only
    this rank's groups go into the buffer (its worst case: every pick on
    its experts), the other rows into a dump row past it, and their outputs
    are zero."""
    from repro_torch.kernels.ops import moe_gmm_op, pad_group_sizes
    t, d = x.shape
    k = cfg.top_k
    e = _local_experts(p)
    tk = t * k
    bt = 128 if tk >= 128 else 8
    # static worst-case padded length (every group rounds up by < bt)
    t_pad = (tk + bt - 1) // bt * bt + e * bt
    flat_e, order, inv, xs, group_sizes = _sort_by_expert(x, idx, cfg)
    sorted_e = flat_e[order]
    if e != cfg.n_experts:
        sorted_e = sorted_e - e0
        group_sizes = group_sizes[e0:e0 + e]
    _, padded_offs = pad_group_sizes(group_sizes, bt)
    raw_offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=x.device),
                          torch.cumsum(group_sizes, 0, dtype=torch.int32)])
    shift = padded_offs[:-1] - raw_offs[:-1]
    if e == cfg.n_experts:
        dest = torch.arange(tk, device=x.device) + shift[sorted_e]
        buf = torch.zeros((t_pad, d), dtype=x.dtype, device=x.device)
        buf[dest] = xs
    else:
        mine = (sorted_e >= 0) & (sorted_e < e)
        # the rows of the experts before e0 come first in the sorted order
        before = (flat_e < e0).sum()
        dest = torch.where(mine, torch.arange(tk, device=x.device) - before
                           + shift[sorted_e.clamp(0, e - 1)], t_pad)
        buf = torch.zeros((t_pad + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = xs
        buf = buf[:t_pad]
        dest = dest.clamp(max=t_pad - 1)
    tile_starts = torch.arange(t_pad // bt, dtype=torch.int32, device=x.device) * bt
    te = (torch.searchsorted(padded_offs, tile_starts, right=True) - 1).clamp(0, e - 1)
    dt = x.dtype
    g = F.silu(moe_gmm_op(buf, p["w_gate"].to(dt), te, block_t=bt))
    u = moe_gmm_op(buf, p["w_up"].to(dt), te, block_t=bt)
    ys = moe_gmm_op(g * u, p["w_down"].to(dt), te, block_t=bt)[dest]
    if e != cfg.n_experts:
        ys = torch.where(mine[:, None], ys, torch.zeros((), dtype=dt, device=x.device))
    y_rep = ys[inv] * weights.reshape(-1, 1).to(dt)
    return y_rep.reshape(t, k, d).sum(dim=1)


def _moe_gmm_impl(p, x, weights, idx, cfg: ModelConfig, e0: int = 0, dp=None):
    """Kernel-path dispatch: mirror the reference impl's drop semantics so
    temperature-0 tokens stay identical — capacity drops for ``scatter``,
    dropless for ``ragged``/``dense``."""
    if cfg.moe_impl == "scatter":
        return _moe_gmm_capacity(p, x, weights, idx, cfg, e0, dp)
    return _moe_gmm_dropless(p, x, weights, idx, cfg, e0)


_IMPLS = {"dense": _moe_dense, "scatter": _moe_scatter, "ragged": _moe_ragged,
          "gmm": _moe_gmm_impl}


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, impl: Optional[str] = None,
              tp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,D) -> (y, aux). The per-config ``kernel_impls['moe']`` policy
    swaps in the ``moe_gmm`` kernel path unless ``impl`` overrides it.
    Under ``tp`` ``p`` is this rank's shard, ``cfg`` its config
    (``tensor_parallel.tp_local``, the global expert count) and ``x`` the
    same on every rank; every rank gets the whole ``y`` (see the module
    docstring)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    dp = None if tp is None else tp.batch
    weights, idx, aux = route(p["router"], xt, cfg, dp)
    if impl is None and kernel_impl(cfg, "moe") == "kernel":
        impl = "gmm"
    name = impl or cfg.moe_impl
    if name not in _IMPLS:
        raise ValueError(f"apply_moe: unknown impl {name!r}; allowed impls: "
                         f"{tuple(sorted(_IMPLS))}")
    # the capacity forms count the global batch's tokens under a grid
    kw = {"dp": dp} if name in ("scatter", "gmm") and dp is not None else {}
    if tp_size(tp) == 1:
        y = _IMPLS[name](p, xt, weights, idx, cfg, **kw)
        if cfg.n_shared_experts:
            y = y + _shared_ffn(p["shared"], xt)
        return y.reshape(b, s, d), aux
    # the routing is whole on every rank; its tokens and combine weights
    # enter the rank's experts (and shared width) through the "copy"
    xs = copy_in(xt, tp)
    y = _IMPLS[name](p, xs, copy_in(weights, tp), idx, cfg, expert_span(cfg, tp)[0],
                     **kw).float()
    if cfg.n_shared_experts:
        y = y + _shared_ffn(p["shared"], xs, f32=True)
    return all_sum(y, tp).to(x.dtype).reshape(b, s, d), aux

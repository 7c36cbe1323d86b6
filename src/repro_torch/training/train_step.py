"""Train step factory: loss, gradients and the AdamW update, with optional
microbatch gradient accumulation, and remat selected through the model
config (``cfg.remat``, applied in ``models/transformer.py``) — the port of
``repro.training.train_step``.

Parameters stay plain tensors at rest (``requires_grad=False``). Each
microbatch differentiates ``loss_fn`` with respect to detached views of
them (``p.detach().requires_grad_()``, no copy) through
``torch.autograd.grad``, so the trained tree serves through the engines
and the kernels afterwards with no ``torch.no_grad()`` around it.

Under a tensor-parallel group ``tp`` (the ``"model"`` axis) every rank
passes its shards and the whole batch: ``loss_fn`` runs split over the
group, its collectives carry the backward (``tensor_parallel``'s "copy" and
"reduce"), a segment several ranks hold gets its gradient summed over
exactly those ranks (``sharding.sum_shared``), and the update clips by the
whole tree's norm (``optimizer.global_norm`` under the group).

Under a grid (``distributed.data_parallel.Grid``: the ``"data"`` and
``"pod"`` axes too) every rank passes its 2-D shards, their optimizer state
(ZeRO: the moments cut as the parameters) and the whole global batch, of
which it takes its rows (``data_parallel.batch_rows``); the backward
reduce-scatters the gradient of every leaf ``"data"`` cuts
(``data_parallel.gather_data``), and ``data_parallel.reduce_grads`` sums the
others over ``"data"`` and every gradient over ``"pod"``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.data_parallel import batch_rows, reduce_grads
from repro_torch.distributed.sharding import map_with_names, sum_shared
from repro_torch.distributed.tensor_parallel import tp_local, tp_size
from repro_torch.models.model import loss_fn, tree_leaves, tree_map
from repro_torch.training.optimizer import OptimizerConfig, adamw_update, global_norm


def _grads_of(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, tp=None):
    """(loss, metrics, grads): grads a tree like ``params``, in each
    parameter's dtype; a leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives. Under ``tp`` the rank's gradients of its shards,
    each partial one of a shared segment as it is (see
    :func:`make_train_step`)."""
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(ps)
        loss, metrics = loss_fn(ps, batch, cfg, tp=tp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), ps))


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, n_microbatches: int = 1,
                    tp=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics being ``loss_fn``'s ``ce`` and ``lb_loss``, the
    ``grad_norm`` and ``lr`` of the update, and ``loss``.

    With ``n_microbatches`` > 1 the batch is split along dim 0 in order, the
    gradients are summed in float32 and divided by the count, ``loss`` is
    the mean over the microbatches, and ``ce`` and ``lb_loss`` are the last
    microbatch's: ``repro``'s ``lax.scan`` semantics. The update works in
    place (see :func:`adamw_update`): ``params`` and ``opt_state`` are
    consumed and returned.

    Under a tensor-parallel group ``tp`` every rank calls the step with its
    shards (``init_params(..., tp=)``, ``sharding.local_shard``), its
    optimizer state (``init_opt_state`` of them) and the whole batch;
    ``cfg`` is the global config. The gradient of a segment several ranks
    hold is summed over them once the microbatches are accumulated, and
    every rank clips by the whole tree's norm, so the shards step as the
    one-device tree's would and the metrics are the same on every rank.
    Under a grid each rank runs its rows of each microbatch (``repro``'s
    microbatch ``i`` is global rows ``[i B / n, (i + 1) B / n)``, split
    over ``(pod, data)``), and the metrics are the global batch's.

    Raises ``ValueError`` here when ``cfg.kernel_impls`` names a kernel: the
    kernels have no backward. ``repro`` builds the step and fails at its
    first call instead."""
    kernels = sorted(site for site, impl in cfg.kernel_impls if impl == "kernel")
    if kernels:
        raise ValueError(
            f"make_train_step: kernel_impls names kernels at {kernels}, which have no "
            f"backward (repro's kernels define no VJP); train under "
            f"kernel_impls=\"reference\"")
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")
    tp_local(cfg, tp)   # a config that does not split over the group raises here

    def train_step(params, opt_state, batch) -> Tuple[Any, Any, Dict]:
        if n_microbatches == 1:
            loss, metrics, grads = _grads_of(params, batch_rows(batch, tp), cfg, tp)
        else:
            grads, loss = None, 0.0
            for i in range(n_microbatches):
                mb = batch_rows(batch, tp, n_microbatches, i)
                mb_loss, metrics, mb_grads = _grads_of(params, mb, cfg, tp)
                if grads is None:  # 0 + g is g: start from the first microbatch's
                    grads = tree_map(lambda g: g.to(torch.float32).contiguous(), mb_grads)
                else:
                    tree_map(lambda acc, g: acc.add_(g), grads, mb_grads)
                del mb_grads
                loss = loss + mb_loss
            tree_map(lambda g: g.div_(n_microbatches), grads)
            loss = loss / n_microbatches
        gnorm = None
        grads = reduce_grads(grads, cfg, tp)
        if tp_size(tp) > 1:
            grads = map_with_names(lambda names, g: sum_shared(g, names, cfg, tp), grads)
        if tp is not None and tp.world.size > 1:
            gnorm = global_norm(grads, tp, cfg)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg, gnorm)
        return params, opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step

"""AdamW on tensor trees, with global-norm clipping and a linear-warmup /
cosine schedule — the port of ``repro.training.optimizer``.

Plain functions on nested dicts of tensors, not ``torch.optim.AdamW``: the
state is ``repro``'s tree, ``{"m": tree, "v": tree, "step": 0-d int32}``
with ``m`` and ``v`` in float32, so a checkpoint of it has ``repro``'s keys.
The schedule, the bias corrections and the clip scale are float32 tensors
(not Python floats), so ``lr`` and every update round as JAX's f32 does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.model import tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as a 0-d float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts in ``jax.tree.leaves`` order: sorted keys."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_opt_state(params) -> Dict[str, Any]:
    """Zero ``m`` and ``v`` (float32, on each parameter's device) and step 0."""
    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
    device = tree_leaves(params)[0].device
    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32,
                                                            device=device)}


def _named_leaves(tree, names: Tuple[str, ...] = ()):
    """(path, leaf) of nested dicts in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _named_leaves(tree[k], names + (k,))]
    return [(names, tree)]


def global_norm(tree, tp=None, cfg=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in ``jax.tree.leaves`` order.

    Under a tensor-parallel group ``tp`` ``tree`` holds this rank's shards
    (of a parameter tree of the global model config ``cfg``), and the norm
    is the whole tree's, the same on every rank: each rank squares and sums
    what it owns, one float32 sum over the group adds the ranks' sums leaf
    by leaf, and the leaves are summed in order. A leaf every rank holds
    whole is counted once (rank 0's), and so is a segment several ranks
    hold (a replicated KV head, a shared Mamba2 B/C group: the lowest
    holder's), whose gradient every holder holds whole once
    ``sharding.sum_shared`` has summed it.

    Under a grid (``distributed.data_parallel.Grid``) each element is
    counted once too: a piece ``"data"`` cuts by its owner, a leaf
    ``"data"`` replicates by data rank 0, and a ``"pod"`` replica by pod
    rank 0, each by the ``"model"`` rule above; one float32 sum over every
    rank adds the parts up."""
    if tp is None or tp.world.size == 1:
        total = 0.0
        for g in tree_leaves(tree):
            total = total + g.float().square().sum()
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    from repro_torch.distributed.sharding import data_axis, shared_segments
    from repro_torch.distributed.tensor_parallel import all_sum
    parts = []
    for names, g in _named_leaves(tree):
        segs = shared_segments(names, cfg, tp.size, tp.rank)
        g = g.float()
        replica = tp.pod_rank != 0 or (tp.data_rank != 0
                                       and data_axis(names, cfg, tp.dims) is None)
        if replica:
            part = g.new_zeros(())
        elif segs is None:
            part = g.square().sum() if tp.rank == 0 else g.new_zeros(())
        else:
            axis, mine = segs
            part = g.new_zeros(())
            for at, _, n, held in mine:
                if held[0] == tp.rank:
                    part = part + g.narrow(axis, at, n).square().sum()
        parts.append(part)
    with torch.no_grad():
        sums = all_sum(torch.stack(parts), tp.world)
    total = 0.0
    for part in sums:
        total = total + part
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptimizerConfig,
                 grad_norm: Optional[torch.Tensor] = None):
    """Returns (params, opt_state, metrics {"grad_norm", "lr"}).

    The update is ``repro``'s: the gradients clipped to ``grad_clip`` by
    their global norm, ``delta = mh / (sqrt(vh) + eps) + weight_decay * p``
    on every leaf (norms and embeddings too), ``p - lr * delta``, all in
    float32 and cast back to ``p.dtype``. It works in place, the counterpart
    of ``repro``'s ``donate_argnums=(0, 1)``: ``params``, ``opt_state`` and
    ``grads`` are consumed (overwritten), and the returned trees are the
    same objects as the ones passed in. ``grad_norm``: the gradients'
    global norm when the caller has it (a tensor-parallel step passes the
    whole tree's, :func:`global_norm` under its group, so every rank clips
    by the same scale); None computes it from ``grads``."""
    step = opt_state["step"]
    step += 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        p32 = p.to(torch.float32)
        delta.add_(p32 * cfg.weight_decay)
        p.copy_(p32 - lr * delta)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}

"""The ``"data"`` and ``"pod"`` axes of training: a grid of process groups,
and FSDP in eager PyTorch.

``repro`` trains on a mesh of ``("pod", "data", "model")`` devices and lets
GSPMD place every leaf by its rules (``sharding.param_specs``): ``"data"``
on the d_model side of nearly every matrix, which is FSDP over
``"data"``, with the optimizer state sharded as the parameters (ZeRO);
``"pod"`` replicating every parameter; and the batch split over ``("pod",
"data")`` (``sharding.batch_spec``). torch has no GSPMD, so the port runs
one process a grid point and meets at explicit collectives:

- :class:`Grid` and :func:`make_grid`: the world's ranks laid out as
  ``repro``'s mesh lays out its devices, each rank with its ``"model"``,
  ``"data"``, ``"pod"`` and ``(pod, data)`` groups and the world;
  :func:`grid_coords` a world rank's ``(p, d, m)``, :func:`holder_key`
  which piece of a leaf it holds;
- :func:`gather_data`, an autograd pair: forward the all-gather of a leaf's
  shards over ``"data"`` along its data axis (``sharding.data_axis``),
  backward the reduce-scatter (a float32 sum) of its gradient along the
  same axis; :func:`gather_tree` gathers a subtree so. The model gathers a
  stacked leaf one layer at a time inside the unit ``cfg.remat`` wraps
  (``models/transformer.py``), and the other leaves where ``models/model.py``
  uses them. Under ``remat="full"`` the backward's recompute gathers each
  layer again, so no gathered layer outlives its unit, as FSDP does; under
  ``remat="none"`` autograd keeps every gathered layer for the backward
  (the whole of the rank's ``"model"`` shard of the parameters at the
  forward's end);
- :func:`reduce_grads`: after the backward, the float32 sum over
  ``"data"`` of the gradient of a leaf ``"data"`` does not cut, and over
  ``"pod"`` of every gradient;
- :func:`batch_rows`: this rank's rows of microbatch ``i`` of the global
  batch.

Every collective here is the one it is named for, on whatever backend the
group has (``tensor_parallel.backend_for``); gloo takes CUDA tensors
through host memory. ``STATS`` counts them under their axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import data_axis, map_with_names, tp_split
from repro_torch.distributed.tensor_parallel import TPGroup, _all_reduce, _run, all_gather


@dataclasses.dataclass(eq=False)
class Grid(TPGroup):
    """One rank's place in a grid of ``pod_size x data_size x size``
    ranks. The world's ranks are laid out as ``repro``'s mesh lays out its
    devices (``np.asarray(devices).reshape(sizes)``, ``"model"`` fastest):
    world rank ``r`` is ``(p, d, m)`` with ``r = (p * data + d) * model +
    m``.

    The ``TPGroup`` fields are the rank's ``"model"`` group's (the ranks
    that share ``(p, d)``), so the model code, which takes a ``TPGroup`` as
    ``tp``, splits over ``"model"`` as under a ``TPGroup``. ``data``: the
    ranks that share ``(p, m)``, by ``d``; ``pod``: those that share ``(d,
    m)``, by ``p``; ``batch``: the ``(pod, data)`` plane, those that share
    ``m``, by ``p * data + d`` (the loss's and the MoE statistics' sums);
    ``world``: every rank. A group of one rank is a ``TPGroup`` without a
    process group."""
    pod_size: int = 1
    data_size: int = 1
    pod_rank: int = 0
    data_rank: int = 0
    data: Optional[TPGroup] = None
    pod: Optional[TPGroup] = None
    batch: Optional[TPGroup] = None
    _world: Optional[TPGroup] = dataclasses.field(default=None, repr=False)

    @property
    def world(self) -> TPGroup:
        return self._world

    def subgroup(self, n: int):
        raise NotImplementedError("a grid's groups are fixed: move its state to another "
                                  "grid through a checkpoint (reshard_restore)")


def grid_coords(rank: int, dims: Sequence[int]) -> Tuple[int, int, int]:
    """World rank ``rank``'s coordinates ``(p, d, m)`` in a grid of
    ``dims`` (pod, data, model): ``rank = (p * data + d) * model + m``."""
    _, data, model = dims
    return rank // (data * model), rank // model % data, rank % model


def holder_key(names: Sequence[str], cfg, dims: Sequence[int], rank: int) -> Tuple[int, int]:
    """The piece of the leaf at ``names`` (of the global ``cfg``) that world
    rank ``rank`` of a grid of ``dims`` holds, as (its data rank where
    ``"data"`` cuts the leaf, else 0; its model rank where ``"model"`` cuts
    it, else 0): ranks with one key hold the same piece, a pod replicating
    every piece. Segments that ``"model"`` ranks share (``tp_segments``)
    are not told apart."""
    _, d, m = grid_coords(rank, dims)
    return (d if data_axis(names, cfg, dims) is not None else 0,
            m if dims[2] > 1 and tp_split(names, cfg, dims[2]) is not None else 0)


def make_grid(world: TPGroup, data: int, model: int, pod: int = 1) -> TPGroup:
    """This rank's :class:`Grid` of ``pod x data x model`` ranks over the
    ``world`` (``init_tp``'s group of every rank; ``spawn_tp`` hands it to
    each rank). Every rank calls it with the same sizes: it makes every
    group of every axis, its own and the others', in one order
    (``new_group`` is collective). With ``pod`` and ``data`` 1 it returns
    ``world`` itself, the 1-D ``"model"`` group."""
    if pod * data * model != world.size or min(pod, data, model) < 1:
        raise ValueError(f"a grid of (pod, data, model) {(pod, data, model)} over "
                         f"{world.size} ranks")
    if pod == data == 1:
        return world
    p, d, m = grid_coords(world.rank, (pod, data, model))

    def at(pp, dd, mm):
        return (pp * data + dd) * model + mm

    sets = {"model": [[at(pp, dd, mm) for mm in range(model)]
                      for pp in range(pod) for dd in range(data)],
            "data": [[at(pp, dd, mm) for dd in range(data)]
                     for pp in range(pod) for mm in range(model)],
            "pod": [[at(pp, dd, mm) for pp in range(pod)]
                    for dd in range(data) for mm in range(model)]}
    if pod > 1 and data > 1:
        sets["batch"] = [[at(pp, dd, mm) for pp in range(pod) for dd in range(data)]
                         for mm in range(model)]
    mine = {}
    for axis, groups in sets.items():
        for ranks in groups:
            g = world.group_of(ranks, axis)
            if g is not None:
                mine[axis] = g
    mg = mine["model"]
    batch = mine.get("batch") or (mine["data"] if pod == 1 else mine["pod"])
    return Grid(mg.group, mg.rank, mg.size, world.device, mg.devices, world.backend,
                axis="model", ranks=mg.ranks, pod_size=pod, data_size=data, pod_rank=p,
                data_rank=d, data=mine["data"], pod=mine["pod"], batch=batch,
                _world=dataclasses.replace(world, axis="world", _subgroups={}))


def grid_layout(pod: int, data: int, model: int, rank: int,
                device: Any = "cpu") -> TPGroup:
    """World rank ``rank``'s place in a grid of ``pod x data x model``
    ranks with no process group behind it: enough to cut a leaf
    (``sharding.local_shard``) or name a rank's coordinates in a process
    that holds every rank's shards (a test, a comparison). Its collectives
    cannot run."""
    dev = torch.device(device)
    p, d, m = grid_coords(rank, (pod, data, model))

    def one(size, at, axis):
        return TPGroup(None, at, size, dev, (dev,) * size, "gloo", axis=axis)
    if pod == data == 1:
        return one(model, m, "model")
    return Grid(None, m, model, dev, (dev,) * model, "gloo", pod_size=pod, data_size=data,
                pod_rank=p, data_rank=d, data=one(data, d, "data"), pod=one(pod, p, "pod"),
                batch=one(pod * data, p * data + d, "batch"),
                _world=one(pod * data * model, rank, "world"))


def reduce_scatter(x: torch.Tensor, axis: int, group: TPGroup,
                   backward: bool = False) -> torch.Tensor:
    """Rank ``group.rank``'s even slice along ``axis`` of the sum of every
    rank's ``x`` over ``group``, summed at float32 and cast back to
    ``x``'s dtype (``dist.reduce_scatter``; a backend that lacks it for
    ``x``'s device raises)."""
    x32 = x.to(torch.float32)
    chunks = [c.contiguous() for c in x32.chunk(group.size, dim=axis)]
    out = torch.empty_like(chunks[0])
    _run(dist.reduce_scatter, x32, out, chunks, group=group.group, backward=backward,
         axis=group.axis)
    return out.to(x.dtype)


class _GatherData(torch.autograd.Function):
    """FSDP's pair: forward every ``"data"`` rank's shard side by side on
    ``axis``, backward the reduce-scatter (sum) of the gradient on
    ``axis``: each rank's gradient of the whole leaf comes from its rows of
    the batch, and the sum over the ranks, cut to the rank's slice, is its
    shard's gradient."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return torch.cat(all_gather(x, group), dim=axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.group, backward=True), None, None


def gather_data(x: torch.Tensor, axis: Optional[int], grid: TPGroup) -> torch.Tensor:
    """The whole ``"data"`` extent of a leaf's shard ``x`` (cut on
    ``axis``), whose backward reduce-scatters the gradient; ``x`` itself
    for a leaf ``"data"`` does not cut (``axis`` None) or no ``"data"``
    axis."""
    if axis is None or grid is None or grid.data_size == 1:
        return x
    return _GatherData.apply(x, axis, grid.data)


def gather_tree(tree: Any, prefix: Sequence[str], cfg, grid: TPGroup) -> Any:
    """The subtree ``tree`` at the parameter path ``prefix`` (of the global
    ``cfg``; a stacked subtree's layer too, whose leaves keep their axes
    from the end) with every leaf gathered over ``"data"``
    (:func:`gather_data`)."""
    if grid is None or grid.data_size == 1:
        return tree
    return map_with_names(lambda names, x: gather_data(x, data_axis(names, cfg, grid.dims),
                                                       grid), tree, tuple(prefix))


def reduce_grads(grads: Any, cfg, grid: TPGroup) -> Any:
    """The gradient tree of this rank's shards once the backward has
    reduce-scattered the leaves ``"data"`` cuts: a leaf ``"data"``
    replicates summed over ``"data"``, then every leaf summed over
    ``"pod"`` (float32 sums, in place where the dtype allows), so each rank
    holds its ``(d, m)`` cut of the whole batch's gradient."""
    if grid is None or grid.pod_size * grid.data_size == 1:
        return grads

    def one(names, g):
        groups = [grid.data] if grid.data_size > 1 and \
            data_axis(names, cfg, grid.dims) is None else []
        groups += [grid.pod] if grid.pod_size > 1 else []
        for group in groups:
            g = _all_reduce(g.to(torch.float32, copy=True).contiguous(), group).to(g.dtype)
        return g
    return map_with_names(one, grads)


def batch_rows(batch: Dict[str, torch.Tensor], tp: Optional[TPGroup],
               n_microbatches: int = 1, i: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's rows of microbatch ``i`` of the global ``batch``:
    ``repro`` splits the global batch into ``n_microbatches`` consecutive
    row blocks, and each block over the ``(pod, data)`` ranks in order
    (``batch_spec``'s leading axis), so rank ``(p, d)`` takes the ``p *
    data + d``-th even share of block ``i``. Raises ``ValueError`` for rows
    that do not split so."""
    rows = next(iter(batch.values())).shape[0]
    n = 1 if tp is None else tp.pod_size * tp.data_size
    if rows % (n_microbatches * n):
        raise ValueError(f"a batch of {rows} rows does not split into {n_microbatches} "
                         f"microbatches over {n} (pod, data) ranks")
    if n_microbatches * n == 1:
        return batch
    share = rows // n_microbatches // n
    start = (i * n + (tp.pod_rank * tp.data_size + tp.data_rank if n > 1 else 0)) * share
    return {k: v[start:start + share] for k, v in batch.items()}

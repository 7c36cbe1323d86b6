"""Elastic scaling: move a parameter tree between mesh shapes via the
full-size checkpoint format (checkpoint/checkpoint.py stores gathered
arrays keyed by tree path) — the port of ``repro.distributed.elastic``.

``reshard_restore`` restores any committed checkpoint onto a *different* mesh
by computing the target shardings from the same path-based rules — the
fault-tolerance story for losing (or gaining) members mid-run: write, resize,
restore, continue; the deterministic data pipeline guarantees identical batch
order afterwards.

Placement follows the mesh. A mesh that a tensor-parallel group covers
(``distributed.tensor_parallel``, one rank a device; ``reshard_restore``
included, which a training group resumes through) gives each rank its
head-aligned shard of every leaf
(:func:`repro_torch.distributed.sharding.local_shard`) on the rank's
device; a mesh without a group places each leaf whole on its one device
(:func:`repro_torch.distributed.sharding.mesh_device`), and one over
several distinct devices that no group covers raises
``NotImplementedError`` rather than fall back to anything.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (local_shard, map_with_names, mesh_device,
                                             param_shardings)
from repro_torch.models.model import tree_map


def _place(leaf: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``leaf`` on ``dev``; a leaf already there is not copied."""
    there = leaf.device.type == dev.type and dev.index in (None, leaf.device.index)
    return leaf if there else leaf.to(dev)


def reshard_restore(cfg: ModelConfig, template: Any, directory: str,
                    mesh, step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore a checkpoint onto ``mesh`` (any shape). ``template`` holds
    the whole shapes (``meta`` tensors will do); over a mesh that a group
    covers each rank gets its ``local_shard`` of every leaf, read leaf by
    leaf, so no rank's device holds the whole tree (a training state's
    optimizer moments split as the parameters they shadow)."""
    shardings = param_shardings(template, cfg, mesh) if mesh is not None else None
    return ckpt.restore(template, directory, step=step, shardings=shardings, cfg=cfg)


def reshard_in_place(params: Any, cfg: ModelConfig, mesh) -> Any:
    """Re-lay a LIVE params tree onto ``mesh`` without the checkpoint
    round-trip: the target shardings come from the same path-based rules as
    :func:`reshard_restore`, and each leaf moves straight to its target
    device. This is the elastic *serving* resize — a gang losing (or
    gaining) a member inside its SIGTERM grace reshards the full parameter
    set onto the survivors instead of writing and re-reading a
    checkpoint. ``params`` is the whole tree. Over a mesh that a group
    covers, each rank keeps its own :func:`local_shard` of every leaf, on its
    device (a sliced leaf is a copy of its own, so the whole one can be
    freed); without a group every leaf moves whole to the mesh's one
    device."""
    dev = mesh_device(mesh)
    tp = getattr(mesh, "tp", None)
    if tp is None or tp.world.size == 1:
        return tree_map(lambda leaf: _place(leaf, dev), params)
    return map_with_names(lambda names, leaf: _place(local_shard(leaf, names, cfg, tp), dev),
                          params)


def dp_degree(mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    return sizes.get("data", 1) * sizes.get("pod", 1)

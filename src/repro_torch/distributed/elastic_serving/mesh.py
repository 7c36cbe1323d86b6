"""Gang meshes — the port of ``repro.distributed.elastic_serving.mesh``.

The serving mesh is one-dimensional over the ``"model"`` axis: gang TP is
pure tensor parallelism (every member holds a distinct shard of every weight
and of the KV feature dims), which is what makes a member's departure a
*hand-off problem* — its shard exists nowhere else.

Over a tensor-parallel group (``distributed.tensor_parallel``, one rank a
gang member) the mesh spans the group's devices: the active gang is the
first ``min(n_members, group size)`` ranks, each holding the head-aligned
shard that ``distributed.sharding.local_shard`` cuts (the query heads, KV
heads, ``d_ff`` and vocabulary of its slice), and the model runs SPMD over
them. Two ranks may share one card (over gloo): their shards are apart in
memory all the same.

Without a group, N gang members share one card: ``repro`` stands each member
in for by one XLA host device and, with fewer devices than members, CLAMPS
the mesh to the devices that exist while its byte accounting follows the
LOGICAL gang. The port does the same over ``torch.device``\\ s: the replica's
mesh is its own card (or the CPU), clamped to ``min(n_members,
len(devices))``, and the gang size stays logical — it drives the migration
bytes, the platform's counters and the controller-visible invoker. A mesh
over several distinct devices that no group covers raises
(``distributed.sharding.mesh_device``).

``repro``'s ``ensure_host_devices`` is left out: it sets an XLA flag that
splits one CPU into N devices, and has no torch meaning.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh
from repro_torch.models.model import nbytes


def available_gang_devices(tp=None) -> int:
    """How many devices a gang can actually span: the ranks of the
    tensor-parallel group ``tp``, else the visible cards, else the one
    CPU."""
    if tp is not None:
        return tp.size
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def serving_mesh(n_members: int, devices: Optional[List] = None, tp=None) -> Mesh:
    """A 1-D tensor-parallel mesh over ``n_members`` gang members. Over a
    group ``tp`` it spans the devices of the group's first
    ``min(n_members, tp.size)`` ranks (a replica passes the count its
    config splits over, ``tensor_parallel.gang_ranks``) and carries that
    subgroup (None on a rank outside it), which places each rank's shard;
    every rank of ``tp`` calls it alike (``TPGroup.subgroup``). Without a group, ``devices``
    ``None`` is the default device (the card, raising without CUDA), and
    with fewer devices than members the mesh CLAMPS to what exists —
    sharding rules degrade gracefully, so serving stays correct and only
    the simulated-distribution fidelity shrinks."""
    if tp is not None:
        n = max(1, min(int(n_members), tp.size))
        return Mesh(np.asarray(list(tp.devices[:n]), dtype=object), ("model",),
                    tp=tp.subgroup(n))
    if devices is None:
        devices = [resolve_device(None)]
    n = max(1, min(int(n_members), len(devices)))
    return Mesh(np.asarray(list(devices[:n]), dtype=object), ("model",))


def tree_bytes(tree: Any) -> int:
    return nbytes(tree)


def member_shard_bytes(tree: Any, mesh: Mesh) -> int:
    """Bytes of ``tree`` resident on ONE member of ``mesh`` under even model
    sharding — the volume a departing node must push to survivors inside its
    SIGTERM grace. Computed analytically (total / mesh size): rules that drop
    an axis replicate the leaf, so this is the upper bound the migration
    protocol budgets for."""
    n = int(np.prod(mesh.devices.shape))
    return tree_bytes(tree) // max(n, 1)

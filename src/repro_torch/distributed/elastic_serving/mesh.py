"""Gang meshes — the port of ``repro.distributed.elastic_serving.mesh``.

The serving mesh is one-dimensional over the ``"model"`` axis: gang TP is
pure tensor parallelism (every member holds a distinct shard of every weight
and of the KV feature dims), which is what makes a member's departure a
*hand-off problem* — its shard exists nowhere else.

How N gang members share one card: ``repro`` stands each member in for by
one XLA host device and, with fewer devices than members, CLAMPS the mesh to
the devices that exist while its byte accounting follows the LOGICAL gang.
The port does the same over ``torch.device``\\ s: a replica's mesh is its own
card (or the CPU), clamped to ``min(n_members, len(devices))``, and the gang
size stays logical — it drives the migration bytes, the platform's
counters and the controller-visible invoker. A mesh over several distinct
devices would need tensor parallelism across cards, which the port does not
have; placing onto one raises (``distributed.sharding.mesh_device``).

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


def available_gang_devices() -> int:
    """How many devices a gang can actually span in this process: the
    visible cards, or the one CPU without CUDA."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def serving_mesh(n_members: int, devices: Optional[List] = None) -> Mesh:
    """A 1-D tensor-parallel mesh over ``n_members`` gang members.
    ``devices`` ``None`` is the default device (the card, raising without
    CUDA). With fewer devices than members, the mesh CLAMPS to what exists —
    sharding rules degrade gracefully, so serving stays correct and only the
    simulated-distribution fidelity shrinks."""
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

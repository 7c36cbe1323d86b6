"""Production mesh construction — the port of ``repro.launch.mesh``. A
FUNCTION (not a module-level constant), as in ``repro``.

The meshes are :class:`~repro_torch.distributed.sharding.AbstractMesh`es:
axis names and sizes without devices. ``repro`` builds its production
meshes over 256 or 512 placeholder host devices that an XLA flag creates
(``--xla_force_host_platform_device_count``, set first thing in its
``dryrun.py``, and ``ensure_host_devices`` for tests); torch has no such
placeholder devices and needs none, since the port's dry run runs on the
``meta`` device and computes shard shapes from axis sizes alone. A mesh that
places tensors on devices is :class:`~repro_torch.distributed.sharding.Mesh`.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.distributed.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: (data=16, model=16) = 256 chips. Multi-pod: (pod=2,
    data=16, model=16) = 512 chips, the "pod" axis carrying pure DP whose
    gradient all-reduce crosses the inter-pod links."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(shape), tuple(axes))

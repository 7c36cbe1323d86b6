"""The elastic replica: one model served tensor-parallel by a gang — the port
of ``repro.distributed.elastic_serving.replica``.

An :class:`ElasticReplica` is what a *gang* of concurrently-idle harvested
nodes jointly hosts: parameters laid out over a 1-D ``"model"`` mesh by the
``distributed.sharding`` path rules, decode driven by the stock
:class:`~repro_torch.serving.engine.ContinuousEngine`. The replica's one
elastic primitive is :meth:`resize` (with :meth:`shrink`/:meth:`grow`
sugar): a member's window closing mid-stream becomes a mesh resize handled
by the :class:`~repro_torch.distributed.elastic_serving.migration.MigrationProtocol`
instead of the death of the whole replica.

The replica knows nothing about invokers, SIGTERMs, or the simulation
clock. ``repro_torch.platform.elastic`` owns that side and calls ``shrink``
from the departing member's grace window.

A fresh engine is handed the old engine's compute-dtype parameters
(``cast_params`` keeps leaves already in the compute dtype), so a resize
makes no second bf16 copy of the weights while the old engine is alive; the
bits are the same as a cast of ``params``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.elastic import reshard_in_place
from repro_torch.distributed.elastic_serving.mesh import (serving_mesh, tree_bytes)
from repro_torch.distributed.elastic_serving.migration import (MigrationProtocol,
                                                               MigrationRecord)
from repro_torch.distributed.sharding import mesh_device
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine


class ElasticReplica:
    """A gang-owned serving engine that survives membership churn.

    ``n_members`` is the LOGICAL gang size (how many harvested nodes back the
    replica); the mesh is the one ``device`` the replica lives on, so byte
    accounting follows the gang while the layout clamps to the device that
    exists. ``device`` ``None`` is the card (raising without CUDA; pass
    ``device="cpu"``).
    """

    def __init__(self, cfg: ModelConfig, params: Any, n_members: int, *,
                 n_slots: int = 4, max_seq: int = 64,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, kv_mode: str = "migrate",
                 device: DeviceLike = None):
        self.cfg = cfg
        self.n_members = int(n_members)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self._devices = [resolve_device(device)]
        self.protocol = MigrationProtocol(kv_mode)
        self.mesh = serving_mesh(self.n_members, self._devices)
        self.params = reshard_in_place(params, cfg, self.mesh)
        self.engine = None
        self.engine = self._fresh_engine()
        self.migrations: List[MigrationRecord] = []

    def _fresh_engine(self) -> ContinuousEngine:
        """A blank engine over the CURRENT params/mesh; the migration
        protocol transplants (or replays) decode state into it."""
        params = (self.params if self.engine is None
                  else reshard_in_place(self.engine.params, self.cfg, self.mesh))
        return ContinuousEngine(self.cfg, params, n_slots=self.n_slots,
                                max_seq=self.max_seq, eos_id=self.eos_id,
                                temperature=self.temperature, seed=self.seed,
                                device=mesh_device(self.mesh))

    # --- elasticity -----------------------------------------------------------
    def resize(self, n_members: int) -> MigrationRecord:
        """Migrate to a gang of ``n_members`` mid-stream. In-flight decodes
        survive; at temperature 0 the ``migrate`` kv_mode resumes
        token-identically to an uninterrupted run."""
        assert n_members >= 1, n_members
        rec = self.protocol.migrate(self, n_members)
        self.migrations.append(rec)
        return rec

    def shrink(self, n: int = 1) -> MigrationRecord:
        """A member's window is closing: drop ``n`` members, keep serving."""
        return self.resize(self.n_members - n)

    def grow(self, n: int = 1) -> MigrationRecord:
        """New idle windows opened: spread the same replica wider."""
        return self.resize(self.n_members + n)

    # --- serving (delegation) -------------------------------------------------
    def add(self, req: GenRequest) -> None:
        self.engine.add(req)

    def step(self) -> int:
        return self.engine.step()

    def run(self) -> List[GenRequest]:
        return self.engine.run()

    def serve(self, gens: List[GenRequest]) -> Dict[int, float]:
        return self.engine.serve(gens)

    def drain(self) -> List[GenRequest]:
        return self.engine.drain()

    @property
    def batcher(self):
        return self.engine.batcher

    # --- accounting -----------------------------------------------------------
    @property
    def param_bytes(self) -> int:
        return tree_bytes(self.params)

    @property
    def mesh_size(self) -> int:
        """Devices actually spanned (<= logical ``n_members``)."""
        return int(self.mesh.devices.size)

    @property
    def migrated_bytes(self) -> int:
        return sum(r.bytes_moved for r in self.migrations)

    @property
    def wire_bytes(self) -> int:
        return sum(r.wire_bytes for r in self.migrations)

    def stats(self) -> Dict[str, Any]:
        return {
            "n_members": self.n_members,
            "mesh_size": self.mesh_size,
            "n_migrations": len(self.migrations),
            "migrated_bytes": self.migrated_bytes,
            "wire_bytes": self.wire_bytes,
            "param_bytes": self.param_bytes,
        }

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

Over a tensor-parallel group (``tp``: every rank that may serve, the
world of ``distributed.tensor_parallel``) the replica is physical: every
rank builds it alike from the whole parameters and keeps its shard, the
active gang being the first ``min(n_members, tp.size)`` ranks; or, with
``sharded``, from its shards alone (``init_params(..., tp=tp)`` or
``params_from_numpy(..., tp=tp)``), so no rank ever holds the whole tree.
Rank 0 keeps the API: ``add``, ``step``, ``run``, ``serve``, ``drain`` and
``resize`` send a small command to the other ranks first, which sit in
:meth:`follow` and run the same call on their shards (a rank outside the
gang ignores every call but a resize, which may bring it in).
:meth:`close` ends their loops. :attr:`serving_engine` is what the
platform drives.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.distributed.elastic import reshard_in_place
from repro_torch.distributed.elastic_serving.mesh import (serving_mesh, tree_bytes)
from repro_torch.distributed.elastic_serving.migration import (MigrationProtocol,
                                                               MigrationRecord)
from repro_torch.distributed.sharding import mesh_device
from repro_torch.models.model import param_specs, tree_leaves, tree_map
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine


class ElasticReplica:
    """A gang-owned serving engine that survives membership churn.

    ``n_members`` is the LOGICAL gang size (how many harvested nodes back the
    replica). Without ``tp`` the mesh is the one ``device`` the replica lives
    on, so byte accounting follows the gang while the layout clamps to the
    device that exists; ``device`` ``None`` is the card (raising without
    CUDA; pass ``device="cpu"``). With ``tp`` the mesh is the group's first
    ``min(n_members, tp.size)`` ranks and each holds its shard (see the
    module docstring); the group's devices place them. ``sharded``: the
    ``params`` given are already this rank's shards for a gang of every
    rank of ``tp``.
    """

    def __init__(self, cfg: ModelConfig, params: Any, n_members: int, *,
                 n_slots: int = 4, max_seq: int = 64,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, kv_mode: str = "migrate",
                 device: DeviceLike = None, tp=None, sharded: bool = False):
        tpar.tp_local(cfg, tp)   # an architecture tensor parallelism does not cover raises
        self.cfg = cfg
        self.n_members = int(n_members)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.tp = tp
        self._devices = None if tp is not None else [resolve_device(device)]
        self.protocol = MigrationProtocol(kv_mode)
        self.mesh = self._mesh(self.n_members)
        if sharded:
            if tp is None or self.mesh_size != tp.size:
                raise ValueError(f"sharded parameters need a gang over every rank of a group; "
                                 f"{self.n_members} members span {self.mesh_size} of "
                                 f"{tp and tp.size} ranks")
            pd = cfg.param_torch_dtype
            self._param_bytes = sum(math.prod(s.shape) * pd.itemsize
                                    for s in tree_leaves(param_specs(cfg)))
            self.params = tree_map(lambda t: t.to(tp.device), params)
        else:
            self._param_bytes = tree_bytes(params)
            self.params = reshard_in_place(params, cfg, self.mesh) if self.in_gang else None
        self.engine = None
        self.engine = self._fresh_engine() if self.in_gang else None
        self.migrations: List[MigrationRecord] = []
        self.last_resize: Optional[Dict[str, int]] = None

    def _mesh(self, n_members: int):
        """The mesh of a gang of ``n_members``: over a group, the ranks the
        config splits over (``tensor_parallel.gang_ranks``)."""
        if self.tp is None:
            return serving_mesh(n_members, self._devices)
        return serving_mesh(tpar.gang_ranks(self.cfg, n_members, self.tp), tp=self.tp)

    @property
    def in_gang(self) -> bool:
        """Whether this process holds a shard (always, without a group)."""
        return self.tp is None or self.mesh.tp is not None

    def _fresh_engine(self) -> ContinuousEngine:
        """A blank engine over the CURRENT params/mesh; the migration
        protocol transplants (or replays) decode state into it."""
        if self.tp is not None:
            return ContinuousEngine(self.cfg, self.params, n_slots=self.n_slots,
                                    max_seq=self.max_seq, eos_id=self.eos_id,
                                    temperature=self.temperature, seed=self.seed,
                                    tp=self.mesh.tp)
        params = (self.params if self.engine is None
                  else reshard_in_place(self.engine.params, self.cfg, self.mesh))
        return ContinuousEngine(self.cfg, params, n_slots=self.n_slots,
                                max_seq=self.max_seq, eos_id=self.eos_id,
                                temperature=self.temperature, seed=self.seed,
                                device=mesh_device(self.mesh))

    def _command(self, name: str, *args) -> None:
        """Rank 0 of a group sends a call to the other ranks (:meth:`follow`)."""
        if self.tp is not None and self.tp.size > 1:
            if self.tp.rank != 0:
                raise RuntimeError(f"{name}: rank {self.tp.rank} follows rank 0's calls")
            tpar.broadcast_object((name, args))

    def follow(self) -> None:
        """On a rank other than 0: run rank 0's calls on this rank's shards
        until rank 0 calls :meth:`close`."""
        while True:
            name, args = tpar.broadcast_object()
            if name == "close":
                return
            if name == "resize":
                self._resize(*args)
            elif self.engine is not None:
                getattr(self.engine, name)(*args)
                if name == "serve":   # rank 0's caller reads and clears its own
                    self.engine.batcher.finished.clear()

    def close(self) -> None:
        """End the other ranks' :meth:`follow` (rank 0 of a group)."""
        self._command("close")

    # --- elasticity -----------------------------------------------------------
    def resize(self, n_members: int) -> MigrationRecord:
        """Migrate to a gang of ``n_members`` mid-stream. In-flight decodes
        survive; at temperature 0 the ``migrate`` kv_mode resumes
        token-identically to an uninterrupted run."""
        assert n_members >= 1, n_members
        self._command("resize", n_members)
        return self._resize(n_members)

    def _resize(self, n_members: int) -> MigrationRecord:
        rec = self.protocol.migrate(self, n_members)
        self.migrations.append(rec)
        return rec

    def shrink(self, n: int = 1) -> MigrationRecord:
        """A member's window is closing: drop ``n`` members, keep serving."""
        return self.resize(self.n_members - n)

    def grow(self, n: int = 1) -> MigrationRecord:
        """New idle windows opened: spread the same replica wider."""
        return self.resize(self.n_members + n)

    # --- serving (delegation; sent to the other ranks of a group first) ------
    def add(self, req: GenRequest) -> None:
        self._command("add", req)
        self.engine.add(req)

    def step(self) -> int:
        self._command("step")
        return self.engine.step()

    def run(self) -> List[GenRequest]:
        self._command("run")
        return self.engine.run()

    def serve(self, gens: List[GenRequest]) -> Dict[int, float]:
        self._command("serve", gens)
        return self.engine.serve(gens)

    def drain(self) -> List[GenRequest]:
        self._command("drain")
        return self.engine.drain()

    @property
    def batcher(self):
        return self.engine.batcher

    @property
    def serving_engine(self):
        """What a caller drives as an engine: the engine itself, or on rank
        0 of a group a handle whose ``add``, ``step``, ``run``, ``serve`` and
        ``drain`` go through the replica (and so to every rank); everything
        else reads rank 0's engine."""
        if self.tp is None or self.tp.size == 1:
            return self.engine
        return _GroupEngine(self)

    # --- accounting -----------------------------------------------------------
    @property
    def param_bytes(self) -> int:
        """Bytes of the whole parameter tree (every shard together)."""
        return self._param_bytes

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


class _GroupEngine:
    """Rank 0's engine handle on a replica over a group (see
    :attr:`ElasticReplica.serving_engine`)."""

    def __init__(self, replica: ElasticReplica):
        self._replica = replica

    def __getattr__(self, name: str):
        if name in ("add", "step", "run", "serve", "drain"):
            return getattr(self._replica, name)
        return getattr(self._replica.engine, name)

"""Gang-scheduled elastic serving on the harvest platform.

A model too large for one harvested node is served by a *gang* of members
whose idle windows happen to be open at the same time. To the Controller the
gang is ONE logical invoker (:class:`ElasticGangInvoker`): it registers, owns
a topic, pulls requests, and reports ``sched_end`` as the MINIMUM remaining
lease across its members — so the deadline-aware router prices placements
against the first member due to leave, with zero router changes.

The members themselves are :class:`GangMember` pilot workers built by the
normal SlurmSim placement path through the ``invoker_factory`` seam. They
warm up like any invoker but never register; instead they report to the
:class:`GangPool`, which forms gangs of ``platform.gang_size`` concurrently
healthy members. A member's SIGTERM (window closing) fires the pre-exit
``on_sigterm`` hook at grace start, and the pool reacts inside that grace:

* ``migrate=True`` (default) — the gang resizes in place: parameters are
  re-sharded onto the survivors and the departing member's KV is handed off
  (``distributed.elastic_serving.MigrationProtocol`` when the executor is
  replica-backed; analytic ``model_bytes``/``kv_bytes`` accounting under the
  pure-sim executor). Serving never stops; only the mesh shrinks.
* ``migrate=False`` — the lose-whole-replica baseline: one member's eviction
  kills the gang. In-flight work is requeued or dies exactly like a plain
  invoker's SIGTERM, survivors return to the pool, and a future gang must
  pay ``form_warmup`` (the tensor-parallel model load) from scratch.

New healthy members first back-fill under-strength gangs (a *grow*
migration) and only then accumulate toward a fresh gang.

The port's copy of ``repro.platform.elastic``: every line of logic, RNG draw
and counter name is kept; the ``sharded-serving`` factory builds the port's
:class:`~repro_torch.distributed.elastic_serving.ElasticReplica` on
``device`` (``None``: the card) and builds the CUDA kernels before the first
request, as the other serving factories do.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, TYPE_CHECKING

import numpy as np

from repro_torch.core.invoker import Invoker
from repro_torch.platform.registry import register

if TYPE_CHECKING:
    from repro_torch.platform.runtime import Platform

_GANG_IDS = itertools.count()


class GangMember(Invoker):
    """A pilot worker owned by a gang pool: warms up like any invoker but
    reports readiness to the pool instead of registering with the controller
    — its gang is the controller-visible invoker."""

    def __init__(self, sim, controller, *, pool: "GangPool", **kw):
        self.pool = pool
        self.gang: Optional["ElasticGangInvoker"] = None
        super().__init__(sim, controller,
                         on_sigterm=pool._member_sigterm, **kw)

    def _become_healthy(self):
        if self.state != "warming":
            return
        self.state = "healthy"
        self.t_healthy = self.sim.now
        self.pool.member_ready(self)


class ElasticGangInvoker(Invoker):
    """The gang as one logical invoker. Lifecycle is driven entirely by its
    members: the base proactive-timeout event is cancelled (members carry
    their own), and ``sched_end`` is a live view of the weakest lease."""

    def __init__(self, sim, controller, *, members: List[GangMember],
                 rng, executor=None, grace: float = 180.0,
                 warmup: float = 0.0, **kw):
        self._members = list(members)
        self.gid = next(_GANG_IDS)
        super().__init__(sim, controller, node=members[0].node,
                         sched_end=sim.now, rng=rng, executor=executor,
                         grace=grace, warmup=warmup, **kw)
        for m in self._members:
            m.gang = self
        # member departures (which re-shard or kill the gang) are the only
        # deadline authority; the base self-timeout would SIGTERM the whole
        # gang the moment the weakest member's lease ran low
        self.sim.cancel(self._deadline_ev)

    @property
    def sched_end(self) -> float:
        """Minimum remaining lease across live members — what the deadline-
        aware router must price a placement against (any member's departure
        forces a resize or a loss)."""
        live = [m.sched_end for m in self._members
                if m.state in ("warming", "healthy")]
        return min(live) if live else self._sched_end_fallback

    @sched_end.setter
    def sched_end(self, value: float):
        # base __init__ (and nothing else) assigns this; keep it as the
        # memberless fallback so a dead gang still reports a finite lease
        self._sched_end_fallback = value

    @property
    def n_members(self) -> int:
        return len(self._members)

    def member_left(self, member: GangMember) -> int:
        """Drop a departing member; returns how many remain."""
        if member in self._members:
            self._members.remove(member)
        return len(self._members)

    def add_member(self, member: GangMember) -> int:
        self._members.append(member)
        member.gang = self
        return len(self._members)

    def release_members(self) -> List[GangMember]:
        """Detach every still-live member (gang death path); they return to
        the pool as free agents."""
        out = [m for m in self._members if m.state in ("warming", "healthy")]
        self._members = []
        for m in out:
            m.gang = None
        return out


class GangPool:
    """Forms gangs from ready members and reacts to membership churn.

    One pool per platform; it is the ``invoker_factory`` (via
    :meth:`spawn_member`) handed to SlurmSim, so every placed pilot job
    becomes a member. Metrics: per-gang ``gang_mesh_size`` gauges plus
    ``gang_migrations_total`` / ``gang_migrated_bytes_total`` / ``gang_wire_bytes_total``
    counters (labelled shrink/grow) and ``gang_replica_losses_total`` for the
    non-migrating baseline's deaths.
    """

    def __init__(self, platform: "Platform", *, gang_size: int = 2,
                 migrate: bool = True, form_warmup: float = 20.0,
                 model_bytes: float = 6e9, kv_bytes: float = 1e9,
                 min_members: int = 1, gang_concurrency: Optional[int] = None):
        if gang_size < 1:
            raise ValueError(f"gang_size={gang_size} must be >= 1")
        self.platform = platform
        self.sim = platform.sim
        self.controller = platform.controller
        self.metrics = platform.metrics
        self.executor = platform.executor
        # gangs draw (drain jitter) at event time; give each its own stream
        # keyed by formation order so tie reshuffles can't reassign draws
        self._gang_seed = int(platform.rng.integers(2 ** 31))
        self._n_formed = 0
        self.gang_size = gang_size
        self.migrate = migrate
        self.form_warmup = form_warmup      # tensor-parallel model-load cost
        self.model_bytes = float(model_bytes)   # analytic accounting (sim
        self.kv_bytes = float(kv_bytes)         # executor has no replica)
        self.min_members = min_members
        self.gang_concurrency = gang_concurrency
        self._ready: List[GangMember] = []
        self.gangs: List[ElasticGangInvoker] = []
        self.n_migrations = 0
        self.migrated_bytes = 0.0
        self.n_replica_losses = 0
        if self.metrics is not None:
            self.metrics.gauge("gangs_live", fn=lambda: len(
                [g for g in self.gangs
                 if g.state in ("warming", "healthy")]))
            self.metrics.gauge("gang_members_ready",
                               fn=lambda: len(self._ready))

    # --- SlurmSim seam --------------------------------------------------------
    def spawn_member(self, sim, controller, **kw) -> GangMember:
        """``invoker_factory`` entry: same signature as the Invoker
        constructor, returns a pool-managed member."""
        return GangMember(sim, controller, pool=self, **kw)

    # --- membership events ----------------------------------------------------
    def member_ready(self, member: GangMember):
        if self.migrate:
            for gang in self.gangs:
                if (gang.state in ("warming", "healthy")
                        and gang.n_members < self.gang_size):
                    n = gang.add_member(member)
                    self._account(gang, n - 1, n, "grow")
                    return
        self._ready.append(member)
        if len(self._ready) >= self.gang_size:
            members, self._ready = (self._ready[:self.gang_size],
                                    self._ready[self.gang_size:])
            self._form(members)

    def _form(self, members: List[GangMember]):
        kw = {}
        if self.gang_concurrency is not None:
            kw["concurrency"] = self.gang_concurrency
        gang = ElasticGangInvoker(
            self.sim, self.controller, members=members,
            rng=np.random.default_rng((self._gang_seed, self._n_formed)),
            executor=self.executor, grace=members[0].grace,
            warmup=self.form_warmup, **kw)
        self._n_formed += 1
        self.gangs.append(gang)
        if self.metrics is not None:
            self.metrics.gauge(
                "gang_mesh_size",
                fn=(lambda g=gang: g.n_members
                    if g.state in ("warming", "healthy") else 0),
                gang=f"g{gang.gid}")

    def _member_sigterm(self, member: GangMember, reason: str):
        """Pre-exit hook, fired at the member's grace start — the transfer
        window everything below must fit into."""
        if member in self._ready:
            self._ready.remove(member)
            return
        gang = member.gang
        member.gang = None
        if gang is None or gang.state in ("draining", "dead"):
            return
        n_before = gang.n_members
        n_after = gang.member_left(member)
        if n_after < self.min_members:
            # nobody left to migrate to: the gang dies like any invoker —
            # in-flight work requeues through the fast lane or rides out
            # the grace, exactly the Sec. III-C SIGTERM path
            gang.sigterm("gang-empty")
        elif self.migrate:
            self._account(gang, n_before, n_after, "shrink")
        else:
            # lose-whole-replica baseline: one eviction ends the gang;
            # survivors go back in the pool and a future gang re-pays the
            # model load (form_warmup)
            self.n_replica_losses += 1
            if self.metrics is not None:
                self.metrics.counter("gang_replica_losses_total").inc()
            survivors = gang.release_members()
            gang.sigterm("replica-lost")
            for m in survivors:
                self.member_ready(m)

    # --- migration accounting -------------------------------------------------
    def _account(self, gang: ElasticGangInvoker, n_before: int, n_after: int,
                 kind: str):
        """One mesh resize: run it (replica-backed executor) or cost it
        (analytic), and publish the gauges the benchmarks scrape."""
        hook = getattr(self.executor, "migrate_to", None)
        if hook is not None:
            rec = hook(n_after)
            moved, wire = rec.bytes_moved, rec.wire_bytes
        else:
            frac = abs(n_before - n_after) / max(n_before, n_after, 1)
            moved = wire = (self.model_bytes + self.kv_bytes) * frac
        self.n_migrations += 1
        self.migrated_bytes += moved
        if self.metrics is not None:
            self.metrics.counter("gang_migrations_total", kind=kind).inc()
            self.metrics.counter("gang_migrated_bytes_total", kind=kind).inc(moved)
            self.metrics.counter("gang_wire_bytes_total", kind=kind).inc(wire)


class ElasticServingExecutor:
    """Replica-backed gang executor (registry key ``sharded-serving``): the
    continuous-batching request path of ``BatchedServingExecutor`` over an
    :class:`~repro_torch.distributed.elastic_serving.replica.ElasticReplica`, plus
    the ``migrate_to`` hook the :class:`GangPool` drives on membership churn.

    Composition, not inheritance-with-a-frozen-engine: migration REPLACES the
    replica's engine, so every request-path attribute is delegated to an
    inner batched executor whose ``engine`` is re-pointed after each resize
    (parked partials and decoded-result state survive the swap).
    """

    def __init__(self, replica, **kw):
        from repro_torch.platform.executors import BatchedServingExecutor
        self.replica = replica
        self._inner = BatchedServingExecutor(replica.engine, **kw)
        # over a group, rank 0's handle that sends each call to every rank
        self._inner.engine = replica.serving_engine

    @property
    def engine(self):
        return self._inner.engine

    def run_batch(self, reqs):
        return self._inner.run_batch(reqs)

    def __call__(self, req):
        return self._inner(req)

    def note_preempt(self, req, elapsed: float, total: float):
        return self._inner.note_preempt(req, elapsed, total)

    def drain(self) -> int:
        return self._inner.drain()

    def migrate_to(self, n_after: int):
        """Resize the replica's gang mesh in place; returns the
        MigrationRecord the pool turns into counters."""
        rec = self.replica.resize(max(1, n_after))
        self._inner.engine = self.replica.serving_engine
        return rec


@register("executor", "sharded-serving")
def build_sharded_serving(platform: "Platform", *, arch: str = None,
                          max_seq: int = 64, init_seed: int = 0,
                          n_slots: int = 4, gang_size: Optional[int] = None,
                          kv_mode: str = "migrate", kernel_impls=None,
                          device=None, tp=None, **params) -> ElasticServingExecutor:
    """One tensor-parallel replica shared by the platform's gang (the
    shared-engine idiom: every invoker's pull lands on the same engine).
    ``gang_size`` defaults to the scenario's ``platform.gang_size``;
    ``arch``/``kernel_impls`` default to the scenario's ``platform.model`` /
    ``platform.kernel_impls`` model-zoo knobs. ``device`` (``None``: the
    card, raising without CUDA) places the smoke replica; its weights are
    the port's own random stream from ``init_seed``.

    ``tp``, a tensor-parallel group (``distributed.tensor_parallel``),
    spreads the replica over the group's ranks, each on its own device:
    every rank calls this factory with the same arguments. Rank 0 gets the
    executor and runs the platform; every other rank serves rank 0's calls
    here (``ElasticReplica.follow``) and returns None once rank 0 closes
    the replica (``executor.replica.close()``)."""
    import torch  # deferred: only real-serving scenarios pay this import

    from repro_torch.configs import get_config
    from repro_torch.configs.base import with_kernel_impls
    from repro_torch.device import resolve_device
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.models.model import init_params
    from repro_torch.platform.executors import (_KV_GAUGES, _scenario_model_knobs,
                                                _warm_up)
    dev = resolve_device(device) if tp is None else tp.device
    arch, kernel_impls = _scenario_model_knobs(platform, arch, kernel_impls)
    cfg = get_config(arch, smoke=True)
    if kernel_impls != "reference":
        cfg = with_kernel_impls(cfg, kernel_impls)
    model_params = init_params(
        cfg, torch.Generator(device=dev).manual_seed(init_seed), dev)
    if gang_size is None:
        sc = getattr(platform, "scenario", None)
        gang_size = getattr(getattr(sc, "platform", None), "gang_size",
                            None) or 2
    replica = ElasticReplica(cfg, model_params, max(gang_size, 1),
                             n_slots=n_slots, max_seq=max_seq,
                             kv_mode=kv_mode, device=dev, tp=tp)
    del model_params   # every rank keeps only its shard
    if tp is not None and tp.rank != 0:
        if dev.type == "cuda":
            from repro_torch.kernels.build import build_all
            build_all()
        replica.follow()
        return None
    ex = ElasticServingExecutor(replica, **params)
    _warm_up(ex.engine)
    if platform is not None and getattr(platform, "metrics", None) is not None:
        for key in _KV_GAUGES:
            platform.metrics.gauge(
                f"kv_{key}", fn=(lambda k=key: ex.engine.kv_stats()[k]),
                layout="dense")
        platform.metrics.gauge("replica_mesh_size",
                               fn=lambda: replica.mesh_size)
        platform.metrics.gauge("replica_members",
                               fn=lambda: replica.n_members)
        platform.metrics.gauge("replica_migrations",
                               fn=lambda: len(replica.migrations))
        platform.metrics.gauge("replica_migrated_bytes",
                               fn=lambda: replica.migrated_bytes)
    return ex


__all__ = ["GangMember", "ElasticGangInvoker", "GangPool",
           "ElasticServingExecutor", "build_sharded_serving"]

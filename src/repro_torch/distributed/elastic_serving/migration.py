"""Live shard + KV migration for an elastic serving gang — the port of
``repro.distributed.elastic_serving.migration``.

When a member's idle window closes, its SIGTERM grace is the transfer budget:
the gang drains the in-flight decode wave, reshards the full parameter set
onto the surviving members (``elastic.reshard_in_place`` — no checkpoint
round-trip), hands off the departing node's KV so no context is lost, and
resumes. Three KV hand-off modes:

``replay``        — drop the KV and re-prefill each live request's context
                    (prompt + generated-so-far) on the new mesh. Zero KV
                    wire bytes, but the survivors re-pay prefill compute.
``migrate``       — move the cache tensors through host memory exactly; the
                    resumed decode continues from the same numeric state, so
                    temperature-0 streams are token-identical to an
                    uninterrupted run.
``migrate_int8``  — same hand-off with per-tensor int8 quantisation on the
                    wire (``compression.quantize``): ~4x fewer KV bytes vs
                    fp32 (~2x vs bf16) at a bounded dequantisation error.

Byte accounting is per-LOGICAL-member: a gang of k owns 1/k of params and KV
per member regardless of how many devices back the mesh.

The wire is host tensors, not numpy arrays (numpy has no bfloat16), and
every wire leaf is a copy: ``.cpu()`` of a CPU tensor is the tensor itself,
which would leave the transplanted cache sharing storage with the old
engine's. The sampling stream crosses the resize as the engine's
``torch.Generator`` object.

Over a tensor-parallel group (a replica built with ``tp``) the resize is
physical inside a fixed world of ranks, the active gang being the first
``min(n, world)`` of them. It goes leaf by leaf, so no rank ever holds the
whole tree: every rank first makes the new gang's subgroup and takes rank
0's decode state and the skeleton (each whole leaf's shape, from the
config, and dtype); then, for each parameter leaf and then each cache leaf
in a fixed order, and for a stacked leaf one layer at a time, the old gang
gathers the piece whole (``sharding.gather_shards``), the ranks of both
gangs cut their new shard of it and rank 0 sends each joining rank its
own (a broadcast over the new gang), and the whole piece is dropped before
the next; an old rank lets go of each old leaf once it is moved. A rank's
peak is its old shards, its new shards and one whole layer of one leaf.
The leaving ranks end holding nothing; the joining ranks adopt rank 0's
decode state. ``migrate_int8`` rounds each cache piece through the wire
format at the scale of its whole leaf (the largest magnitude over the old
gang), so the codes are those of the whole cache's rounding, as ``repro``
rounds its global cache. The :class:`MigrationRecord` keeps ``repro``'s
logical accounting (its bytes equal ``repro``'s records); the bytes that
crossed the group are the replica's ``last_resize``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, List

import torch

from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.distributed.compression import dequantize, quantize
from repro_torch.distributed.elastic_serving.mesh import tree_bytes
from repro_torch.distributed.sharding import (gather_shards, local_shard, map_with_names,
                                             tp_split)
from repro_torch.models.model import cache_spec, params_meta, tree_leaves, tree_map
from repro_torch.models.transformer import segments_for

KV_MODES = ("replay", "migrate", "migrate_int8")


@dataclasses.dataclass
class MigrationRecord:
    """One mesh resize: what moved, how, and what it cost."""
    n_before: int               # logical gang size before the resize
    n_after: int
    kv_mode: str
    param_bytes: int            # departing/arriving members' param shards
    kv_bytes: int               # departing/arriving members' KV shards
    wire_bytes: int             # actually pushed (int8 shrinks the KV term)
    n_requests_live: int        # in-flight decodes carried across
    wall_s: float               # real seconds the resize took

    @property
    def bytes_moved(self) -> int:
        return self.param_bytes + self.kv_bytes


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _to_host(tree: Any) -> Any:
    """Pull a device tree through host memory — the migration wire."""
    return tree_map(_host_copy, tree)


def _through_int8(tree: Any) -> Any:
    """Round each floating leaf through the int8 wire format (integer leaves
    — none in a KV cache today — pass through untouched)."""
    def one(leaf):
        if not leaf.is_floating_point():
            return _host_copy(leaf)
        q, scale = quantize(leaf)
        return dequantize(_host_copy(q), _host_copy(scale)).to(leaf.dtype)
    return tree_map(one, tree)


def int8_wire_bytes(tree: Any) -> int:
    """Bytes of ``tree`` in the int8 wire format: one byte per element of
    every floating leaf plus a 4-byte scale sideband per leaf."""
    total = 0
    for leaf in tree_leaves(tree):
        if leaf.is_floating_point():
            total += leaf.numel() + 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total


class MigrationProtocol:
    """Orchestrates one mesh resize of an :class:`ElasticReplica`.

    The replica owns policy (when to shrink/grow, member bookkeeping); the
    protocol owns mechanism: pause, account, reshard, hand off, resume. It is
    deliberately stateless between calls so one protocol instance can serve
    every gang in a fleet.
    """

    def __init__(self, kv_mode: str = "migrate"):
        assert kv_mode in KV_MODES, kv_mode
        self.kv_mode = kv_mode

    def migrate(self, replica, n_after: int) -> MigrationRecord:
        if replica.tp is not None:
            return self._migrate_group(replica, n_after)
        from repro_torch.distributed.elastic import reshard_in_place
        from repro_torch.distributed.elastic_serving.mesh import serving_mesh
        t0 = time.perf_counter()
        engine = replica.engine
        n_before = replica.n_members
        moved = abs(n_before - n_after)
        frac = moved / max(n_before, n_after, 1)

        # --- pause: snapshot the live decode state -------------------------
        finished = list(engine.batcher.finished)
        live: List = [r for r in engine.batcher.active().values()]
        waiting = list(engine.batcher.waiting)
        slots = list(engine.batcher.slots)
        positions = engine.positions.copy()
        last_tok = engine.last_tok.copy()
        rng = engine._gen
        counters = (engine.n_decode_steps, engine.n_emitted,
                    engine.n_slot_steps, engine.prefill_tokens)

        param_total = tree_bytes(replica.params)
        kv_total = tree_bytes(engine.cache)
        param_bytes = int(param_total * frac)
        kv_bytes = int(kv_total * frac)

        # --- hand off the KV through the wire ------------------------------
        if self.kv_mode == "replay":
            cache_wire = None
            kv_wire = 0
        elif self.kv_mode == "migrate":
            cache_wire = _to_host(engine.cache)
            kv_wire = kv_bytes
        else:                                   # migrate_int8
            cache_wire = _through_int8(engine.cache)
            kv_wire = int(int8_wire_bytes(engine.cache) * frac)

        # --- reshard params onto the surviving mesh (resize in place) ------
        new_mesh = serving_mesh(n_after, replica._devices)
        replica.params = reshard_in_place(replica.params, replica.cfg,
                                          new_mesh)
        replica.mesh = new_mesh
        replica.n_members = n_after

        # --- resume --------------------------------------------------------
        new_engine = replica._fresh_engine()
        if cache_wire is None:
            # replay: finished streams survive; every unfinished request
            # re-prefills its context (prompt + partial) on the new mesh
            new_engine.batcher.finished = finished
            for req in engine.drain():
                new_engine.add(req)
        else:
            # transplant: same numeric decode state, new parameter layout
            new_engine.cache = tree_map(
                lambda z, c: c.to(device=z.device, dtype=z.dtype),
                new_engine.cache, cache_wire)
            new_engine.batcher.finished = finished
            new_engine.batcher.slots = slots
            new_engine.batcher.waiting = waiting
            new_engine.positions = positions
            new_engine.last_tok = last_tok
            new_engine._gen = rng
        (new_engine.n_decode_steps, new_engine.n_emitted,
         new_engine.n_slot_steps, new_engine.prefill_tokens) = counters
        replica.engine = new_engine
        return MigrationRecord(
            n_before=n_before, n_after=n_after, kv_mode=self.kv_mode,
            param_bytes=param_bytes, kv_bytes=kv_bytes,
            wire_bytes=param_bytes + kv_wire,
            n_requests_live=len(live) + len(waiting),
            wall_s=time.perf_counter() - t0)

    def _migrate_group(self, replica, n_after: int) -> MigrationRecord:
        """The physical resize of a replica over a tensor-parallel group;
        every rank of the world calls it (see the module docstring)."""
        t0 = time.perf_counter()
        cfg, world = replica.cfg, replica.tp
        old_tp, engine, first_joiner = replica.mesh.tp, replica.engine, replica.mesh_size
        n_before = replica.n_members
        frac = abs(n_before - n_after) / max(n_before, n_after, 1)
        spec = cache_spec(cfg, replica.n_slots, replica.max_seq)   # the whole cache
        param_bytes = int(replica.param_bytes * frac)
        kv_bytes = int(tree_bytes(spec) * frac)
        kv_wire = {"replay": 0, "migrate": kv_bytes,
                   "migrate_int8": int(int8_wire_bytes(spec) * frac)}[self.kv_mode]
        transplant = self.kv_mode != "replay"

        # --- pause: the old gang snapshots its (equal) decode state and lets
        # go of its engine, keeping its shards until each is moved
        state, old, gathered, rng = None, (None, None), 0, None
        if engine is not None:
            b = engine.batcher
            state = {"finished": list(b.finished), "live": len(b.active()) + len(b.waiting),
                     "counters": (engine.n_decode_steps, engine.n_emitted,
                                  engine.n_slot_steps, engine.prefill_tokens)}
            if transplant:
                state.update(slots=list(b.slots), waiting=list(b.waiting),
                             positions=engine.positions.copy(), last_tok=engine.last_tok.copy(),
                             gen_state=engine._gen.get_state())
            else:
                state["replay"] = engine.drain()
            old = (replica.params, engine.cache if transplant else None)
            gathered = (old_tp.size - 1) * sum(_split_bytes(t, cfg, old_tp.size, c)
                                               for t, c in zip(old, (False, True)) if t)
            rng = engine._gen
            # a caller's hook may keep the old engine alive: its references go
            # now, so each old leaf is freed once it is moved
            engine.params = engine.cache = None
        replica.engine = replica.params = engine = None

        # --- the new gang: every rank makes the subgroup; rank 0's state and
        # the skeleton (each whole leaf's shape, from the config, and dtype)
        # go to every rank, for the ones that join
        new_mesh = replica._mesh(n_after)
        new_tp = new_mesh.tp
        shipped = None
        if world.rank == 0:
            shipped = dict(state, skeleton=tuple(
                None if t is None else map_with_names(
                    lambda n, x, w=w: (tuple(_at(w, n).shape), x.dtype), t)
                for t, w in zip(old, (params_meta(cfg), spec))))
        shipped = tpar.broadcast_object(shipped)
        was_out = state is None   # this rank held no shard before the resize
        if was_out:
            state = shipped
        replica.mesh, replica.n_members = new_mesh, n_after
        params_skel, cache_skel = shipped["skeleton"]

        # --- the parameters, leaf by leaf, then the cache into the new
        # engine's own
        mover = _LeafMover(cfg, old_tp, new_tp, first_joiner)
        new_params = mover.tree(old[0], params_skel, cache=False)
        old = (None, old[1])
        if new_tp is not None:
            replica.params = new_params
            new_engine = replica._fresh_engine()
        if cache_skel is not None:
            mover.tree(old[1], cache_skel, cache=True, int8=self.kv_mode == "migrate_int8",
                       into=new_engine.cache if new_tp is not None else None)
        old = None
        if new_tp is not None:
            new_engine.batcher.finished = state["finished"]
            if transplant:
                new_engine.batcher.slots = state["slots"]
                new_engine.batcher.waiting = state["waiting"]
                new_engine.positions = state["positions"]
                new_engine.last_tok = state["last_tok"]
                if was_out:
                    new_engine._gen.set_state(state["gen_state"])
                else:
                    new_engine._gen = rng
            else:
                for req in state["replay"]:
                    new_engine.add(req)
            (new_engine.n_decode_steps, new_engine.n_emitted,
             new_engine.n_slot_steps, new_engine.prefill_tokens) = state["counters"]
            replica.engine = new_engine
        replica.last_resize = {"gathered_bytes": gathered, "shipped_bytes": mover.shipped}
        return MigrationRecord(
            n_before=n_before, n_after=n_after, kv_mode=self.kv_mode,
            param_bytes=param_bytes, kv_bytes=kv_bytes, wire_bytes=param_bytes + kv_wire,
            n_requests_live=state["live"], wall_s=time.perf_counter() - t0)


def _split_bytes(tree: Any, cfg, size: int, cache: bool) -> int:
    """Bytes of the leaves of ``tree`` that are split over ``size`` ranks."""
    return sum(tree_leaves(map_with_names(
        lambda n, t: t.numel() * t.element_size() if tp_split(n, cfg, size, cache) else 0,
        tree)))


def _at(tree: Any, names) -> Any:
    for k in names:
        tree = tree[k]
    return tree


def _stacked_axes(names, cfg, cache: bool) -> int:
    """How many leading axes of the leaf at ``names`` stack layers: one for
    a segment's leaves, two for a hybrid group's mamba leaves (groups, then
    the mamba layers of a group) and its cache's ``state`` and ``conv``,
    none for the hybrid's shared block and the leaves outside the stack."""
    path = tuple(names) if cache else tuple(names[1:]) if names[0] == "stack" else ()
    if not path:
        return 0
    kind = {seg.name: seg.kind for seg in segments_for(cfg)}[path[0]]
    if kind != "hybrid_group":
        return 1
    if cache:
        return 2 if path[-1] in ("state", "conv") else 1
    return 2 if path[1] == "mamba" else 0


class _LeafMover:
    """Moves trees leaf by leaf (a stacked leaf layer by layer) from the
    old gang's shards to the new gang's (see the module docstring), and
    counts the bytes rank 0 ships to the joining ranks."""

    def __init__(self, cfg, old_tp, new_tp, first_joiner: int):
        self.cfg, self.old_tp, self.new_tp = cfg, old_tp, new_tp
        self.first_joiner, self.shipped = first_joiner, 0

    def tree(self, old: Any, skeleton: Any, cache: bool, int8: bool = False,
             into: Any = None) -> Any:
        """This rank's new shards of ``skeleton``'s leaves (None off the new
        gang), written into ``into``'s leaves where given. ``old`` (None off
        the old gang) loses each leaf once it is moved."""
        return map_with_names(lambda names, meta: self.leaf(old, names, meta, cache, int8, into),
                              skeleton)

    def leaf(self, old, names, meta, cache: bool, int8: bool, into) -> Any:
        cfg, old_tp, new_tp = self.cfg, self.old_tp, self.new_tp
        shape, dtype = meta
        local = None
        if old is not None:
            parent = _at(old, names[:-1])
            local, parent[names[-1]] = parent[names[-1]], None
        mine = None
        if new_tp is not None:
            mine = (_at(into, names) if into is not None else torch.empty(
                local_shard(torch.empty(shape, device="meta"), names, cfg, new_tp, cache).shape,
                dtype=dtype, device=new_tp.device))
        amax = None
        if int8 and local is not None:
            amax = tpar.all_max(local.abs().amax().float(), old_tp)
        lead = shape[:_stacked_axes(names, cfg, cache)]
        for idx in itertools.product(*map(range, lead)):
            whole = None
            if local is not None:
                whole = gather_shards(local[idx], names, cfg, old_tp, cache)
                if amax is not None:
                    q, scale = quantize(whole, amax)
                    whole = dequantize(q, scale).to(whole.dtype)
            dst = None if mine is None else mine[idx]
            if dst is not None and whole is not None:
                dst.copy_(local_shard(whole, names, cfg, new_tp, cache))
            for j in range(self.first_joiner, 0 if new_tp is None else new_tp.size):
                if new_tp.rank == 0:
                    buf = local_shard(whole, names, cfg, new_tp, cache, rank=j).contiguous()
                elif new_tp.rank == j:
                    buf = dst if dst.is_contiguous() else torch.empty_like(dst)
                else:
                    like = local_shard(torch.empty(shape[len(lead):], dtype=dtype, device="meta"),
                                       names, cfg, new_tp, cache, rank=j)
                    buf = torch.empty(like.shape, dtype=dtype, device=new_tp.device)
                tpar.broadcast_(buf, new_tp, src=0)
                self.shipped += buf.numel() * buf.element_size()
                if new_tp.rank == j and buf is not dst:
                    dst.copy_(buf)
                del buf
            del whole, dst
        return mine

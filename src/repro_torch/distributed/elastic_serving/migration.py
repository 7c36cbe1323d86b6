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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List

import torch

from repro_torch.distributed.compression import dequantize, quantize
from repro_torch.distributed.elastic_serving.mesh import tree_bytes
from repro_torch.models.model import tree_leaves, tree_map

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

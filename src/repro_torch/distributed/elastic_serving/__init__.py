"""Elastic sharded serving over harvested multi-node idle windows — the port
of ``repro.distributed.elastic_serving``.

A model too big for any single invoker is served tensor-parallel across a
*gang* of concurrently-idle nodes, and survives window churn by migrating
shards instead of losing the whole replica:

:mod:`mesh`       — gang mesh construction and per-member byte accounting
                    (what a departing node must hand off); how N members
                    share one card.
:mod:`replica`    — :class:`ElasticReplica`: the gang-owned serving engine,
                    params laid out by ``distributed.sharding`` rules, with
                    ``shrink``/``grow`` mesh resizes mid-stream.
:mod:`migration`  — :class:`MigrationProtocol`: drain -> reshard params in
                    place -> hand off the departing member's KV (optionally
                    int8-compressed on the wire) -> resume token-identically.

The platform-side gang lifecycle (members as invokers, the controller seeing
one logical invoker, SIGTERM-driven migration) lives in
``repro_torch.platform.elastic``; this package imports no simulation layer.
``repro``'s ``ensure_host_devices`` (an XLA flag) has no torch counterpart.
"""
from repro_torch.distributed.elastic_serving.mesh import (available_gang_devices,
                                                          member_shard_bytes,
                                                          serving_mesh)
from repro_torch.distributed.elastic_serving.migration import (MigrationProtocol,
                                                               MigrationRecord)
from repro_torch.distributed.elastic_serving.replica import ElasticReplica

__all__ = ["ElasticReplica", "MigrationProtocol", "MigrationRecord",
           "serving_mesh", "member_shard_bytes", "available_gang_devices"]

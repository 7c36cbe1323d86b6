"""Placement routers for the modified-OpenWhisk controller.

The controller owns the *mechanism* of routing (topics, health states, the
fast lane); a router owns the *policy* — which healthy invoker a request's
topic message lands on. Three policies ship:

  - :class:`HashRouter`      — OpenWhisk's home-invoker hashing with overload
                               stepping; bit-identical to the pre-seam
                               controller (and to the paper's behaviour).
  - :class:`LeastLoadedRouter` — global shortest-queue (topic backlog plus
                               in-flight containers); better tail latency
                               under bursts at the cost of warm-container
                               locality.
  - :class:`LocalityRouter`  — per-function warm affinity: stick each
                               function to the invoker that last ran it while
                               it stays healthy and un-backlogged, falling
                               back to least-loaded; fewer cold starts than
                               pure least-loaded, better spread than hashing.
  - :class:`DeadlineAwareRouter` — rFaaS-style lease awareness: filter out
                               invokers whose remaining scheduled lifetime
                               (``sched_end - now``) is too short to finish
                               the request before the drain/SIGKILL window,
                               then place least-loaded among the survivors.

Routers are deliberately free of controller internals beyond the read-only
surface (``healthy_order``, ``topics``, ``invokers``,
``queue_depth_soft_limit``) so new policies are one registered class — see
``repro_torch.platform.routers``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from repro_torch.core.controller import Controller
    from repro_torch.core.invoker import Invoker
    from repro_torch.core.queues import Request


def _fn_hash(fn: str) -> int:
    return int.from_bytes(hashlib.sha1(fn.encode()).digest()[:4], "big")


class BaseRouter:
    """No-op lifecycle hooks shared by the bundled routers."""

    def on_register(self, inv: "Invoker") -> None:
        pass

    def on_deregister(self, inv: "Invoker") -> None:
        pass

    def route(self, req: "Request", ctrl: "Controller") -> Optional[int]:
        raise NotImplementedError


class HashRouter(BaseRouter):
    """OpenWhisk-style: hash the function name to a home invoker, step
    forward past invokers whose topic backlog exceeds the soft limit, and
    fall back to the home invoker when everyone is overloaded."""

    def route(self, req: "Request", ctrl: "Controller") -> Optional[int]:
        order = ctrl.healthy_order
        n = len(order)
        if n == 0:
            return None
        start = _fn_hash(req.fn) % n
        for step in range(n):
            cand = order[(start + step) % n]
            if len(ctrl.topics[cand]) < ctrl.queue_depth_soft_limit:
                return cand
        return order[start]


def _load(ctrl: "Controller", inv_id: int) -> int:
    return len(ctrl.topics[inv_id]) + len(ctrl.invokers[inv_id].running)


class LeastLoadedRouter(BaseRouter):
    """Send every request to the healthy invoker with the smallest combined
    backlog (queued topic messages + running containers); ties break on the
    lowest invoker id for determinism."""

    def route(self, req: "Request", ctrl: "Controller") -> Optional[int]:
        order = ctrl.healthy_order
        if not order:
            return None
        return min(order, key=lambda i: (_load(ctrl, i), i))


class LocalityRouter(BaseRouter):
    """Warm-affinity routing: each function sticks to the invoker that last
    ran it (its containers are warm there) for as long as that invoker stays
    healthy and its backlog is shallow; past ``overflow_depth`` queued
    messages the function spills to the least-loaded invoker *without*
    re-homing (the burst drains, the warm home remains).

    Unlike hashing, affinities survive invoker churn: when the healthy set
    changes, only functions homed on the departed invoker re-home — a hash
    router re-maps every function whenever ``len(healthy)`` changes."""

    def __init__(self, overflow_depth: int = 4):
        self.overflow_depth = overflow_depth
        self.affinity: Dict[str, int] = {}

    def route(self, req: "Request", ctrl: "Controller") -> Optional[int]:
        order = ctrl.healthy_order
        if not order:
            return None
        aff = self.affinity.get(req.fn)
        if (aff is not None and aff in ctrl.invokers
                and ctrl.invokers[aff].state == "healthy"):
            if len(ctrl.topics[aff]) < self.overflow_depth:
                return aff
            return min(order, key=lambda i: (_load(ctrl, i), i))  # spill
        chosen = min(order, key=lambda i: (_load(ctrl, i), i))
        self.affinity[req.fn] = chosen
        return chosen

    def on_deregister(self, inv: "Invoker") -> None:
        self.affinity = {fn: i for fn, i in self.affinity.items()
                         if i != inv.id}


class DeadlineAwareRouter(BaseRouter):
    """Lease-aware placement for ephemeral pilot workers (cf. rFaaS): an
    invoker is *eligible* for a request only when its remaining scheduled
    lifetime covers the request's expected occupancy — dispatch overhead, a
    cold start if the function is not warm there, the nominal execution time
    (scaled by ``runtime_factor`` for heavy-tailed workloads), the invoker's
    own drain margin, and an extra safety ``margin``. Among eligible invokers
    the least-loaded wins (ties on the lowest id).

    When *no* invoker can finish the request before its kill deadline, the
    one with the longest remaining lease is chosen: the attempt makes the
    most progress before the preemption boundary, which matters once the
    reliability layer retries or the SIGTERM hand-off restarts it."""

    def __init__(self, margin: float = 0.0, runtime_factor: float = 1.0,
                 queue_penalty_s: float = 0.0):
        self.margin = margin
        self.runtime_factor = runtime_factor
        # optional: bill each already-queued message as this many seconds of
        # delay before the request would even start executing
        self.queue_penalty_s = queue_penalty_s

    def _expected_occupancy(self, req: "Request", inv: "Invoker",
                            backlog: int) -> float:
        cold = 0.0 if req.fn in inv.warm_fns else inv.cold_start
        return (inv.overhead + cold + req.exec_time * self.runtime_factor
                + backlog * self.queue_penalty_s)

    def route(self, req: "Request", ctrl: "Controller") -> Optional[int]:
        order = ctrl.healthy_order
        if not order:
            return None
        now = ctrl.sim.now
        best_key, best = None, None
        for i in order:
            inv = ctrl.invokers[i]
            backlog = len(ctrl.topics[i])
            lease = inv.sched_end - now
            need = (self._expected_occupancy(req, inv, backlog)
                    + inv.drain_margin + self.margin)
            if lease < need:
                continue
            key = (_load(ctrl, i), i)
            if best_key is None or key < best_key:
                best_key, best = key, i
        if best is not None:
            return best
        return max(order, key=lambda i: (ctrl.invokers[i].sched_end, -i))

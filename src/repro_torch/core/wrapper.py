"""Client-side wrapper for FaaS calls with unknown cluster availability —
paper Alg. 1, verbatim control flow: after any 503, route to the commercial
cloud for the next 60 seconds, then try the cluster again."""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.controller import Controller
from repro_torch.core.events import Simulator
from repro_torch.core.queues import Request


class CommercialBackend:
    """Simulated commercial FaaS (AWS-Lambda-like): always available, fixed
    platform overhead, optional per-function slowdown factor (Fig. 7: the HPC
    node is ~15% faster on compute-bound functions, i.e. factor ~1.176)."""

    def __init__(self, sim: Simulator, overhead: float = 0.35,
                 slowdown: float = 1.176):
        self.sim = sim
        self.overhead = overhead
        self.slowdown = slowdown
        self.executed = []

    def execute(self, req: Request, on_done: Optional[Callable] = None):
        dur = self.overhead + req.exec_time * self.slowdown
        def _done():
            req.outcome = "success"
            req.t_completed = self.sim.now
            self.executed.append(req)
            if on_done:
                on_done(req)
        self.sim.after(dur, _done)


class FaaSWrapper:
    """Alg. 1. ``submit`` returns "cluster" or "commercial" (routing chosen)."""

    def __init__(self, sim: Simulator, controller: Controller,
                 commercial: CommercialBackend, cooloff: float = 60.0):
        self.sim = sim
        self.controller = controller
        self.commercial = commercial
        self.cooloff = cooloff
        self.last_503 = -1e18
        self.n_cluster = 0
        self.n_commercial = 0

    def submit(self, req: Request) -> str:
        if self.sim.now - self.last_503 <= self.cooloff:
            self.n_commercial += 1
            self.commercial.execute(req)
            return "commercial"
        ok = self.controller.submit(req)
        if ok:
            self.n_cluster += 1
            return "cluster"
        # 503: remember and retry on the commercial cloud (recursion in Alg. 1)
        self.last_503 = self.sim.now
        self.n_commercial += 1
        retry = Request(fn=req.fn, exec_time=req.exec_time, arrival=req.arrival,
                        timeout=req.timeout, interruptible=req.interruptible,
                        tenant=req.tenant, slo_class=req.slo_class)
        retry.attempts = req.attempts + 1
        self.commercial.execute(retry)
        return "commercial"

"""Demand-adaptive pilot-job supply (closed loop).

The paper's ``JobManager`` is open-loop: always 10 queued jobs per fib
length, regardless of what the FaaS side observes (Sec. III-D-b). The
:class:`AdaptiveJobManager` closes the loop using three signals:

  - **503 delta** per tick — requests arriving while no invoker is healthy
    are the direct cost of under-supply;
  - **queue depth vs healthy capacity** — a leading indicator of saturation
    before requests start timing out;
  - **recent idle-window lengths** from ``SlurmSim.recent_window_lengths`` —
    the supply mix should track what the cluster is actually giving out (a
    90-minute pilot queued against a stream of 2-minute windows is wasted
    queue budget).

Under pressure it scales the per-length targets up and submits with
``expedite=True`` (Slurm runs its quick scheduler on submission), cutting the
window-open -> placement delay from a full backfill period to ~1 s exactly
when demand is being shed. In quiet periods it decays supply toward a floor,
keeping every fib length stocked (coverage safety) while shrinking queue
pressure on the prime scheduler. Lease-style acquisition as in rFaaS, driven
by demand instead of a static bag.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import PilotJob, SlurmSim
from repro_torch.core.controller import Controller
from repro_torch.core.events import Simulator
from repro_torch.core.pilot import FIB_LENGTHS_MIN
from repro_torch.faas.metrics import MetricsRegistry


class AdaptiveJobManager:
    def __init__(self, sim: Simulator, slurm: SlurmSim,
                 controller: Controller, *,
                 lengths_min: Sequence[int] = FIB_LENGTHS_MIN,
                 base_per_length: int = 10, min_per_length: int = 2,
                 max_queued: int = 100, interval: float = 5.0,
                 scale_min: float = 0.6, scale_max: float = 2.0,
                 horizon: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 autostart: bool = True):
        self.sim = sim
        self.slurm = slurm
        self.controller = controller
        self.lengths_s = [m * 60.0 for m in lengths_min]
        self.base_per_length = base_per_length
        self.min_per_length = min_per_length
        self.max_queued = max_queued
        self.interval = interval
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.horizon = horizon
        self.metrics = metrics
        self.scale = 1.0
        self.n_created = 0
        self.n_cancelled = 0
        self._last_503 = 0
        self._pressure_ticks = 0
        if metrics is not None:
            self._g_scale = metrics.gauge("pilot_supply_scale")
            self._c_sub = metrics.counter("pilot_jobs_submitted_total",
                                          manager="adaptive")
            self._c_cancel = metrics.counter("pilot_jobs_cancelled_total",
                                             manager="adaptive")
        self._started = False
        if autostart:
            self.start()

    def start(self):
        """Begin the control loop on the sim clock (Scaler seam; idempotent)."""
        if self._started:
            return
        self._started = True
        # reprolint: disable=RPL601 -- same benignity as JobManager._replenish: control-loop ticks tied with passes shift pilot submissions by at most one pass over warming invokers, nothing request-visible — fuzz-invariant
        self.sim.at(self.sim.now, self._tick)

    # --- observation --------------------------------------------------------
    def _observe(self):
        # only capacity 503s count as demand pressure — admission-control
        # throttles are deliberate policy shedding, not under-supply
        rejected = self.controller.rejected_503
        d503 = sum(1 for r in rejected[self._last_503:]
                   if r.reject_reason == "no_invoker")
        self._last_503 = len(rejected)
        qdepth = sum(len(t) for t in self.controller.topics.values())
        qdepth += len(self.controller.fast_lane)
        healthy = self.controller.healthy_count()
        return d503, qdepth, healthy

    def _window_weights(self) -> Dict[float, float]:
        """Per-length demand weight from the recent idle-window distribution:
        the weight of length L tracks the share of recent windows a job of
        length L could still fit into, floored at 0.5 — running out of a
        length entirely forces shorter substitutes whose chain boundaries
        open warm-up gaps."""
        recent = list(self.slurm.recent_window_lengths)
        if len(recent) < 8:                 # not enough evidence yet
            return {ell: 1.0 for ell in self.lengths_s}
        arr = np.array(recent)
        return {ell: 0.5 + 0.5 * float(np.mean(arr >= ell))
                for ell in self.lengths_s}

    # --- control loop -------------------------------------------------------
    def _tick(self):
        d503, qdepth, healthy = self._observe()
        pressure = d503 > 0 or qdepth > 8 * max(healthy, 1)
        if pressure:
            self._pressure_ticks = min(self._pressure_ticks + 1, 12)
            self.scale = min(self.scale_max, max(self.scale, 1.0) * 1.4)
        else:
            self._pressure_ticks = max(self._pressure_ticks - 1, 0)
            if self._pressure_ticks == 0:
                # gentle decay (halves in ~6 min of quiet) — scale-down churn
                # is cheap queue bookkeeping, scale-up lag costs 503s
                self.scale = max(self.scale_min, self.scale * 0.99)
        self._reconcile(expedite=pressure)
        if self.metrics is not None:
            self._g_scale.set(self.scale)
        if self.horizon is None or self.sim.now < self.horizon:
            self.sim.after(self.interval, self._tick)

    def _targets(self) -> Dict[float, int]:
        w = self._window_weights()
        raw = {ell: max(self.min_per_length,
                        int(round(self.base_per_length * self.scale * w[ell])))
               for ell in self.lengths_s}
        # respect the global queue cap, shedding longest-first (long jobs are
        # the least likely to fit the windows that motivated the cap)
        total = sum(raw.values())
        for ell in sorted(raw, reverse=True):
            if total <= self.max_queued:
                break
            give = min(raw[ell] - self.min_per_length, total - self.max_queued)
            raw[ell] -= give
            total -= give
        return raw

    def _reconcile(self, expedite: bool):
        targets = self._targets()
        counts = self.slurm.queued_counts()
        new: List[PilotJob] = []
        surplus: List[PilotJob] = []
        for ell, want in targets.items():
            have = counts.get(ell, 0)
            if have < want:
                new.extend(PilotJob(length_s=ell) for _ in range(want - have))
            elif have > want:
                # cancel the oldest queued jobs of this length (FIFO head);
                # the bucketed queue iterates one length without a full scan
                drop = have - want
                for j in self.slurm.iter_queued(ell):
                    surplus.append(j)
                    drop -= 1
                    if drop == 0:
                        break
        if surplus:
            self.n_cancelled += self.slurm.cancel_queued(surplus)
            if self.metrics is not None:
                self._c_cancel.inc(len(surplus))
        if new:
            self.n_created += len(new)
            self.slurm.submit_jobs(new, expedite=expedite)
            if self.metrics is not None:
                self._c_sub.inc(len(new))
        elif expedite:
            # demand pressure with a full queue: still worth an immediate
            # quick-scheduler pass to fill any window opened since the last one
            self.slurm.submit_jobs([], expedite=True)

"""Pilot-job supply managers (paper Sec. III-D-b): *fib* keeps 10 queued jobs
of each fixed length; *var* keeps a bag of 100 flexible-length jobs. Both
replenish every 15 s, never exceed 100 queued jobs, and only create new jobs
to replace ones that started."""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.cluster import PilotJob, SlurmSim
from repro_torch.core.events import Simulator

FIB_LENGTHS_MIN = (2, 4, 6, 8, 14, 22, 34, 56, 90)  # set A1 (Sec. IV-B)


class JobManager:
    def __init__(self, sim: Simulator, slurm: SlurmSim, *, model: str = "fib",
                 lengths_min: Sequence[int] = FIB_LENGTHS_MIN,
                 per_length: int = 10, var_target: int = 100,
                 replenish_interval: float = 15.0, max_queued: int = 100,
                 time_min_s: float = 120.0, time_max_s: float = 7200.0,
                 horizon: Optional[float] = None, autostart: bool = True):
        assert model in ("fib", "var")
        self.sim = sim
        self.slurm = slurm
        self.model = model
        self.lengths_s = [m * 60.0 for m in lengths_min]
        self.per_length = per_length
        self.var_target = var_target
        self.interval = replenish_interval
        self.max_queued = max_queued
        self.time_min_s = time_min_s
        self.time_max_s = time_max_s
        self.horizon = horizon
        self.n_created = 0
        self._started = False
        if autostart:
            self.start()

    def start(self):
        """Begin the replenish loop on the sim clock (Scaler seam; idempotent)."""
        if self._started:
            return
        self._started = True
        # reprolint: disable=RPL601 -- replenish-vs-pass ties on the 15s grid only decide whether freshly queued pilots are visible to the same-instant pass or the next one; placements touch warming invokers only, nothing request-visible — fuzz-invariant
        self.sim.at(0.0, self._replenish)

    def _replenish(self):
        counts = self.slurm.queued_counts()
        total = sum(counts.values())
        new = []
        if self.model == "fib":
            for ell in self.lengths_s:
                want = self.per_length - counts.get(ell, 0)
                for _ in range(max(0, want)):
                    if total + len(new) >= self.max_queued:
                        break
                    new.append(PilotJob(length_s=ell))
        else:
            want = self.var_target - counts.get(None, 0)
            for _ in range(max(0, want)):
                if total + len(new) >= self.max_queued:
                    break
                new.append(PilotJob(length_s=None, time_min_s=self.time_min_s,
                                    time_max_s=self.time_max_s))
        if new:
            self.n_created += len(new)
            self.slurm.submit_jobs(new)
        if self.horizon is None or self.sim.now < self.horizon:
            self.sim.after(self.interval, self._replenish)

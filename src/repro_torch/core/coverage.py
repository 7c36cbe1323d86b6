"""A-posteriori clairvoyant coverage simulation (paper Sec. IV-B, Table I).

Given the idle windows of a trace and a set of pilot-job lengths, greedily
fill each window with the longest job that fits (the paper's simulator), then
account each second of idle surface as warm-up (first ``warmup_s`` of every
job), ready, or not-used. Also derives the ready-worker count distribution
and the non-availability share (time with zero ready workers).

This is both the Table I reproduction and the upper bound ("Simulation" rows
of Tables II/III) against which the online cluster sim is scored.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.trace import IdleWindow

MIN = 60.0

# Paper Table I job-length sets (minutes)
JOB_LENGTH_SETS: Dict[str, Tuple[int, ...]] = {
    "A1": (2, 4, 6, 8, 14, 22, 34, 56, 90),
    "A2": (2, 4, 8, 12, 20, 34, 54, 88),
    "A3": (2, 4, 6, 10, 16, 26, 42, 68, 110),
    "B": (2, 4, 8, 16, 32, 64),
    "C1": (2, 4, 6, 8, 10, 12, 14, 16, 18, 20),
    "C2": tuple(range(2, 121, 2)),
}


@dataclasses.dataclass
class CoverageReport:
    set_name: str
    n_jobs: int
    warmup_share: float      # of total idle surface
    ready_share: float
    unused_share: float
    workers_p25: float
    workers_p50: float
    workers_p75: float
    workers_avg: float
    non_availability: float  # share of time with zero ready workers

    def row(self) -> str:
        return (f"{self.set_name:>3s} jobs={self.n_jobs:6d} warmup={self.warmup_share:6.2%} "
                f"ready={self.ready_share:6.2%} unused={self.unused_share:6.2%} "
                f"workers p25/50/75={self.workers_p25:.0f}/{self.workers_p50:.0f}/"
                f"{self.workers_p75:.0f} avg={self.workers_avg:.2f} "
                f"non-avail={self.non_availability:6.2%}")


def greedy_fill(length_s: float, job_lengths_s: Sequence[float]) -> List[float]:
    """Longest-fit-first packing of one idle window (paper Sec. IV-B)."""
    jobs = []
    remaining = length_s
    lengths = sorted(job_lengths_s, reverse=True)
    shortest = lengths[-1]
    while remaining >= shortest:
        for ell in lengths:
            if ell <= remaining:
                jobs.append(ell)
                remaining -= ell
                break
    return jobs


def simulate_coverage(windows: Sequence[IdleWindow], job_lengths_min: Sequence[int],
                      horizon: float, warmup_s: float = 20.0,
                      set_name: str = "?", step: float = 10.0) -> CoverageReport:
    lengths_s = [m * MIN for m in job_lengths_min]
    total = sum(w.length for w in windows)
    n_jobs = 0
    warmup = ready = 0.0
    ready_intervals: List[Tuple[float, float]] = []
    for w in windows:
        t = w.start
        for ell in greedy_fill(w.length, lengths_s):
            n_jobs += 1
            wu = min(warmup_s, ell)
            warmup += wu
            ready += ell - wu
            ready_intervals.append((t + wu, t + ell))
            t += ell
    # ready-worker count over time
    events = []
    for s, e in ready_intervals:
        events.append((s, 1))
        events.append((e, -1))
    events.sort()
    # sample times derived from an integer index: `t += step` accumulates
    # float error over a 24 h horizon (8640 additions of 10.0 drift past the
    # exact grid) and can gain/lose a boundary sample, skewing percentiles
    samples = []
    i, cur = 0, 0
    for k in range(int(horizon / step + 1e-9) + 1):
        t = k * step
        while i < len(events) and events[i][0] <= t:
            cur += events[i][1]
            i += 1
        samples.append(cur)
    samples = np.array(samples)
    denom = total if total > 0 else 1.0   # no idle surface -> all shares 0
    return CoverageReport(
        set_name=set_name,
        n_jobs=n_jobs,
        warmup_share=warmup / denom,
        ready_share=ready / denom,
        unused_share=1.0 - (warmup + ready) / denom,
        workers_p25=float(np.percentile(samples, 25)),
        workers_p50=float(np.percentile(samples, 50)),
        workers_p75=float(np.percentile(samples, 75)),
        workers_avg=float(np.mean(samples)),
        non_availability=float(np.mean(samples == 0)),
    )


def table1(windows: Sequence[IdleWindow], horizon: float,
           warmup_s: float = 20.0) -> List[CoverageReport]:
    """The full Table I sweep over job-length sets A1..C2."""
    return [simulate_coverage(windows, lengths, horizon, warmup_s, name)
            for name, lengths in JOB_LENGTH_SETS.items()]


def optimize_lengths_dp(windows: Sequence[IdleWindow], horizon: float,
                        warmup_s: float = 20.0, n_lengths: int = 9,
                        slot_min: int = 2, max_min: int = 120) -> Tuple[Tuple[int, ...], CoverageReport]:
    """BEYOND-PAPER: pick a near-optimal length set for the observed idle-length
    distribution by greedy forward selection on simulated ready share (the
    paper hand-compares six fixed sets; this searches the space directly)."""
    chosen = [slot_min]
    candidates = list(range(slot_min, max_min + 1, 2))
    best_report = simulate_coverage(windows, chosen, horizon, warmup_s, "DP")
    while len(chosen) < n_lengths:
        best_gain, best_c, best_r = 0.0, None, None
        for c in candidates:
            if c in chosen:
                continue
            r = simulate_coverage(windows, sorted(chosen + [c]), horizon, warmup_s, "DP")
            gain = r.ready_share - best_report.ready_share
            if gain > best_gain:
                best_gain, best_c, best_r = gain, c, r
        if best_c is None:
            break
        chosen = sorted(chosen + [best_c])
        best_report = best_r
    return tuple(chosen), best_report

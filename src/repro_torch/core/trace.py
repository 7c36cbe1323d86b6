"""Synthetic cluster-availability trace calibrated to the paper's published
Prometheus statistics (Feb 21-27 2022, Sec. I + Fig. 1):

  - average idle nodes at any moment: 9.23 (median 5, p25 2)
  - idle-period length: median 2 min, p75 ~4 min, mean ~5 min, 5% > 23 min
  - fraction of time with ZERO idle nodes: 10.11% (median full period ~1 min,
    mean ~3 min, longest 93 min)
  - total idle surface over the week: ~37,000 core-hours (= ~1,550 node-hours
    at 24 cores/node)

Generation model: alternating FULL / OPEN cluster regimes (semi-Markov, full
share 10.11%); during OPEN regimes, idle windows arrive as a Poisson process
with lengths drawn from an explicit quantile spec interpolated in log space
(so the paper's quantiles hold by construction). Windows are truncated at the
next FULL boundary, making zero-idle periods exact.

Each window carries BOTH an actual end and a *predicted* end (what the
backfill plan believes at window start) — the prediction error models runtime
slack (Fig. 2) and drives pilot preemptions in the cluster sim.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import List, Sequence

import numpy as np

WEEK = 7 * 24 * 3600.0
DAY = 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class IdleWindow:
    node: int
    start: float
    end: float            # actual end (prime demand returns)
    predicted_end: float  # what the scheduler believes at `start`

    @property
    def length(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    horizon: float = WEEK
    n_nodes: int = 2239
    avg_idle_nodes: float = 9.23
    full_share: float = 0.1011
    mean_full_period: float = 180.0       # paper: mean ~3 min
    median_full_period: float = 60.0
    # idle-length quantile knots (u, seconds): median 120, p75 240, 5% > 1380
    idle_quantiles: Sequence = ((0.0, 25.0), (0.25, 70.0), (0.5, 125.0),
                                (0.75, 260.0), (0.85, 500.0), (0.95, 1800.0),
                                (0.995, 5200.0), (1.0, 7000.0))
    # predicted_end error: predicted = start + length * slack, slack ~ LogU
    slack_lo: float = 0.6
    slack_hi: float = 2.5
    # share of windows whose length snaps to the 2-min backfill slot grid
    # (Sec. IV-B: "the backfill scheduler operates on 2-minute slots")
    slot_aligned_share: float = 0.6
    slot_s: float = 120.0
    seed: int = 0


def _quantile_sample(u: np.ndarray, knots) -> np.ndarray:
    """Piecewise log-linear inverse CDF through the given (u, value) knots."""
    us = np.array([k[0] for k in knots])
    vs = np.log(np.array([k[1] for k in knots]))
    return np.exp(np.interp(u, us, vs))


def generate_trace(cfg: TraceConfig, calibrate: bool = True) -> List[IdleWindow]:
    """Generate the trace; with ``calibrate`` a short fixed-point loop tunes
    the arrival rate and full-period frequency so the *measured* avg-idle-node
    count and zero-idle share hit the paper's numbers despite truncation."""
    lam_scale, full_scale = 1.08, 1.0
    for it in range(3 if calibrate else 1):
        windows = _generate_once(cfg, lam_scale, full_scale)
        if not calibrate or it == 2:
            break
        st = trace_stats(windows, cfg.horizon)
        lam_scale *= cfg.avg_idle_nodes / max(st["avg_idle_nodes"], 1e-6)
        full_scale *= cfg.full_share / max(st["zero_idle_share"], 1e-6)
        full_scale = min(max(full_scale, 0.05), 2.0)
    return windows


def _generate_once(cfg: TraceConfig, lam_scale: float, full_scale: float) -> List[IdleWindow]:
    rng = np.random.default_rng(cfg.seed)
    # --- FULL / OPEN regime alternation -------------------------------------
    # full periods: lognormal matched to median 60s / mean 180s
    mu = math.log(cfg.median_full_period)
    sigma = math.sqrt(2 * math.log(cfg.mean_full_period / cfg.median_full_period))
    mean_open = cfg.mean_full_period * (1 - cfg.full_share) / (cfg.full_share * full_scale)
    # OPEN periods are heavy-tailed (full periods cluster in busy stretches;
    # long idle windows live in the long open stretches between them) —
    # lognormal with the target mean and a small median.
    open_sigma = 1.8
    open_mu = math.log(mean_open) - open_sigma ** 2 / 2
    boundaries = []  # list of (t_full_start, t_full_end)
    t = float(rng.lognormal(open_mu, open_sigma))
    while t < cfg.horizon:
        full_len = float(rng.lognormal(mu, sigma))
        boundaries.append((t, min(t + full_len, cfg.horizon)))
        t += full_len + float(rng.lognormal(open_mu, open_sigma))
    full_starts = [b[0] for b in boundaries]

    def next_full_start(time: float) -> float:
        i = bisect.bisect_right(full_starts, time)
        return boundaries[i][0] if i < len(boundaries) else cfg.horizon

    def in_full(time: float) -> bool:
        i = bisect.bisect_right(full_starts, time) - 1
        return i >= 0 and boundaries[i][0] <= time < boundaries[i][1]

    # --- idle window arrivals -------------------------------------------------
    # target: avg_idle_nodes = lambda_open * mean_len * (1 - full_share)
    probe = _quantile_sample(rng.random(200_000), cfg.idle_quantiles)
    mean_len = float(np.mean(probe))
    lam = cfg.avg_idle_nodes / (mean_len * (1 - cfg.full_share))
    # truncation at FULL boundaries shortens windows; the calibration loop in
    # generate_trace refines this scale against measured stats
    lam *= lam_scale
    # Burstiness (Fig. 1c: rapid changes, bursts up to 150 idle nodes while the
    # median is 5): modulate the arrival intensity with a LOW/HIGH regime whose
    # mean factor is 1 (75% of time at 0.5x, 25% at 2.5x).
    regime = []  # (start, factor)
    t = 0.0
    while t < cfg.horizon:
        lo = float(rng.exponential(3 * 3600))
        hi = float(rng.exponential(1 * 3600))
        regime.append((t, 0.5))
        regime.append((t + lo, 2.5))
        t += lo + hi
    regime_starts = [r[0] for r in regime]

    def intensity(time: float) -> float:
        i = max(bisect.bisect_right(regime_starts, time) - 1, 0)
        return regime[i][1]

    windows: List[IdleWindow] = []
    t = 0.0
    lam_max = 2.5 * lam
    # nodes currently inside an idle window ("busy" for placement purposes):
    # node -> window end, with an expiry heap. Arrival times only move
    # forward, so expiring busy nodes as t advances reproduces exactly the
    # historical full-array `node_free_at <= t` candidate set — at O(#idle)
    # per arrival instead of O(n_nodes) — and the k-th-free-id walk below
    # consumes the same RNG draw over the same candidate count, keeping
    # generated traces bit-identical.
    busy = {}
    expiry: List[tuple] = []
    while True:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= cfg.horizon:
            break
        if rng.random() > intensity(t) / 2.5:  # thinning to the regime intensity
            continue
        if in_full(t):
            continue
        length = float(_quantile_sample(np.array([rng.random()]), cfg.idle_quantiles)[0])
        if length >= cfg.slot_s and rng.random() < cfg.slot_aligned_share:
            length = round(length / cfg.slot_s) * cfg.slot_s
        end = min(t + length, next_full_start(t), cfg.horizon)
        if end - t < 1.0:
            continue
        # pick a node currently not idle (windows on one node cannot overlap)
        while expiry and expiry[0][0] <= t:
            busy.pop(heapq.heappop(expiry)[1], None)
        n_free = cfg.n_nodes - len(busy)
        if n_free == 0:
            continue
        node = int(rng.integers(n_free))
        for b in sorted(busy):          # k-th free id, skipping busy holes
            if b <= node:
                node += 1
        busy[node] = end
        heapq.heappush(expiry, (end, node))
        slack = math.exp(rng.uniform(math.log(cfg.slack_lo), math.log(cfg.slack_hi)))
        predicted = t + (end - t) * slack
        windows.append(IdleWindow(node=node, start=t, end=end, predicted_end=predicted))
    windows.sort(key=lambda w: w.start)
    return windows


# --- analysis (Fig. 1 reproduction) --------------------------------------------
def idle_count_series(windows: Sequence[IdleWindow], horizon: float, step: float = 10.0):
    """Sampled number of simultaneously idle nodes (Fig. 1a/1c)."""
    events = []
    for w in windows:
        events.append((w.start, 1))
        events.append((w.end, -1))
    events.sort()
    out = []
    i, cur = 0, 0
    # sample points derived from an integer index: repeated `t += step`
    # accumulates rounding error and drifts off the k*step lattice
    for k in range(int(horizon / step + 1e-9) + 1):
        t = k * step
        if t > horizon:
            break
        while i < len(events) and events[i][0] <= t:
            cur += events[i][1]
            i += 1
        out.append(cur)
    return np.array(out)


def trace_stats(windows: Sequence[IdleWindow], horizon: float) -> dict:
    lengths = np.array([w.length for w in windows])
    series = idle_count_series(windows, horizon)
    return {
        "n_windows": len(windows),
        "idle_len_median_s": float(np.median(lengths)),
        "idle_len_p75_s": float(np.percentile(lengths, 75)),
        "idle_len_mean_s": float(np.mean(lengths)),
        "idle_len_p95_s": float(np.percentile(lengths, 95)),
        "avg_idle_nodes": float(np.sum(lengths) / horizon),
        "median_idle_nodes": float(np.median(series)),
        "p25_idle_nodes": float(np.percentile(series, 25)),
        "zero_idle_share": float(np.mean(series == 0)),
        "idle_surface_node_hours": float(np.sum(lengths) / 3600.0),
    }

"""Workload sources: traffic generators behind the
:class:`repro_torch.platform.interfaces.WorkloadSource` seam, plus the named-suite
registry used by declarative scenarios.

Arrival *times* AND per-request attribute draws (interruptibility, per-call
exec times) all happen here at schedule time, before the simulation runs a
single event. Nothing on the event path consumes the shared RNG stream, so a
request's randomness is a function of its position in the arrival sequence —
not of the order same-time events happen to pop. That is what lets the
tie-order fuzz harness (``tie_break="shuffle"``) reshuffle equal-time events
and still reproduce every aggregate bit-for-bit.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.faas.workloads import (WorkloadSuite, burst_suite, default_suite,
                                        serving_suite)
from repro_torch.platform.registry import register, resolve

if TYPE_CHECKING:
    from repro_torch.platform.runtime import Platform

register("suite", "default")(default_suite)
register("suite", "burst")(burst_suite)
register("suite", "serving")(serving_suite)


class UniformLoad:
    """The paper's homogeneous load: ``qps`` requests/s over ``n_functions``
    round-robin function names, constant-rate by default (the paper used a
    constant 10 QPS) or Poisson."""

    def __init__(self, qps: float = 10.0, n_functions: int = 100,
                 poisson: bool = False):
        self.qps = qps
        self.n_functions = n_functions
        self.poisson = poisson

    def schedule(self, platform: "Platform") -> None:
        duration = platform.scenario.duration
        if self.qps <= 0:
            return
        n = int(duration * self.qps)
        if self.poisson:
            gaps = platform.rng.exponential(1.0 / self.qps, size=n)
            times = np.cumsum(gaps)
        else:
            times = (np.arange(n) + 1) / self.qps
        ns = platform.scenario.workload.non_interruptible_share
        for i, t in enumerate(times):
            if t >= duration:
                break
            fn = f"fn-{i % self.n_functions:03d}"
            interruptible = bool(platform.rng.random() >= ns)
            # reprolint: disable=RPL601 -- every request attribute is pre-drawn above, so a submit tied with worker events carries identical state either side of the tie; routing differences permute queue order only — fuzz-invariant (test_tie_order.py)
            platform.sim.at(float(t), platform.submit, fn, None, None,
                            interruptible)


class SuiteLoad:
    """Multi-tenant traffic from a :class:`WorkloadSuite`: one merged,
    time-sorted arrival stream over all function classes."""

    def __init__(self, suite: WorkloadSuite):
        self.suite = suite

    def schedule(self, platform: "Platform") -> None:
        duration = platform.scenario.duration
        # materialize the arrival stream BEFORE drawing per-request
        # attributes: events() draws arrival times lazily from the same rng,
        # and interleaving would change the arrival process itself
        events = list(self.suite.events(platform.rng, duration))
        for t, cls, fn in events:
            exec_time = float(cls.sample_exec(platform.rng))
            interruptible = bool(platform.rng.random()
                                 < cls.interruptible_share)
            # reprolint: disable=RPL601 -- same pre-drawn-attribute argument as UniformLoad above; suite arrivals are Poisson/on-off with continuous times, so submit-vs-submit ties have measure zero — fuzz-invariant
            platform.sim.at(t, platform.submit_class, cls, fn, exec_time,
                            interruptible)


@register("workload", "uniform")
def build_uniform(platform: "Platform", **params) -> UniformLoad:
    w = platform.scenario.workload
    params.setdefault("qps", w.qps)
    params.setdefault("n_functions", w.n_functions)
    params.setdefault("poisson", w.poisson)
    return UniformLoad(**params)


@register("workload", "suite")
def build_suite(platform: "Platform", **params) -> SuiteLoad:
    w = platform.scenario.workload
    factory = resolve("suite", w.suite)
    return SuiteLoad(factory(scale=w.suite_scale, **params))


__all__ = ["UniformLoad", "SuiteLoad", "build_uniform", "build_suite"]

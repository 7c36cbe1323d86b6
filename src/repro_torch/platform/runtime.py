"""The composed harvest platform: ``Platform.build(ScenarioConfig)``.

``Platform`` wires trace -> SlurmSim -> Scaler -> Controller(Router) ->
Invokers -> Executor, drives a FaaS workload through the AdmissionPolicy
seam, and collects the three observation perspectives of the paper's
Sec. IV-A (OpenWhisk-level, Slurm-level, clairvoyant simulation). Every seam
is resolved from the scenario's registry keys, so a new router/scaler/
workload/executor is one registered class — never another constructor flag.

Construction order (and therefore simulator event order and shared-RNG draw
order) exactly mirrors the pre-seam ``HarvestRuntime``, so a seeded scenario
with the ``hash`` router reproduces historical runs bit-for-bit.

This is the port's copy of ``repro.platform.runtime``, line for line: every
seeded scenario, gangs (``gang_size > 1``, ``repro_torch.platform.elastic``)
included, runs here exactly as in ``repro``.

:class:`HarvestRuntime` survives as a thin façade over ``Platform`` for the
paper-style call sites (`HarvestConfig` + kwargs); new code should build a
:class:`repro_torch.platform.ScenarioConfig` — see README "Architecture".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import SlurmSim
from repro_torch.core.controller import Controller
from repro_torch.core.coverage import simulate_coverage
from repro_torch.core.events import Simulator
from repro_torch.core.pilot import FIB_LENGTHS_MIN
from repro_torch.core.queues import Request
from repro_torch.core.trace import IdleWindow, TraceConfig, generate_trace
from repro_torch.faas.metrics import MetricsRegistry, TimeSampler
from repro_torch.faas.slo import ClassReport, SLOClass, default_slos, per_class_report
from repro_torch.faas.workloads import FunctionClass, WorkloadSuite
from repro_torch.platform.registry import resolve
from repro_torch.platform.scenario import (PlatformSection, ScenarioConfig,
                                           SchedulingSection, TraceSection,
                                           WorkloadSection)

WORKER_STATES = ("warming", "healthy", "draining")


def nan_to_none(x):
    """Canonical no-data mapping for result stats: percentiles/shares are NaN
    when nothing succeeded; serialise that as None (strict-JSON null)."""
    return None if isinstance(x, float) and math.isnan(x) else x


def _fmt_share(x: float) -> str:
    return "n/a" if nan_to_none(x) is None else f"{x:.2%}"


@dataclasses.dataclass
class HarvestResult:
    requests: List[Request]
    n_submitted: int
    outcome_counts: Dict[str, int]
    invoked_share: float                # accepted by controller (not 503)
    success_share: float                # of invoked
    response_p50: float                 # NaN when no request succeeded
    response_p95: float                 # NaN when no request succeeded
    slurm_coverage: float
    sim_upper_bound: float
    worker_samples: Dict[str, np.ndarray]   # state -> counts every 10 s
    n_jobs_started: int
    n_evicted: int
    no_worker_time_share: float
    per_class: List[ClassReport] = dataclasses.field(default_factory=list)
    n_throttled: int = 0                # 503s due to admission control
    metrics: Optional[MetricsRegistry] = None
    n_wasted_execs: int = 0             # stale/killed executions (see Invoker)
    goodput_s: float = 0.0              # successful request-seconds
    reliability: Optional[Dict[str, float]] = None  # RetryPolicy.summary()

    def summary(self) -> str:
        oc = self.outcome_counts
        p50 = ("n/a" if math.isnan(self.response_p50)
               else f"{self.response_p50:.3f}s")
        return (f"{'':2s}coverage={self.slurm_coverage:.2%} (sim bound {self.sim_upper_bound:.2%}) "
                f"invoked={self.invoked_share:.2%} success={_fmt_share(self.success_share)} "
                f"p50={p50} "
                f"healthy avg={np.mean(self.worker_samples['healthy']):.2f} "
                f"jobs={self.n_jobs_started} evicted={self.n_evicted} "
                f"outcomes={ {k: oc.get(k, 0) for k in ('success','timeout','503')} }")


class Platform:
    """One fully-wired harvest stack. Use :meth:`build`; the attributes
    (``sim``, ``controller``, ``slurm``, ``scaler``, ``router``, ``metrics``,
    ``windows``) are the live components for callers that want to attach
    extra instrumentation or traffic before :meth:`run`."""

    def __init__(self, scenario: ScenarioConfig, *,
                 windows: Optional[Sequence[IdleWindow]] = None,
                 trace_cfg: Optional[TraceConfig] = None,
                 executor=None,
                 suite: Optional[WorkloadSuite] = None,
                 slos: Optional[Dict[str, SLOClass]] = None):
        sc = scenario
        self.scenario = sc
        self.sim = Simulator(tie_break=sc.tie_break, tie_seed=sc.tie_seed)
        self.rng = np.random.default_rng(sc.seed + 77)
        if windows is None:
            tc = trace_cfg or sc.trace.trace_config(sc.duration, sc.seed)
            windows = generate_trace(tc)
        self.windows = [w for w in windows if w.start < sc.duration]
        self.metrics = MetricsRegistry()
        # workload source first: whether traffic is multi-tenant decides the
        # default SLO table, which the admission policy is built against
        if suite is not None:
            from repro_torch.platform.sources import SuiteLoad
            self.workload = SuiteLoad(suite)
        else:
            self.workload = resolve("workload", sc.workload.source)(
                self, **sc.workload.params)
        multi_tenant = hasattr(self.workload, "suite")
        has_admission = sc.platform.admission != "none"
        self.slos = slos or (default_slos()
                             if (has_admission or multi_tenant) else None)
        self.admission = resolve("admission", sc.platform.admission)(
            self, **sc.platform.admission_params)
        self.router = resolve("router", sc.platform.router)(
            **sc.platform.router_params)
        self.reliability = resolve("reliability", sc.reliability.policy)(
            self, **sc.reliability.params)
        self.controller = Controller(
            self.sim,
            queue_depth_soft_limit=sc.platform.queue_depth_soft_limit,
            admission=self.admission, metrics=self.metrics,
            router=self.router, reliability=self.reliability)
        if executor is not None:
            from repro_torch.platform.executors import as_executor
            self.executor = as_executor(executor)
        else:
            self.executor = resolve("executor", sc.platform.executor)(
                self, **sc.platform.executor_params)
        # gang mode: workers become members of tensor-parallel serving gangs
        # (one logical invoker per gang); the pool's spawn_member replaces
        # the plain Invoker constructor in SlurmSim's placement path
        self.gang_pool = None
        if sc.platform.gang_size > 1:
            from repro_torch.platform.elastic import GangPool
            self.gang_pool = GangPool(self, gang_size=sc.platform.gang_size,
                                      **sc.platform.gang_params)
        sch = sc.scheduling
        self.slurm = SlurmSim(
            self.sim, self.windows, self.controller, self.rng,
            sched_interval=(sch.var_sched_interval if sch.model == "var"
                            else sch.sched_interval),
            grace=sch.grace, executor=self.executor,
            # var: flexible-length sizing is too slow for the backfill loop
            # (Sec. V-B2) — bounded per-pass placements, no plan chaining.
            pass_budget=(sch.var_pass_budget if sch.model == "var" else None),
            chain_on_exit=(sch.model == "fib"),
            invoker_kwargs=dict(sc.platform.invoker_params),
            invoker_factory=(self.gang_pool.spawn_member
                             if self.gang_pool is not None else None))
        self.scaler = resolve("scaler", sch.scaler)(self, **sch.scaler_params)
        self.scaler.start()
        self.requests: List[Request] = []
        self._max_timeout = sc.workload.timeout  # longest timeout submitted
        self._wc_time = -1.0            # memo stamp for _count_workers
        self._wc: Dict[str, int] = {}
        # worker-state time series via sampled callback gauges (10 s grid,
        # matching the paper's Prometheus scrape cadence)
        self.sampler = TimeSampler(self.sim, interval=10.0,
                                   horizon=sc.duration)
        for state in WORKER_STATES:
            g = self.metrics.gauge(
                "workers", fn=(lambda s=state: self._count_workers(s)),
                state=state)
            self.sampler.track(state, g)
        self.metrics.gauge("healthy_invokers",
                           fn=self.controller.healthy_count)
        self.metrics.gauge("wasted_execs", fn=self.slurm.total_wasted)
        self.workload.schedule(self)

    @classmethod
    def build(cls, scenario: ScenarioConfig, **overrides) -> "Platform":
        """Construct a fully-wired platform from a declarative scenario.
        Keyword overrides (``windows``, ``trace_cfg``, ``executor``,
        ``suite``, ``slos``) inject pre-built objects where a registry key
        is not expressive enough (e.g. a live ServingEngine executor)."""
        return cls(scenario, **overrides)

    def _count_workers(self, state: str) -> int:
        # one pass over the LIVE invokers per sim timestamp, shared by the
        # three state gauges the sampler scrapes together — dead invokers are
        # pruned from the registry, so this never rescans the day's history
        if self._wc_time != self.sim.now:
            counts = {s: 0 for s in WORKER_STATES}
            for inv in self.slurm.live_invokers.values():
                if inv.state in counts:
                    counts[inv.state] += 1
            self._wc, self._wc_time = counts, self.sim.now
        return self._wc[state]

    # --- request entry points ------------------------------------------------
    def submit(self, fn: str, exec_time: Optional[float] = None,
               timeout: Optional[float] = None,
               interruptible: Optional[bool] = None):
        """Submit one request now; ``None`` falls back to the scenario's
        workload defaults (0.0 is a legitimate explicit value). Workload
        sources pre-draw ``interruptible`` at schedule time so the shared
        RNG stream is never consumed at event time (tie-order reshuffles
        must not reassign draws); ``None`` draws here for manual callers.
        """
        w = self.scenario.workload
        if interruptible is None:
            interruptible = bool(self.rng.random() >= w.non_interruptible_share)
        req = Request(fn=fn,
                      exec_time=(exec_time if exec_time is not None
                                 else w.exec_time),
                      arrival=self.sim.now,
                      timeout=timeout if timeout is not None else w.timeout,
                      interruptible=interruptible)
        self.requests.append(req)
        self._max_timeout = max(self._max_timeout, req.timeout)
        self.controller.submit(req)

    def submit_class(self, cls: FunctionClass, fn: str,
                     exec_time: Optional[float] = None,
                     interruptible: Optional[bool] = None):
        if exec_time is None:
            exec_time = cls.sample_exec(self.rng)
        if interruptible is None:
            interruptible = bool(self.rng.random() < cls.interruptible_share)
        req = Request(fn=fn, exec_time=exec_time,
                      arrival=self.sim.now, timeout=cls.timeout,
                      interruptible=interruptible,
                      tenant=cls.tenant, slo_class=cls.slo_class)
        self.requests.append(req)
        self._max_timeout = max(self._max_timeout, req.timeout)
        self.controller.submit(req)

    # --- run -----------------------------------------------------------------
    def run(self) -> HarvestResult:
        sc = self.scenario
        # two-phase: arrivals all land by `duration`, after which _max_timeout
        # is final — the tail must outlast the longest pending timeout or
        # late requests end the run with no outcome (conservation break)
        self.sim.run_until(sc.duration)
        self.sim.run_until(sc.duration + sc.scheduling.grace
                           + max(60.0, self._max_timeout))
        # clairvoyant upper bound over the same windows (Sec. IV-A persp. 3)
        lengths = (FIB_LENGTHS_MIN if sc.scheduling.model == "fib"
                   else tuple(range(2, 121, 2)))
        bound = simulate_coverage(self.windows, lengths, sc.duration)
        invoked = [r for r in self.requests if r.outcome != "503"]
        done = [r for r in invoked if r.outcome == "success"]
        if done:
            rts = np.array([r.response_time for r in done])
            p50, p95 = (float(np.percentile(rts, 50)),
                        float(np.percentile(rts, 95)))
        else:
            p50 = p95 = float("nan")
        ws = {s: self.sampler.series(s) for s in WORKER_STATES}
        adm = self.controller.admission
        return HarvestResult(
            requests=self.requests,
            n_submitted=len(self.requests),
            outcome_counts=self.controller.outcome_counts(),
            invoked_share=len(invoked) / max(len(self.requests), 1),
            success_share=(len(done) / len(invoked) if invoked
                           else float("nan")),
            response_p50=p50,
            response_p95=p95,
            slurm_coverage=self.slurm.coverage(),
            sim_upper_bound=bound.warmup_share + bound.ready_share,
            worker_samples=ws,
            n_jobs_started=self.slurm.n_started,
            n_evicted=self.slurm.n_evicted,
            no_worker_time_share=float(np.mean(ws["healthy"] == 0)),
            per_class=per_class_report(self.requests, self.slos),
            n_throttled=(adm.n_throttled + adm.n_fn_capped) if adm else 0,
            metrics=self.metrics,
            n_wasted_execs=self.slurm.total_wasted(),
            goodput_s=float(sum(r.exec_time for r in done)),
            reliability=(self.reliability.summary()
                         if self.reliability is not None else None),
        )


# --- legacy façade ------------------------------------------------------------
@dataclasses.dataclass
class HarvestConfig:
    """Flat paper-era config, mapped 1:1 onto a :class:`ScenarioConfig` by
    :class:`HarvestRuntime`. Prefer building scenarios directly."""
    model: str = "fib"                  # fib | var
    duration: float = 24 * 3600.0
    qps: float = 10.0
    n_functions: int = 100
    exec_time: float = 0.010
    timeout: float = 60.0
    sched_interval: float = 15.0        # fib backfill pass period
    var_sched_interval: float = 90.0    # var passes are slower (Sec. V-B2)
    var_pass_budget: int = 2            # max var placements per pass
    grace: float = 180.0
    seed: int = 0
    poisson: bool = False               # paper used a constant 10 QPS rate
    non_interruptible_share: float = 0.0  # clients opting out of interruption
    scaler: str = "static"              # scaler registry key

    def to_scenario(self, *, admission: bool = False,
                    suite: bool = False, router: str = "hash") -> ScenarioConfig:
        return ScenarioConfig(
            name="harvest", duration=self.duration, seed=self.seed,
            workload=WorkloadSection(
                source=("suite" if suite else "uniform"),
                qps=self.qps, n_functions=self.n_functions,
                exec_time=self.exec_time, timeout=self.timeout,
                poisson=self.poisson,
                non_interruptible_share=self.non_interruptible_share),
            scheduling=SchedulingSection(
                model=self.model, scaler=self.scaler,
                sched_interval=self.sched_interval,
                var_sched_interval=self.var_sched_interval,
                var_pass_budget=self.var_pass_budget, grace=self.grace),
            platform=PlatformSection(
                router=router, admission=("slo" if admission else "none")))


class HarvestRuntime:
    """Thin façade over :class:`Platform` accepting the historical
    ``HarvestConfig`` + kwargs call shape; every attribute of the underlying
    platform (``sim``, ``controller``, ``slurm``, ``windows``, ...) is
    forwarded. See README "Migration" for the scenario-first equivalent."""

    def __init__(self, cfg: HarvestConfig,
                 windows: Optional[Sequence[IdleWindow]] = None,
                 trace_cfg: Optional[TraceConfig] = None,
                 executor: Optional[Callable[[Request], float]] = None,
                 suite: Optional[WorkloadSuite] = None,
                 admission: bool = False,
                 slos: Optional[Dict[str, SLOClass]] = None):
        self.cfg = cfg
        scenario = cfg.to_scenario(admission=admission,
                                   suite=suite is not None)
        self.platform = Platform.build(scenario, windows=windows,
                                       trace_cfg=trace_cfg,
                                       executor=executor, suite=suite,
                                       slos=slos)

    def __getattr__(self, name):
        return getattr(self.platform, name)

    def run(self) -> HarvestResult:
        return self.platform.run()

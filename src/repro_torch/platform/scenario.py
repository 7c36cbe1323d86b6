"""Declarative scenario configuration for the harvest platform.

A :class:`ScenarioConfig` is a nested dataclass with four sections —
``trace`` (the idle-window supply side), ``workload`` (the FaaS demand side),
``scheduling`` (Slurm passes and the pilot-supply scaler), and ``platform``
(router / admission / executor seams). Components are referred to purely by
their registry keys, so a scenario round-trips through JSON:

    cfg = ScenarioConfig.multi_tenant_burst(duration=2 * 3600.0)
    cfg.platform.router = "least-loaded"
    Path("scenario.json").write_text(cfg.to_json())
    ...
    cfg2 = ScenarioConfig.from_json(Path("scenario.json").read_text())
    assert cfg2 == cfg
    res = Platform.build(cfg2).run()

Preset constructors reproduce the paper's experiment days (``fib_day`` /
``var_day`` are Table II / Table III; ``multi_tenant_steady`` /
``multi_tenant_burst`` are the platform-layer scenario grid).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.core.trace import TraceConfig

DAY = 24 * 3600.0


@dataclasses.dataclass
class TraceSection:
    """Idle-window supply. ``seed=None`` inherits the scenario seed (matching
    the historical ``TraceConfig(seed=cfg.seed)`` default); ``horizon=None``
    inherits the scenario duration. ``params`` passes any further
    :class:`repro_torch.core.trace.TraceConfig` field (quantile knots, slack range,
    node count) for fully declarative trace shaping."""
    horizon: Optional[float] = None
    seed: Optional[int] = None
    avg_idle_nodes: Optional[float] = None
    full_share: Optional[float] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def trace_config(self, duration: float, scenario_seed: int) -> TraceConfig:
        kw: Dict[str, Any] = dict(self.params)
        kw["horizon"] = self.horizon if self.horizon is not None else duration
        kw["seed"] = self.seed if self.seed is not None else scenario_seed
        if self.avg_idle_nodes is not None:
            kw["avg_idle_nodes"] = self.avg_idle_nodes
        if self.full_share is not None:
            kw["full_share"] = self.full_share
        return TraceConfig(**kw)


@dataclasses.dataclass
class WorkloadSection:
    """FaaS demand. ``source`` is a workload registry key: ``uniform`` is the
    paper's homogeneous load (constant or Poisson ``qps``), ``suite`` draws a
    multi-tenant :class:`repro_torch.faas.workloads.WorkloadSuite` named by
    ``suite`` from the suite registry."""
    source: str = "uniform"
    qps: float = 10.0
    n_functions: int = 100
    exec_time: float = 0.010
    timeout: float = 60.0
    poisson: bool = False
    non_interruptible_share: float = 0.0
    suite: str = "default"
    suite_scale: float = 1.0
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulingSection:
    """Slurm-side policy: the paper's fib/var supply model, backfill pass
    cadence, preemption grace, and the pilot-supply scaler seam."""
    model: str = "fib"                  # fib | var
    scaler: str = "static"              # scaler registry key
    sched_interval: float = 15.0        # fib backfill pass period
    var_sched_interval: float = 90.0    # var passes are slower (Sec. V-B2)
    var_pass_budget: int = 2            # max var placements per pass
    grace: float = 180.0
    scaler_params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PlatformSection:
    """Controller-side seams: routing policy, admission policy, executor,
    and invoker tuning (``invoker_params`` feeds
    :class:`repro_torch.core.invoker.Invoker` — e.g. ``concurrency``/``cold_start``
    for serving-style invokers whose accelerator bounds parallelism)."""
    router: str = "hash"                # router registry key
    admission: str = "none"             # none | slo
    executor: str = "sim"               # executor registry key
    kv_layout: str = "dense"            # serving KV cache: dense | paged
    # model zoo knobs for the serving executors: which smoke arch the engine
    # hosts, and its per-site CUDA kernel policy ("" inherits the executor
    # default; kernel_impls values are reference | kernel | the "auto"/
    # "reference" shorthands of repro_torch.configs.base.with_kernel_impls)
    model: str = ""
    kernel_impls: Any = "reference"
    # gang_size > 1 turns workers into gang members: the controller sees one
    # logical invoker per gang of concurrently-open idle windows, serving a
    # model tensor-parallel across them (repro_torch.platform.elastic).
    # gang_params feeds GangPool (migrate / form_warmup / model_bytes / ...)
    gang_size: int = 1
    queue_depth_soft_limit: int = 64
    router_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    admission_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    executor_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    invoker_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    gang_params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ReliabilitySection:
    """Retry/hedging policy in the controller's terminal path. ``policy`` is
    a reliability registry key (``none`` leaves the paper's behaviour:
    preemption deaths are final). The remaining fields parameterise the
    bundled ``retry`` policy; ``params`` passes anything further straight to
    the registered factory."""
    policy: str = "none"                # reliability registry key
    max_retries: int = 2                # default per-request retry budget
    retry_budgets: Dict[str, int] = dataclasses.field(default_factory=dict)
    backoff_base: float = 0.5           # first retry delay (seconds)
    backoff_factor: float = 2.0
    backoff_max: float = 30.0
    # which would-be-terminal outcomes a retry absorbs. Only "failed"
    # (execution died with its worker) ever reaches the hook — timeouts and
    # 503s commit outside Controller.complete — so entries beyond "failed"
    # are inert; [] gives hedging-only semantics.
    retry_on: List[str] = dataclasses.field(
        default_factory=lambda: ["failed"])
    hedge_delay: Optional[float] = None  # None disables hedging
    max_hedges: int = 1
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


_SECTIONS = {"trace": TraceSection, "workload": WorkloadSection,
             "scheduling": SchedulingSection, "platform": PlatformSection,
             "reliability": ReliabilitySection}


@dataclasses.dataclass
class ScenarioConfig:
    name: str = "scenario"
    duration: float = DAY
    seed: int = 0
    # same-timestamp event ordering (repro_torch.core.events.Simulator): "fifo"
    # reproduces the published insertion-order runs; "shuffle" permutes
    # equal-time ties with tie_seed — the tie-order fuzz harness sweeps this
    # to certify aggregates don't lean on insertion accidents
    tie_break: str = "fifo"
    tie_seed: int = 0
    trace: TraceSection = dataclasses.field(default_factory=TraceSection)
    workload: WorkloadSection = dataclasses.field(
        default_factory=WorkloadSection)
    scheduling: SchedulingSection = dataclasses.field(
        default_factory=SchedulingSection)
    platform: PlatformSection = dataclasses.field(
        default_factory=PlatformSection)
    reliability: ReliabilitySection = dataclasses.field(
        default_factory=ReliabilitySection)

    # --- (de)serialisation ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioConfig":
        d = dict(d)
        for key, section in _SECTIONS.items():
            if isinstance(d.get(key), dict):
                d[key] = section(**d[key])
        return cls(**d)

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "ScenarioConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # --- presets (the paper's experiment days) -------------------------------
    @classmethod
    def fib_day(cls, duration: float = DAY, qps: float = 10.0,
                seed: int = 3) -> "ScenarioConfig":
        """Table II: the fib supply model on its day-matched trace
        (Mar 17: avg 11.85 idle nodes, 0.6% zero-idle share)."""
        return cls(
            name="fib_day", duration=duration, seed=seed,
            trace=TraceSection(avg_idle_nodes=11.85, full_share=0.006,
                               seed=17),
            workload=WorkloadSection(qps=qps, non_interruptible_share=0.2),
            scheduling=SchedulingSection(model="fib"))

    @classmethod
    def var_day(cls, duration: float = DAY, qps: float = 10.0,
                seed: int = 3) -> "ScenarioConfig":
        """Table III: the var supply model on its day-matched trace
        (Mar 21: avg 7.38 idle nodes, 9.44% zero-idle share)."""
        return cls(
            name="var_day", duration=duration, seed=seed,
            trace=TraceSection(avg_idle_nodes=7.38, full_share=0.0944,
                               seed=21),
            workload=WorkloadSection(qps=qps, non_interruptible_share=0.2),
            scheduling=SchedulingSection(model="var"))

    @classmethod
    def multi_tenant(cls, duration: float = 2 * 3600.0, suite: str = "default",
                     scaler: str = "static", seed: int = 3) -> "ScenarioConfig":
        """Multi-tenant platform scenario: a heterogeneous workload suite with
        SLO admission on the fib day trace."""
        return cls(
            name=f"multi_tenant_{suite}_{scaler}", duration=duration,
            seed=seed,
            trace=TraceSection(avg_idle_nodes=11.85, full_share=0.006,
                               seed=17),
            workload=WorkloadSection(source="suite", suite=suite, qps=0.0),
            scheduling=SchedulingSection(model="fib", scaler=scaler),
            platform=PlatformSection(admission="slo"))

    @classmethod
    def multi_tenant_steady(cls, duration: float = 2 * 3600.0,
                            scaler: str = "static") -> "ScenarioConfig":
        return cls.multi_tenant(duration, suite="default", scaler=scaler)

    @classmethod
    def multi_tenant_burst(cls, duration: float = 2 * 3600.0,
                           scaler: str = "static") -> "ScenarioConfig":
        return cls.multi_tenant(duration, suite="burst", scaler=scaler)

    @classmethod
    def preemption_storm(cls, duration: float = 2 * 3600.0,
                         seed: int = 5) -> "ScenarioConfig":
        """Reliability stress day: idle windows are short and fragmented while
        the backfill plan systematically over-predicts them (slack 1.2-4.0x),
        so pilots are routinely evicted mid-request; calls run *longer than
        the preemption grace* and are mostly non-interruptible — exactly the
        work that "failed during execution" in the paper's Sec. V-C (a call
        with more remaining time than the grace window cannot drain to
        completion in place). Retries default on; benchmarks flip
        ``reliability.policy`` / ``platform.router`` per cell."""
        return cls(
            name="preemption_storm", duration=duration, seed=seed,
            trace=TraceSection(
                avg_idle_nodes=9.0, full_share=0.06, seed=29,
                params={
                    # short, fragmented windows: median ~3.5 min, p95 ~12 min
                    "idle_quantiles": [[0.0, 60.0], [0.25, 140.0],
                                       [0.5, 210.0], [0.75, 330.0],
                                       [0.9, 520.0], [0.98, 760.0],
                                       [1.0, 1100.0]],
                    # the plan believes windows are far longer than they are
                    "slack_lo": 1.2, "slack_hi": 4.0,
                }),
            workload=WorkloadSection(qps=0.5, exec_time=240.0, timeout=1800.0,
                                     non_interruptible_share=0.7),
            scheduling=SchedulingSection(model="fib"),
            reliability=ReliabilitySection(policy="retry", max_retries=3,
                                           backoff_base=0.5))

    @classmethod
    def elastic_storm(cls, duration: float = 2 * 3600.0, gang_size: int = 3,
                      seed: int = 7, migrate: bool = True) -> "ScenarioConfig":
        """Elastic sharded serving under the preemption storm: the model
        needs a GANG of ``gang_size`` concurrently-open idle windows, and
        those windows are short, fragmented, and over-predicted — so members
        are constantly torn out of live gangs. With ``migrate`` the gang
        re-shards onto the survivors inside the member's grace (the
        tentpole's live shard+KV migration); without it one eviction costs
        the whole replica and a re-formed gang re-pays the model load. The
        deadline-aware router prices placements against the gang's MINIMUM
        member lease. The pivotal ratio: calls (240 s) are LONGER than the
        median idle window (~210 s), so without migration almost no gang
        survives a whole call — exactly the regime where carrying state
        across member churn is the difference between goodput and a retry
        loop. Load is kept under capacity (offered concurrency well below
        gangs x concurrency) so goodput measures survival, not admission."""
        return cls(
            name=f"elastic_storm_g{gang_size}"
                 f"{'_migrate' if migrate else '_lose'}",
            duration=duration, seed=seed,
            trace=TraceSection(
                avg_idle_nodes=9.0, full_share=0.06, seed=29,
                params={
                    "idle_quantiles": [[0.0, 60.0], [0.25, 140.0],
                                       [0.5, 210.0], [0.75, 330.0],
                                       [0.9, 520.0], [0.98, 760.0],
                                       [1.0, 1100.0]],
                    "slack_lo": 1.2, "slack_hi": 4.0,
                }),
            workload=WorkloadSection(qps=0.15, exec_time=240.0,
                                     timeout=1200.0,
                                     non_interruptible_share=0.3),
            scheduling=SchedulingSection(model="fib"),
            platform=PlatformSection(router="deadline-aware",
                                     gang_size=gang_size,
                                     gang_params={"migrate": migrate}),
            reliability=ReliabilitySection(policy="retry", max_retries=3,
                                           backoff_base=0.5))

    @classmethod
    def churn_day(cls, duration: float = 2 * 3600.0,
                  seed: int = 6) -> "ScenarioConfig":
        """Sustained worker churn rather than an outright storm: moderately
        fragmented windows with optimistic predictions and a mixed
        interruptible/non-interruptible load of mid-length calls. Hedging is
        armed at 150 s — an attempt that deep into a 210 s call is exposed to
        preemption for its remaining minute, so the duplicate buys insurance
        against a drain/SIGKILL ending the original."""
        return cls(
            name="churn_day", duration=duration, seed=seed,
            trace=TraceSection(
                avg_idle_nodes=10.0, full_share=0.04, seed=31,
                params={
                    "idle_quantiles": [[0.0, 80.0], [0.25, 180.0],
                                       [0.5, 300.0], [0.75, 520.0],
                                       [0.9, 900.0], [0.98, 1500.0],
                                       [1.0, 2400.0]],
                    "slack_lo": 0.9, "slack_hi": 3.0,
                }),
            workload=WorkloadSection(qps=1.0, exec_time=210.0, timeout=1500.0,
                                     non_interruptible_share=0.4),
            scheduling=SchedulingSection(model="fib"),
            reliability=ReliabilitySection(policy="retry", max_retries=2,
                                           hedge_delay=150.0))

    @classmethod
    def serving_burst(cls, duration: float = 2 * 3600.0,
                      scaler: str = "static") -> "ScenarioConfig":
        """Model-serving traffic (few heavy endpoints) on accelerator-bound
        invokers (concurrency 2) — the placement-sensitive regime where the
        Router seam decides tail latency."""
        sc = cls.multi_tenant(duration, suite="serving", scaler=scaler)
        sc.name = f"serving_burst_{scaler}"
        sc.platform.invoker_params = {"concurrency": 2}
        return sc

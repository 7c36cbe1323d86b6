"""Composable component API for the harvest stack.

The paper's architecture (Slurm + modified OpenWhisk + pilot jobs +
invokers, composed non-invasively) is expressed here as five typed seams —
Router, Scaler, AdmissionPolicy, WorkloadSource, Executor — a string-keyed
component registry, and a declarative :class:`ScenarioConfig` consumed by
:meth:`Platform.build`. Layering: ``repro_torch.core`` (paper mechanisms)
knows nothing of ``repro_torch.faas`` (multi-tenant policies); this package
composes both and is the only construction path the port's benchmarks and
launchers use.

The port's copy of ``repro.platform``, whose serving executors run the
port's engines on the card, elastic serving gangs (``GangMember``,
``ElasticGangInvoker``, ``GangPool``, and the ``sharded-serving`` executor
``ElasticServingExecutor`` over an ``ElasticReplica``) included.
"""
from repro_torch.platform.interfaces import (AdmissionPolicy, Executor, Router,
                                             Scaler, WorkloadSource)
from repro_torch.platform.registry import available, register, resolve
from repro_torch.platform.scenario import (PlatformSection, ReliabilitySection,
                                           ScenarioConfig, SchedulingSection,
                                           TraceSection, WorkloadSection)
# component modules register themselves on import
from repro_torch.platform.routers import (DeadlineAwareRouter, HashRouter,
                                          LeastLoadedRouter, LocalityRouter)
from repro_torch.platform.scalers import AdaptiveJobManager, JobManager
from repro_torch.platform.sources import SuiteLoad, UniformLoad
from repro_torch.platform.executors import (BatchedServingExecutor,
                                            ServingExecutor, SimExecutor)
from repro_torch.platform.elastic import (ElasticGangInvoker, ElasticServingExecutor,
                                          GangMember, GangPool, build_sharded_serving)
from repro_torch.platform import admission as _admission  # noqa: F401 (registers)
from repro_torch.platform import reliability as _reliability  # noqa: F401 (registers)
from repro_torch.platform.reliability import RetryPolicy
from repro_torch.platform.runtime import (HarvestConfig, HarvestResult,
                                          HarvestRuntime, Platform, nan_to_none)

__all__ = [
    "AdmissionPolicy", "Executor", "Router", "Scaler", "WorkloadSource",
    "available", "register", "resolve",
    "ScenarioConfig", "TraceSection", "WorkloadSection",
    "SchedulingSection", "PlatformSection", "ReliabilitySection",
    "HashRouter", "LeastLoadedRouter", "LocalityRouter",
    "DeadlineAwareRouter", "RetryPolicy",
    "JobManager", "AdaptiveJobManager",
    "UniformLoad", "SuiteLoad",
    "SimExecutor", "ServingExecutor", "BatchedServingExecutor",
    "GangMember", "ElasticGangInvoker", "GangPool", "ElasticServingExecutor",
    "build_sharded_serving",
    "HarvestConfig", "HarvestResult", "HarvestRuntime", "Platform",
    "nan_to_none",
]

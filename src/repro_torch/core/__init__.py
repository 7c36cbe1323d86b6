"""The paper's contribution: HPC-Whisk — a FaaS layer harvesting idle
capacity via low-priority preemptible pilot jobs, with dynamic-invoker
OpenWhisk semantics (fast-lane hand-off, register/deregister, pluggable
placement routers), fib/var pilot-job supply models, and the Alg. 1
commercial-fallback wrapper.

This package holds *mechanisms* only and never imports the policy layers —
``repro_torch.faas`` (multi-tenant policies) builds on it, and ``repro_torch.platform``
composes both (``Platform.build(ScenarioConfig)`` is where ``HarvestRuntime``
and friends now live).
"""
from repro_torch.core.controller import Controller
from repro_torch.core.coverage import JOB_LENGTH_SETS, simulate_coverage, table1
from repro_torch.core.events import Simulator
from repro_torch.core.invoker import Invoker
from repro_torch.core.pilot import FIB_LENGTHS_MIN, JobManager
from repro_torch.core.cluster import PilotJob, SlurmSim
from repro_torch.core.queues import Request, Topic
from repro_torch.core.routing import (DeadlineAwareRouter, HashRouter,
                                      LeastLoadedRouter, LocalityRouter)
from repro_torch.core.trace import IdleWindow, TraceConfig, generate_trace, trace_stats
from repro_torch.core.wrapper import CommercialBackend, FaaSWrapper

__all__ = [
    "Controller", "JOB_LENGTH_SETS", "simulate_coverage", "table1",
    "Simulator", "Invoker", "FIB_LENGTHS_MIN", "JobManager", "PilotJob",
    "SlurmSim", "Request", "Topic",
    "DeadlineAwareRouter", "HashRouter", "LeastLoadedRouter",
    "LocalityRouter",
    "IdleWindow", "TraceConfig", "generate_trace",
    "trace_stats", "CommercialBackend", "FaaSWrapper",
]

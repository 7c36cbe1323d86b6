"""Multi-tenant FaaS platform layer on top of the paper's harvest core:
heterogeneous workload suites, per-tenant SLO classes with token-bucket
admission control, a demand-adaptive pilot-job supply manager, and a
Prometheus-style metrics registry sampled on the sim clock."""
from repro_torch.faas.admission import AdmissionController, TokenBucket
from repro_torch.faas.autoscaler import AdaptiveJobManager
from repro_torch.faas.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                      TimeSampler)
from repro_torch.faas.reliability import NoReliability, RetryPolicy
from repro_torch.faas.slo import ClassReport, SLOClass, default_slos, per_class_report
from repro_torch.faas.workloads import (FunctionClass, WorkloadSuite, burst_suite,
                                        default_suite, serving_suite)

__all__ = [
    "AdmissionController", "TokenBucket", "AdaptiveJobManager",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "TimeSampler",
    "NoReliability", "RetryPolicy",
    "ClassReport", "SLOClass", "default_slos", "per_class_report",
    "FunctionClass", "WorkloadSuite", "burst_suite", "default_suite",
    "serving_suite",
]

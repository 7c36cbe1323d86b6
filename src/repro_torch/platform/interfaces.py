"""Typed protocols for the five seams of the harvest stack.

The paper's architecture composes four independent systems non-invasively
(Slurm, a modified OpenWhisk controller, pilot jobs, invokers). This module
makes those seams explicit so every composition decision is an interface, not
a constructor flag:

  ==================  =====================================================
  seam                decides
  ==================  =====================================================
  :class:`Router`     which healthy invoker a request's topic message lands
                      on (controller placement policy)
  :class:`Scaler`     how many pilot jobs of which lengths sit in the Slurm
                      queue (supply policy; the paper's open-loop fib/var
                      managers and the closed-loop adaptive manager)
  :class:`AdmissionPolicy`  which requests the controller accepts before
                      routing (SLO contracts, token buckets, concurrency caps)
  :class:`WorkloadSource`  what traffic arrives when (uniform QPS replay or
                      multi-tenant heterogeneous suites)
  :class:`Executor`   what actually runs when an invoker pulls a request
                      (simulated service time or a real decode on the
                      port's engines on the card, whose measured wall
                      time advances virtual time)
  ==================  =====================================================

Implementations register under string keys in :mod:`repro_torch.platform.registry`
and are resolved by :meth:`repro_torch.platform.Platform.build` from a declarative
:class:`repro_torch.platform.ScenarioConfig` — a new policy is one registered
class, never another ``HarvestRuntime`` keyword argument.

All protocols are ``runtime_checkable`` and method-only, so conformance can
be asserted with ``isinstance`` in tests without inheriting from anything.
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple, TYPE_CHECKING, runtime_checkable

if TYPE_CHECKING:
    from repro_torch.core.controller import Controller
    from repro_torch.core.invoker import Invoker
    from repro_torch.core.queues import Request
    from repro_torch.platform.runtime import Platform


@runtime_checkable
class Router(Protocol):
    """Placement policy for the controller (paper Sec. III-C mechanism stays
    in :class:`repro_torch.core.controller.Controller`; only the choice is here)."""

    def route(self, req: "Request", ctrl: "Controller") -> Optional[int]:
        """Return the id of the healthy invoker to enqueue ``req`` on, or
        ``None`` when no placement is possible (controller 503s)."""
        ...

    def on_register(self, inv: "Invoker") -> None:
        """An invoker became healthy and joined the routable set."""
        ...

    def on_deregister(self, inv: "Invoker") -> None:
        """An invoker left the routable set (drain or death)."""
        ...


@runtime_checkable
class Scaler(Protocol):
    """Pilot-job supply policy driving the Slurm queue (paper Sec. III-D-b)."""

    def start(self) -> None:
        """Schedule the supply loop on the sim clock; must be idempotent."""
        ...


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Pre-routing accept/reject decision in the controller request path."""

    def check(self, req: "Request", now: float) -> Tuple[bool, str]:
        """Return ``(admitted, reason)``; on admission any in-flight
        accounting is taken immediately."""
        ...

    def release(self, req: "Request") -> None:
        """Called exactly once when an admitted request reaches a terminal
        outcome; frees in-flight accounting."""
        ...


@runtime_checkable
class WorkloadSource(Protocol):
    """Traffic generator: schedules arrival events against the platform."""

    def schedule(self, platform: "Platform") -> None:
        """Register every arrival as a sim event that submits through
        ``platform.submit`` / ``platform.submit_class``."""
        ...


@runtime_checkable
class Executor(Protocol):
    """Maps a pulled request to its execution time in seconds. Simulation
    executors return the request's nominal service time; real executors run
    the actual function (e.g. a model decode) and return measured wall time,
    which advances virtual time — the scheduling layer is oblivious."""

    def __call__(self, req: "Request") -> float:
        ...

"""Executors: what actually runs when an invoker pulls a request.

The port's twin of ``repro.platform.executors``. Sim-only runs and runs on
the port's engines on the card share one construction path — the scenario's
``platform.executor`` key resolves here, and the invoker calls whatever it
gets the same way. :class:`SimExecutor` returns the request's nominal service
time; :class:`ServingExecutor` performs a real bounded decode on a
:class:`repro_torch.serving.engine.ServingEngine` and returns measured wall
seconds, which advance virtual time (the scheduling layer is oblivious —
the paper's Sec. V-D setup).

:class:`BatchedServingExecutor` (registry key ``batched-serving``) is the
continuous-batching variant: it exposes ``run_batch`` so the invoker hands it
every request it admits in one pull, and all of them decode together on a
:class:`repro_torch.serving.engine.ContinuousEngine` — one batched decode per
token wave instead of one full generate per request. Each request is charged
its own completion latency inside the batch, so virtual time sees the real
(shorter) wall clock the invoker spent. ``drain()`` parks partial
generations keyed by request id; a resubmitted request resumes its decode.

Every charged second is device-complete: ``ContinuousEngine.serve`` and
``ServingEngine.generate`` end each step in a host copy of the picked
tokens, which waits for the card. Torch and the model zoo are imported
lazily inside the serving factories, so pure-simulation scenarios never pay
the accelerator-stack import.
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List, TYPE_CHECKING

import numpy as np

from repro_torch.platform.registry import register

if TYPE_CHECKING:
    from repro_torch.core.queues import Request
    from repro_torch.platform.runtime import Platform


def tenant_of(fn: str) -> str:
    """Tenant owning a FaaS function: the name minus its variant suffix
    (``"img-resize-3" -> "img-resize"``); suffix-less names are their own
    tenant."""
    return fn.rsplit("-", 1)[0] if "-" in fn else fn


def tenant_prefix(tenant: str, vocab_size: int, prefix_len: int) -> List[int]:
    """Deterministic shared system prefix for a tenant (crc32-seeded, same
    stability contract as :func:`prompt_for_fn`)."""
    rng = np.random.default_rng(zlib.crc32(b"prefix:" + tenant.encode()))
    return rng.integers(0, vocab_size, size=prefix_len).astype(int).tolist()


def prompt_for_fn(fn: str, vocab_size: int, prompt_len: int,
                  prefix_len: int = 0, tenant: str = None) -> List[int]:
    """Deterministic prompt for a FaaS function name. Seeded with a stable
    digest (crc32), NOT ``hash()``: Python string hashing is randomized per
    process (PYTHONHASHSEED), which would silently break the 'reproducible
    decode' contract across invoker restarts.

    With ``prefix_len > 0`` the first ``prefix_len`` tokens are the tenant's
    shared system prefix (:func:`tenant_prefix`) — every function of one
    tenant starts with the same tokens, so a paged engine prefills the
    prefix once and forks it. Total length stays ``prompt_len``; the default
    ``prefix_len=0`` output is unchanged."""
    rng = np.random.default_rng(zlib.crc32(fn.encode()))
    body = rng.integers(0, vocab_size, size=prompt_len).astype(int).tolist()
    if prefix_len <= 0:
        return body
    if prefix_len >= prompt_len:
        raise ValueError(f"prefix_len={prefix_len} must be < "
                         f"prompt_len={prompt_len}")
    pre = tenant_prefix(tenant if tenant is not None else tenant_of(fn),
                        vocab_size, prefix_len)
    return pre + body[prefix_len:]


def _require(engine, cls, key: str) -> None:
    """The serving executors run the port's engines only (a ``repro``
    engine raises here rather than deep inside a decode)."""
    if not isinstance(engine, cls):
        raise TypeError(f"{key} needs a {cls.__name__} of repro_torch; got "
                        f"{type(engine).__module__}.{type(engine).__name__}")


class SimExecutor:
    """Pure simulation: the request carries its own service time."""

    def __call__(self, req: "Request") -> float:
        return req.exec_time


class ServingExecutor:
    """Real execution on the port's engines on the card: a bounded
    ``generate`` call on a serving engine; the function name seeds the
    prompt (stable digest) so each FaaS function is a distinct,
    reproducible decode."""

    def __init__(self, engine, prompt_len: int = 16, n_new: int = 8):
        from repro_torch.serving.engine import ServingEngine
        _require(engine, ServingEngine, "serving")
        self.engine = engine
        self.prompt_len = prompt_len
        self.n_new = n_new

    def __call__(self, req: "Request") -> float:
        prompt = np.asarray([prompt_for_fn(req.fn, self.engine.cfg.vocab_size,
                                           self.prompt_len)], np.int32)
        t0 = time.perf_counter()
        self.engine.generate(prompt, self.n_new)   # ends in a host copy
        return time.perf_counter() - t0


class BatchedServingExecutor:
    """Continuous-batching execution: concurrent in-flight requests on an
    invoker share one :class:`ContinuousEngine` of the port instead of
    serializing through per-request ``generate`` calls.

    The invoker detects ``run_batch`` and hands over every request admitted
    in one pull loop; per-request cost is the request's real completion
    latency inside the batched run. Two preemption hand-off paths park
    partial generations so a resubmitted request (same id) RESUMES instead
    of restarting from token 0: ``drain()`` for a live engine interrupted
    mid-decode (real-serving SIGTERM), and ``note_preempt`` — called by
    :meth:`Invoker.sigterm`'s requeue path — which keeps the prefix of the
    already-decoded stream proportional to the virtual seconds the doomed
    invocation actually ran (the drained worker hands those tokens back).
    """

    _RESULTS_CAP = 8192   # decoded streams kept for preemption hand-off

    def __init__(self, engine, prompt_len: int = 16, n_new: int = 8,
                 resume_bucket: int = 4, prefix_len: int = 0):
        from repro_torch.serving.engine import ContinuousEngine
        _require(engine, ContinuousEngine, "batched-serving")
        self.engine = engine
        self.prompt_len = prompt_len
        self.n_new = n_new
        # tenant system-prefix tokens at the head of every prompt; a paged
        # engine prefills each tenant's prefix once and forks it per request
        self.prefix_len = prefix_len
        # parked partials are truncated to a multiple of this, as in
        # ``repro`` (where it bounds jit retraces of the prefill). The port
        # traces nothing, but truncating alike keeps its resumed streams,
        # and so its charged decodes, the reference's
        self.resume_bucket = max(resume_bucket, 1)
        self._partials: Dict[int, List[int]] = {}  # req.id -> parked tokens
        # req.id -> (decoded stream, tokens already banked before that run)
        self._results: Dict[int, tuple] = {}
        self.last_results: Dict[int, List[int]] = {}  # last batch's tokens

    def run_batch(self, reqs: List["Request"]) -> List[float]:
        """Decode every request together; returns per-request wall seconds
        (completion latency inside the batch, prefill included)."""
        from repro_torch.serving.batching import GenRequest
        eng = self.engine
        if self.prefix_len > 0:
            for t in sorted({tenant_of(req.fn) for req in reqs}):
                eng.register_prefix(
                    tenant_prefix(t, eng.cfg.vocab_size, self.prefix_len))
        gens = [GenRequest(id=req.id,
                           prompt=prompt_for_fn(req.fn, eng.cfg.vocab_size,
                                                self.prompt_len,
                                                self.prefix_len),
                           max_new=self.n_new,
                           generated=self._partials.pop(req.id, []))
                for req in reqs]
        banked = {g.id: len(g.generated) for g in gens}
        finished_at = eng.serve(gens)
        self.last_results = {f.id: list(f.generated)
                             for f in eng.batcher.finished}
        eng.batcher.finished.clear()
        for rid, toks in self.last_results.items():
            self._results.pop(rid, None)   # move-to-end: keep live ids fresh
            self._results[rid] = (toks, banked.get(rid, 0))
        while len(self._results) > self._RESULTS_CAP:   # evict oldest
            self._results.pop(next(iter(self._results)))
        return [finished_at[req.id] for req in reqs]

    def __call__(self, req: "Request") -> float:
        return self.run_batch([req])[0]

    def note_preempt(self, req: "Request", elapsed: float, total: float):
        """Invoker preemption hand-off (virtual time): the invocation ran
        ``elapsed`` of its ``total`` virtual seconds before the requeue.
        Tokens banked by an earlier drain survive unconditionally; of the
        tokens THIS invocation owed, the elapsed fraction survives (an
        approximation — ``total`` also carries dispatch overhead/cold
        start, slightly under-crediting short invocations)."""
        entry = self._results.get(req.id)
        if entry is None or total <= 0:
            return
        toks, base = entry
        frac = min(max(elapsed / total, 0.0), 1.0)
        keep = base + int((len(toks) - base) * frac)
        if keep:
            self._park(req.id, list(toks[:keep]))

    def _park(self, rid: int, toks: List[int]) -> bool:
        toks = toks[:len(toks) - len(toks) % self.resume_bucket]
        if not toks:
            return False
        self._partials.pop(rid, None)      # move-to-end: keep live ids fresh
        self._partials[rid] = toks
        while len(self._partials) > self._RESULTS_CAP:  # evict oldest:
            # never-resumed requests (timed out / lost) must not pile up
            self._partials.pop(next(iter(self._partials)))
        return True

    def drain(self) -> int:
        """SIGTERM hand-off for a live engine interrupted mid-decode: park
        every unfinished request's partial tokens (truncated to the resume
        bucket) for resumption on resubmit. Returns how many were parked."""
        return sum(self._park(gr.id, list(gr.generated))
                   for gr in self.engine.drain())


@register("executor", "sim")
def build_sim(platform: "Platform", **params) -> SimExecutor:
    return SimExecutor(**params)


def _smoke_engine(arch: str, init_seed: int, max_seq: int, continuous: bool,
                  paged: bool = False, kernel_impls="reference", device=None,
                  **engine_params):
    """The smoke config of ``arch`` on ``device`` (``None``: the card),
    random weights from ``init_seed``: the port's own stream, not
    ``repro``'s (parity goes through ``engine=``)."""
    import torch  # deferred: only serving scenarios pay this import

    from repro_torch.configs import get_config
    from repro_torch.configs.base import with_kernel_impls
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import (ContinuousEngine,
                                            PagedContinuousEngine,
                                            ServingEngine)
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=True)
    if kernel_impls != "reference":
        cfg = with_kernel_impls(cfg, kernel_impls)
    model_params = init_params(
        cfg, torch.Generator(device=dev).manual_seed(init_seed), dev)
    if continuous:
        cls = PagedContinuousEngine if paged else ContinuousEngine
        return cls(cfg, model_params, max_seq=max_seq, device=dev,
                   **engine_params)
    return ServingEngine(cfg, model_params, max_seq=max_seq, device=dev)


def _warm_up(engine):
    """The invoker's warm-up on the card: build every CUDA kernel of the
    port (one ``nvcc`` per source, in parallel; a no-op once built) before
    the first request. ``repro`` pays its jit inside the first request;
    here that would charge tens of seconds of ``nvcc`` as request latency
    in virtual time and time the first requests out."""
    if engine.device.type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all()


def _scenario_model_knobs(platform: "Platform", arch, kernel_impls):
    """Resolve the model-zoo knobs: explicit executor param > scenario
    ``platform.model`` / ``platform.kernel_impls`` > defaults."""
    sc = getattr(getattr(platform, "scenario", None), "platform", None)
    if arch is None:
        arch = getattr(sc, "model", "") or "qwen2.5-3b"
    if kernel_impls is None:
        kernel_impls = getattr(sc, "kernel_impls", "reference") or "reference"
    return arch, kernel_impls


@register("executor", "serving")
def build_serving(platform: "Platform", *, engine=None, arch: str = None,
                  max_seq: int = 64, init_seed: int = 0, kernel_impls=None,
                  device=None, **params) -> ServingExecutor:
    """``device`` (``None``: the card, raising without CUDA) places the
    smoke engine built here; an ``engine`` passed in keeps its own."""
    arch, kernel_impls = _scenario_model_knobs(platform, arch, kernel_impls)
    if engine is None:
        engine = _smoke_engine(arch, init_seed, max_seq, continuous=False,
                               kernel_impls=kernel_impls, device=device)
    executor = ServingExecutor(engine, **params)
    _warm_up(engine)
    return executor


_KV_GAUGES = ("blocks_in_use", "blocks_high_water", "bytes_in_use",
              "pool_bytes", "prefill_tokens", "share_hit_rate")


def _register_kv_gauges(platform: "Platform", engine):
    """Callback gauges over the engine's KV accounting (both layouts expose
    the same keys, so dashboards compare dense vs paged one-to-one)."""
    if platform is None or getattr(platform, "metrics", None) is None:
        return
    layout = engine.kv_stats()["layout"]
    for key in _KV_GAUGES:
        platform.metrics.gauge(f"kv_{key}",
                               fn=(lambda k=key: engine.kv_stats()[k]),
                               layout=layout)


@register("executor", "batched-serving")
def build_batched_serving(platform: "Platform", *, engine=None,
                          arch: str = None, max_seq: int = 64,
                          init_seed: int = 0, n_slots: int = 4,
                          kv_layout: str = None, block_size: int = 16,
                          n_blocks: int = None, attn: str = "gather",
                          kernel_impls=None, device=None,
                          **params) -> BatchedServingExecutor:
    """``kv_layout`` (param > scenario ``platform.kv_layout`` > dense) picks
    the engine's KV cache: ``dense`` reserves ``n_slots x max_seq`` rows,
    ``paged`` shares a block pool (``block_size``/``n_blocks``/``attn`` are
    paged-only tuning; ``attn="kernel"`` runs the CUDA paged-attention
    kernel). ``arch``/``kernel_impls`` (param > scenario ``platform.model``
    / ``platform.kernel_impls``) pick the served model and which sites run
    the hand-written kernels vs the reference path. ``device`` (``None``:
    the card, raising without CUDA) places the smoke engine built here; an
    ``engine`` passed in keeps its own."""
    if kv_layout is None:
        sc = getattr(platform, "scenario", None)
        kv_layout = getattr(getattr(sc, "platform", None), "kv_layout",
                            None) or "dense"
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"batched-serving: unknown kv_layout={kv_layout!r}; "
                         f"allowed values: ('dense', 'paged')")
    arch, kernel_impls = _scenario_model_knobs(platform, arch, kernel_impls)
    if engine is None:
        paged_kw = (dict(block_size=block_size, n_blocks=n_blocks, attn=attn)
                    if kv_layout == "paged" else {})
        engine = _smoke_engine(arch, init_seed, max_seq, continuous=True,
                               paged=(kv_layout == "paged"),
                               n_slots=n_slots, kernel_impls=kernel_impls,
                               device=device, **paged_kw)
    executor = BatchedServingExecutor(engine, **params)
    _warm_up(engine)
    _register_kv_gauges(platform, engine)
    return executor


def as_executor(obj):
    """Validate an executor override: any ``request -> seconds`` callable
    satisfies the Executor protocol and passes through; None stays None."""
    if obj is None or callable(obj):
        return obj
    raise TypeError(f"executor override must be callable, got {type(obj)!r}")


__all__ = ["SimExecutor", "ServingExecutor", "BatchedServingExecutor",
           "prompt_for_fn", "tenant_of", "tenant_prefix", "as_executor",
           "build_sim", "build_serving", "build_batched_serving"]

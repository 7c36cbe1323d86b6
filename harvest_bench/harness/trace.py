"""The traced run's profiled stretch: ``torch.profiler`` over the last
``length_s`` seconds of the window (the traffic file's ``profile``), the
harness's spans in it, and what a reader takes from them.

Spans are ``record_function`` ranges around each ``add()`` (``admit``) and
each ``step()`` (``decode_step``); the rest of the host's time is the
harness's own. Both calls end by copying tokens to the host, so the device
work a span launches runs inside it, and a kernel is the span's whose range
holds the kernel's start. The trace stays in memory; nothing is written.
"""
from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

from harvest_bench.harness.work import MOE_GMM_KERNELS, GmmRecorder

SPAN_PREFIX = "hb."
HOST_IDLE = "harness"


def is_gmm_kernel(name: str) -> bool:
    return any(re.search(rf"(?<!\w){k}(?!\w)", name) for k in MOE_GMM_KERNELS)


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class SpanIndex:
    """Which harness span (name) holds a time, from sorted spans."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][2]
        return HOST_IDLE


def summarize(kernels: List[Tuple[float, float, str]], spans: List[Tuple[float, float, str]],
              window_s: float) -> Dict:
    """Readings of a stretch: ``kernels`` and ``spans`` as (start, end,
    name) in microseconds of one clock, ``window_s`` its length."""
    index = SpanIndex(spans)
    busy = merge([(s, e) for s, e, _ in kernels])
    by_span: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    gmm_s, gmm_n = 0.0, 0
    for s, e, name in kernels:
        d = (e - s) / 1e6
        owner = index.at(s)
        by_span[owner] = by_span.get(owner, 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
        if is_gmm_kernel(name):
            gmm_s, gmm_n = gmm_s + d, gmm_n + 1
    gaps: List[Tuple[float, str]] = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gaps.append(((s1 - e0) / 1e6, index.at((e0 + s1) / 2)))
    idle_by: Dict[str, float] = {}
    for d, owner in gaps:
        idle_by[owner] = idle_by.get(owner, 0.0) + d
    n_spans: Dict[str, int] = {}
    for _, _, name in spans:
        n_spans[name] = n_spans.get(name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = [[f"{k}: all gaps", v] for k, v in sorted(idle_by.items(), key=lambda kv: -kv[1])]
    idle += [[f"{owner}: one gap", d] for d, owner in sorted(gaps, reverse=True)]
    return {"busy_s": sum(e - s for s, e in busy) / 1e6, "window_s": window_s,
            "device_s_by_span": by_span, "n_spans": n_spans, "gmm_kernels": gmm_n,
            "gmm_s": gmm_s, "kernels": len(kernels),
            "breakdown": {"device_ops": [[n[:160], v] for n, v in top], "idle_gaps": idle[:10]}}


class Tracer:
    """Starts the profiler ``length_s`` before the window closes and stops it
    when the window has closed (:meth:`finish`), with the ``moe_gmm``
    recorder installed over the same steps; the trace is reduced after the
    window, so its reading costs the window nothing."""

    def __init__(self, length_s: float, seconds: float, cuda: bool):
        self.offset_s = max(seconds - length_s, 0.0)
        self.cuda = cuda
        self.prof = None
        self.recorder = GmmRecorder()
        self.result: Optional[Dict] = None

    def warm(self) -> None:
        """Start and stop the profiler once during set-up, so that its first
        start (which loads the tracing library) is not in the window."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.ones(8, device="cuda" if self.cuda else "cpu").sum().item()

    def _activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])

    def span(self, name: str):
        if self.prof is None:
            from harvest_bench.harness.loop import _NULL
            return _NULL
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def tick(self, elapsed: float) -> None:
        if self.prof is None and self.result is None and elapsed >= self.offset_s:
            self._start()

    def _start(self) -> None:
        from repro_torch.kernels.ops import launch_counts
        from torch.profiler import profile
        self._sync()
        self.launches0 = launch_counts()["moe_gmm"]
        self.recorder.install()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def finish(self) -> None:
        """Stop the profiler (the window has closed) and reduce the trace."""
        from repro_torch.kernels.ops import launch_counts
        from torch.autograd import DeviceType
        if self.prof is None:
            return
        self._sync()
        window_s = time.perf_counter() - self.t0
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.recorder.uninstall()
        launches = launch_counts()["moe_gmm"] - self.launches0
        kernels, spans = [], []
        for e in prof.events():
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                # a span shows on the device's timeline too (as a user
                # annotation): it is the host's, not an operation
                if e.device_type != DeviceType.CUDA:
                    spans.append((tr.start, tr.end, e.name[len(SPAN_PREFIX):]))
            elif e.device_type == DeviceType.CUDA:
                kernels.append((tr.start, tr.end, e.name))
        self.result = summarize(kernels, spans, window_s)
        self.result.update(gmm_launches=launches, gmm_recorded=len(self.recorder.launches),
                           gmm_fault=self.recorder.fault)
        if kernels:
            self.result["gmm_work"] = self.recorder.work()

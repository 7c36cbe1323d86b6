"""The port's own spans (``repro_torch.spans``) over a run's window, for the
readers of the host times of a decode step and of the MoE rows counted at
admission.

The port stamps its spans on the window's clock (``time.perf_counter``), so
they are selected by ``run.window``: over the window's unprofiled part,
``[t0, stop - trace["window_s"]]`` (the profiler slows the host it traces),
or over the whole window when the run has no trace. Only spans that lie
wholly inside the part count. A reader finds nothing, and says why on
standard error, where the port has no recorder (a tree from before it),
where the recorder's ring pushed out records that may lie inside the part,
or where the part holds no span.

A span's parent is the span that was open when it opened (its cause): the
engine's ``engine.step`` holds ``model.decode_step`` (the dispatch of the
layers, each ``model.moe`` inside it) and ``engine.pick`` (the pick and
its copy to the host, which waits for the card); ``engine.admit`` holds an
admission's ``model.moe`` spans, whose counts give the rows that carry a
token (``rows``) and the rows launched (``rows_launched``).
"""
from __future__ import annotations

import importlib
import sys
from typing import Dict, List, Optional, Tuple


def recorder():
    """The port's span recorder, None for a port without one."""
    try:
        return importlib.import_module("repro_torch.spans")
    except ImportError:
        return None


def unprofiled(run) -> Tuple[int, int]:
    """The window's unprofiled part, in ns of ``time.perf_counter``."""
    w = run.window
    stop = w.stop - (run.trace["window_s"] if run.trace else 0.0)
    return round(w.t0 * 1e9), round(stop * 1e9)


class Spans:
    """The spans wholly inside one stretch, with their tree."""

    def __init__(self, records: List):
        self.records = records
        self.by_seq = {r.seq: r for r in records}
        self.children: Dict[int, List] = {}
        for r in records:
            if r.parent is not None:
                self.children.setdefault(r.parent, []).append(r)

    def named(self, name: str) -> List:
        return [r for r in self.records if r.name == name]

    def under(self, parent: str, name: str) -> List:
        """Spans named ``name`` whose parent is named ``parent``."""
        return [r for r in self.records if r.name == name and r.parent in self.by_seq
                and self.by_seq[r.parent].name == parent]

    def kids(self, r, name: Optional[str] = None) -> List:
        return [c for c in self.children.get(r.seq, []) if name is None or c.name == name]

    def steps(self) -> List:
        """The ``engine.step`` spans that decoded (held a dispatch)."""
        return [s for s in self.named("engine.step") if self.kids(s, "model.decode_step")]


def stretch(metric: str, t0: int, t1: int) -> Optional[Spans]:
    """The spans wholly inside ``[t0, t1]`` (ns), or None with a line on
    standard error."""
    sp = recorder()
    if sp is None:
        print(f"{metric}: the port records no spans: not read", file=sys.stderr)
        return None
    recs = sp.records()
    # records are in the order spans closed: those pushed out ended first
    if sp.dropped() and (not recs or recs[0].end >= t0):
        print(f"{metric}: the span ring pushed out {sp.dropped()} records that may lie in "
              f"the part read: not read", file=sys.stderr)
        return None
    inside = [r for r in recs if r.start >= t0 and r.end <= t1]
    if not inside:
        print(f"{metric}: no span in the part read: not read", file=sys.stderr)
        return None
    return Spans(inside)


def part(run, metric: str) -> Optional[Spans]:
    """The spans of the window's unprofiled part."""
    return stretch(metric, *unprofiled(run))


def dispatch_ns(s: Spans) -> List[int]:
    return [r.end - r.start for r in s.under("engine.step", "model.decode_step")]


def moe_ns(s: Spans) -> List[int]:
    """Per decoding step, the summed ``model.moe`` spans of its dispatch."""
    return [sum(m.end - m.start for d in s.kids(st, "model.decode_step")
                for m in s.kids(d, "model.moe")) for st in s.steps()]


def wait_ns(s: Spans) -> List[int]:
    return [r.end - r.start for r in s.under("engine.step", "engine.pick")]


def self_ns(s: Spans) -> List[int]:
    """Per decoding step, the step less its children's spans."""
    return [(st.end - st.start) - sum(c.end - c.start for c in s.kids(st))
            for st in s.steps()]


def row_use(s: Spans) -> Optional[float]:
    """Rows that carry a token over rows launched, in %, of the MoE layers
    of the admissions."""
    counted = [m.counts for m in s.under("engine.admit", "model.moe")
               if m.counts and m.counts.get("rows_launched")]
    if not counted:
        return None
    return 100.0 * sum(c["rows"] for c in counted) / sum(c["rows_launched"] for c in counted)

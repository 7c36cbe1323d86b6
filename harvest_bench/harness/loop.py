"""The closed loop: ``clients`` callers, each sending its next request the
moment its previous one completes, as an invoker with ``concurrency``
slots pulls from a backlogged topic.

The loop calls the engine's public ``add()`` and ``step()`` only. A
request is sent when the step that finished its client's previous one
returns (the step ends by copying the picked tokens to the host, so the
device is done); its ``add()`` prefills it at batch 1 into the freed slot
and returns with its first token on the host. So a request's time to first
token holds the wait behind the admissions sent before it in the same gap,
and its latency ends when the step that emitted its last token returns.

Warm-up runs this loop until every one of the first ``clients`` requests
has completed (each slot has turned over once); the window opens at the
next step and closes at the first step boundary past ``seconds``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from harvest_bench.harness.work import ModelFlops


@dataclasses.dataclass
class Sent:
    req: object                  # the port's GenRequest
    send: float
    first: Optional[float] = None
    end: Optional[float] = None


@dataclasses.dataclass
class Window:
    t0: float = 0.0
    stop: float = 0.0
    tokens: int = 0              # output tokens emitted in the window
    sent: List[Sent] = dataclasses.field(default_factory=list)      # sent in the window
    finished: List[Sent] = dataclasses.field(default_factory=list)  # ended in the window
    admit_s: List[float] = dataclasses.field(default_factory=list)  # host span of each add() alone
    counters0: Dict[str, int] = dataclasses.field(default_factory=dict)
    counters1: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops: Optional[ModelFlops] = None

    @property
    def seconds(self) -> float:
        return self.stop - self.t0


def engine_counters(engine) -> Dict[str, int]:
    return {"n_decode_steps": engine.n_decode_steps, "n_slot_steps": engine.n_slot_steps,
            "n_slots": engine.n_slots}


class NoSpans:
    """Span hooks of a run without tracing: no-ops."""

    def span(self, name: str):
        return _NULL

    def tick(self, elapsed: float) -> None:
        pass


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class ClosedLoop:
    def __init__(self, engine, traffic, clients: int, cfg,
                 clock: Callable[[], float] = time.perf_counter, spans=None):
        self.engine = engine
        self.traffic = traffic
        self.clients = clients
        self.clock = clock
        self.spans = spans or NoSpans()
        self.cfg = cfg
        self.next_id = 0
        self.live: Dict[int, Sent] = {}
        self.window: Optional[Window] = None
        self.all_sent: List[Sent] = []

    def _send(self, t: float) -> None:
        from repro_torch.serving.batching import GenRequest
        prompt, out = self.traffic.request(self.next_id)
        req = GenRequest(id=self.next_id, prompt=prompt, max_new=out)
        self.next_id += 1
        s = Sent(req, t)
        self.live[req.id] = s
        self.all_sent.append(s)
        w = self.window
        t_add = self.clock()
        with self.spans.span("admit"):
            self.engine.add(req)
        s.first = self.clock()
        if w is not None:
            w.sent.append(s)
            w.admit_s.append(s.first - t_add)
            w.tokens += 1
            w.flops.prefill(len(prompt))
        for _ in self._reap(s.first):   # done at its admission: its client sends again
            self._send(s.first)

    def _reap(self, t: float) -> List[Sent]:
        done = []
        for req in self.engine.batcher.finished:
            s = self.live.pop(req.id)
            s.end = t
            done.append(s)
            if self.window is not None:
                self.window.finished.append(s)
        self.engine.batcher.finished.clear()
        return done

    def _step(self) -> int:
        """One decode step, then a request sent for each completed one."""
        w = self.window
        if w is not None:
            w.flops.decode([len(r.prompt) + len(r.generated) - 1
                            for r in self.engine.batcher.active().values()])
        with self.spans.span("decode_step"):
            n = self.engine.step()
        t1 = self.clock()
        if w is not None:
            w.tokens += n
        for _ in self._reap(t1):
            self._send(t1)
        return n

    def warm_up(self) -> None:
        """Send ``clients`` requests, then step until each has completed."""
        t = self.clock()
        for _ in range(self.clients):
            self._send(t)
        first = self.all_sent[:self.clients]
        while any(s.end is None for s in first):
            if self._step() == 0:
                raise RuntimeError("the engine stopped with requests still open")

    def run(self, seconds: float) -> Window:
        """The measured window: steps from now until ``seconds`` have passed."""
        w = Window(flops=ModelFlops(self.cfg))
        w.counters0 = engine_counters(self.engine)
        self.window = w
        w.t0 = self.clock()
        while True:
            now = self.clock()
            if now - w.t0 >= seconds:
                break
            self.spans.tick(now - w.t0)
            if self._step() == 0:
                raise RuntimeError("the engine stopped with requests still open")
        w.stop = self.clock()
        w.counters1 = engine_counters(self.engine)
        return w

"""A copy of ``repro.serving.batching`` (the port imports nothing of
``repro``).

Slot-based continuous batching for the serving engine: requests occupy
fixed batch slots; finished slots are refilled without stopping the decode
loop. Engine-agnostic bookkeeping — the real batched decode lives in
:class:`repro_torch.serving.engine.ContinuousEngine`, which drives one of these."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class GenRequest:
    id: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    eos_id: Optional[int] = None   # per-request stop token (early slot free)

    @property
    def remaining(self) -> int:
        """Tokens still owed — non-zero ``generated`` means a drained partial
        being resumed (the platform's ``resubmit()`` hand-off), not a fresh decode."""
        return max(self.max_new - len(self.generated), 0)


class SlotBatcher:
    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.slots: List[Optional[GenRequest]] = [None] * n_slots
        self.waiting: List[GenRequest] = []
        self.finished: List[GenRequest] = []

    def add(self, req: GenRequest) -> List[int]:
        """Queue a request; returns the slot indices newly filled (so an
        engine can prefill exactly those)."""
        self.waiting.append(req)
        return self._fill()

    def _fill(self) -> List[int]:
        filled = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.waiting:
                self.slots[i] = self.waiting.pop(0)
                filled.append(i)
        return filled

    def active(self) -> Dict[int, GenRequest]:
        return {i: r for i, r in enumerate(self.slots) if r is not None}

    def _finish_if_done(self, i: int, req: GenRequest, tok: int,
                        eos_id: Optional[int]) -> bool:
        """Terminate slot ``i`` on length or stop-token; returns True when the
        slot was freed."""
        stop = req.eos_id if req.eos_id is not None else eos_id
        if len(req.generated) >= req.max_new or (stop is not None and tok == stop):
            req.done = True
            self.finished.append(req)
            self.slots[i] = None
            return True
        return False

    def step(self, emit: Callable[[GenRequest], int],
             eos_id: Optional[int] = None) -> List[int]:
        """Advance every active slot by one token via ``emit``. A slot frees
        early when the emitted token matches the request's ``eos_id`` (or the
        batcher-wide ``eos_id`` default), else at ``max_new``. Returns the
        slot indices refilled from the waiting queue."""
        for i, req in list(self.active().items()):
            tok = emit(req)
            req.generated.append(tok)
            self._finish_if_done(i, req, tok, eos_id)
        return self._fill()

    def drain(self) -> List[GenRequest]:
        """SIGTERM hand-off: return all unfinished work (waiting + in-slot)
        for fast-lane requeue; slots are cleared. In-slot requests keep their
        partial ``generated`` so a resumed decode continues instead of
        restarting."""
        out = list(self.waiting)
        self.waiting.clear()
        for i, r in enumerate(self.slots):
            if r is not None:
                out.append(r)
                self.slots[i] = None
        return out

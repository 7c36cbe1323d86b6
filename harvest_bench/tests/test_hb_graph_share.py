"""``decode_graph_share``: by hand on made-up records, over the window's
unprofiled part, and nothing to read where the port's decode steps carry
no ``graphed`` count."""
from types import SimpleNamespace

import pytest

from harvest_bench import run
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.loop import Window
from repro_torch.spans import Record

MS = 1_000_000     # ns


class Recorder:
    def __init__(self, recs):
        self.recs = recs

    def records(self):
        return self.recs

    def dropped(self):
        return 0


def step(seq, t, graphed):
    """One decode step at ``t`` ms: its dispatch (with a MoE layer) counting
    ``graphed`` (no count for None), then its pick."""
    t0 = t * MS
    counts = None if graphed is None else {"graphed": graphed}
    return [Record(seq + 2, "model.moe", t0 + 2 * MS, t0 + 3 * MS, seq + 1, None,
                   {"rows": 64, "rows_launched": 128}),
            Record(seq + 1, "model.decode_step", t0 + MS, t0 + 5 * MS, seq, None, counts),
            Record(seq + 3, "engine.pick", t0 + 5 * MS, t0 + 8 * MS, seq, None, None),
            Record(seq, "engine.step", t0, t0 + 9 * MS, None, seq, None)]


def read(recs, monkeypatch, traced=True):
    monkeypatch.setattr(ps, "recorder", lambda: Recorder(recs))
    run_ = SimpleNamespace(window=Window(t0=1.0, stop=2.0),
                           trace={"window_s": 0.4} if traced else None)
    return run.load_reader("decode_graph_share")(run_)


@pytest.mark.parametrize("traced,want", [(True, 75.0), (False, 80.0)])
def test_share_of_replayed_steps(monkeypatch, traced, want):
    recs = (step(0, 900, 0)                                  # before the window
            + step(10, 1000, 0)                              # the capture
            + step(20, 1100, 1) + step(30, 1200, 1) + step(40, 1300, 1)
            + step(50, 1650, 1)                              # in the profiled part
            + [Record(60, "model.decode_step", 1400 * MS, 1401 * MS, None, None,
                      {"graphed": 0})])                      # not under a step
    assert read(recs, monkeypatch, traced) == pytest.approx(want)


def test_nothing_to_read_without_the_count(monkeypatch, capsys):
    recs = step(10, 1000, None) + step(20, 1100, None)
    assert read(recs, monkeypatch) is None
    assert "no decode step counts graphed" in capsys.readouterr().err
    assert read([], monkeypatch) is None

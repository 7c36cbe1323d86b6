"""The readers of the port's spans (``harness.program_spans``): by hand on
made-up records, and on a CPU rehearsal, where the MoE rows of the
admissions are counted again from the admitted prompts' lengths."""
import json
import sys
from types import SimpleNamespace

import pytest

from harvest_bench import run
from harvest_bench.harness import program_spans as ps
from harvest_bench.harness.loop import Window
from repro_torch.spans import Record

NEW = ("host_ms.decode_dispatch", "host_ms.decode_moe", "host_wait_ms.decode_step",
       "host_self_ms.decode_step", "moe_gmm_row_use.admit")
MS = 1_000_000     # ns


class Recorder:
    def __init__(self, recs, dropped=0):
        self.recs, self.n = recs, dropped

    def records(self):
        return self.recs

    def dropped(self):
        return self.n


def step(seq, t, dispatch, moe, wait, self_ms, admit=None):
    """One decode step at ``t`` ms: its dispatch (``moe`` ms of it in two
    MoE layers), its pick and ``self_ms`` of its own, then an admission of
    ``admit`` = (rows, rows launched) if given. Children close first."""
    t0 = t * MS
    d0, d1 = t0 + MS // 10, t0 + MS // 10 + dispatch * MS
    out = [Record(seq + 2, "model.moe", d0, d0 + moe * MS // 2, seq + 1, None,
                  {"rows": 64, "rows_launched": 128}),
           Record(seq + 3, "model.moe", d0 + moe * MS // 2, d0 + moe * MS, seq + 1, None,
                  {"rows": 64, "rows_launched": 128}),
           Record(seq + 1, "model.decode_step", d0, d1, seq, None, None),
           Record(seq + 4, "engine.pick", d1, d1 + wait * MS, seq, None, None)]
    end = d1 + wait * MS
    if admit:
        out += [Record(seq + 6, "model.moe", end, end + MS, seq + 5, None,
                       {"rows": admit[0], "rows_launched": admit[1]}),
                Record(seq + 5, "engine.admit", end, end + 2 * MS, seq, 7, None)]
        end += 2 * MS
    out.append(Record(seq, "engine.step", t0, end + self_ms * MS - MS // 10, None, seq, None))
    return out


def made_run(recs, monkeypatch, dropped=0, traced=True):
    monkeypatch.setattr(ps, "recorder", lambda: Recorder(recs, dropped))
    w = Window(t0=1.0, stop=2.0)
    return SimpleNamespace(window=w, trace={"window_s": 0.4} if traced else None)


def read(run_):
    return {m: run.load_reader(m)(run_) for m in NEW}


def test_readers_by_hand(monkeypatch):
    recs = (step(0, 900, 5, 3, 1, 1)                          # before the window
            + step(10, 1000, 10, 6, 2, 1)
            + step(20, 1100, 12, 8, 4, 2, admit=(300, 1200))
            + step(30, 1200, 14, 10, 6, 3)
            + step(40, 1590, 12, 8, 4, 2)                     # into the profiled part
            + [Record(50, "engine.admit", 1700 * MS, 1710 * MS, None, 9, None)])
    got = read(made_run(recs, monkeypatch))
    assert got["host_ms.decode_dispatch"] == pytest.approx(12.0)
    assert got["host_ms.decode_moe"] == pytest.approx(8.0)
    assert got["host_wait_ms.decode_step"] == pytest.approx(4.0)
    # the middle step's self time leaves out its admission's 2 ms
    assert got["host_self_ms.decode_step"] == pytest.approx(2.0)
    assert got["moe_gmm_row_use.admit"] == pytest.approx(25.0)
    # the whole window without a trace: the step at 1590 ms counts too
    untraced = read(made_run(recs, monkeypatch, traced=False))
    assert untraced["host_ms.decode_dispatch"] == pytest.approx(12.0)
    assert untraced["host_wait_ms.decode_step"] == pytest.approx(4.0)


def test_the_parts_of_a_step_sum_to_the_step(monkeypatch):
    recs = sum((step(10 * i, 1000 + 20 * i, 5 + i, 3, 1 + i % 3, 1 + i % 2,
                     admit=(10, 40) if i % 4 == 0 else None) for i in range(20)), [])
    s = ps.part(made_run(recs, monkeypatch), "test")
    steps = s.steps()
    assert len(steps) == 20
    for st, d, w, own in zip(steps, ps.dispatch_ns(s), ps.wait_ns(s), ps.self_ns(s)):
        admits = sum(c.end - c.start for c in s.kids(st, "engine.admit"))
        assert d + w + own + admits == st.end - st.start


def test_nothing_to_read(monkeypatch, capsys):
    assert set(read(made_run([], monkeypatch)).values()) == {None}
    # pushed-out records may reach into the part: nothing is read
    recs = step(10, 1000, 10, 6, 2, 1, admit=(1, 2))
    assert set(read(made_run(recs, monkeypatch, dropped=3)).values()) == {None}
    assert "pushed out 3 records" in capsys.readouterr().err
    # they all ended before it: the part is whole
    early = step(0, 900, 5, 3, 1, 1) + recs
    assert None not in read(made_run(early, monkeypatch, dropped=3)).values()


def test_a_port_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)   # import fails
    assert ps.recorder() is None
    run_ = SimpleNamespace(window=Window(t0=1.0, stop=2.0), trace=None)
    assert set(read(run_).values()) == {None}


def test_rehearsal_prints_the_new_metrics(capsys, checkout_env, monkeypatch):
    from repro_torch import spans
    from harvest_bench.harness.spec import load_cell, port_config
    served = []
    serve = run.serve

    def keep(*a, **kw):
        served.append(serve(*a, **kw))
        return served[-1]
    monkeypatch.setattr(run, "serve", keep)
    cell = "mixtral-8x22b-s7.chat32"
    assert run.main(["--workload", cell, "--seed", "3000000019", "--seconds", "2",
                     "--device", "cpu", "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metrics = line["metrics"]
    assert {"cpu.admit_ms.p50", "cpu.slot_occupancy"} <= set(metrics)
    assert {f"cpu.{m}" for m in NEW} <= set(metrics)

    # the admissions inside the unprofiled part, counted again from the
    # lengths of the prompts the harness sent
    (s,) = served
    cfg = port_config(load_cell(cell, rehearsal=True).config, rehearsal=True)
    t0, t1 = ps.unprofiled(s)
    ids = [r.id for r in spans.records() if r.name == "engine.admit"
           and t0 <= r.start and r.end <= t1]
    lengths = {x.req.id: len(x.req.prompt) for x in s.window.sent}
    assert ids and set(ids) <= set(lengths)
    rows = launched = 0
    for i in ids:
        tk = lengths[i] * cfg.top_k
        bt = 128 if tk >= 128 else 8
        rows += tk
        launched += -(-tk // bt) * bt + cfg.n_experts * bt
    assert metrics["cpu.moe_gmm_row_use.admit"]["value"] == pytest.approx(100 * rows / launched)

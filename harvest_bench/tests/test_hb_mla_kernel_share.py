"""``mla_kernel_share``: by hand on made-up records, over the window's
unprofiled part; admissions whose MLA prefills counted ``kernel`` 1, ran
the einsum (no count) or mixed the two; nothing to read without an MLA
prefill under an admission."""
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


def admit(seq, t, kernels, s=4096):
    """One admission at ``t`` ms of an ``s``-token prompt: an MLA prefill
    span a layer, counting ``kernel`` 1 (and no score bytes) where the
    layer's flag is true, the einsum's counts where it is false; then a MoE
    span."""
    t0 = t * MS
    out = []
    for i, k in enumerate(kernels):
        counts = ({"tokens": s, "score_bytes": 0, "kernel": 1} if k
                  else {"tokens": s, "score_bytes": 16 * s * s * 4})
        out.append(Record(seq + 1 + i, "model.mla_prefill", t0 + (2 * i + 1) * MS,
                          t0 + (2 * i + 2) * MS, seq, None, counts))
    n = len(kernels)
    out.append(Record(seq + 1 + n, "model.moe", t0 + (2 * n + 1) * MS, t0 + (2 * n + 2) * MS,
                      seq, None, {"rows": 24, "rows_launched": 128}))
    out.append(Record(seq, "engine.admit", t0, t0 + (2 * n + 3) * MS, None, seq, None))
    return out


def read(recs, monkeypatch, traced=True):
    monkeypatch.setattr(ps, "recorder", lambda: Recorder(recs))
    run_ = SimpleNamespace(window=Window(t0=1.0, stop=2.0),
                           trace={"window_s": 0.4} if traced else None)
    return run.load_reader("mla_kernel_share")(run_)


@pytest.mark.parametrize("layers,want", [
    ([True] * 3, 100.0),                    # every prefill on the kernel
    ([False] * 3, 0.0),                     # the einsum's spans carry no count
    ([True, False, True], 200.0 / 3),       # mixed
])
def test_share_of_kernel_prefills(monkeypatch, layers, want):
    recs = (admit(0, 1000, layers) + admit(20, 1200, layers)
            + admit(40, 900, [False] * 3)                   # before the window
            + admit(60, 1700, [False] * 3)                  # in the profiled part
            + [Record(80, "model.mla_prefill", 1400 * MS, 1401 * MS, None, None,
                      {"tokens": 1, "score_bytes": 64})])    # not under an admission
    assert read(recs, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("traced,want", [(True, 100.0 * 4 / 9), (False, 100.0 * 7 / 12)])
def test_read_over_the_unprofiled_part(monkeypatch, traced, want):
    """An einsum admission, a kernel one, a mixed one (one layer of three on
    the kernel), then a kernel one in the profiled part, read only without
    a trace."""
    recs = (admit(0, 1000, [False] * 3) + admit(20, 1200, [True] * 3)
            + admit(40, 1300, [False, True, False]) + admit(60, 1700, [True] * 3))
    assert read(recs, monkeypatch, traced) == pytest.approx(want)


def test_nothing_to_read_without_an_mla_prefill(monkeypatch, capsys):
    recs = [Record(1, "model.moe", 1100 * MS, 1101 * MS, 0, None, {"rows": 8,
                                                                   "rows_launched": 64}),
            Record(0, "engine.admit", 1000 * MS, 1200 * MS, None, 0, None)]
    assert read(recs, monkeypatch) is None
    assert "no MLA prefill under an admission" in capsys.readouterr().err
    assert read([], monkeypatch) is None

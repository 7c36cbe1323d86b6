"""The reduction of a profiled stretch, and the readers on its output."""
from types import SimpleNamespace

import pytest

from harvest_bench import run
from harvest_bench.harness.loop import Window
from harvest_bench.harness.trace import SpanIndex, merge, summarize


def test_merge_and_span_index():
    assert merge([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    idx = SpanIndex([(10, 20, "admit"), (30, 40, "decode_step")])
    assert [idx.at(t) for t in (5, 10, 15, 25, 40, 41)] == [
        "harness", "admit", "admit", "harness", "decode_step", "harness"]


def stretch():
    # times in microseconds: an admission 0-1000 with two kernels, a step
    # 1200-2200 with a moe_gmm kernel, one kernel in the harness's time
    kernels = [(100, 400, "void flash_tc_kernel<128>(TcArgs)"), (500, 900, "ampere_gemm"),
               (1300, 1800, "void (anonymous namespace)::gmm_narrow_kernel(GmmArgs)"),
               (1900, 2000, "ampere_gemm"), (2500, 2600, "memcpy")]
    spans = [(0, 1000, "admit"), (1200, 2200, "decode_step")]
    return summarize(kernels, spans, window_s=0.003)


def test_summarize_by_hand():
    s = stretch()
    assert s["busy_s"] == pytest.approx(1400e-6)
    assert s["device_s_by_span"] == pytest.approx(
        {"admit": 700e-6, "decode_step": 600e-6, "harness": 100e-6})
    assert s["n_spans"] == {"admit": 1, "decode_step": 1}
    assert s["gmm_kernels"] == 1 and s["gmm_s"] == pytest.approx(500e-6)
    idle = dict((k, v) for k, v in s["breakdown"]["idle_gaps"] if k.endswith("all gaps"))
    assert idle["admit: all gaps"] == pytest.approx(100e-6)
    assert idle["decode_step: all gaps"] == pytest.approx(100e-6)
    assert idle["harness: all gaps"] == pytest.approx(900e-6)
    assert s["breakdown"]["device_ops"][0] == ["ampere_gemm", pytest.approx(500e-6)]
    assert len(s["breakdown"]["device_ops"]) <= 10 and len(s["breakdown"]["idle_gaps"]) <= 10


def record(trace, **kw):
    w = Window(t0=0.0, stop=2.0)
    w.counters0 = {"n_decode_steps": 10, "n_slot_steps": 300, "n_slots": 32}
    w.counters1 = {"n_decode_steps": 20, "n_slot_steps": 620, "n_slots": 32}
    w.admit_s = [0.01, 0.03, 0.02]
    w.flops = SimpleNamespace(total=989e12 * 0.5)
    return SimpleNamespace(window=w, trace=trace, peak_window_bytes=2 ** 31,
                           cuda=True, **kw)


def test_readers():
    t = stretch()
    t.update(gmm_recorded=1, gmm_launches=1, gmm_fault=None,
             gmm_work=(0.0, 0.0, 250e-6))
    rec = record(t)
    read = {m: run.load_reader(m)(rec) for m in (
        "slot_occupancy", "moe_gmm_roofline", "device_idle_share", "mfu", "peak_mem_gib")}
    assert run.load_reader("admit_ms.p50")(rec) == pytest.approx(20.0)
    assert run.load_reader("device_ms.decode_step")(rec) == pytest.approx(0.6)
    assert run.load_reader("device_ms.admit")(rec) == pytest.approx(0.7)
    assert read["slot_occupancy"] == pytest.approx(100.0)
    assert read["moe_gmm_roofline"] == pytest.approx(50.0)
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 1400e-6 / 0.003))
    assert read["mfu"] == pytest.approx(25.0)
    assert read["peak_mem_gib"] == pytest.approx(2.0)


def test_roofline_reads_nothing_when_the_counts_disagree():
    t = stretch()
    t.update(gmm_recorded=1, gmm_launches=2, gmm_fault=None, gmm_work=(0.0, 0.0, 1e-4))
    assert run.load_reader("moe_gmm_roofline")(record(t)) is None
    t.update(gmm_launches=1, gmm_fault="a launch without sizes")
    assert run.load_reader("moe_gmm_roofline")(record(t)) is None


def test_device_readers_read_nothing_without_a_trace():
    rec = record(None, )
    rec.cuda = False
    for m in ("device_ms.decode_step", "device_ms.admit", "moe_gmm_roofline",
              "device_idle_share", "mfu"):
        assert run.load_reader(m)(rec) is None

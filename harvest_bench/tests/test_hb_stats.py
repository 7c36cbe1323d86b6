"""The end-to-end arithmetic: tails over every request sent in the window,
an open one at its age when the window closed."""
import statistics
from types import SimpleNamespace

import pytest

from harvest_bench import run
from harvest_bench.harness.loop import Sent, Window
from harvest_bench.harness.stats import latencies, quantile


def test_open_requests_count_with_their_age():
    assert latencies([0.0, 1.0, 2.0], [0.5, None, 2.25], stop=10.0) == [0.5, 9.0, 0.25]


def test_quantile_is_over_all_values_not_a_median_of_chunks():
    values = [1.0] * 90 + [100.0] * 10
    chunks = [values[i:i + 10] for i in range(0, 100, 10)]
    median_of_chunks = statistics.median(quantile(c, 0.95) for c in chunks)
    assert median_of_chunks == 1.0
    assert quantile(values, 0.95) == 100.0
    assert quantile(list(range(101)), 0.95) == 95.0
    assert quantile([], 0.95) is None and quantile([3.0], 0.5) == 3.0
    with pytest.raises(ValueError):
        quantile([1.0, 2.0], 0.955)


def test_end_to_end_reads_the_window():
    sent = [Sent(None, send=1.0 + i * 0.1, first=1.02 + i * 0.1,
                 end=None if i % 10 == 9 else 2.0 + i * 0.1) for i in range(40)]
    w = Window(t0=1.0, stop=11.0, tokens=500, sent=sent)
    s = SimpleNamespace(window=w, setup_s=12.5)
    m = run.end_to_end(s, ["tokens_per_s", "latency_p95_s", "ttft_p95_ms", "latency_p90_s",
                           "ttft_p90_ms", "setup_s"])
    assert m["tokens_per_s"] == pytest.approx(50.0)
    lat = [(11.0 if x.end is None else x.end) - x.send for x in sent]
    assert m["latency_p95_s"] == pytest.approx(quantile(lat, 0.95))
    assert m["latency_p90_s"] == pytest.approx(quantile(lat, 0.90))
    assert max(lat) > 9.0            # an open request's age is in the tail
    assert m["ttft_p95_ms"] == pytest.approx(20.0) and m["ttft_p90_ms"] == pytest.approx(20.0)
    assert m["setup_s"] == 12.5
    with pytest.raises(ValueError):
        run.end_to_end(s, ["queue_depth"])


class _Engine:
    """An engine whose ``add()`` takes 0.1 s of the fake clock."""

    def __init__(self, clock):
        self.clock = clock
        self.batcher = SimpleNamespace(finished=[])

    def add(self, req):
        self.clock.t += 0.1


def test_admission_time_leaves_out_the_wait_in_its_gap():
    from harvest_bench.harness.loop import ClosedLoop

    clock = SimpleNamespace(t=0.0)
    eng = _Engine(clock)
    traffic = SimpleNamespace(request=lambda i: ([1, 2, 3], 4))
    flops = SimpleNamespace(prefill=lambda n: None, decode=lambda ctx: None)
    loop = ClosedLoop(eng, traffic, clients=3, cfg=None, clock=lambda: clock.t)
    loop.window = Window(flops=flops)
    for _ in range(3):                  # three requests sent at one moment
        loop._send(0.0)
    w = loop.window
    assert w.admit_s == pytest.approx([0.1, 0.1, 0.1])     # each add() alone
    assert [x.first - x.send for x in w.sent] == pytest.approx([0.1, 0.2, 0.3])

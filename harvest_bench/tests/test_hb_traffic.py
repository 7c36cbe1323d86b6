"""The traffic generator: repeatable by seed, within its clips, the same
sizes for every seed in another order."""
from collections import Counter

import pytest

from harvest_bench.harness.spec import BENCH_DIR, read_json
from harvest_bench.harness.traffic import Traffic, quantile_sizes

MIXES = ["chat32", "extract16"]


def mix(name):
    return read_json(BENCH_DIR / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = Traffic(mix(name), 32768, 2147483761), Traffic(mix(name), 32768, 2147483761)
    for i in (0, 1, 63, 64, 500):
        assert a.request(i) == b.request(i)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_same_sizes_in_the_same_order_other_tokens(name):
    m = mix(name)
    a, b = Traffic(m, 32768, 1), Traffic(m, 32768, 2)
    block = m["block"]
    sizes = [a.sizes(i) for i in range(3 * block)]
    assert sizes == [b.sizes(i) for i in range(3 * block)]
    assert sizes[:block] != sizes[block:2 * block]          # each block in an order of its own
    for part in (sizes[block:2 * block], sizes[2 * block:]):
        assert Counter(p for p, _ in part) == Counter(p for p, _ in sizes[:block])
        assert Counter(o for _, o in part) == Counter(o for _, o in sizes[:block])
    assert a.request(5)[0] != b.request(5)[0]


@pytest.mark.parametrize("name", MIXES)
def test_sizes_within_clips_and_tokens_in_vocab(name):
    m = mix(name)
    t = Traffic(m, 1000, 7)
    for i in range(3 * m["block"]):
        prompt, out = t.request(i)
        assert m["prompt"]["min"] <= len(prompt) <= m["prompt"]["max"]
        assert m["output"]["min"] <= out <= m["output"]["max"]
        assert len(prompt) + out <= m["max_seq"]
        assert all(0 <= tok < 1000 for tok in prompt)


def test_quantile_sizes_median_and_clip():
    d = {"dist": "lognormal", "median": 256, "sigma": 0.7, "min": 64, "max": 1024}
    sizes = quantile_sizes(d, 64)
    assert sizes == sorted(sizes)
    assert sizes[31] <= 256 <= sizes[32]
    assert min(sizes) >= 64 and max(sizes) <= 1024
    with pytest.raises(ValueError):
        quantile_sizes({**d, "dist": "uniform"}, 4)


def test_mix_longer_than_max_seq_refused():
    m = dict(mix("chat32"), max_seq=100)
    with pytest.raises(ValueError):
        Traffic(m, 100, 0)

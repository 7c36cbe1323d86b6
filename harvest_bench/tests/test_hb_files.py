"""Every file a cell needs resolves by name, and BENCHMARK.json keeps to
the benchmark's contract on names, keys and units."""
import copy
import re

import pytest

from harvest_bench import run
from harvest_bench.harness.spec import BENCH_DIR, ROOT, load_cell, port_config, read_json

BENCH = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("rehearsal", [False, True])
def test_cell_files_resolve(cell, rehearsal):
    c = load_cell(cell, rehearsal)
    assert c.limits["gap_mean"] > 0
    assert c.traffic["clients"] == c.traffic["slots"]
    assert (BENCH_DIR / "reference" / f"{c.config['reference']}.py").is_file()
    assert c.config["control"] and c.config["rehearsal"]["control"]


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        load_cell("no-such-cell")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    assert callable(run.load_reader(metric))


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(entry):
    config = read_json(ROOT / entry["file"])
    assert entry["file"].startswith("harvest_bench/configs/")
    assert config["source"] == entry["source"] and config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert key in config and key in config["published"]
        assert not re.search(r"(_dim|_rank|size|heads|experts_per_tok)$", key)
    assert config["assumed"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
@pytest.mark.parametrize("rehearsal", [False, True])
def test_port_runs_the_widths_its_file_states(entry, rehearsal):
    config = read_json(ROOT / entry["file"])
    cfg = port_config(config, rehearsal)
    stated = config["rehearsal"]["hp"] if rehearsal else config
    for key, field in config["port"]["fields"].items():
        if key in stated:
            assert getattr(cfg, field) == stated[key], key
    wrong = copy.deepcopy(config)
    (wrong["rehearsal"]["hp"] if rehearsal else wrong)["hidden_size"] += 64
    with pytest.raises(ValueError, match="hidden_size"):
        port_config(wrong, rehearsal)

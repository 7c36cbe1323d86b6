"""The benchmark on the card: one short run of each cell prints a correct
line with every end-to-end metric. Skips without a card (run on the chip:
``python -m pytest -m gpu harvest_bench/tests``)."""
import json

import pytest

from harvest_bench import run
from harvest_bench.harness.spec import ROOT, read_json

BENCH = read_json(ROOT / "BENCHMARK.json")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(cell, card, capsys, checkout_env):
    assert run.main(["--workload", cell, "--seed", "11", "--seconds", "5"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                    if cell in m.get("workloads", [cell])}

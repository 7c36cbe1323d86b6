"""Find a cell's files by name and turn them into a run's inputs.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (``configs/<name>.json``, through the ``file`` of its entry in
``configs``) and a traffic mix (``traffic/<name>.json``). Its correctness
limits are in ``limits/<cell>.json``. ``rehearsal`` swaps in each file's
``rehearsal`` section: the port's smoke-size model and a small mix, for a
run on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: Dict[str, Any]     # the configuration file
    traffic: Dict[str, Any]    # the traffic file (its rehearsal section when rehearsing)
    limits: Dict[str, Any]     # name -> limit of each number compared
    chips: int
    rehearsal: bool


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, rehearsal: bool = False, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises ``KeyError`` for a
    name it does not list."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json; known: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[entry["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(BENCH_DIR / "limits" / f"{name}.json")
    if rehearsal:
        traffic = traffic["rehearsal"]
        limits = limits["rehearsal"]
    return Cell(name, config, traffic, {k: v["limit"] for k, v in limits.items()
                                        if isinstance(v, dict) and "limit" in v},
                entry["chips"], rehearsal)


def port_config(config: Dict[str, Any], rehearsal: bool = False):
    """The port's ``ModelConfig`` as the configuration file runs it: its
    ``arch_id`` (the smoke preset when rehearsing) with the file's
    ``replace`` applied, every kernel site that the architecture has on
    (``kernel_impls="auto"``). Raises ``ValueError`` where a field that
    ``port.fields`` maps from a key of the file (its ``rehearsal.hp`` when
    rehearsing) differs from that key's value, so that the cell runs the
    widths its file states."""
    from repro_torch.configs import get_config, with_kernel_impls
    port = config["port"]
    base = get_config(port["arch_id"], smoke=rehearsal)
    replace = dict(port["rehearsal_replace"] if rehearsal else port["replace"])
    cfg = with_kernel_impls(dataclasses.replace(base, **replace), "auto")
    stated = config["rehearsal"]["hp"] if rehearsal else config
    differ = {key: (stated[key], getattr(cfg, field)) for key, field in port["fields"].items()
              if key in stated and stated[key] != getattr(cfg, field)}
    if differ:
        raise ValueError(f"{config['name']}: the port's config differs from the file's "
                         f"(key: (file, port)): {differ}")
    return cfg

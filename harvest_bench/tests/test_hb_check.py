"""How ``correct`` comes out: a sound rehearsal run is correct; the
control and every fault that a one-chip serving cell can have are not.

The faults break the timed path underneath a whole run (``run.main`` at
``--device cpu``, past the look for a card): a decode step that leaves the
slot state as it was; half of the batch left out (the second half of the
slots takes the other half's logits, the halves in turn); a token altered where it is produced
(each admission's). The exchange between chips has no place on one chip."""
import json

import pytest
import torch

from harvest_bench import run
from harvest_bench.harness.check import compare
from harvest_bench.harness.spec import load_cell
from harvest_bench.reference.common import Bf16

CELLS = ["mixtral-8x22b-s7.chat32"]


def main_line(capsys, cell, seed, fault=None):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
                   "--device", "cpu"], fault=fault)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def state_unchanged(engine):
    from repro_torch.models.model import tree_map
    decode = engine._decode_active

    def stale(pos):
        saved = tree_map(lambda t: t.clone(), engine.cache)
        logits = decode(pos)
        tree_map(lambda t, s: t.copy_(s), engine.cache, saved)
        return logits
    engine._decode_active = stale


def half_batch(engine):
    decode = engine._decode_active
    steps = [0]

    def half(pos):
        logits = decode(pos)
        n, h = logits.shape[0], logits.shape[0] // 2
        # the half left out takes the other half's rows; which half
        # alternates, so every slot's request is hit
        if steps[0] % 2:
            logits[:h] = logits[n - h:]
        else:
            logits[n - h:] = logits[:h]
        steps[0] += 1
        return logits
    engine._decode_active = half


def token_altered(engine):
    pick = engine._pick_row

    def altered(logits):
        toks = pick(logits)
        if logits.shape[0] == 1:
            toks = (toks + 1) % engine.cfg.vocab_size
        return toks
    engine._pick_row = altered


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys, checkout_env):
    line = main_line(capsys, cell, 2147483789)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert all(k.startswith("cpu.") for k in line["metrics"])
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, token_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, capsys, checkout_env):
    line = main_line(capsys, cell, 17, fault)
    assert line["correct"] is False
    assert line["checks"]["gap_mean"]["value"] > line["checks"]["gap_mean"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(cell, seed):
    """The control (the reference one precision below the rehearsal's
    float32, bfloat16) on the served tokens of 40 requests run to the end."""
    from harvest_bench.harness.spec import port_config
    from harvest_bench.harness.traffic import Traffic
    from harvest_bench.harness.weights import make_weights
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ContinuousEngine
    c = load_cell(cell, rehearsal=True)
    cfg = port_config(c.config, rehearsal=True)
    w = make_weights(cfg, seed, torch.device("cpu"))
    mix = c.traffic
    eng = ContinuousEngine(cfg, w, n_slots=mix["slots"], max_seq=mix["max_seq"],
                           device="cpu")
    traffic = Traffic(mix, cfg.vocab_size, seed)
    reqs = [GenRequest(id=i, prompt=p, max_new=n) for i, (p, n) in
            ((i, traffic.request(i)) for i in range(40))]
    with torch.no_grad():
        eng.serve(reqs)
        numbers = compare(w, c.config, reqs, seed, 400, True, Bf16())
    assert numbers["gap_mean"] <= c.limits["gap_mean"] < numbers["control_gap_mean"]


def test_no_card_exits_without_a_line(capsys, checkout_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_loaded_jax_package_exits_without_a_line(capsys, checkout_env, monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "0.5",
                     "--device", "cpu"]) == 4
    assert capsys.readouterr().out == ""

"""The ``"data"`` and ``"pod"`` axes of training in the port, continued:
the MoE capacity and load-balance statistics of the global batch,
microbatches, the ``"pod"`` axis, ``remat="full"``, checkpoints across mesh
shapes and the launch loop, on a grid of four gloo ranks against
``repro``'s train step jitted on a host mesh of the same shape (CPU,
float32, smoke size). The ranks run the "rest" part of
``test_torch_dp_train.py``'s program, started once for this module, and 3
steps of zamba2, hubert and internvl2, held as there.

- MoE under ``moe_impl="scatter"`` with tokens dropped: the grid's drops
  are one device's token for token, its ``lb_loss`` and steps ``repro``'s;
  summing the load-balance statistics a second time in the backward (a
  mutant) fails the same comparison.
- ``n_microbatches=2`` on ``(data 2, model 2)`` and the ``(pod 2, data 2,
  model 1)`` grid against ``repro``'s; ``remat="full"``, each layer
  gathered again in the backward, bit for bit ``"none"``.
- A resume across a resize: the grid saves after 2 steps (each leaf
  gathered to rank 0 alone), ``repro`` restores the checkpoint bit for
  bit, and ``reshard_restore`` onto ``(data 4, model 1)``, ``(data 1,
  model 2)`` and one device each take step 3 equal to the grid's.
- ``launch.train.train(tc, tp=grid)``: a resume is bit for bit the
  unbroken run.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, close
from test_torch_dp_train import (GRID, POD_GRID, RESUME, SCATTER, _assemble, _check_parity,
                                 _close_metrics, _close_trained, _inputs, _jax_steps,
                                 _repro_steps, _setup, _start)
from test_torch_forward import _torch
from test_torch_train_step import OPT, _close_params, _leaves
from repro.checkpoint import checkpoint as jckpt
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.distributed.sharding import data_axis
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

pytestmark = pytest.mark.slow

MOE = "mixtral-8x22b"
# the other three of test_torch_dp_train.py's seven archs
ARCHS = ("zamba2-2.7b", "hubert-xlarge", "internvl2-26b")


@pytest.fixture(scope="module")
def setup():
    return _setup((RESUME, MOE) + ARCHS)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The four ranks' "rest" part, and ``repro``'s references computed
    while they run."""
    inputs = _inputs(setup, "rest", ARCHS, (), tmp_path_factory.mktemp("dpr"))
    wait = _start(inputs, tmp_path_factory.mktemp("dpr4"))
    ref = _repro_steps(setup, ARCHS)
    v = setup[MOE]
    ref["scatter"] = _jax_steps(dataclasses.replace(v["jc"], **SCATTER), v["jp"],
                                v["batches"], GRID)
    v = setup[RESUME]
    ref["microbatches"] = _jax_steps(v["jc"], v["jp"], v["big"][:2], GRID, n_mb=2)
    ref["pod"] = _jax_steps(v["jc"], v["jp"], v["big"], POD_GRID)
    ref["remat"] = _jax_steps(v["jc"], v["jp"], v["batches"][:2], GRID)
    return {"repro": ref, "ranks": wait(), "inputs": inputs}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_data2_model2_matches_repro(setup, runs, arch):
    """As ``test_torch_dp_train.py``'s, for the three archs this module
    holds: 3 steps on (data 2, model 2) against ``repro``'s on that mesh."""
    _check_parity(setup, runs, arch)


def test_scatter_drops_the_tokens_one_device_drops(setup, runs):
    """mixtral under ``moe_impl="scatter"`` at a capacity that drops tokens:
    every MoE layer's keep mask of the grid's first step, its ``(pod,
    data)`` ranks' side by side, is the one-device forward's; the capacity
    comes from the global token count; the steps and ``lb_loss`` are
    ``repro``'s on the mesh."""
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.weights import params_from_numpy

    v = setup[MOE]
    tc = dataclasses.replace(v["tc"], **SCATTER)
    keeps, dispatch = [], moe._capacity_dispatch

    def record(*a, **k):
        out = dispatch(*a, **k)
        keeps.append(out[2].clone())
        return out
    moe._capacity_dispatch = record
    try:
        tp = params_from_numpy(jax.tree.map(np.asarray, v["jp"]), tc, "cpu")
        M.loss_fn(tp, _torch(v["batches"][0]), tc)
    finally:
        moe._capacity_dispatch = dispatch
    ranks = runs["ranks"]
    assert len(keeps) == len(ranks[0]["scatter"]["keeps"]) == tc.n_layers
    for layer, one in enumerate(keeps):
        grid = np.concatenate([ranks[r]["scatter"]["keeps"][layer] for r in (0, 2)])
        assert not one.all() and np.array_equal(grid, one.numpy())
        assert all(np.array_equal(ranks[r]["scatter"]["keeps"][layer],
                                  ranks[r - 1]["scatter"]["keeps"][layer]) for r in (1, 3))
    want = runs["repro"]["scatter"]
    for r in ranks:
        _close_metrics(r["scatter"]["metrics"], want["metrics"])
    _close_params(_assemble(ranks, "scatter", "params", tc), want["params"])
    _close_params(_assemble(ranks, "scatter", "m", tc), want["m"])


def test_summing_the_lb_statistics_twice_in_the_backward_fails(setup, runs):
    """The mutant: the load-balance statistics' sum over ``(pod, data)``
    whose backward also sums (a "copy" after the "reduce") doubles the
    lb gradient; the comparison the real run passes must fail on it."""
    tc = dataclasses.replace(setup[MOE]["tc"], **SCATTER)
    want = runs["repro"]["scatter"]
    mutant = runs["ranks"][0]["mutant"]
    close(mutant["metrics"][0]["lb_loss"], want["metrics"][0]["lb_loss"], F32_TOL)   # forward
    failed = []
    for what, check in (("grad_norm", lambda: _close_metrics(mutant["metrics"], want["metrics"])),
                        ("params", lambda: _close_params(
                            _assemble(runs["ranks"], "mutant", "params", tc), want["params"])),
                        ("m", lambda: _close_params(
                            _assemble(runs["ranks"], "mutant", "m", tc), want["m"]))):
        try:
            check()
        except AssertionError:
            failed.append(what)
    assert failed == ["grad_norm", "params", "m"], failed


def test_microbatches_on_a_grid_match_repro(setup, runs):
    """Two microbatches of (4, 24) on (data 2, model 2): microbatch ``i`` is
    global rows ``[2 i, 2 i + 2)`` split over ``"data"``, as ``repro``
    splits them; under the one stated exception of
    ``test_torch_train_step.py``."""
    tc = setup[RESUME]["tc"]
    want = runs["repro"]["microbatches"]
    for r in runs["ranks"]:
        _close_metrics(r["microbatches"]["metrics"], want["metrics"], 2)
    _close_trained(setup, RESUME, _assemble(runs["ranks"], "microbatches", "params", tc),
                   want["params"], setup[RESUME]["big"][:2], n_mb=2, steps=2)


def test_pod_data_grid_matches_repros_three_axis_mesh(setup, runs):
    """internlm2 on (pod 2, data 2, model 1), 3 steps of 4 rows (one a
    rank) against ``repro``'s step on the 3-axis mesh; the two pods' copies
    are the same bits."""
    tc = setup[RESUME]["tc"]
    want = runs["repro"]["pod"]
    ranks = runs["ranks"]
    assert [r["pod"]["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    for r in ranks:
        _close_metrics(r["pod"]["metrics"], want["metrics"])
    got = _assemble(ranks, "pod", "params", tc, dims=POD_GRID)
    _close_trained(setup, RESUME, got, want["params"], setup[RESUME]["big"])
    for rank in (2, 3):   # pod 1's ranks hold pod 0's bits
        for path, x in _leaves(ranks[rank]["pod"]["params"]).items():
            np.testing.assert_array_equal(x, _leaves(ranks[rank - 2]["pod"]["params"])[path])


def test_remat_full_gathers_each_layer_again_and_matches_repro(setup, runs):
    """``remat="full"`` on the grid: each layer's ``"data"`` gather runs
    again in the backward's recompute (the forward gathers of a step grow
    by the stack's), the metrics are ``repro``'s and the parameters those of
    ``remat="none"`` on the grid bit for bit."""
    tc = setup[RESUME]["tc"]
    want = runs["repro"]["remat"]
    none, full = (runs["ranks"][0][("remat", m)] for m in ("none", "full"))
    for r in runs["ranks"]:
        _close_metrics(r[("remat", "full")]["metrics"], want["metrics"], 2)
        for path, x in _leaves(r[("remat", "full")]["params"]).items():
            np.testing.assert_array_equal(x, _leaves(r[("remat", "none")]["params"])[path])
    stacked = sum(1 for path in _leaves(runs["repro"]["remat"]["params"])
                  if path.startswith("/stack/") and data_axis(path.strip("/").split("/"), tc,
                                                              GRID) is not None)
    for a, b in zip(none["collectives"], full["collectives"]):
        fwd = {k: x["data_calls"] - x["backward_data_calls"] for k, x in (("n", a), ("f", b))}
        assert fwd["f"] - fwd["n"] == stacked * tc.n_layers
        assert a["backward_data_calls"] == b["backward_data_calls"] > 0


def test_a_resume_across_mesh_shapes_takes_the_same_next_step(setup, runs):
    """internlm2: the grid saves after 2 steps, each leaf gathered to rank
    0 alone; ``repro`` restores the whole arrays bit for bit;
    ``reshard_restore`` onto (data 4, model 1), (data 1, model 2) and one
    device each take the 3rd step equal to the grid's."""
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.models import model as M
    from repro_torch.training.train_step import make_train_step

    tc = setup[RESUME]["tc"]
    ranks = runs["ranks"]
    ckdir = runs["inputs"]["ckpt"]
    assert ranks[0]["resume"]["committed"] == 2   # rank 0 wrote it before returning
    # each leaf went to rank 0 alone: gathers (over "data", then "model"),
    # no all-gather; rank 0 took part in both stages, rank 3 in the first
    calls = [r["resume"]["save_calls"] for r in ranks]
    assert all(c["all_gather"] == 0 for c in calls), calls
    assert calls[0]["gather"] > calls[3]["gather"] > 0, calls
    saved = _assemble(ranks, "resume", "saved", tc)
    template = {"params": jax.eval_shape(lambda: setup[RESUME]["jp"]),
                "opt": jax.eval_shape(lambda: jax_init_opt_state(setup[RESUME]["jp"]))}
    restored, manifest = jckpt.restore(template, ckdir)
    assert manifest["step"] == 2 and manifest["extra"] == {"k": 1}
    for path, w in _leaves(restored["params"]).items():
        np.testing.assert_array_equal(np.asarray(w), _leaves(saved)[path], err_msg=path)
    assert int(restored["opt"]["step"]) == 2
    whole = M.params_meta(tc)
    state, _ = reshard_restore(tc, {"params": whole, "opt": init_opt_state(whole)}, ckdir,
                               Mesh([torch.device("cpu")], ("model",)))
    step = make_train_step(tc, OptimizerConfig(**OPT))
    p1, _, m1 = step(state["params"], state["opt"], _torch(setup[RESUME]["big"][2]))
    grid3 = ranks[0]["resume"]["grid"]["metrics"][0]
    whole3 = _assemble([r["resume"] for r in ranks], "grid", "params", tc)
    for key in grid3:
        close(float(m1[key]), grid3[key], F32_TOL)
    _close_params(M.tree_map(lambda t: t.numpy(), p1), whole3)
    for name, dims, members in (("data4", (1, 4, 1), ranks), ("model2", (1, 1, 2), ranks[:2])):
        for r in members:
            for key in grid3:
                close(r["resume"][name]["metrics"][0][key], grid3[key], F32_TOL)
        _close_params(_assemble([r["resume"] for r in members], name, "params", tc, dims),
                      whole3)
    assert "model2" not in ranks[2]["resume"] and "model2" not in ranks[3]["resume"]
    assert ranks[0]["resume"]["data4"]["shapes"] != ranks[0]["resume"]["model2"]["shapes"]


def test_train_launch_on_a_grid_resumes_bit_for_bit(runs):
    """``train(tc, tp=grid)``: every rank logs the same losses; a resume
    from the step-2 checkpoint ends with the unbroken run's bits."""
    got = [r["launch"] for r in runs["ranks"]]
    assert all(g == got[0] for g in got)
    unbroken, resumed = got[0]["unbroken"], got[0]["resumed"]
    assert [s for s, _ in unbroken] == [1, 2, 3, 4] and resumed == unbroken[2:]
    assert got[0]["same_params"] and all(np.isfinite(l) for _, l in unbroken)

"""The ``"data"`` and ``"pod"`` axes of training in the port: the train step
on a grid of gloo ranks (``data_parallel.make_grid``) against ``repro``'s
train step jitted on a host mesh of the same shape, on the CPU at float32 at
smoke size.

Four ranks are processes of their own over gloo, started once per module by
``spawn_tp`` from a script that a subprocess runs under a timeout of its own
(the pattern of ``test_torch_tp_train.py``), while ``repro``'s references
are computed here on the host devices that conftest exposes. This module
runs the program's "parity" part; ``test_torch_dp_resume.py`` its "rest"
(the MoE capacity, microbatches, the ``"pod"`` axis, remat, checkpoints
across mesh shapes, the launch loop), so the two modules run on two
workers.

- 3 steps of seven archs on ``(data 2, model 2)`` from ``repro``'s
  parameters, against ``repro``'s step under ``param_shardings`` /
  ``input_shardings`` on that mesh: the metrics at 5e-5/5e-4, the
  parameters and the first moments at ``test_torch_train_step.py``'s
  ``PARAM_TOL`` with its one stated exception; each rank's parameter bytes
  a quarter of the tree's (internlm2, at most 1.1 times it; every full
  config cut on ``meta``); a leaf several ranks hold equal across them bit
  for bit.
- Gradients: every rank's gradient is the ``(d, m)`` cut of ``repro``'s
  whole gradient (internlm2; mixtral, experts cut over ``"model"`` and
  their ``D`` over ``"data"``; mamba2, a B/C group shared over
  ``"model"``), and the global norm is the whole tree's on every rank.
- ``"data"`` never cuts the axis ``"model"`` splits, for every leaf of the
  ten configs; ``init_params(tp=grid)`` draws the cut of the whole tree.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from _torch_parity import F32_TOL, close, configs, params
from test_torch_forward import _batch, _jax
from test_torch_tp_train import _at, _near_zero_masks
from test_torch_train_step import OPT, _close_params, _leaves
from repro.distributed.sharding import input_shardings as jax_input_shardings
from repro.distributed.sharding import param_shardings as jax_param_shardings
from repro.models.model import loss_fn as jax_loss_fn
from repro.training.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.training.optimizer import global_norm as jax_global_norm
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.distributed.data_parallel import grid_layout, holder_key
from repro_torch.distributed.sharding import (assemble_shards, data_axis, local_shard,
                                              map_with_names, tp_split)
from repro_torch.distributed.tensor_parallel import _unsplit

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
# the archs whose steps this module holds to repro's; test_torch_dp_resume.py
# holds the other three of the seven (zamba2, hubert, internvl2)
ARCHS = ("internlm2-1.8b", "mixtral-8x22b", "deepseek-v2-lite-16b", "mamba2-2.7b")
GRAD_ARCHS = ("internlm2-1.8b", "mixtral-8x22b", "mamba2-2.7b")
RESUME = "internlm2-1.8b"
GRID = (1, 2, 2)          # (pod, data, model)
POD_GRID = (2, 2, 1)
STEPS = 3
# mixtral's smoke config under the capacity dispatch: 48 tokens of 4 experts
# top 2 give a capacity of 16 rows an expert for 24 picks on average
SCATTER = dict(moe_impl="scatter", capacity_factor=0.5)

# the ranks' program: ``python dp_train_ranks.py <inputs.pkl> <out.pkl>``
_RANKS = textwrap.dedent('''
    import dataclasses, os, pickle, shutil, sys, time
    import numpy as np
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.data_parallel import batch_rows, make_grid, reduce_grads
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.distributed.sharding import group_mesh, map_with_names, sum_shared
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.training.optimizer import OptimizerConfig, global_norm, init_opt_state
    from repro_torch.training.train_step import _grads_of, make_train_step


    def config(arch, **kw):
        return dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)


    def batch(b):
        return {k: torch.as_tensor(v) for k, v in b.items()}


    def host(tree):
        return M.tree_map(lambda t: t.detach().clone().numpy(), tree)


    def steps(grid, arch, d, n, params=None, opt=None, first=0, n_mb=1, key="batches",
              stats=False, **kw):
        cfg = config(arch, **kw)
        if params is None:
            params = params_from_numpy(d["params"][arch], cfg, "cpu", grid)
            opt = init_opt_state(params)
        step = make_train_step(cfg, OptimizerConfig(**d["opt"]), n_mb, grid)
        metrics, coll = [], []
        for i in range(first, first + n):
            T.reset_stats()
            params, opt, m = step(params, opt, batch(d["batches"][arch][key][i]))
            metrics.append({k: float(v) for k, v in m.items()})
            coll.append(dict(T.STATS))
        return params, opt, (metrics, coll) if stats else metrics


    def grads(grid, arch, d):
        cfg = config(arch)
        params = params_from_numpy(d["params"][arch], cfg, "cpu", grid)
        rows = batch_rows(batch(d["batches"][arch]["batches"][0]), grid)
        g = reduce_grads(_grads_of(params, rows, cfg, grid)[2], cfg, grid)
        g = map_with_names(lambda names, x: sum_shared(x, names, cfg, grid), g)
        return {"grads": host(g), "norm": float(global_norm(g, grid, cfg))}


    def scatter(grid, d, mutant=False):
        """mixtral under the capacity dispatch: the first step's keep masks
        (every MoE layer's), 3 steps; with ``mutant`` the load-balance
        statistics' sum over (pod, data) sums the gradients once more in
        the backward."""
        keeps, dispatch, all_sum = [], moe._capacity_dispatch, moe.all_sum

        def record(*a, **k):
            out = dispatch(*a, **k)
            keeps.append(out[2].clone())
            return out

        def twice(x, tp):
            y = all_sum(x, tp)
            return T.copy_in(y, tp) if tp is not None and tp.axis != "model" else y
        moe._capacity_dispatch = record
        moe.all_sum = twice if mutant else all_sum
        try:
            cfg = config("mixtral-8x22b", **d["scatter"])
            params = params_from_numpy(d["params"]["mixtral-8x22b"], cfg, "cpu", grid)
            opt = init_opt_state(params)
            step = make_train_step(cfg, OptimizerConfig(**d["opt"]), 1, grid)
            metrics = []
            for i, b in enumerate(d["batches"]["mixtral-8x22b"]["batches"]):
                params, opt, m = step(params, opt, batch(b))
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 0:
                    first = [k.numpy() for k in keeps]
        finally:
            moe._capacity_dispatch, moe.all_sum = dispatch, all_sum
        return {"keeps": first, "metrics": metrics, "params": host(params), "m": host(opt["m"])}


    def resume(world, grid, d):
        """(data 2, model 2): two steps, a save, the 3rd; then the save
        restored onto (data 4, model 1) and onto (data 1, model 2), each
        taking the 3rd step."""
        cfg = config(d["resume"])
        out = {}
        p, o, _ = steps(grid, d["resume"], d, 2, key="big")
        out["saved"] = host(p)
        calls = {"gather": 0, "all_gather": 0}
        real = {k: getattr(torch.distributed, k) for k in calls}

        def counted(name):
            def call(*a, **k):
                calls[name] += 1
                return real[name](*a, **k)
            return call
        for k in calls:
            setattr(torch.distributed, k, counted(k))
        try:
            ckpt.save({"params": p, "opt": o}, d["ckpt"], 2, extra={"k": 1}, tp=grid, cfg=cfg)
        finally:
            for k, f in real.items():
                setattr(torch.distributed, k, f)
        out["save_calls"] = calls
        out["committed"] = ckpt.latest_step(d["ckpt"])
        p, o, m3 = steps(grid, d["resume"], d, 1, p, o, first=2, key="big")
        out["grid"] = {"params": host(p), "metrics": m3}
        T.broadcast_object(None)   # rank 0 has written the checkpoint
        whole = M.params_meta(cfg)
        template = {"params": whole, "opt": init_opt_state(whole)}
        for name, to in (("data4", make_grid(world, 4, 1)), ("model2", world.subgroup(2))):
            if to is None:
                continue
            state, manifest = reshard_restore(cfg, template, d["ckpt"], group_mesh(to))
            assert manifest["extra"] == {"k": 1}
            p, o, m3 = steps(to, d["resume"], d, 1, state["params"], state["opt"], first=2,
                             key="big")
            out[name] = {"params": host(p), "metrics": m3,
                         "shapes": [tuple(t.shape) for t in M.tree_leaves(state["params"])]}
        return out


    def launch(world, grid, d):
        tc = TrainConfig(steps=4, ckpt_dir=d["launch"], ckpt_every=2, log_every=1,
                         seq_len=16, global_batch=4)
        p, _, unbroken = train(tc, tp=grid)
        ckpt.wait_for_saves()
        T.broadcast_object(None)   # rank 0's checkpoint is written
        if world.rank == 0:
            shutil.rmtree(os.path.join(d["launch"], "step_00000004"))
        T.broadcast_object(None)
        q, _, resumed = train(tc, tp=grid)
        same = all(torch.equal(a, b) for a, b in zip(M.tree_leaves(p), M.tree_leaves(q)))
        return {"unbroken": unbroken, "resumed": resumed, "same_params": same}


    def rank_main(world, d):
        """3 steps of each of ``d["archs"]``, the gradients of
        ``d["grad_archs"]``, and with ``d["part"]`` "rest" the resume, the
        MoE drops, microbatches, remat, the pod grid and the launch loop."""
        torch.set_num_threads(1)
        grid = make_grid(world, 2, 2)
        out = {"coords": (grid.pod_rank, grid.data_rank, grid.rank)}
        for arch in d["archs"]:
            p, o, m = steps(grid, arch, d, len(d["batches"][arch]["batches"]))
            out[arch] = {"metrics": m, "params": host(p), "m": host(o["m"]),
                         "v_bytes": M.nbytes(o["v"]), "step": int(o["step"])}
        for arch in d["grad_archs"]:
            out[("grads", arch)] = grads(grid, arch, d)
        if d["part"] != "rest":
            return out
        out["resume"] = resume(world, grid, d)
        out["scatter"] = scatter(grid, d)
        out["mutant"] = scatter(grid, d, mutant=True)
        p, _, m = steps(grid, d["resume"], d, 2, n_mb=2, key="big")
        out["microbatches"] = {"metrics": m, "params": host(p)}
        for remat in ("none", "full"):
            p, _, (m, coll) = steps(grid, d["resume"], d, 2, remat=remat, stats=True)
            out[("remat", remat)] = {"metrics": m, "params": host(p), "collectives": coll}
        pod = make_grid(world, 2, 1, pod=2)
        p, _, m = steps(pod, d["resume"], d, 3, key="big")
        out["pod"] = {"metrics": m, "params": host(p),
                      "coords": (pod.pod_rank, pod.data_rank, pod.rank)}
        out["launch"] = launch(world, grid, d)
        return out


    if __name__ == "__main__":
        inputs, output = sys.argv[1], sys.argv[2]
        with open(inputs, "rb") as f:
            d = pickle.load(f)
        results = T.spawn_tp(rank_main, 4, device="cpu", args=(d,), timeout=280)
        with open(output, "wb") as f:
            pickle.dump(results, f)
''')


def _start(inputs, tmp: Path):
    """Start the four ranks in the background; returns a function that
    waits for them (320 s at most) and gives each rank's results."""
    script = tmp / "dp_train_ranks.py"
    script.write_text(_RANKS)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    proc = subprocess.Popen([sys.executable, str(script), str(tmp / "in.pkl"),
                             str(tmp / "out.pkl")],
                            env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=str(tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            _, err = proc.communicate(timeout=320)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            raise AssertionError(f"4 ranks: no end within 320 s\n{err[-4000:]}")
        assert proc.returncode == 0, err[-4000:]
        with open(tmp / "out.pkl", "rb") as f:
            return pickle.load(f)
    return wait


def _mesh(dims):
    """``repro``'s mesh of ``dims`` (pod, data, model) over the host
    devices: ``np.asarray(devices).reshape(sizes)``, ``"model"`` fastest."""
    n = int(np.prod(dims))
    devices = np.asarray(jax.devices()[:n])
    if dims[0] == 1:
        return JaxMesh(devices.reshape(dims[1:]), ("data", "model"))
    return JaxMesh(devices.reshape(dims), ("pod", "data", "model"))


def _jax_steps(jc, jp, batches, dims, n_mb=1):
    """``repro``'s train step jitted on the mesh of ``dims`` under
    ``param_shardings`` and ``input_shardings``, over ``batches``."""
    mesh = _mesh(dims)
    p_sh = jax_param_shardings(jp, jc, mesh)
    opt_sh = {"m": p_sh, "v": p_sh, "step": JaxNamedSharding(mesh, JaxP())}
    b_sh = jax_input_shardings(_jax(batches[0]), mesh)
    with mesh:
        step = jax.jit(jax_make_train_step(jc, JaxOptimizerConfig(**OPT), n_mb),
                       in_shardings=(p_sh, opt_sh, b_sh),
                       out_shardings=(p_sh, opt_sh, JaxNamedSharding(mesh, JaxP())))
        jp, opt = jax.device_put(jp, p_sh), jax.device_put(jax_init_opt_state(jp), opt_sh)
        metrics = []
        for b in batches:
            jp, opt, m = step(jp, opt, _jax(b))
            metrics.append({k: float(x) for k, x in m.items()})
    return {"metrics": metrics, "params": jax.tree.map(np.asarray, jp),
            "m": jax.tree.map(np.asarray, opt["m"]), "step": int(opt["step"])}


def _setup(archs):
    """The archs' ``repro`` configs, parameters and batches (internlm2's
    also 4-row ones)."""
    out = {}
    for arch in archs:
        jc, tc = configs(arch)
        jp, _ = params(jc, tc)
        out[arch] = {"jc": jc, "tc": tc, "jp": jp,
                     "batches": [_batch(tc, seed=10 + i, b=2) for i in range(STEPS)]}
    if RESUME in out:
        out[RESUME]["big"] = [_batch(out[RESUME]["tc"], seed=20 + i, b=4)
                              for i in range(STEPS)]
    return out


def _inputs(setup, part: str, archs, grad_archs, tmp: Path) -> dict:
    """The ranks' inputs for ``part`` of their program, the steps of
    ``archs`` and the gradients of ``grad_archs``."""
    return {"part": part,
            "params": {a: jax.tree.map(np.asarray, v["jp"]) for a, v in setup.items()},
            "batches": {a: {"batches": v["batches"], "big": v.get("big")}
                        for a, v in setup.items()},
            "opt": OPT, "archs": archs, "grad_archs": grad_archs, "resume": RESUME,
            "scatter": SCATTER, "ckpt": str(tmp / "ckpt"), "launch": str(tmp / "launch")}


def _repro_steps(setup, archs) -> dict:
    """``repro``'s 3 steps of each of ``archs`` on the ``GRID`` mesh."""
    return {arch: _jax_steps(setup[arch]["jc"], setup[arch]["jp"], setup[arch]["batches"],
                             GRID) for arch in archs}


@pytest.fixture(scope="module")
def setup():
    return _setup(ARCHS)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The four ranks' "parity" part, and ``repro``'s references computed
    while they run."""
    inputs = _inputs(setup, "parity", ARCHS, GRAD_ARCHS, tmp_path_factory.mktemp("dpt"))
    wait = _start(inputs, tmp_path_factory.mktemp("dpt4"))
    ref = _repro_steps(setup, ARCHS)
    for arch in GRAD_ARCHS:
        v = setup[arch]
        g = jax.grad(lambda p: jax_loss_fn(p, _jax(v["batches"][0]), v["jc"])[0])(v["jp"])
        ref[("grads", arch)] = {"grads": jax.tree.map(np.asarray, g),
                                "norm": float(jax_global_norm(g))}
    return {"repro": ref, "ranks": wait(), "inputs": inputs}


def _assemble(ranks, key, what, tc, dims=GRID):
    """The whole tree from every rank's 2-D shards of ``ranks[r][key][what]``."""
    trees = [r[key][what] for r in ranks]
    return map_with_names(
        lambda names, _: assemble_shards([torch.as_tensor(_at(t, names)) for t in trees],
                                         names, tc, dims=dims).numpy(), trees[0])


def _close_metrics(got, want, steps=STEPS):
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["ce", "grad_norm", "lb_loss", "loss", "lr"]
        for key in w:
            close(g[key], w[key], F32_TOL)


def _close_trained(setup, arch, got, want, batches=None, n_mb=1, steps=STEPS):
    """Parameters within ``PARAM_TOL`` under the one stated exception of
    ``test_torch_train_step.py``: at most one element whose gradient is
    below ``NEAR_ZERO`` in some step, held to ``2 * lr * steps``."""
    try:
        _close_params(got, want)
        return
    except AssertionError:
        pass
    v = setup[arch]
    near_zero = _near_zero_masks(v["jc"], v["jp"], batches or v["batches"], n_mb)
    excepted = _close_params(got, want, near_zero, bound=2 * OPT["lr"] * steps)
    assert sum(excepted.values()) <= 1, excepted


def _nbytes(tree) -> int:
    return sum(np.asarray(x).nbytes for x in _leaves(tree).values())


def test_the_ranks_are_laid_out_as_repros_mesh(runs):
    """World rank r is (p, d, m) with r = (p * data + d) * model + m."""
    assert [r["coords"] for r in runs["ranks"]] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 1), (2, 2, 2), (1, 4, 1)])
def test_grid_coords_and_holder_key_follow_the_mesh_and_the_cut(dims):
    """``grid_coords`` is the place of each rank in ``np.arange(world)
    .reshape(dims)`` (``repro``'s mesh layout), and two ranks have one
    ``holder_key`` for a leaf exactly when ``local_shard`` gives them the
    same cut of it (mamba2's shared B/C segments aside)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.data_parallel import grid_coords
    from repro_torch.models import model as M

    world = int(np.prod(dims))
    layout = np.arange(world).reshape(dims)
    assert [tuple(int(i) for i in np.argwhere(layout == r)[0]) for r in range(world)] == \
        [grid_coords(r, dims) for r in range(world)]
    cfg = dataclasses.replace(get_config("mixtral-8x22b", smoke=True), dtype="float32")
    whole = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    grids = [grid_layout(*dims, r) for r in range(world)]

    def check(names, leaf):
        cuts = [local_shard(leaf, names, cfg, g) for g in grids]
        keys = [holder_key(names, cfg, dims, r) for r in range(world)]
        for a in range(world):
            for b in range(world):
                same = cuts[a].shape == cuts[b].shape and torch.equal(cuts[a], cuts[b])
                assert same == (keys[a] == keys[b]), (names, a, b)
    map_with_names(check, whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_data2_model2_matches_repro(setup, runs, arch):
    """3 steps on (data 2, model 2) against ``repro``'s on that mesh; every
    rank holds a quarter of the state (at most 1.1 times it) and the same
    bits as the other holders of any leaf it shares."""
    _check_parity(setup, runs, arch)


def _check_parity(setup, runs, arch):
    tc = setup[arch]["tc"]
    want = runs["repro"][arch]
    ranks = runs["ranks"]
    for r in ranks:
        _close_metrics(r[arch]["metrics"], want["metrics"])
        assert r[arch]["step"] == want["step"] == STEPS
    assert all(m["grad_norm"] > 0 for m in ranks[0][arch]["metrics"])
    assert (ranks[0][arch]["metrics"][0]["lb_loss"] > 0) == (tc.n_experts > 0)
    _close_trained(setup, arch, _assemble(ranks, arch, "params", tc), want["params"])
    _close_params(_assemble(ranks, arch, "m", tc), want["m"])
    whole = _nbytes(want["params"])
    for r in ranks:
        assert r[arch]["v_bytes"] == _nbytes(r[arch]["m"]) == _nbytes(r[arch]["params"])
        if arch == RESUME:   # the card's leg; the other smoke configs' norms weigh more
            assert _nbytes(r[arch]["params"]) <= 1.1 * whole / 4
    for names, _ in _leaves(want["params"]).items():
        path = names.strip("/").split("/")
        by_cut = {}
        for rank, r in enumerate(ranks):
            by_cut.setdefault(holder_key(path, tc, GRID, rank), []).append(
                _at(r[arch]["params"], path))
        for held in by_cut.values():
            assert all(np.array_equal(h, held[0]) for h in held[1:]), names


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_each_ranks_gradient_is_the_d_m_cut_of_repros(setup, runs, arch):
    """Every rank's gradient of every leaf is its ``(d, m)`` cut of
    ``repro``'s whole gradient (mixtral's experts cut over ``"model"`` and
    their ``D`` over ``"data"``; mamba2's one B/C group shared over
    ``"model"``, its gradient summed over the holders), and the global norm
    is the whole tree's on every rank."""
    tc = setup[arch]["tc"]
    want = _leaves(runs["repro"][("grads", arch)]["grads"])
    cut_on_both = 0
    for rank, r in enumerate(runs["ranks"]):
        got = _leaves(r[("grads", arch)]["grads"])
        assert sorted(got) == sorted(want)
        grid = grid_layout(*GRID, rank)
        for path, w in want.items():
            names = path.strip("/").split("/")
            cut = local_shard(torch.as_tensor(np.array(w)), names, tc, grid).numpy()
            assert got[path].shape == cut.shape, path
            close(got[path], cut, F32_TOL)
            cut_on_both += cut.size * 4 == w.size
        close(r[("grads", arch)]["norm"], runs["repro"][("grads", arch)]["norm"], F32_TOL)
    assert cut_on_both > 0
    if arch == "mixtral-8x22b":
        w = want["/stack/moe/moe/w_gate"]
        got = runs["ranks"][3][("grads", arch)]["grads"]["stack"]["moe"]["moe"]["w_gate"]
        e, dm = tc.n_experts // 2, tc.d_model // 2
        assert got.shape == (w.shape[0], e, dm, w.shape[-1])   # experts, then D
    if arch == "mamba2-2.7b":
        assert tc.ssm_ngroups == 1   # one B/C group, whole on both "model" ranks


@pytest.mark.parametrize("smoke, dims", [(True, (1, 2, 2)), (True, (1, 4, 1)), (True, (2, 2, 1)),
                                         (False, (1, 2, 2)), (False, (1, 4, 4)),
                                         (False, (1, 16, 16)), (False, (2, 16, 16))])
def test_data_never_cuts_the_axis_model_splits(smoke, dims):
    """For every leaf of all ten configs (full and smoke), the axis
    ``"data"`` cuts (``repro``'s ``param_specs`` placement) is never the one
    the ``"model"`` cut splits, and the 2-D cut on ``meta`` has the
    ``"data"`` slice's extent on it."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import model as M

    cut = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=smoke)
        if _unsplit(cfg, dims[2]):
            continue
        grid = grid_layout(*dims, rank=int(np.prod(dims)) - 1)

        def check(names, leaf):
            nonlocal cut
            axis = data_axis(names, cfg, dims)
            split = tp_split(names, cfg, dims[2]) if dims[2] > 1 else None
            if axis is None:
                return
            cut += 1
            assert split is None or split[1] % leaf.ndim != axis % leaf.ndim, (arch, names)
            shard = local_shard(leaf, names, cfg, grid)
            assert shard.shape[axis] * dims[1] == leaf.shape[axis], (arch, names)
        map_with_names(check, M.params_meta(cfg))
    assert cut > 0


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hubert-xlarge", "internlm2-1.8b",
                                  "internvl2-26b", "mamba2-2.7b", "mixtral-8x22b",
                                  "qwen1.5-4b", "qwen2.5-3b", "stablelm-12b", "zamba2-2.7b"])
def test_a_data2_model2_rank_holds_a_quarter_of_a_full_config(arch):
    """Every rank of (data 2, model 2) holds at most 1.1 times a quarter of
    a full config's parameter bytes (its moments are cut as they are), cut
    on ``meta``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    whole = M.params_meta(cfg)
    for rank in range(4):
        grid = grid_layout(*GRID, rank)
        held = map_with_names(lambda names, t: local_shard(t, names, cfg, grid), whole)
        assert M.nbytes(held) <= 1.1 * M.nbytes(whole) / 4, (rank, M.nbytes(held))


def test_init_params_on_a_grid_draws_the_cut_of_the_whole_tree():
    """``init_params(cfg, gen, device, tp=grid)`` keeps each rank's 2-D
    shard with the bits of the whole tree's cut (every leaf still drawn
    whole from the same stream)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    for arch in ("internlm2-1.8b", "mixtral-8x22b"):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        whole = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        for rank in range(4):
            grid = grid_layout(*GRID, rank)
            got = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu", tp=grid)
            map_with_names(lambda names, w: np.testing.assert_array_equal(
                _at(got, names).numpy(), local_shard(w, names, cfg, grid).numpy()), whole)

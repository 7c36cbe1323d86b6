"""The ``"model"`` axis of training in the port: ``make_train_step(tp=)``
on gloo ranks against ``repro``'s train step on one device, on the CPU at
float32 at smoke size, with checkpoints across a resize and the launch
loop.

Ranks are processes of their own over gloo, started by ``spawn_tp`` from a
script that a subprocess runs under a timeout of its own (the pattern of
``test_torch_tp.py``); a group of two ranks and one of four start once per
module while ``repro``'s references are computed here.

- 3 steps of every arch at TP 2, and of internlm2-1.8b and internvl2-26b
  (two KV heads, each whole on two of the four ranks) at TP 4, against
  ``repro``'s jitted step from the same parameters on the same batches:
  the metrics at 5e-5/5e-4, the parameters and the first moments at
  ``test_torch_train_step.py``'s ``PARAM_TOL`` with its one stated
  exception (at most one element whose gradient is near zero in some
  step, held to ``2 * lr * steps``: the ranks' partial sums round its
  gradient otherwise, as microbatches do; hubert-xlarge and stablelm-12b
  have one such element each at TP 2).
- Gradients: every rank's gradient of its shard equals the cut of
  ``repro``'s whole gradient, for a replicated KV head (qwen2.5-3b), a
  Mamba2 B/C group and its conv channels that several ranks read
  (mamba2-2.7b) and the leaves every rank holds whole (the norms, the
  router, MLA's ``w_dkv`` and ``w_krope``: deepseek-v2-lite-16b); the global
  norm under the group is the whole tree's, on every rank.
- A resume across a resize: internlm2-1.8b at TP 2 saves after 2 steps
  (the whole arrays, rank 0 writing); ``repro`` restores the checkpoint bit
  for bit; ``reshard_restore`` onto 4 ranks and onto one device each take
  the 3rd step equal to the group's.
- ``launch.train.train(tc, tp=)``: 4 steps at TP 2 with a checkpoint every
  2, a resume from step 2 equal to the unbroken run bit for bit, and the
  losses the one-device loop's within the bf16 tolerance (the smoke
  config computes in bf16).
- The four ranks as a grid of ``(data 2, model 2)``: its mesh places each
  rank's 2-D shard (``tests/test_torch_dp_train.py`` trains on it).
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

from _torch_parity import BF16_TOL, F32_TOL, close, configs, params
from test_torch_forward import _batch, _jax, _torch
from test_torch_train_step import NEAR_ZERO, OPT, _close_params, _leaves
from repro.checkpoint import checkpoint as jckpt
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.models.model import loss_fn as jax_loss_fn
from repro.training.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.training.optimizer import global_norm as jax_global_norm
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.distributed import tensor_parallel as T
from repro_torch.distributed.sharding import Mesh, assemble_shards, local_shard, map_with_names
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = sorted(JAX_ARCH_IDS)
TP4_ARCHS = ("internlm2-1.8b", "internvl2-26b")
GRAD_ARCHS = ("deepseek-v2-lite-16b", "mamba2-2.7b", "qwen2.5-3b")
RESUME = "internlm2-1.8b"
STEPS = 3

# the ranks' program: ``python tp_train_ranks.py <world> <inputs.pkl> <out.pkl>``
_RANKS = textwrap.dedent('''
    import dataclasses, os, pickle, shutil, sys, time
    import numpy as np
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.distributed.sharding import group_mesh, map_with_names, sum_shared
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models import model as M
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.training.optimizer import OptimizerConfig, global_norm, init_opt_state
    from repro_torch.training.train_step import _grads_of, make_train_step


    def config(arch, **kw):
        return dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)


    def batch(b):
        return {k: torch.as_tensor(v) for k, v in b.items()}


    def host(tree):
        return M.tree_map(lambda t: t.detach().clone().numpy(), tree)


    def steps(tp, arch, d, n, params=None, opt=None, first=0, n_mb=1, key="batches", **kw):
        cfg = config(arch, **kw)
        if params is None:
            params = params_from_numpy(d["archs"][arch]["params"], cfg, "cpu", tp)
            opt = init_opt_state(params)
        step = make_train_step(cfg, OptimizerConfig(**d["opt"]), n_mb, tp)
        metrics = []
        for i in range(first, first + n):
            params, opt, m = step(params, opt, batch(d["archs"][arch][key][i]))
            metrics.append({k: float(v) for k, v in m.items()})
        return params, opt, metrics


    def grads(tp, arch, d):
        cfg = config(arch)
        params = params_from_numpy(d["archs"][arch]["params"], cfg, "cpu", tp)
        _, _, g = _grads_of(params, batch(d["archs"][arch]["batches"][0]), cfg, tp)
        g = map_with_names(lambda names, x: sum_shared(x, names, cfg, tp), g)
        return {"grads": host(g), "norm": float(global_norm(g, tp, cfg))}


    def resume_ranks(tp, d):
        """TP 2: two steps, a save, the 3rd; TP 4: a restore of that save
        once it is committed, and the 3rd step."""
        cfg = config(d["resume"])
        out = {}
        if tp.size == 2:
            p, o, m = steps(tp, d["resume"], d, 2)
            out["saved"] = host(p)
            ckpt.save({"params": p, "opt": o}, d["ckpt"], 2, extra={"k": 1}, tp=tp, cfg=cfg)
            p, o, m3 = steps(tp, d["resume"], d, 1, p, o, first=2)
        else:
            deadline = time.monotonic() + 150
            while ckpt.latest_step(d["ckpt"]) != 2:
                assert time.monotonic() < deadline, "no checkpoint from the group of 2"
                time.sleep(0.2)
            whole = M.params_meta(cfg)
            template = {"params": whole, "opt": init_opt_state(whole)}
            state, manifest = reshard_restore(cfg, template, d["ckpt"], group_mesh(tp))
            assert manifest["extra"] == {"k": 1}
            out["restored_shapes"] = [tuple(t.shape) for t in M.tree_leaves(state["params"])]
            p, o, m3 = steps(tp, d["resume"], d, 1, state["params"], state["opt"], first=2)
        out.update(params=host(p), metrics=m3)
        return out


    def launch(tp, d):
        tc = TrainConfig(steps=4, ckpt_dir=d["launch"], ckpt_every=2, log_every=1,
                         seq_len=16, global_batch=4)
        _, _, unbroken = train(tc, tp=tp)
        ckpt.wait_for_saves()
        T.broadcast_object(None)   # rank 0's checkpoint is written
        if tp.rank == 0:
            shutil.rmtree(os.path.join(d["launch"], "step_00000004"))
        T.broadcast_object(None)
        _, _, resumed = train(tc, tp=tp)
        return {"unbroken": unbroken, "resumed": resumed}


    def rank_main(tp, d):
        torch.set_num_threads(1)
        out = {"resume": resume_ranks(tp, d)}
        archs = d["archs"] if tp.size == 2 else d["tp4"]
        for arch in archs:
            p, o, m = steps(tp, arch, d, len(d["archs"][arch]["batches"]))
            out[arch] = {"metrics": m, "params": host(p), "m": host(o["m"]),
                         "step": int(o["step"])}
        for arch in d["grad_archs"]:
            out[("grads", arch)] = grads(tp, arch, d)
        if tp.size == 2:
            out["launch"] = launch(tp, d)
            # remat "full" recomputes each layer with its collectives; two
            # microbatches accumulate the rank's gradients before the sums
            p, _, m = steps(tp, d["resume"], d, 2, remat="full")
            out["remat"] = {"metrics": m, "params": host(p)}
            p, _, m = steps(tp, d["resume"], d, 2, n_mb=2, key="big")
            out["microbatches"] = {"metrics": m, "params": host(p)}
        else:
            # a grid's (data 2, model 2) mesh places each rank's 2-D shard
            from repro_torch.distributed.data_parallel import make_grid
            from repro_torch.distributed.elastic import reshard_in_place
            from repro_torch.distributed.sharding import mesh_device
            grid = make_grid(tp, 2, 2)
            mesh = group_mesh(grid)
            cfg = config(d["resume"])
            whole = params_from_numpy(d["archs"][d["resume"]]["params"], cfg, "cpu")
            out["data_axis"] = {"axes": mesh.axis_names, "sizes": mesh.axis_sizes,
                                "device": str(mesh_device(mesh)),
                                "params": host(reshard_in_place(whole, cfg, mesh))}
        return out


    if __name__ == "__main__":
        world, inputs, output = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        with open(inputs, "rb") as f:
            d = pickle.load(f)
        results = T.spawn_tp(rank_main, world, device="cpu", args=(d,), timeout=280)
        with open(output, "wb") as f:
            pickle.dump(results, f)
''').replace("import dataclasses, os, pickle, sys, time",
             "import dataclasses, os, pickle, shutil, sys, time")


def _start(world: int, inputs, tmp: Path):
    """Start ``world`` ranks in the background; returns a function that
    waits for them (320 s at most) and gives each rank's results."""
    script = tmp / "tp_train_ranks.py"
    script.write_text(_RANKS)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    proc = subprocess.Popen([sys.executable, str(script), str(world), str(tmp / "in.pkl"),
                             str(tmp / "out.pkl")],
                            env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=str(tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            _, err = proc.communicate(timeout=320)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            raise AssertionError(f"{world} ranks: no end within 320 s\n{err[-4000:]}")
        assert proc.returncode == 0, err[-4000:]
        with open(tmp / "out.pkl", "rb") as f:
            return pickle.load(f)
    return wait


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Every arch's ``repro`` config, parameters and batches."""
    out = {}
    for arch in ARCHS:
        jc, tc = configs(arch)
        jp, _ = params(jc, tc)
        out[arch] = {"jc": jc, "tc": tc, "jp": jp,
                     "batches": [_batch(tc, seed=10 + i, b=2) for i in range(STEPS)]}
    out[RESUME]["big"] = [_batch(out[RESUME]["tc"], seed=20 + i, b=4) for i in range(2)]
    return out


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Both groups of ranks, and ``repro``'s references computed while they
    run: 3 jitted steps of every arch, the gradients and their norm of the
    gradient archs, the restored checkpoint; the port's one-device resume
    and launch loop."""
    tmp = tmp_path_factory.mktemp("tpt")
    inputs = {"archs": {a: {"params": jax.tree.map(np.asarray, v["jp"]),
                            "batches": v["batches"], "big": v.get("big")}
                        for a, v in setup.items()},
              "opt": OPT, "tp4": TP4_ARCHS, "grad_archs": GRAD_ARCHS, "resume": RESUME,
              "ckpt": str(tmp / "ckpt"), "launch": str(tmp / "launch")}
    waits = {w: _start(w, inputs, tmp_path_factory.mktemp(f"tpt{w}")) for w in (2, 4)}
    ref = {}
    for arch, v in setup.items():
        jc, jp = v["jc"], v["jp"]
        step = jax.jit(jax_make_train_step(jc, JaxOptimizerConfig(**OPT), 1))
        opt = jax_init_opt_state(jp)
        metrics = []
        for b in v["batches"]:
            jp, opt, m = step(jp, opt, _jax(b))
            metrics.append({k: float(x) for k, x in m.items()})
        ref[arch] = v["ref"] = {"metrics": metrics, "params": jp, "m": opt["m"],
                                "step": int(opt["step"])}
        if arch in GRAD_ARCHS:
            g = jax.grad(lambda p: jax_loss_fn(p, _jax(v["batches"][0]), jc)[0])(v["jp"])
            ref[("grads", arch)] = {"grads": g, "norm": float(jax_global_norm(g))}
    # remat under the group, and 2 microbatches, against repro's (2 steps)
    v = setup[RESUME]
    ref["remat"] = _jax_steps(dataclasses.replace(v["jc"], remat="full"), v["jp"],
                              v["batches"][:2], 1)
    ref["microbatches"] = _jax_steps(v["jc"], v["jp"], v["big"], 2)
    got = {w: wait() for w, wait in waits.items()}
    return {"repro": ref, **got, "inputs": inputs}


def _jax_steps(jc, jp, batches, n_mb):
    step = jax.jit(jax_make_train_step(jc, JaxOptimizerConfig(**OPT), n_mb))
    opt, metrics = jax_init_opt_state(jp), []
    for b in batches:
        jp, opt, m = step(jp, opt, _jax(b))
        metrics.append({k: float(x) for k, x in m.items()})
    return {"metrics": metrics, "params": jp}


def _assemble(ranks, key, what, tc):
    """The whole tree from every rank's shards of ``ranks[r][key][what]``."""
    trees = [r[key][what] for r in ranks]
    return map_with_names(
        lambda names, _: assemble_shards(
            [torch.as_tensor(_at(t, names)) for t in trees], names, tc).numpy(), trees[0])


def _at(tree, names):
    for k in names:
        tree = tree[k]
    return tree


def _close_metrics(got, want, steps=STEPS):
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["ce", "grad_norm", "lb_loss", "loss", "lr"]
        for key in w:
            close(g[key], w[key], F32_TOL)


def _close_trained_params(setup, arch, got):
    """The trained parameters within ``PARAM_TOL``, under the one stated
    exception of ``test_torch_train_step.py`` (there for microbatches,
    here for the group's partial sums, the same cause): at most one element
    whose gradient is below ``NEAR_ZERO`` in some step, held to
    ``2 * lr * steps``. The masks are only computed when the plain check
    fails."""
    want = setup[arch]["ref"]["params"]
    try:
        _close_params(got, want)
        return
    except AssertionError:
        pass
    near_zero = _near_zero_masks(setup[arch]["jc"], setup[arch]["jp"], setup[arch]["batches"], 1)
    excepted = _close_params(got, want, near_zero, bound=2 * OPT["lr"] * STEPS)
    assert sum(excepted.values()) <= 1, excepted


def _near_zero_masks(jc, jp, batches, n_mb):
    """{path: mask} of the elements whose mean gradient over the
    microbatches (``repro``'s) is below ``NEAR_ZERO`` in any of the steps
    that ``batches`` drive from ``jp``: ``test_torch_train_step.py``'s
    ``_near_zero_grads`` over the steps, with one compiled gradient."""
    grad = jax.jit(jax.grad(lambda p, mb: jax_loss_fn(p, mb, jc)[0]))
    step = jax.jit(jax_make_train_step(jc, JaxOptimizerConfig(**OPT), n_mb))
    opt, near_zero = jax_init_opt_state(jp), None
    for b in batches:
        size = b["labels"].shape[0] // n_mb
        gs = [grad(jp, _jax({k: v[i * size:(i + 1) * size] for k, v in b.items()}))
              for i in range(n_mb)]
        mean = jax.tree.map(lambda *g: sum(np.asarray(x, np.float32) for x in g) / n_mb, *gs)
        masks = {path: np.abs(g) < NEAR_ZERO for path, g in _leaves(mean).items()}
        near_zero = masks if near_zero is None else {k: near_zero[k] | m
                                                     for k, m in masks.items()}
        jp, opt, _ = step(jp, opt, _jax(b))
    return near_zero


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_at_tp2_matches_repro(setup, runs, arch):
    tc = setup[arch]["tc"]
    want = runs["repro"][arch]
    for r in runs[2]:
        _close_metrics(r[arch]["metrics"], want["metrics"])
        assert r[arch]["step"] == want["step"] == STEPS
    assert all(m["grad_norm"] > 0 for m in runs[2][0][arch]["metrics"])
    _close_trained_params(setup, arch, _assemble(runs[2], arch, "params", tc))
    _close_params(_assemble(runs[2], arch, "m", tc), want["m"])


@pytest.mark.parametrize("arch", TP4_ARCHS)
def test_train_step_at_tp4_matches_repro(setup, runs, arch):
    tc = setup[arch]["tc"]
    want = runs["repro"][arch]
    assert tc.n_kv_heads < 4   # each KV head whole on two ranks
    for r in runs[4]:
        _close_metrics(r[arch]["metrics"], want["metrics"])
    _close_trained_params(setup, arch, _assemble(runs[4], arch, "params", tc))
    _close_params(_assemble(runs[4], arch, "m", tc), want["m"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_each_ranks_gradient_is_the_cut_of_repros(setup, runs, arch, world):
    """Every rank's gradient of every leaf it holds is its cut of
    ``repro``'s whole gradient: a split leaf's slice, a segment several
    ranks hold summed over them (qwen2.5-3b's KV head, mamba2's B/C group
    in ``in_proj`` and the conv), a leaf every rank holds whole whole and
    equal (the norms; deepseek's router, ``w_dkv``, ``w_krope``). The
    global norm under the group is the whole tree's on every rank."""
    tc = setup[arch]["tc"]
    want = _leaves(runs["repro"][("grads", arch)]["grads"])
    shared = {"qwen2.5-3b": ("/stack/dense/attn/wk", "/stack/dense/attn/wv"),
              "mamba2-2.7b": ("/stack/ssm/mixer/in_proj", "/stack/ssm/mixer/conv_w"),
              "deepseek-v2-lite-16b": ("/stack/moe/moe/router", "/stack/moe/attn/w_dkv",
                                       "/stack/moe/attn/w_krope")}[arch]
    for rank, r in enumerate(runs[world]):
        got = _leaves(r[("grads", arch)]["grads"])
        assert sorted(got) == sorted(want) and set(shared) <= set(got)
        group = T.TPGroup(None, rank, world, torch.device("cpu"),
                          (torch.device("cpu"),) * world, "gloo")
        for path, w in want.items():
            cut = local_shard(torch.as_tensor(np.array(w)), path.strip("/").split("/"), tc,
                              group).numpy()
            close(got[path], cut, F32_TOL)
        close(r[("grads", arch)]["norm"], runs["repro"][("grads", arch)]["norm"], F32_TOL)


def test_a_resume_across_a_resize_takes_the_same_next_step(setup, runs):
    """internlm2-1.8b: the group of 2 saves after 2 steps; ``repro``
    restores the whole arrays bit for bit; 4 ranks (each KV head now whole
    on two of them) and one device restore it and take the 3rd step, equal
    to the group's."""
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.models import model as M
    from repro_torch.training.train_step import make_train_step

    jc, tc = setup[RESUME]["jc"], setup[RESUME]["tc"]
    ckdir = runs["inputs"]["ckpt"]
    saved = _assemble(runs[2], "resume", "saved", tc)
    template = {"params": jax.eval_shape(lambda: setup[RESUME]["jp"]),
                "opt": jax.eval_shape(lambda: jax_init_opt_state(setup[RESUME]["jp"]))}
    restored, manifest = jckpt.restore(template, ckdir)
    assert manifest["step"] == 2 and manifest["extra"] == {"k": 1}
    for path, w in _leaves(restored["params"]).items():
        np.testing.assert_array_equal(np.asarray(w), _leaves(saved)[path], err_msg=path)
    assert int(restored["opt"]["step"]) == 2
    # one device: reshard_restore onto a mesh of the CPU, then the 3rd step
    whole = M.params_meta(tc)
    state, _ = reshard_restore(tc, {"params": whole, "opt": init_opt_state(whole)}, ckdir,
                               Mesh([torch.device("cpu")], ("model",)))
    step = make_train_step(tc, OptimizerConfig(**OPT))
    p1, _, m1 = step(state["params"], state["opt"], _torch(setup[RESUME]["batches"][2]))
    group3 = runs[2][0]["resume"]["metrics"][0]
    whole3 = _assemble(runs[2], "resume", "params", tc)
    for r in runs[4]:
        assert r["resume"]["restored_shapes"] != [tuple(np.shape(x)) for x in
                                                  _leaves(saved).values()]
        for key in group3:
            close(r["resume"]["metrics"][0][key], group3[key], F32_TOL)
    for key in group3:
        close(float(m1[key]), group3[key], F32_TOL)
    _close_params(_assemble(runs[4], "resume", "params", tc), whole3)
    _close_params(M.tree_map(lambda t: t.numpy(), p1), whole3)


def test_train_launch_under_a_group_resumes_bit_for_bit(runs):
    """``train(tc, tp=)``: every rank logs the same losses; a resume from
    the step-2 checkpoint ends with the unbroken run's bits; the losses are
    the one-device loop's within the bf16 tolerance."""
    from repro_torch.launch.train import TrainConfig, train

    got = [r["launch"] for r in runs[2]]
    assert got[0] == got[1]
    unbroken, resumed = got[0]["unbroken"], got[0]["resumed"]
    assert [s for s, _ in unbroken] == [1, 2, 3, 4] and resumed == unbroken[2:]
    one = train(TrainConfig(steps=4, log_every=1, seq_len=16, global_batch=4), device="cpu")[2]
    assert [s for s, _ in one] == [1, 2, 3, 4]
    close([l for _, l in unbroken], [l for _, l in one], BF16_TOL)
    assert all(np.isfinite(l) for _, l in unbroken)


def test_a_kernel_in_kernel_impls_raises_before_any_launch_under_a_group():
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.training.train_step import make_train_step

    group = T.TPGroup(None, 0, 2, torch.device("cpu"), (torch.device("cpu"),) * 2, "gloo")
    cfg = with_kernel_impls(get_config("internlm2-1.8b", smoke=True), "auto")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, OptimizerConfig(), tp=group)
    bad = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), n_heads=3)
    with pytest.raises(ValueError, match="do not split"):
        make_train_step(bad, OptimizerConfig(), tp=group)


def test_remat_full_under_a_group_matches_repro(setup, runs):
    """``cfg.remat`` wraps the same units under a group: ``"full"``
    recomputes each layer's collectives in the backward, every rank in the
    same order."""
    tc = setup[RESUME]["tc"]
    want = runs["repro"]["remat"]
    for r in runs[2]:
        _close_metrics(r["remat"]["metrics"], want["metrics"], 2)
    _close_params(_assemble(runs[2], "remat", "params", tc), want["params"])


def test_microbatches_under_a_group_match_repro(setup, runs):
    """Two microbatches of (2, 24) at TP 2: ``repro``'s ``lax.scan``
    semantics (``loss`` the mean, ``ce`` the last microbatch's), the shared
    segments summed once the gradients are accumulated; under the one
    stated exception of ``test_torch_train_step.py``'s microbatch test."""
    tc, jc, jp = setup[RESUME]["tc"], setup[RESUME]["jc"], setup[RESUME]["jp"]
    want = runs["repro"]["microbatches"]
    for r in runs[2]:
        _close_metrics(r["microbatches"]["metrics"], want["metrics"], 2)
    got = _assemble(runs[2], "microbatches", "params", tc)
    try:
        _close_params(got, want["params"])
        return
    except AssertionError:
        pass
    near_zero = _near_zero_masks(jc, jp, setup[RESUME]["big"], 2)
    excepted = _close_params(got, want["params"], near_zero, bound=2 * OPT["lr"] * 2)
    assert sum(excepted.values()) <= 1, excepted


def test_a_grids_mesh_gives_each_rank_its_2d_shard(setup, runs):
    """A grid's ``(data 2, model 2)`` mesh (``group_mesh`` of
    ``data_parallel.make_grid`` over the 4 ranks) places on each rank's
    device its 2-D ``local_shard`` of every leaf (the ``"model"`` cut, then
    the ``"data"`` cut); a mesh over several distinct devices that no group
    covers still raises."""
    from repro_torch.distributed.data_parallel import grid_layout
    from repro_torch.distributed.sharding import mesh_device

    tc = setup[RESUME]["tc"]
    whole = _leaves(setup[RESUME]["jp"])
    cut_on_data = 0
    for rank, r in enumerate(runs[4]):
        got = r["data_axis"]
        assert got["axes"] == ("data", "model") and got["sizes"] == (2, 2)
        assert got["device"] == "cpu"
        grid = grid_layout(1, 2, 2, rank)
        for path, w in _leaves(got["params"]).items():
            names = path.strip("/").split("/")
            want = local_shard(torch.as_tensor(np.array(whole[path])), names, tc, grid).numpy()
            np.testing.assert_array_equal(w, want, err_msg=path)
            cut_on_data += w.size * 4 == np.size(whole[path])
    assert cut_on_data > 0
    with pytest.raises(NotImplementedError, match="item 3"):
        mesh_device(Mesh([torch.device("cuda", 0), torch.device("cuda", 1)], ("model",)))

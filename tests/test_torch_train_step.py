"""The port's train step against ``repro``'s at float32 on the smoke configs
of all ten archs: 3 steps of ``make_train_step`` (loss, gradients, AdamW)
from the same parameters on the same numpy batches (tokens, hubert's audio
frames, internvl2's vision patches; the batches of
``test_torch_forward.py``). Each step's metrics within 5e-5/5e-4
and the final parameters within atol 2e-5 / rtol 1e-4, the tolerance of
``repro``'s own ``test_grad_accumulation_matches_full_batch``. Microbatches:
the port's ``n_microbatches=2`` against JAX's for a dense and a MoE arch,
and the port's 4 against its 1.

One stated exception, in the microbatch test only: an element whose mean
gradient over the microbatches is near zero in some step (below
``NEAR_ZERO``, 100 times Adam's eps; the microbatches' gradients cancel).
There AdamW's normalised step ``g / (|g| + eps)`` turns the two sides'
fp32 rounding of ``g`` (about 1e-8 here) into a step that differs by a
share of ``lr``; such an element is held to ``2 * lr * steps``, the most
two AdamW runs can move it apart, and every other element to the
tolerance above. At mixtral's smoke size this is 1 element of ``w_down``.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import close, configs, params
from test_torch_forward import _batch, _jax, _torch
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.models.model import loss_fn as jax_loss_fn
from repro.training.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

pytestmark = pytest.mark.slow

PARAM_TOL = dict(atol=2e-5, rtol=1e-4)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
NEAR_ZERO = 100 * 1e-8  # 100 times OptimizerConfig.eps


def _leaves(tree, prefix=""):
    """{path: leaf} over nested dicts."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key],
                                                                f"{prefix}/{key}").items()}
    return {prefix: tree}


def _close_params(got, want, near_zero=None, bound=None):
    """Every leaf within PARAM_TOL, except elements that ``near_zero``
    marks (the exception of the module docstring): those within ``bound``.
    Returns {path: the number of elements held to ``bound`` only}."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    excepted = {}
    for path in want:
        g, w = np.asarray(got[path], np.float32), np.asarray(want[path], np.float32)
        bad = ~np.isclose(g, w, **PARAM_TOL)
        if near_zero is not None and bad.any():
            assert not np.any(bad & ~near_zero[path]), path
            assert np.all(np.abs(g[bad] - w[bad]) <= bound), path
            excepted[path] = int(bad.sum())
            continue
        np.testing.assert_allclose(g, w, err_msg=path, **PARAM_TOL)
    return excepted


def _near_zero_grads(jc, jp, batch, n_mb):
    """{path: mask} of the elements whose mean gradient over the
    microbatches, JAX's, is below NEAR_ZERO."""
    grad = jax.jit(jax.grad(lambda p, mb: jax_loss_fn(p, mb, jc)[0]))
    size = batch["labels"].shape[0] // n_mb
    gs = [grad(jp, _jax({k: v[i * size:(i + 1) * size] for k, v in batch.items()}))
          for i in range(n_mb)]
    mean = jax.tree.map(lambda *g: sum(np.asarray(x, np.float32) for x in g) / n_mb, *gs)
    return {path: np.abs(g) < NEAR_ZERO for path, g in _leaves(mean).items()}


def _run_both(arch, n_mb, steps=3, b=2, track_near_zero=False):
    """Train ``steps`` steps on both sides from the same parameters; returns
    (jax metrics, torch metrics, jax params, torch params, near-zero masks
    over all steps or None)."""
    jc, tc = configs(arch)
    jp, tp = params(jc, tc)
    jstep = jax.jit(jax_make_train_step(jc, JaxOptimizerConfig(**OPT), n_mb))
    tstep = make_train_step(tc, OptimizerConfig(**OPT), n_mb)
    jopt, topt = jax_init_opt_state(jp), init_opt_state(tp)
    jms, tms, near_zero = [], [], None
    for i in range(steps):
        batch = _batch(tc, seed=10 + i, b=b)
        if track_near_zero:
            masks = _near_zero_grads(jc, jp, batch, n_mb)
            near_zero = masks if near_zero is None else {
                k: near_zero[k] | m for k, m in masks.items()}
        jp, jopt, jm = jstep(jp, jopt, _jax(batch))
        tp, topt, tm = tstep(tp, topt, _torch(batch))
        jms.append(jm)
        tms.append(tm)
    assert int(topt["step"]) == int(jopt["step"]) == steps
    _close_params(topt["m"], jopt["m"])
    return jms, tms, jp, tp, near_zero


def _close_metrics(jms, tms):
    for jm, tm in zip(jms, tms):
        assert sorted(tm) == sorted(jm) == ["ce", "grad_norm", "lb_loss", "loss", "lr"]
        for key in jm:
            close(tm[key], jm[key])


@pytest.mark.parametrize("arch", sorted(JAX_ARCH_IDS))
def test_train_step_matches_jax(arch):
    jms, tms, jp, tp, _ = _run_both(arch, 1)
    _close_metrics(jms, tms)
    assert all(float(m["grad_norm"]) > 0 for m in tms)
    _close_params(tp, jp)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x22b"])
def test_microbatches_match_jax(arch):
    """n_microbatches=2 on both sides: ``ce`` and ``lb_loss`` are the last
    microbatch's, ``loss`` the mean, the gradients the mean."""
    steps = 2
    jms, tms, jp, tp, near_zero = _run_both(arch, 2, steps=steps, b=4, track_near_zero=True)
    _close_metrics(jms, tms)
    excepted = _close_params(tp, jp, near_zero, bound=2 * OPT["lr"] * steps)
    assert sum(excepted.values()) <= 1, excepted


def test_microbatch_accumulation_matches_full_batch():
    """The twin of ``test_substrate.py::test_grad_accumulation_matches_full_batch``."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models.model import init_params, tree_map

    _, cfg = configs("internlm2-1.8b")
    p0 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in DataPipeline(cfg, 8, 32, seed=0).next_batch().items()}
    out = {}
    for n in (1, 4):
        p = tree_map(torch.clone, p0)
        out[n] = make_train_step(cfg, OptimizerConfig(lr=1e-3), n)(p, init_opt_state(p), batch)
    np.testing.assert_allclose(float(out[1][2]["loss"]), float(out[4][2]["loss"]), rtol=1e-4)
    _close_params(out[4][0], out[1][0])

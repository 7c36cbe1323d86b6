"""The port's optimizer against ``repro.training.optimizer`` (schedule,
AdamW with clipping on and off and a bf16 leaf, within 1e-6 relative),
remat (``cfg.remat``: every mode gives the same loss and gradients), and
the refusal to differentiate through a kernel op: under
``kernel_impls="auto"`` with parameters that require grad, both packages
refuse, the port before any launch; under ``torch.no_grad()`` the port's
forward runs as before.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, params
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro_torch.kernels import ops as kops
from repro_torch.models import model as tmodel
from repro_torch.models.model import tree_map
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import _grads_of, make_train_step

pytestmark = pytest.mark.slow

OPT_TOL = dict(rtol=1e-6, atol=1e-12)


def _close(got, want, tol=OPT_TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), **tol)


# --- optimizer ---------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 130])
def test_schedule_matches_jax(step):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = topt.schedule(topt.OptimizerConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    want = jopt.schedule(jopt.OptimizerConfig(**cfg), jnp.int32(step))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)


def _tree(rng, scale):
    """A random parameter tree (one bf16 leaf) and gradients of ``scale``."""
    shapes = {"a": ((4, 5), np.float32), "b": {"c": ((7,), np.float32),
                                               "d": ((3, 2), "bfloat16")}}

    def leaf(spec):
        shape, dt = spec
        return rng.standard_normal(shape).astype(np.float32), dt

    def is_spec(x):
        return isinstance(x, tuple)
    p = jax.tree.map(leaf, shapes, is_leaf=is_spec)
    g = jax.tree.map(lambda spec: (rng.standard_normal(spec[0]).astype(np.float32) * scale,
                                   spec[1]), shapes, is_leaf=is_spec)
    return p, g


def _jax_tree(t):
    return jax.tree.map(lambda x: jnp.asarray(x[0], jnp.bfloat16 if x[1] == "bfloat16"
                                              else jnp.float32), t,
                        is_leaf=lambda x: isinstance(x, tuple))


def _torch_tree(t):
    return jax.tree.map(lambda x: torch.from_numpy(x[0]).to(
        torch.bfloat16 if x[1] == "bfloat16" else torch.float32), t,
        is_leaf=lambda x: isinstance(x, tuple))


def _pairs(got, want):
    """(torch leaf, jax leaf) pairs of two trees, by sorted key."""
    return list(zip(topt.tree_leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(scale):
    """Three updates from the same tree: new params (bf16 leaf in its
    dtype), m, v, step, grad_norm and lr."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    rng = np.random.default_rng(0)
    p, _ = _tree(rng, 1.0)
    jp, tp = _jax_tree(p), _torch_tree(p)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    for _ in range(3):
        _, g = _tree(rng, scale)
        jp, js, jm = jopt.adamw_update(_jax_tree(g), js, jp, jopt.OptimizerConfig(**cfg))
        tp, ts, tm = topt.adamw_update(_torch_tree(g), ts, tp, topt.OptimizerConfig(**cfg))
        assert (float(tm["grad_norm"]) > 1.0) == (scale > 1)
        for key in ("grad_norm", "lr"):
            _close(tm[key], jm[key])
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 3
    for got, want in _pairs(tp, jp):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16 else torch.float32)
        _close(got, want)
    for key in ("m", "v"):
        for got, want in _pairs(ts[key], js[key]):
            assert got.dtype == torch.float32
            _close(got, want)


def test_adamw_update_works_in_place():
    """The update consumes its inputs: the returned trees are the ones
    passed in, changed in place (``repro``'s donate_argnums)."""
    p = {"w": torch.ones(3)}
    state = topt.init_opt_state(p)
    w, m = p["w"], state["m"]["w"]
    new_p, new_state, _ = topt.adamw_update({"w": torch.ones(3)}, state, p,
                                            topt.OptimizerConfig(lr=0.1, warmup_steps=1))
    assert new_p is p and new_state is state and new_p["w"] is w and new_state["m"]["w"] is m
    assert float(w[0]) < 1.0 and float(m[0]) > 0.0 and int(state["step"]) == 1


def test_adamw_reduces_quadratic_loss():
    """The twin of ``test_substrate.py::test_adamw_reduces_quadratic_loss``."""
    cfg = topt.OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=200,
                               weight_decay=0.0, grad_clip=100.0)
    params_ = {"w": torch.tensor([5.0, -3.0])}
    opt = topt.init_opt_state(params_)
    for _ in range(150):
        grads = {"w": 2 * params_["w"]}
        params_, opt, _ = topt.adamw_update(grads, opt, params_, cfg)
    assert float(params_["w"].abs().max()) < 0.5


# --- remat -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x22b", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """``"full"`` and ``"dots_saveable"`` recompute what ``"none"`` keeps:
    the same loss and gradients, bit for bit on the CPU."""
    _, tc = configs(arch)
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, tc.vocab_size, size=(2, 24)))
             for k in ("tokens", "labels")}
    out = {mode: _grads_of(tp, batch, dataclasses.replace(tc, remat=mode))
           for mode in ("none", "full", "dots_saveable")}
    for mode in ("full", "dots_saveable"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for got, want in zip(topt.tree_leaves(out[mode][2]), topt.tree_leaves(out["none"][2])):
            assert torch.equal(got, want), mode


def test_remat_checkpoints_under_full():
    """Under ``"full"`` the backward recomputes each layer: the forward's
    products run again (counted with a dispatch hook on ``aten.mm``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    _, tc = configs("internlm2-1.8b")
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.zeros((2, 8), dtype=torch.long) for k in ("tokens", "labels")}
    counts = {}
    for mode in ("none", "full", "dots_saveable"):
        CountMM.n = 0
        with CountMM():
            _grads_of(tp, batch, dataclasses.replace(tc, remat=mode))
        counts[mode] = CountMM.n
    assert counts["full"] > counts["none"]
    assert counts["dots_saveable"] == counts["none"]  # the products are kept, not redone


def test_unknown_remat_raises():
    _, tc = configs("internlm2-1.8b")
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.zeros((1, 4), dtype=torch.long) for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="everything"):
        tmodel.loss_fn(tp, batch, dataclasses.replace(tc, remat="everything"))


# --- no gradient through a kernel op -----------------------------------------
def _op_calls():
    """Each kernel op with small CPU inputs: name -> fn(requires_grad)."""
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g)

    def x(*shape, rg):
        return t(*shape).requires_grad_(rg)
    tiles = torch.zeros(2, dtype=torch.int32)
    return {
        "rmsnorm_op": lambda rg: kops.rmsnorm_op(x(4, 16, rg=rg), torch.ones(16)),
        "add_rmsnorm_op": lambda rg: kops.add_rmsnorm_op(t(4, 16), x(4, 16, rg=rg),
                                                         torch.ones(16)),
        "gated_rmsnorm_op": lambda rg: kops.gated_rmsnorm_op(t(4, 16), t(4, 16),
                                                             torch.ones(16).requires_grad_(rg)),
        "flash_attention_op": lambda rg: kops.flash_attention_op(
            x(1, 2, 8, 16, rg=rg), t(1, 2, 8, 16), t(1, 2, 8, 16)),
        "paged_attention_op": lambda rg: kops.paged_attention_op(
            t(2, 2, 16), x(4, 4, 2, 16, rg=rg), t(4, 4, 2, 16),
            torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
            torch.tensor([5, 7], dtype=torch.int32)),
        "moe_gmm_op": lambda rg: kops.moe_gmm_op(t(16, 16), x(1, 16, 8, rg=rg), tiles,
                                                 block_t=8),
        "moe_gmm_capacity": lambda rg: kops.moe_gmm_capacity(x(2, 8, 16, rg=rg),
                                                             t(2, 16, 8), block_t=8),
        "ssd_op": lambda rg: kops.ssd_op(x(1, 16, 2, 4, rg=rg), t(1, 16, 2).abs(),
                                         -torch.ones(2), t(1, 16, 1, 4), t(1, 16, 1, 4),
                                         chunk=8),
    }


@pytest.mark.parametrize("op", sorted(_op_calls()))
def test_kernel_ops_refuse_inputs_that_require_grad(op):
    call = _op_calls()[op]
    kops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="kernel_impls=\"reference\""):
        call(True)
    with torch.no_grad():
        call(True)
    call(False)
    assert kops.launch_counts() == dict.fromkeys(kops.launch_counts(), 0)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x22b", "mamba2-2.7b"])
def test_loss_fn_under_auto_refuses_grad_in_both_packages(arch):
    """Parameters that require grad under ``auto``: the port raises naming
    ``"reference"`` and launches nothing; ``jax.value_and_grad`` through
    ``repro``'s Pallas kernels fails as well. Under ``torch.no_grad()`` the
    port's forward runs and equals the one without grad."""
    jc, tc = configs(arch, "auto")
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, tc.vocab_size, size=(2, 16)) for k in ("tokens", "labels")}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="reference"):
        tmodel.loss_fn(tree_map(lambda p: p.detach().requires_grad_(), tp), tb, tc)
    assert kops.launch_counts() == dict.fromkeys(kops.launch_counts(), 0)
    with torch.no_grad():
        got = tmodel.loss_fn(tree_map(lambda p: p.detach().requires_grad_(), tp), tb, tc)[0]
    assert torch.equal(got, tmodel.loss_fn(tp, tb, tc)[0])
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.value_and_grad(lambda p: jmodel.loss_fn(p, jb, jc)[0])(jp)


def test_make_train_step_refuses_a_kernel_site():
    _, tc = configs("internlm2-1.8b", "auto")
    with pytest.raises(ValueError, match="reference"):
        make_train_step(tc, topt.OptimizerConfig())
    _, tc = configs("internlm2-1.8b", "reference")
    make_train_step(tc, topt.OptimizerConfig())

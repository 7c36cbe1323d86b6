"""The port's MoE path against ``repro``'s at float32 on the mixtral smoke
config: the grouped-matmul plain versions and host helpers, ``route``,
every ``apply_moe`` impl (the kernel twins under both drop policies),
``prefill``/``decode_step`` and the ``ContinuousEngine`` streams.

The same numpy inputs and parameters go through both sides, within
5e-5/5e-4; routing picks (``idx``) and temperature-0 tokens must be equal.
Under ``auto`` the JAX side runs its Pallas kernels in interpret mode and
the port its plain versions (a CPU tensor never reaches the CUDA kernel).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BF16_TOL, F32_TOL, close, configs, params
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving.batching import GenRequest as JaxGenRequest
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.kernels import ops, ref
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine

pytestmark = pytest.mark.slow

ARCH = "mixtral-8x22b"
SRC = Path(__file__).resolve().parents[1] / "src"


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


# --- grouped matmul: plain versions and host helpers ------------------------------------
def _gmm_case(t, d, f, e, bt, seed=0):
    """tests/test_kernels.py's construction: group sizes are multiples of bt
    summing to t, the remainder spread over the first experts."""
    per = [1] * e
    for i in range(t // bt - e):
        per[i % e] += 1
    sizes = np.array([p * bt for p in per], np.int32)
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((t, d), dtype=np.float32)
    rhs = rng.standard_normal((e, d, f), dtype=np.float32)
    te = np.repeat(np.arange(e, dtype=np.int32), sizes // bt)
    return lhs, rhs, sizes, te


@pytest.mark.parametrize("dtype,jd,td,tol", [
    ("float32", jnp.float32, torch.float32, F32_TOL),
    ("bfloat16", jnp.bfloat16, torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("t,d,f,e,bt,bf", [
    (256, 64, 96, 4, 32, 32),
    (512, 128, 128, 8, 64, 128),
    (128, 32, 200, 2, 64, 128),   # F padding path of the TPU kernel
])
def test_moe_gmm_plain_matches_pallas_and_ref(t, d, f, e, bt, bf, dtype, jd, td, tol):
    lhs, rhs, sizes, te = _gmm_case(t, d, f, e, bt)
    jl, jr = jnp.asarray(lhs).astype(jd), jnp.asarray(rhs).astype(jd)
    tl, tr = torch.from_numpy(lhs).to(td), torch.from_numpy(rhs).to(td)
    tiles = ref.moe_gmm_tiles_ref(tl, tr, torch.from_numpy(te), bt)
    groups = ref.moe_gmm_ref(tl, tr, torch.from_numpy(sizes))
    assert tiles.dtype == groups.dtype == td and tiles.shape == (t, f)
    want = _f32(pallas_gmm(jl, jr, jnp.asarray(te), block_t=bt, block_f=bf, interpret=True))
    close(_f32(tiles), want, tol)
    close(_f32(groups), _f32(jref.moe_gmm_ref(jl, jr, jnp.asarray(sizes))), tol)
    close(_f32(groups), _f32(tiles), tol)
    before = ops.launch_counts()["moe_gmm"]
    close(_f32(ops.moe_gmm_op(tl, tr, te, block_t=bt)), _f32(tiles), tol)  # CPU: plain path
    assert ops.launch_counts()["moe_gmm"] == before


def test_moe_gmm_ref_tail_rows_belong_to_the_last_group():
    lhs, rhs = _x(20, 8), _x(3, 8, 5, seed=1)
    sizes = np.array([4, 0, 9], np.int32)          # 7 tail rows
    close(ref.moe_gmm_ref(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(sizes)),
          jref.moe_gmm_ref(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(sizes)))


@pytest.mark.parametrize("bt", [8, 128])
def test_pad_group_sizes_matches_jax(bt):
    sizes = np.array([5, 0, 17, 128, 129], np.int32)
    tp, to = ops.pad_group_sizes(torch.from_numpy(sizes), bt)
    jp_, jo = jops.pad_group_sizes(jnp.asarray(sizes), bt)
    assert tp.dtype == to.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp_))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_tile_experts_for_capacity_and_moe_gmm_capacity_match_jax():
    te = ops.tile_experts_for_capacity(4, 24, 8, device="cpu")
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(jops.tile_experts_for_capacity(4, 24, 8)))
    with pytest.raises(ValueError, match="multiple of block_t"):
        ops.tile_experts_for_capacity(4, 20, 8)
    buf, rhs = _x(4, 24, 16), _x(4, 16, 40, seed=1)
    for bt in (8, 128):   # 128 clamps to C = 24
        close(ops.moe_gmm_capacity(torch.from_numpy(buf), torch.from_numpy(rhs), block_t=bt),
              jops.moe_gmm_capacity(jnp.asarray(buf), jnp.asarray(rhs), block_t=bt,
                                    interpret=True))
    with pytest.raises(ValueError, match="multiple of block_t"):
        ops.moe_gmm_capacity(torch.from_numpy(_x(4, 20, 16)), torch.from_numpy(rhs), block_t=8)


# --- routing and the MoE layer ------------------------------------------------------------
def _moe_params(jc, n_shared=0, seed=3):
    """One layer's MoE parameters from ``repro.models.moe.init_moe``, on both sides."""
    jc = dataclasses.replace(jc, n_shared_experts=n_shared)
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), jc)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    return pj, pt


def test_route_matches_jax_pick_for_pick():
    jc, tc = configs(ARCH)
    pj, pt = _moe_params(jc)
    x = _x(96, tc.d_model)
    jw, jidx, jaux = jmoe.route(pj["router"], jnp.asarray(x), jc)
    tw, tidx, taux = tmoe.route(pt["router"], torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(tw, jw)
    close(taux["lb_loss"], jaux["lb_loss"])
    close(taux["router_probs_mean"], jaux["router_probs_mean"])
    # ties: a zero router makes every probability equal; both pick the
    # lowest experts in order
    zj, zt = jnp.zeros_like(pj["router"]), torch.zeros_like(pt["router"])
    _, jidx, _ = jmoe.route(zj, jnp.asarray(x), jc)
    _, tidx, _ = tmoe.route(zt, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx.numpy() == np.arange(tc.top_k)).all()


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.05])
@pytest.mark.parametrize("impl,moe_impl", [
    ("dense", "ragged"), ("scatter", "scatter"), ("ragged", "ragged"),
    ("gmm", "scatter"), ("gmm", "ragged")])
def test_apply_moe_matches_jax(impl, moe_impl, capacity_factor, n_shared):
    """Every impl; ``gmm`` is the capacity twin under ``moe_impl="scatter"``
    and the dropless twin under ``ragged``. At capacity_factor 0.05 the
    capacity paths drop tokens (as tests/test_models.py checks for JAX)."""
    jc, tc = configs(ARCH, moe_impl=moe_impl, capacity_factor=capacity_factor,
                     n_shared_experts=n_shared)
    pj, pt = _moe_params(jc, n_shared)
    x = _x(4, 64, tc.d_model, seed=4)
    yj, aj = jmoe.apply_moe(pj, jnp.asarray(x), jc, impl=impl)
    yt, at = tmoe.apply_moe(pt, torch.from_numpy(x), tc, impl=impl)
    close(yt, yj)
    close(at["lb_loss"], aj["lb_loss"])
    if capacity_factor < 1 and moe_impl == "scatter":
        dropless = tmoe.apply_moe(pt, torch.from_numpy(x), tc, impl="dense")[0]
        assert not torch.allclose(yt, dropless, atol=1e-3)   # tokens were dropped


def test_apply_moe_policy_and_rejects():
    jc, tc = configs(ARCH, "auto")
    _, pt = _moe_params(jc)
    x = torch.from_numpy(_x(2, 5, tc.d_model))
    assert dict(tc.kernel_impls)["moe"] == "kernel"
    close(tmoe.apply_moe(pt, x, tc)[0], tmoe.apply_moe(pt, x, tc, impl="gmm")[0], dict(atol=0, rtol=0))
    with pytest.raises(ValueError, match="allowed impls"):
        tmoe.apply_moe(pt, x, tc, impl="einsum")
    # the sharded dispatch: under an ambient mesh whose "model" axis divides
    # the experts the port takes repro's constrained branch (its constraints
    # move no number), and its output equals repro's, which has no mesh here
    jsh, tsh = configs(ARCH, moe_dispatch_constraints=True, shard_activations=True)
    pj, pt = _moe_params(jsh)
    xs = _x(2, 5, tc.d_model, seed=5)
    mesh = AbstractMesh((2, tc.n_experts), ("data", "model"))
    with mesh:
        assert tmoe._expert_parallel(tsh)
        yt, at = tmoe.apply_moe(pt, torch.from_numpy(xs), tsh)
    assert not tmoe._expert_parallel(tsh)
    yj, aj = jmoe.apply_moe(pj, jnp.asarray(xs), jsh)
    close(yt, yj)
    close(at["lb_loss"], aj["lb_loss"])


# --- whole model ----------------------------------------------------------------------------
def _prefill_and_decode(jc, tc, seed=4):
    jp, tp = params(jc, tc)
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size, size=(2, 19))
    jl, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tcache = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    close(tl, jl)
    assert sorted(tcache) == sorted(jcache)
    jfull = jax.tree.map(lambda z, c: z.at[:, :, :c.shape[2]].set(c),
                         jmodel.init_cache(jc, 2, 32), jcache)
    tfull = tmodel.init_cache(tc, 2, 32, device="cpu")
    for seg in tcache:
        for key in ("k", "v"):
            close(tcache[seg][key], jcache[seg][key])
            tfull[seg][key][:, :, :tcache[seg][key].shape[2]] = tcache[seg][key]
    tok = np.array([[3], [7]])
    for pos in (np.array([19, 11]), np.array([20, 12])):
        jl, jfull = jmodel.decode_step(jp, jnp.asarray(tok, jnp.int32), jfull,
                                       jnp.asarray(pos, jnp.int32), jc)
        tl, tfull = tmodel.decode_step(tp, torch.from_numpy(tok), tfull, torch.from_numpy(pos), tc)
        close(tl, jl)
        tok = np.array(jnp.argmax(jl[:, :jc.vocab_size], -1))[:, None]
    for seg in tfull:
        for key in ("k", "v"):
            close(tfull[seg][key], jfull[seg][key])


@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("moe_impl", ["ragged", "scatter"])
def test_prefill_and_decode_match_jax(impls, moe_impl):
    _prefill_and_decode(*configs(ARCH, impls, moe_impl=moe_impl))


@pytest.mark.parametrize("impls", ["reference", "auto"])
def test_prefill_and_decode_with_a_dense_layer_and_a_shared_expert(impls):
    """``first_dense_layers=1`` (a ``dense0`` segment ahead of the moe one)
    and ``n_shared_experts=1``: the deepseek layout with GQA attention."""
    jc, tc = configs(ARCH, impls, n_layers=3, first_dense_layers=1, n_shared_experts=1)
    assert [s for s in tmodel.cache_spec(tc, 1, 8)] == ["dense0", "moe"]
    _prefill_and_decode(jc, tc)


# --- serving ----------------------------------------------------------------------------------
def _serve(engine, prompts, max_new, cls, drain_after=None):
    for i, p in enumerate(prompts):
        engine.add(cls(id=i, prompt=p, max_new=max_new))
    if drain_after is None:
        return {r.id: list(r.generated) for r in engine.run()}
    for _ in range(drain_after):
        engine.step()
    partial = engine.drain()
    assert partial and any(r.generated for r in partial)
    done = {r.id: list(r.generated) for r in engine.batcher.finished}
    for r in partial:
        engine.add(r)
    done.update({r.id: list(r.generated) for r in engine.run()})
    return done


@pytest.mark.parametrize("moe_impl", ["ragged", "scatter"])
def test_continuous_engine_streams_equal_jax(moe_impl):
    """Temperature-0 streams of the port's engine (``auto``: the kernel twins'
    plain paths) equal JAX's reference engine, uninterrupted and through a
    drain and resume; under ``scatter`` every decode wave runs the capacity
    bookkeeping over all slots, free ones included, as JAX does."""
    jc, tc = configs(ARCH, "reference", moe_impl=moe_impl)
    _, tc_auto = configs(ARCH, "auto", moe_impl=moe_impl)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tc.vocab_size, size=int(rng.integers(4, 12))).tolist()
               for _ in range(5)]
    want = _serve(JaxContinuousEngine(jc, jp, n_slots=3, max_seq=40), prompts, 7, JaxGenRequest)
    got = _serve(ContinuousEngine(tc_auto, tp, n_slots=3, max_seq=40, device="cpu"),
                 prompts, 7, GenRequest)
    assert got == want
    resumed = _serve(ContinuousEngine(tc_auto, tp, n_slots=3, max_seq=40, device="cpu"),
                     prompts, 7, GenRequest, drain_after=3)
    assert resumed == want


def test_serve_cli_serves_mixtral_smoke_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--requests", "3", "--prompt-len", "8", "--new-tokens", "4", "--batch-slots", "2"],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "served 3 requests, 12 tokens" in r.stdout and "mixtral-8x22b-smoke" in r.stdout

"""The port's SSM and hybrid path against ``repro``'s at float32 on the
mamba2 and zamba2 smoke configs: the ``ssd`` plain versions, the chunked
scan and its decode step, the causal conv, ``mamba_block`` and
``mamba_decode``, ``prefill``/``decode_step`` and the ``ContinuousEngine``
streams.

The same numpy inputs and parameters go through both sides, within
5e-5/5e-4 unless a case says why it uses ``tests/test_kernels.py``'s own
ssd tolerance; temperature-0 tokens must be equal. Under ``auto`` the JAX
side runs its Pallas kernels in interpret mode and the port its plain
versions (a CPU tensor never reaches the CUDA kernel).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, configs, params
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd as pallas_ssd
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.serving.batching import GenRequest as JaxGenRequest
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.serving.slot_state import find_batch_axes as jax_find_batch_axes
from repro_torch.kernels import ops, ref
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, PagedContinuousEngine, ServingEngine
from repro_torch.serving.kvcache import paged_compatible
from repro_torch.serving.slot_state import SlotBatchState, find_batch_axes

pytestmark = pytest.mark.slow

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
SRC = Path(__file__).resolve().parents[1] / "src"
# tests/test_kernels.py's ssd tolerance at float32, for comparisons of two
# different orders of summation: the chunked scan against the sequential
# recurrence, or one chunk size against another
SSD_TOL = dict(atol=2e-3, rtol=1e-3)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    """tests/test_kernels.py's construction, drawn with numpy: x, B, C
    standard normal, dt = softplus(N(0,1)), a = -exp(0.3 N(0,1))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.3)
    bm = rng.standard_normal((b, s, g, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, g, n), dtype=np.float32)
    return x, dt, a, bm, cm


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


# --- the ssd kernel's plain versions ----------------------------------------------------
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 16, 2, 8, 16),
    (1, 128, 8, 64, 1, 32, 32),     # mamba2-like (headdim 64, state big)
    (2, 96, 2, 8, 2, 16, 32),
    (1, 256, 4, 64, 1, 64, 128),    # zamba2-like
])
def test_ssd_chunk_ref_matches_pallas_and_ref(b, s, h, p, g, n, chunk):
    """The kernel's plain version against the Pallas kernel (interpret), the
    same algorithm, within 5e-5/5e-4; against the sequential oracles
    (``repro``'s and the port's ``ssd_ref``) within the ssd tolerance."""
    xs = _ssd_inputs(b, s, h, p, g, n)
    y, fin = ref.ssd_chunk_ref(*map(_t, xs), chunk)
    assert y.dtype == fin.dtype == torch.float32
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n) and y.is_contiguous()
    jy, jfin = pallas_ssd(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    close(y, jy)
    close(fin, jfin)
    ry, rfin = jref.ssd_ref(*map(jnp.asarray, xs))
    close(y, ry, SSD_TOL)
    close(fin, rfin, SSD_TOL)
    ty, tfin = ref.ssd_ref(*map(_t, xs))
    close(ty, ry)
    close(tfin, rfin)
    before = ops.launch_counts()["ssd"]
    oy, ofin = ops.ssd_op(*map(_t, xs), chunk=chunk)  # CPU: the plain path
    assert torch.equal(oy, y) and torch.equal(ofin, fin)
    assert ops.launch_counts()["ssd"] == before


def test_ssd_chunk_ref_chunk_invariance():
    xs = list(map(_t, _ssd_inputs(1, 128, 2, 16, 1, 8)))
    outs = [ref.ssd_chunk_ref(*xs, c) for c in (16, 32, 64, 128)]
    for y, fin in outs[1:]:
        close(y, outs[0][0], dict(atol=1e-4, rtol=1e-3))   # test_ssd_chunk_invariance's
        close(fin, outs[0][1], dict(atol=1e-4, rtol=1e-3))


def test_ssd_chunk_ref_rejects_bad_shapes():
    x, dt, a, bm, cm = map(_t, _ssd_inputs(1, 64, 4, 16, 2, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_chunk_ref(x, dt, a, bm, cm, 48)
    x3, dt3, a3, bm3, cm3 = map(_t, _ssd_inputs(1, 64, 3, 16, 2, 8))
    with pytest.raises(ValueError, match="multiple of G"):
        ops.ssd_op(x3, dt3, a3, bm3, cm3, chunk=16)
    with pytest.raises(ValueError, match="do not match"):
        ref.ssd_chunk_ref(x, dt[:, :32], a, bm, cm, 16)


# --- models/ssm.py ------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    """The reference scan, from zero and resumed from a state (the state
    threads through: two halves equal one whole)."""
    xs = _ssd_inputs(2, 64, 4, 16, 2, 8, seed=1)
    init = _x(2, 4, 16, 8, seed=2) if with_state else None
    jy, jfin = jssm.ssd_chunked(*map(jnp.asarray, xs), 16,
                                None if init is None else jnp.asarray(init))
    ty, tfin = tssm.ssd_chunked(*map(_t, xs), 16, None if init is None else _t(init))
    close(ty, jy)
    close(tfin, jfin)
    x, dt, a, bm, cm = map(_t, xs)
    y1, s1 = tssm.ssd_chunked(x[:, :32], dt[:, :32], a, bm[:, :32], cm[:, :32], 16,
                              None if init is None else _t(init))
    y2, s2 = tssm.ssd_chunked(x[:, 32:], dt[:, 32:], a, bm[:, 32:], cm[:, 32:], 16, s1)
    close(torch.cat([y1, y2], dim=1), ty)
    close(s2, tfin)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    state = _x(3, 4, 16, 8, seed=4)
    x, bm, cm = _x(3, 4, 16, seed=5), _x(3, 2, 8, seed=6), _x(3, 2, 8, seed=7)
    dt = np.log1p(np.exp(rng.standard_normal((3, 4), dtype=np.float32)))
    a = -np.exp(rng.standard_normal(4, dtype=np.float32) * 0.3)
    args = (state, x, dt, a, bm, cm)
    jy, jst = jssm.ssd_decode_step(*map(jnp.asarray, args))
    ty, tst = tssm.ssd_decode_step(*map(_t, args))
    close(ty, jy)
    close(tst, jst)


def test_causal_conv_matches_jax():
    x, w, b = _x(2, 11, 40), _x(40, 4, seed=1), _x(40, seed=2)
    out = tssm._causal_conv(_t(x), _t(w), _t(b))
    assert out.is_contiguous()
    close(out, jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    close(tssm._segsum(_t(x[0, 0, :8])), jssm._segsum(jnp.asarray(x[0, 0, :8])))


def _mixer(arch, impls):
    jc, tc = configs(arch, impls)
    jp, tp = params(jc, tc)
    seg = "ssm" if arch == "mamba2-2.7b" else "hybrid"
    jm, tm = jp["stack"][seg], tp["stack"][seg]
    if seg == "hybrid":
        jm, tm = _layer0(jm["mamba"]), _layer0(tm["mamba"])
    return jc, tc, _layer0(jm["mixer"]), _layer0(tm["mixer"])


@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("s", [64, 50, 2])  # a multiple of the chunk (32), not, 2 tokens
def test_mamba_block_matches_jax(s, impls):
    jc, tc, jm, tm = _mixer("mamba2-2.7b", impls)
    u = _x(2, s, tc.d_model, seed=8)
    jy, jst, jtail = jssm.mamba_block(jm, jnp.asarray(u), jc)
    ty, tst, ttail = tssm.mamba_block(tm, _t(u), tc)
    close(ty, jy)
    close(tst, jst)
    assert ttail.shape == jtail.shape == (2, min(s, tc.d_conv - 1), tc.conv_dim)
    close(ttail, jtail)


@pytest.mark.parametrize("impls", ["reference", "auto"])
def test_mamba_decode_matches_jax(impls):
    jc, tc, jm, tm = _mixer("zamba2-2.7b", impls)
    u = _x(3, 1, tc.d_model, seed=9)
    state = _x(3, tc.n_ssm_heads, tc.ssm_headdim, tc.ssm_state, seed=10)
    conv = _x(3, tc.d_conv - 1, tc.conv_dim, seed=11)
    jy, jst, jconv = jssm.mamba_decode(jm, jnp.asarray(u), jnp.asarray(state),
                                       jnp.asarray(conv), jc)
    tstate, tconv = _t(state), _t(conv)
    ty, tst, tcv = tssm.mamba_decode(tm, _t(u), tstate, tconv, tc)
    close(ty, jy)
    close(tst, jst)
    close(tcv, jconv)
    assert np.array_equal(tstate.numpy(), state) and np.array_equal(tconv.numpy(), conv)


# --- whole model ----------------------------------------------------------------------------
def _grow(jc, tc, jcache, tcache, batch, seq):
    """Both caches grown to ``seq`` positions (K/V right-padded), as the
    engines' graft does."""
    jfull = jax.tree.map(lambda z, c: z.at[tuple(slice(0, n) for n in c.shape)].set(c),
                         jmodel.init_cache(jc, batch, seq), jcache)
    tfull = tmodel.init_cache(tc, batch, seq, device="cpu")
    for seg in tcache:
        for key, leaf in tcache[seg].items():
            tfull[seg][key][tuple(slice(0, n) for n in leaf.shape)] = leaf
    return jfull, tfull


@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, impls):
    jc, tc = configs(arch, impls)
    jp, tp = params(jc, tc)
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, size=(2, 19))
    jl, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tcache = tmodel.prefill(tp, {"tokens": _t(toks)}, tc)
    close(tl, jl)
    assert {s: sorted(c) for s, c in tcache.items()} == {s: sorted(c) for s, c in jcache.items()}
    for seg in tcache:
        for key in tcache[seg]:
            assert tuple(tcache[seg][key].shape) == jcache[seg][key].shape, (seg, key)
            close(tcache[seg][key], jcache[seg][key])
    jfull, tfull = _grow(jc, tc, jcache, tcache, 2, 32)
    tok = np.array([[3], [7]])
    for pos in (np.array([19, 11]), np.array([20, 12])):
        jl, jfull = jmodel.decode_step(jp, jnp.asarray(tok, jnp.int32), jfull,
                                       jnp.asarray(pos, jnp.int32), jc)
        tl, tfull = tmodel.decode_step(tp, _t(tok), tfull, _t(pos), tc)
        close(tl, jl)
        tok = np.array(jnp.argmax(jl[:, :jc.vocab_size], -1))[:, None]
    for seg in tfull:
        for key in tfull[seg]:
            close(tfull[seg][key], jfull[seg][key])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches_jax(arch):
    jc, tc = configs(arch)
    jspec, tspec = jmodel.cache_spec(jc, 3, 40), tmodel.cache_spec(tc, 3, 40)
    assert sorted(tspec) == sorted(jspec)
    for seg in tspec:
        assert sorted(tspec[seg]) == sorted(jspec[seg])
        for key, leaf in tspec[seg].items():
            assert tuple(leaf.shape) == jspec[seg][key].shape, (seg, key)
            assert leaf.device.type == "meta"
            assert str(leaf.dtype).split(".")[-1] == str(jspec[seg][key].dtype), (seg, key)


def test_cast_params_keeps_ssm_scalars_conv_and_norms():
    """``repro`` reads A_log, dt_bias, D_skip and the decode conv in fp32 and
    casts the conv only at its prefill use, so those leaves, like the norm
    weights, keep param_dtype; the projections get the bf16 copy."""
    for arch, seg in (("mamba2-2.7b", "ssm"), ("zamba2-2.7b", "hybrid")):
        _, tc = configs(arch, dtype="bfloat16")
        tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
        cast = tmodel.cast_params(tp, tc)
        src, got = tp["stack"][seg], cast["stack"][seg]
        if seg == "hybrid":
            assert got["shared"]["attn"]["wq"].dtype == torch.bfloat16
            assert got["shared"]["ln1"]["w"] is src["shared"]["ln1"]["w"]
            src, got = src["mamba"], got["mamba"]
        for key in ("A_log", "dt_bias", "D_skip", "conv_w", "conv_b", "norm_w"):
            assert got["mixer"][key] is src["mixer"][key], (arch, key)
            assert got["mixer"][key].dtype == torch.float32
        assert got["ln"]["w"] is src["ln"]["w"]
        for key in ("in_proj", "out_proj"):
            assert got["mixer"][key].dtype == torch.bfloat16, (arch, key)
        assert (src["mixer"]["dt_bias"] == -2.0).all()


# --- serving ----------------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_slot_state_batch_axes_and_graft(arch):
    """One batch axis per leaf, as JAX finds it (axis 1 of the stacked SSM
    leaves, axis 2 of the hybrid's (group, layer)-stacked ones), and a graft
    that zeroes the row and right-pads a short conv tail; the paged layout
    stays refused for these families."""
    jc, tc = configs(arch)
    axes = find_batch_axes(tc, 16)
    assert axes == jax_find_batch_axes(jc, 16)
    live = SlotBatchState(tc, 3, 16, device="cpu")
    for leaf in tmodel.tree_leaves(live.tree):
        leaf.fill_(7)
    spec = tmodel.cache_spec(tc, 1, 16)
    pre = {seg: {key: torch.ones(leaf.shape[:-2] + (2, leaf.shape[-1]) if key == "conv"
                                 else leaf.shape, dtype=leaf.dtype)
                 for key, leaf in spec[seg].items()} for seg in spec}   # a 2-token conv tail
    live.graft(pre, 1)
    for seg in live.tree:
        for key, leaf in live.tree[seg].items():
            ax = axes[seg][key]
            row = leaf.narrow(ax, 1, 1)
            n = pre[seg][key].shape
            assert bool((row[tuple(slice(0, k) for k in n)] == 1).all()), (seg, key)
            assert float(row.sum()) == pre[seg][key].numel(), (seg, key)  # the rest zeroed
            assert bool((leaf.narrow(ax, 0, 1) == 7).all()), (seg, key)
    assert not paged_compatible(tc)
    _, tp = params(jc, tc)
    with pytest.raises(ValueError, match="paged KV layout not defined"):
        PagedContinuousEngine(tc, tp, max_seq=32, device="cpu")


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


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_streams_equal_jax(arch):
    """Temperature-0 streams of the port's engine (``auto``: the kernels'
    plain paths) equal JAX's reference engine over staggered prompts,
    uninterrupted, through a drain and resume, and one request at a time
    through ``ServingEngine.generate``.

    Request 0's prompt is 2 tokens, shorter than the conv window: both
    packages right-pad its conv tail at the graft, so its first decode
    windows hold a zero row in the wrong place (ROADMAP section 3). A
    resume re-prefills the longer context with the right window, so for
    that request the resumed stream differs from the unbroken one, in JAX
    as in the port; every other request resumes to its unbroken stream."""
    jc, tc = configs(arch, "reference")
    _, tc_auto = configs(arch, "auto")
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(5)
    lens = [2, 9, 5, 12, 7]
    prompts = [rng.integers(0, tc.vocab_size, size=n).tolist() for n in lens]
    want = _serve(JaxContinuousEngine(jc, jp, n_slots=3, max_seq=40), prompts, 7, JaxGenRequest)
    got = _serve(ContinuousEngine(tc_auto, tp, n_slots=3, max_seq=40, device="cpu"),
                 prompts, 7, GenRequest)
    assert got == want
    want_resumed = _serve(JaxContinuousEngine(jc, jp, n_slots=3, max_seq=40), prompts, 7,
                          JaxGenRequest, drain_after=3)
    resumed = _serve(ContinuousEngine(tc_auto, tp, n_slots=3, max_seq=40, device="cpu"),
                     prompts, 7, GenRequest, drain_after=3)
    assert resumed == want_resumed
    assert {i: resumed[i] for i in range(1, 5)} == {i: want[i] for i in range(1, 5)}
    assert resumed[0][:4] == want[0][:4]   # the tokens made before the drain
    seq = ServingEngine(tc_auto, tp, max_seq=40, device="cpu")
    for i, p in enumerate(prompts):
        assert seq.generate(np.asarray([p]), 7)[0].tolist() == want[i], i


def test_serve_cli_serves_mamba2_smoke_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-2.7b", "--device",
         "cpu", "--requests", "3", "--prompt-len", "8", "--new-tokens", "4",
         "--batch-slots", "2"],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "served 3 requests, 12 tokens" in r.stdout and "mamba2-2.7b-smoke" in r.stdout

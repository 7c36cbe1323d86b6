"""The port's model code against ``repro`` at float32 on the smoke configs:
the same parameters (JAX -> numpy -> ``params_from_numpy``) and the same
numpy inputs through both, within 5e-5/5e-4. Under ``auto`` the JAX side
runs its Pallas kernels in interpret mode and the port its plain versions.
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

from _torch_parity import close, configs, params
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import with_kernel_impls as torch_with_kernel_impls
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy

pytestmark = pytest.mark.slow

ARCHS = ["qwen2.5-3b", "internlm2-1.8b", "qwen1.5-4b", "stablelm-12b"]
# the archs served through prefill/decode, and every arch of repro
SERVED_ARCHS = ARCHS + ["mixtral-8x22b", "deepseek-v2-lite-16b", "mamba2-2.7b", "zamba2-2.7b"]
ALL_ARCHS = SERVED_ARCHS + ["hubert-xlarge", "internvl2-26b"]
# kernel sites under ``auto``: rmsnorm for every arch but the gelu encoder
# (LayerNorm), flash attention for GQA archs (MLA has no flash twin), the
# grouped matmul for MoE archs, ssd for SSM and hybrid archs
AUTO_SITES = {"qwen2.5-3b": ("attention", "rmsnorm"),
              "internlm2-1.8b": ("attention", "rmsnorm"),
              "qwen1.5-4b": ("attention", "rmsnorm"),
              "stablelm-12b": ("attention", "rmsnorm"),
              "mixtral-8x22b": ("attention", "moe", "rmsnorm"),
              "mamba2-2.7b": ("rmsnorm", "ssm"),
              "zamba2-2.7b": ("attention", "rmsnorm", "ssm"),
              "deepseek-v2-lite-16b": ("moe", "rmsnorm"),
              "hubert-xlarge": ("attention",),
              "internvl2-26b": ("attention", "rmsnorm")}
SRC = Path(__file__).resolve().parents[1] / "src"


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# --- configs ------------------------------------------------------------------
@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_repro_field_by_field(arch, smoke):
    jc, tc = jax_get_config(arch, smoke=smoke), torch_get_config(arch, smoke=smoke)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.vocab_padded == jc.vocab_padded
    jcfg, tcfg = configs(arch, "auto")
    assert tcfg.kernel_impls == jcfg.kernel_impls == tuple(
        (site, "kernel") for site in AUTO_SITES[arch])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_mla_properties_equal_repros(arch):
    jc, tc = jax_get_config(arch), torch_get_config(arch)
    assert tc.q_dim == jc.q_dim and tc.kv_cache_head_dim == jc.kv_cache_head_dim


# --- parameters ---------------------------------------------------------------
def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_from_numpy_keeps_every_leaf_and_key(arch):
    jc, tc = configs(arch)
    jp, tp = params(jc, tc)
    jflat, tflat = _flat(jp), _flat(tp)
    assert sorted(jflat) == sorted(tflat)
    for path, leaf in jflat.items():
        assert tuple(tflat[path].shape) == leaf.shape, path
        np.testing.assert_array_equal(tflat[path].numpy(), np.asarray(leaf), err_msg=str(path))


def test_params_from_numpy_rejects_wrong_tree():
    jc, tc = configs("qwen2.5-3b")
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jc))
    bad = dict(tree, extra=np.zeros(3))
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(bad, tc, device="cpu")
    tree["final_norm"]["w"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm/w"):
        params_from_numpy(tree, tc, device="cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_has_repro_tree_and_scales(arch):
    jc, tc = configs(arch)
    jflat = _flat(jmodel.init_params(jax.random.PRNGKey(0), jc))
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    tflat = _flat(tp)
    assert sorted(jflat) == sorted(tflat)
    specs = _flat(tmodel.param_specs(tc))
    for path, leaf in jflat.items():
        t = tflat[path]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, path
        spec = specs[path]
        if spec.init == "normal":
            assert t.abs().max() <= 2 * spec.scale + 1e-7, path
            assert abs(t.std().item() / spec.scale - 0.88) < 0.1, path  # std of N(0,1) cut at +-2
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf), err_msg=str(path))
    tp2 = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tmodel.tree_leaves(tp),
                                                 tmodel.tree_leaves(tp2)))


_INIT_DIGEST = (
    "import dataclasses, hashlib, torch\n"
    "from repro_torch.configs import get_config\n"
    "from repro_torch.models import model\n"
    "cfg = dataclasses.replace(get_config('qwen2.5-3b', smoke=True), dtype='float32')\n"
    "tp = model.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')\n"
    "h = hashlib.sha256()\n"
    "for t in model.tree_leaves(tp):\n"
    "    h.update(t.numpy().tobytes())\n"
    "print(h.hexdigest())\n")


def test_init_params_bits_do_not_depend_on_mkl_or_threads():
    """The same seed gives the same bits whatever code path MKL picks and
    however many threads run: the draw never goes through MKL (``erfinv_``
    did, and MKL's SSE4.2, AVX2 and AVX-512 paths round differently)."""
    digests = set()
    for env in ({}, {"MKL_ENABLE_INSTRUCTIONS": "SSE4_2", "OMP_NUM_THREADS": "3"},
                {"MKL_ENABLE_INSTRUCTIONS": "AVX2", "OMP_NUM_THREADS": "1"}):
        r = subprocess.run([sys.executable, "-c", _INIT_DIGEST], capture_output=True,
                           text=True, timeout=120,
                           env={**os.environ, "PYTHONPATH": str(SRC), **env})
        assert r.returncode == 0, r.stderr
        digests.add(r.stdout.strip())
    assert len(digests) == 1, digests


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_init_params_redraws_slice_by_slice_with_the_same_bits(arch, monkeypatch):
    """The out-of-range redraws go slice by slice; with slices of 7
    elements the parameters are bit for bit those of one whole-leaf slice
    (``t[t.abs() > 2] = draw``)."""
    tc = torch_get_config(arch, smoke=True)
    whole = tmodel.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    monkeypatch.setattr(tmodel, "_SLICE", 7)
    sliced = tmodel.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tmodel.tree_leaves(whole),
                                                 tmodel.tree_leaves(sliced)))
    t = torch.empty(1000).normal_(generator=torch.Generator().manual_seed(4))
    want = t.clone()
    gen = torch.Generator().manual_seed(5)
    out = want.abs() > 2.0
    while bool(out.any()):
        want[out] = torch.empty(int(out.sum())).normal_(generator=gen)
        out = want.abs() > 2.0
    tmodel._redraw_outside(t, torch.Generator().manual_seed(5))
    assert torch.equal(t, want) and float(t.abs().max()) <= 2.0


def test_cast_params_keeps_norms_and_copies_matrices_once():
    _, tc = configs("qwen2.5-3b", dtype="bfloat16")
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    cast = tmodel.cast_params(tp, tc)
    assert cast["final_norm"]["w"] is tp["final_norm"]["w"]
    assert cast["stack"]["dense"]["ln1"]["w"].dtype == torch.float32
    assert cast["stack"]["dense"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["stack"]["dense"]["attn"]["bq"].dtype == torch.bfloat16
    again = tmodel.cast_params(cast, tc)
    assert again["stack"]["dense"]["attn"]["wq"] is cast["stack"]["dense"]["attn"]["wq"]
    # the MoE router stays at param_dtype: route reads it in fp32, as repro does
    _, mc = configs("mixtral-8x22b", dtype="bfloat16")
    mp = tmodel.init_params(mc, torch.Generator().manual_seed(0), device="cpu")
    mcast = tmodel.cast_params(mp, mc)
    assert mcast["stack"]["moe"]["moe"]["router"] is mp["stack"]["moe"]["moe"]["router"]
    assert mcast["stack"]["moe"]["moe"]["w_gate"].dtype == torch.bfloat16


# --- layers -------------------------------------------------------------------
@pytest.mark.parametrize("impls", ["reference", "auto"])
def test_rms_norm_matches_jax(impls):
    jc, tc = configs("qwen2.5-3b", impls)
    x, w = _x(3, 5, 64), _x(64, seed=1)
    close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, tc),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, jc))


@pytest.mark.parametrize("impls", ["reference", "auto"])
def test_add_rms_norm_matches_jax(impls):
    """(s, y) = add_rms_norm(x, h) against JAX's x + h and its rms_norm;
    under ``reference`` it is ``x + h`` and ``rms_norm``, bit for bit."""
    jc, tc = configs("qwen2.5-3b", impls)
    x, h, w = _x(3, 5, 64), _x(3, 5, 64, seed=2), _x(64, seed=1)
    tx, th, tw = (torch.from_numpy(a) for a in (x, h, w))
    s, y = tlayers.add_rms_norm(tx, th, tw, 1e-5, tc)
    js = jnp.asarray(x) + jnp.asarray(h)
    close(s, js)
    close(y, jlayers.rms_norm(js, jnp.asarray(w), 1e-5, jc))
    if impls == "reference":
        assert torch.equal(s, tx + th)
        assert torch.equal(y, tlayers.rms_norm(tx + th, tw, 1e-5, tc))


def _count_norm_forms(monkeypatch):
    """Count the calls of each rmsnorm kernel op from the model code (on CPU
    tensors the ops run their plain versions and count no launch)."""
    from repro_torch.kernels import ops as kops
    calls = {"plain": 0, "residual": 0, "gated": 0}
    for name, form in (("rmsnorm_op", "plain"), ("add_rmsnorm_op", "residual"),
                       ("gated_rmsnorm_op", "gated")):
        def counted(*args, _fn=getattr(kops, name), _form=form, **kwargs):
            calls[_form] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(kops, name, counted)
    return calls


def _norms_per_pass(cfg):
    """(plain, residual, gated) norm calls of one forward pass under
    ``auto``: the stack's first norm follows the embedding and no add; every
    other norm follows a residual add (the final norm too); each Mamba2
    mixer has one gated norm."""
    gated = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    total = 2 * cfg.n_layers + 1 + (2 * cfg.n_attn_layers if cfg.family == "hybrid" else 0)
    return {"plain": 1, "residual": total - 1 - gated, "gated": gated}


@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_every_norm_after_an_add_takes_the_residual_form(arch, impls, monkeypatch):
    """Under ``auto`` a prefill and a decode step each make one plain norm
    call, a residual-form call for every other norm and a gated call for
    every Mamba2 mixer; under ``reference`` none of the kernel ops."""
    tc = torch_with_kernel_impls(
        dataclasses.replace(torch_get_config(arch, smoke=True), dtype="float32"), impls)
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    calls = _count_norm_forms(monkeypatch)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, tc.vocab_size, size=(2, 9)))
    logits, cache = tmodel.prefill(tp, {"tokens": toks}, tc)
    per_pass = _norms_per_pass(tc)
    want = per_pass if impls == "auto" else dict.fromkeys(per_pass, 0)
    assert calls == want
    full = tmodel.init_cache(tc, 2, 12, device="cpu")
    for seg in cache:
        for key, leaf in cache[seg].items():
            full[seg][key][tuple(slice(0, n) for n in leaf.shape)] = leaf
    tmodel.decode_step(tp, toks[:, -1:], full, 9, tc)
    assert calls == {k: 2 * n for k, n in want.items()}
    assert bool(torch.isfinite(logits).all())


def test_paged_decode_step_norms_take_the_residual_form(monkeypatch):
    tc = torch_with_kernel_impls(
        dataclasses.replace(torch_get_config("qwen2.5-3b", smoke=True), dtype="float32"), "auto")
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    pool = (tc.n_layers, 5, 4, tc.n_kv_heads, tc.head_dim)
    kp, vp = torch.zeros(pool), torch.zeros(pool)
    calls = _count_norm_forms(monkeypatch)
    tmodel.paged_decode_step(tp, torch.tensor([[3], [7]]), kp, vp,
                             np.array([[1, 2], [3, 4]], np.int32), np.array([0, 0]),
                             np.array([1, 3]), np.array([0, 0]), tc)
    assert calls == _norms_per_pass(tc)


def test_apply_rope_matches_jax():
    x = _x(2, 7, 4, 16)
    pos = np.random.default_rng(3).integers(0, 5000, size=(2, 7))
    close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6))
    close(tlayers.rope_freqs(128, 1e6), jlayers.rope_freqs(128, 1e6))


def test_apply_mlp_matches_jax():
    jc, tc = configs("internlm2-1.8b")
    jp, tp = params(jc, tc)
    x = _x(2, 5, 64)
    close(tlayers.apply_mlp(_layer0(tp["stack"]["dense"]["mlp"]), torch.from_numpy(x), tc),
          jlayers.apply_mlp(_layer0(jp["stack"]["dense"]["mlp"]), jnp.asarray(x), jc))


# --- attention ----------------------------------------------------------------
@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("window", [None, 8])
def test_gqa_prefill_matches_jax(impls, window):
    jc, tc = configs("qwen2.5-3b", impls, sliding_window=window)
    jp, tp = params(jc, tc)
    ja, ta = _layer0(jp["stack"]["dense"]["attn"]), _layer0(tp["stack"]["dense"]["attn"])
    x = _x(2, 20, 64)
    pos = np.broadcast_to(np.arange(20), (2, 20))
    jout, jk, jv = jattn.gqa_prefill(ja, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jc)
    tout, tk, tv = tattn.gqa_prefill(ta, torch.from_numpy(x), torch.from_numpy(pos.copy()), tc)
    close(tout, jout)
    close(tk, jk)
    close(tv, jv)
    close(tattn.gqa_attention(ta, torch.from_numpy(x), torch.from_numpy(pos.copy()), tc),
          jattn.gqa_attention(ja, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jc))


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("pos", [13, "rows"])
def test_gqa_decode_matches_jax(window, pos):
    """Scalar and (B,) positions, dense cache and SWA ring (8 slots); the
    (B,) case includes a row past the cache end, dropped like mode="drop"."""
    jc, tc = configs("qwen2.5-3b", sliding_window=window)
    jp, tp = params(jc, tc)
    ja, ta = _layer0(jp["stack"]["dense"]["attn"]), _layer0(tp["stack"]["dense"]["attn"])
    b, s_cache = 3, (8 if window else 24)
    shape = (b, s_cache, tc.n_kv_heads, tc.head_dim)
    kc, vc, x = _x(*shape, seed=1), _x(*shape, seed=2), _x(b, 1, 64, seed=3)
    if pos == "rows":
        p = np.array([5, 30, 17])
        jpos, tpos = jnp.asarray(p, jnp.int32), torch.from_numpy(p)
    else:
        jpos, tpos = jnp.int32(pos), pos
    jout, jk, jv = jattn.gqa_decode(ja, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jpos, jc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, tk2, tv2 = tattn.gqa_decode(ta, torch.from_numpy(x), tk, tv, tpos, tc)
    assert tk2 is tk and tv2 is tv  # updated in place
    close(tout, jout)
    close(tk, jk)
    close(tv, jv)


# --- whole model ----------------------------------------------------------------
@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, impls):
    jc, tc = configs(arch, impls)
    jp, tp = params(jc, tc)
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, size=(2, 19))
    jl, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tcache = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    close(tl, jl)
    for key in ("k", "v"):
        close(tcache["dense"][key], jcache["dense"][key])
    # grow both caches to 32 and take two decode steps at per-row positions
    jfull = jax.tree.map(lambda z, c: z.at[:, :, :19].set(c), jmodel.init_cache(jc, 2, 32), jcache)
    tfull = tmodel.init_cache(tc, 2, 32, device="cpu")
    for key in ("k", "v"):
        tfull["dense"][key][:, :, :19] = tcache["dense"][key]
    tok = np.array([[3], [7]])
    for pos in (np.array([19, 11]), np.array([20, 12])):
        jl, jfull = jmodel.decode_step(jp, jnp.asarray(tok, jnp.int32), jfull,
                                       jnp.asarray(pos, jnp.int32), jc)
        tl, tfull = tmodel.decode_step(tp, torch.from_numpy(tok), tfull,
                                       torch.from_numpy(pos), tc)
        close(tl, jl)
        tok = np.array(jnp.argmax(jl[:, :jc.vocab_size], -1))[:, None]
    for key in ("k", "v"):
        close(tfull["dense"][key], jfull["dense"][key])
    # the padded-vocab columns are masked with -1e9 on both sides
    assert tl.shape == (2, tc.vocab_padded)


def test_cache_spec_matches_jax():
    jc, tc = configs("internlm2-1.8b", sliding_window=8)
    jspec, tspec = jmodel.cache_spec(jc, 3, 40), tmodel.cache_spec(tc, 3, 40)
    for key in ("k", "v"):
        assert tuple(tspec["dense"][key].shape) == jspec["dense"][key].shape
        assert tspec["dense"][key].device.type == "meta"

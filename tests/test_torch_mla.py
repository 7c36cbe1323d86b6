"""The port's MLA path (multi-head latent attention, deepseek-v2-lite-16b)
against ``repro``'s at float32 on the smoke config.

The four MLA functions (``_mla_q``, ``mla_attention``, ``mla_prefill``,
``mla_decode``) on the same numpy inputs and parameters within 5e-5/5e-4;
the whole model's prefill and decode against its own forward at
``repro``'s decode==forward tolerance (2e-4/2e-3) and against JAX;
temperature-0 ``ContinuousEngine`` and ``batched-serving`` streams equal
JAX's through drain and resume; the paged layout refuses MLA as ``repro``
does. Under ``auto`` the JAX side runs its Pallas kernels (moe, rmsnorm) in
interpret mode and the port its plain versions.
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
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving.batching import GenRequest as JaxGenRequest
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.serving.engine import PagedContinuousEngine as JaxPagedContinuousEngine
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, PagedContinuousEngine
from repro_torch.serving.kvcache import PagedKVCache, paged_compatible
from repro_torch.serving.slot_state import SlotBatchState, find_batch_axes

pytestmark = pytest.mark.slow

ARCH = "deepseek-v2-lite-16b"
SRC = Path(__file__).resolve().parents[1] / "src"
# repro's decode==forward tolerance (tests/test_models.py): the absorbed
# decode and the decompressed forward are one function up to rounding
DECODE_TOL = dict(atol=2e-4, rtol=2e-3)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _attn0(jp, tp, seg="moe"):
    """Layer 0's attention leaves of ``seg`` on both sides."""
    return ({k: v[0] for k, v in jp["stack"][seg]["attn"].items()},
            {k: v[0] for k, v in tp["stack"][seg]["attn"].items()})


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs(ARCH)
    jp, tp = params(jc, tc)
    return jc, tc, jp, tp


# --- the four MLA functions ---------------------------------------------------------------
def test_mla_q_matches_jax(setup):
    jc, tc, jp, tp = setup
    ja, ta = _attn0(jp, tp)
    x = _x(2, 11, tc.d_model)
    pos = np.random.default_rng(1).integers(0, 300, size=(2, 11))
    jn, jr = jattn._mla_q(ja, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jc)
    tn, tr = tattn._mla_q(ta, torch.from_numpy(x), torch.from_numpy(pos), tc)
    assert tuple(tn.shape) == jn.shape == (2, 11, tc.n_heads, tc.qk_nope_dim)
    assert tuple(tr.shape) == jr.shape == (2, 11, tc.n_heads, tc.qk_rope_dim)
    close(tn, jn)
    close(tr, jr)


@pytest.mark.parametrize("seg", ["dense0", "moe"])
def test_mla_attention_and_prefill_match_jax(setup, seg):
    jc, tc, jp, tp = setup
    ja, ta = _attn0(jp, tp, seg)
    x = _x(2, 17, tc.d_model, seed=2)
    pos = np.broadcast_to(np.arange(17), (2, 17))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos.copy())
    close(tattn.mla_attention(ta, tx, tpos, tc), jattn.mla_attention(ja, jx, jpos, jc))
    close(tattn.attention(ta, tx, tpos, tc), jattn.attention(ja, jx, jpos, jc))
    jout, jcache = jattn.mla_prefill(ja, jx, jpos, jc)
    tout, tcache = tattn.mla_prefill(ta, tx, tpos, tc)
    assert tuple(tcache.shape) == jcache.shape == (2, 17, tc.kv_cache_head_dim)
    close(tout, jout)
    close(tcache, jcache)


@pytest.mark.parametrize("pos", [13, "rows"])
def test_mla_decode_matches_jax(setup, pos):
    """Scalar and (B,) positions; the (B,) case has a row past the cache
    end, whose write is dropped as JAX's ``mode="drop"`` drops it."""
    jc, tc, jp, tp = setup
    ja, ta = _attn0(jp, tp)
    b, s_cache = 3, 24
    cache, x = _x(b, s_cache, tc.kv_cache_head_dim, seed=3), _x(b, 1, tc.d_model, seed=4)
    if pos == "rows":
        p = np.array([5, 30, 17])
        jpos, tpos = jnp.asarray(p, jnp.int32), torch.from_numpy(p)
    else:
        jpos, tpos = jnp.int32(pos), pos
    jout, jc2 = jattn.mla_decode(ja, jnp.asarray(x), jnp.asarray(cache), jpos, jc)
    tc_cache = torch.from_numpy(cache.copy())
    tout, tc2 = tattn.mla_decode(ta, torch.from_numpy(x), tc_cache, tpos, tc)
    assert tc2 is tc_cache  # updated in place
    close(tout, jout)
    close(tc_cache, jc2)
    if pos == "rows":  # the out-of-range row left its cache row as it was
        np.testing.assert_array_equal(tc_cache[1].numpy(), cache[1])


# --- the whole model ------------------------------------------------------------------------
def _grow(tcache, jcache, jc, tc, b, s_max):
    jfull = jax.tree.map(lambda z, c: z.at[:, :, :c.shape[2]].set(c),
                         jmodel.init_cache(jc, b, s_max), jcache)
    tfull = tmodel.init_cache(tc, b, s_max, device="cpu")
    for seg in tcache:
        leaf = tcache[seg]["c"]
        tfull[seg]["c"][:, :, :leaf.shape[2]] = leaf
    return jfull, tfull


@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("moe_impl", ["ragged", "scatter"])
def test_prefill_and_decode_match_forward_and_jax(impls, moe_impl):
    """prefill(S) + 4 decode steps reproduce the forward's logits at each
    position (the absorbed decode against the decompressed forward) and
    equal JAX's. ``scatter`` (FULL's capacity path) runs at a capacity
    factor where no token is dropped: the decode and the forward route
    different token counts, so with drops they are not one function."""
    extra = dict(capacity_factor=4.0) if moe_impl == "scatter" else {}
    jc, tc = configs(ARCH, impls, moe_impl=moe_impl, **extra)
    jp, tp = params(jc, tc)
    s, n_dec, b = 16, 4, 2
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, size=(b, s + n_dec))
    tfwd, _ = tmodel.forward(tp, {"tokens": torch.from_numpy(toks)}, tc)
    jfwd, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    close(tfwd, jfwd)
    tl, tcache = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, tc)
    jl, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :s], jnp.int32)}, jc)
    assert sorted(tcache) == ["dense0", "moe"] and sorted(tcache["moe"]) == ["c"]
    close(tl, jl)
    close(tl, tfwd[:, s - 1], DECODE_TOL)
    for seg in tcache:
        close(tcache[seg]["c"], jcache[seg]["c"])
    jfull, tfull = _grow(tcache, jcache, jc, tc, b, s + n_dec)
    for i in range(n_dec):
        pos = s + i
        tok = toks[:, pos:pos + 1]
        tl, tfull = tmodel.decode_step(tp, torch.from_numpy(tok), tfull, pos, tc)
        jl, jfull = jmodel.decode_step(jp, jnp.asarray(tok, jnp.int32), jfull, jnp.int32(pos), jc)
        close(tl, jl)
        close(tl, tfwd[:, pos], DECODE_TOL)
    for seg in tfull:
        close(tfull[seg]["c"], jfull[seg]["c"])


def test_decode_at_per_row_positions_matches_jax(setup):
    """A (B,) position vector: each row decodes at its own offset."""
    jc, tc, jp, tp = setup
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, size=(2, 9))
    tl, tcache = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    jl, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    jfull, tfull = _grow(tcache, jcache, jc, tc, 2, 16)
    tok = np.array([[3], [7]])
    for pos in (np.array([9, 4]), np.array([10, 5])):
        jl, jfull = jmodel.decode_step(jp, jnp.asarray(tok, jnp.int32), jfull,
                                       jnp.asarray(pos, jnp.int32), jc)
        tl, tfull = tmodel.decode_step(tp, torch.from_numpy(tok), tfull, torch.from_numpy(pos), tc)
        close(tl, jl)
        tok = np.array(jnp.argmax(jl[:, :jc.vocab_size], -1))[:, None]
    for seg in tfull:
        close(tfull[seg]["c"], jfull[seg]["c"])


def test_latent_cache_spec_and_graft(setup):
    jc, tc, _, _ = setup
    jspec, tspec = jmodel.cache_spec(jc, 3, 40), tmodel.cache_spec(tc, 3, 40)
    assert sorted(tspec) == sorted(jspec) == ["dense0", "moe"]
    for seg in tspec:
        assert sorted(tspec[seg]) == ["c"]
        assert tuple(tspec[seg]["c"].shape) == jspec[seg]["c"].shape == (
            1 if seg == "dense0" else tc.n_layers - 1, 3, 40, tc.kv_lora_rank + tc.qk_rope_dim)
    assert find_batch_axes(tc, 40) == {"dense0": {"c": 1}, "moe": {"c": 1}}
    state = SlotBatchState(tc, 3, 16, device="cpu")
    for leaf in tmodel.tree_leaves(state.tree):
        leaf.fill_(7.0)
    pre = tmodel.init_cache(tc, 1, 5, device="cpu")
    for leaf in tmodel.tree_leaves(pre):
        leaf.fill_(1.0)
    state.graft(pre, 1)
    c = state.tree["moe"]["c"]
    assert bool((c[:, 1, :5] == 1).all()) and bool((c[:, 1, 5:] == 0).all())
    assert bool((c[:, 0] == 7).all()) and bool((c[:, 2] == 7).all())


# --- serving ------------------------------------------------------------------------------
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


def _prompts(vocab, n=5, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 12))).tolist() for _ in range(n)]


@pytest.mark.parametrize("impls", ["reference", "auto"])
def test_continuous_engine_streams_equal_jax(setup, impls):
    """Temperature-0 streams of the port's engine equal JAX's reference
    engine, uninterrupted and through a drain and a resume by re-prefill."""
    jc, _, jp, tp = setup
    _, tc = configs(ARCH, impls)
    prompts = _prompts(tc.vocab_size)
    want = _serve(JaxContinuousEngine(jc, jp, n_slots=3, max_seq=40), prompts, 7, JaxGenRequest)
    got = _serve(ContinuousEngine(tc, tp, n_slots=3, max_seq=40, device="cpu"),
                 prompts, 7, GenRequest)
    assert got == want
    resumed = _serve(ContinuousEngine(tc, tp, n_slots=3, max_seq=40, device="cpu"),
                     prompts, 7, GenRequest, drain_after=3)
    assert resumed == want


def test_paged_layout_refuses_mla_as_jax_does(setup):
    jc, tc, jp, tp = setup
    assert not paged_compatible(tc)
    with pytest.raises(ValueError) as want:
        JaxPagedContinuousEngine(jc, jp, n_slots=2, max_seq=32)
    for make in (lambda: PagedContinuousEngine(tc, tp, n_slots=2, max_seq=32, device="cpu"),
                 lambda: PagedContinuousEngine(tc, tp, n_slots=2, max_seq=32, attn="kernel",
                                               device="cpu"),
                 lambda: PagedKVCache(tc, n_blocks=4, block_size=4, device="cpu")):
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(want.value)


@dataclasses.dataclass
class Req:
    id: int
    fn: str


def test_batched_serving_executor_hosts_deepseek_like_jax(setup):
    """The ``batched-serving`` executor, with nothing arch-specific: the
    port's streams equal ``repro``'s executor's, stream for stream, also
    for a request drained mid-decode and resubmitted; ``kv_layout="paged"``
    refuses MLA with ``repro``'s error."""
    from repro.platform import executors as jex
    from repro_torch.platform import executors as tex

    jc, tc, jp, tp = setup
    jx = jex.build_batched_serving(
        None, engine=JaxContinuousEngine(jc, jp, n_slots=3, max_seq=48), prompt_len=10, n_new=6)
    te = ContinuousEngine(tc, tp, n_slots=3, max_seq=48, device="cpu")
    tx = tex.build_batched_serving(None, engine=te, prompt_len=10, n_new=6)
    for batch in ([Req(0, "svc-1"), Req(1, "svc-2")],
                  [Req(2, "other-1"), Req(3, "svc-3"), Req(4, "third"), Req(5, "svc-4")]):
        tx.run_batch(batch)
        jx.run_batch(batch)
        assert tx.last_results == jx.last_results
        assert all(len(t) == 6 for t in tx.last_results.values())
    # drained after 4 tokens (parked whole: 4 is the resume bucket), resumed
    te.add(GenRequest(id=9, prompt=tex.prompt_for_fn("fn-a", tc.vocab_size, 10), max_new=6))
    for _ in range(3):
        te.step()
    assert tx.drain() == 1
    tx.run_batch([Req(9, "fn-a")])
    jx.run_batch([Req(9, "fn-a")])
    assert tx.last_results == jx.last_results
    with pytest.raises(ValueError) as want:
        jex.build_batched_serving(None, arch=ARCH, kv_layout="paged", max_seq=32)
    with pytest.raises(ValueError) as got:
        tex.build_batched_serving(None, arch=ARCH, kv_layout="paged", max_seq=32, device="cpu")
    assert str(got.value) == str(want.value)


def test_serve_cli_serves_deepseek_smoke_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--requests", "3", "--prompt-len", "8", "--new-tokens", "4", "--batch-slots", "2"],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "served 3 requests, 12 tokens" in r.stdout and "deepseek-v2-lite-16b-smoke" in r.stdout

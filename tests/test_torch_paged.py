"""The port's paged-KV serving path against ``repro``'s, on the CPU.

Plain paged attention against the Pallas kernel (interpret mode) and
``repro.kernels.ref``; ``paged_gqa_decode`` and ``paged_decode_step``
against their JAX twins on the same parameters, pools and write slots; the
copied ``BlockAllocator`` against ``repro``'s on the same scripts; the
torch ``PagedKVCache``; and ``PagedContinuousEngine`` token streams at
float32 and temperature 0 against the port's dense engine and JAX's paged
engine, through prefix fork with copy-on-write, drain and parked resume,
and pool exhaustion. Inputs come from numpy with a seed; tolerances are
5e-5/5e-4 at float32 and 5e-2 at bfloat16, as in ``tests/test_kernels.py``.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BF16_TOL, F32_TOL, close, configs, params
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving import kvcache as jkv
from repro.serving.batching import GenRequest as JaxGenRequest
from repro.serving.engine import PagedContinuousEngine as JaxPagedEngine
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, PagedContinuousEngine

pytestmark = pytest.mark.slow

DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


# --- plain paged attention ------------------------------------------------------
def _paged_case(b, h, kv, d, bs, maxb, lens, seed=0):
    """numpy pool + distinct non-null block tables + ragged lengths (block 0
    plays the null block and is never referenced)."""
    rng = np.random.default_rng(seed)
    nb = b * maxb + 1
    k_pool = rng.standard_normal((nb, bs, kv, d), dtype=np.float32)
    v_pool = rng.standard_normal((nb, bs, kv, d), dtype=np.float32)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    tables = (rng.permutation(nb - 1)[:b * maxb] + 1).reshape(b, maxb).astype(np.int32)
    return q, k_pool, v_pool, tables, np.asarray(lens, np.int32)


PAGED_CASES = [
    (4, 4, 1, 16, 16, 4, [1, 16, 17, 64]),   # qwen-smoke GQA; block edges
    (2, 4, 4, 32, 8, 3, [5, 24]),            # MHA; full table
    (3, 8, 2, 64, 16, 2, [2, 31, 32]),       # GQA group 4
    (2, 6, 3, 32, 4, 5, [3, 13]),            # odd heads, tiny blocks
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,d,bs,maxb,lens", PAGED_CASES)
def test_paged_plain_matches_pallas_and_ref(b, h, kv, d, bs, maxb, lens, dtype):
    jd, td, tol = DTYPES[dtype]
    q, k_pool, v_pool, tables, lens = _paged_case(b, h, kv, d, bs, maxb, lens)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k_pool, v_pool))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k_pool, v_pool))
    out = ref.paged_attention_ref(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens))
    assert out.dtype == td and out.shape == (b, h, d)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    close(_f32(out), _f32(pallas_paged(jq, jk, jv, jt, jl, interpret=True)), tol)
    close(_f32(out), _f32(jref.paged_attention_ref(jq, jk, jv, jt, jl)), tol)


def test_paged_op_on_cpu_takes_plain_path():
    """CPU tensors take the plain version, with int64 numpy or torch index
    arrays, and count no launch; null rows (all-padding tables, length 1)
    stay finite, as ``test_paged_attention_null_rows_finite`` pins in JAX."""
    q, k_pool, v_pool, tables, lens = _paged_case(*PAGED_CASES[0])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k_pool, v_pool))
    want = ref.paged_attention_ref(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens))
    before = ops.launch_counts()["paged_attention"]
    for t, n in ((tables.astype(np.int64), lens.astype(np.int64)),
                 (torch.from_numpy(tables).long(), torch.from_numpy(lens).long())):
        close(ops.paged_attention_op(tq, tk, tv, t, n), want)
    assert ops.launch_counts()["paged_attention"] == before
    null = ops.paged_attention_op(tq, tk, tv, np.zeros_like(tables), np.ones_like(lens))
    assert bool(torch.isfinite(null).all())
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        x = torch.empty(2, 4, 16, device="meta")
        ops.paged_attention_op(x, x[None], x[None], tables[:2], lens[:2])


# --- model: paged decode -----------------------------------------------------------
def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _pools(cfg, nb, bs, layers=None, seed=1):
    rng = np.random.default_rng(seed)
    shape = ((layers,) if layers else ()) + (nb, bs, cfg.n_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def test_paged_gqa_decode_matches_jax():
    jc, tc = configs("qwen2.5-3b")
    jp, tp = params(jc, tc)
    ja, ta = _layer0(jp["stack"]["dense"]["attn"]), _layer0(tp["stack"]["dense"]["attn"])
    kp, vp = _pools(tc, nb=9, bs=4)
    x = np.random.default_rng(2).standard_normal((3, 1, 64), dtype=np.float32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos, bids, offs = np.array([9, 6, 0]), np.array([3, 5, 0]), np.array([1, 2, 0])
    jout, jk, jv = jattn.paged_gqa_decode(
        ja, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(pos, jnp.int32), jnp.asarray(bids, jnp.int32),
        jnp.asarray(offs, jnp.int32), jc, interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout, tk2, tv2 = tattn.paged_gqa_decode(
        ta, torch.from_numpy(x), tk, tv, torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(bids), torch.from_numpy(offs), tc)
    assert tk2 is tk and tv2 is tv  # updated in place
    close(tout, jout)
    close(tk, jk)
    close(tv, jv)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internlm2-1.8b"])
def test_paged_decode_step_matches_jax(arch):
    """Two waves at per-row positions through both twins on the same pools;
    logits and both pools agree, the teacher-forced token from JAX."""
    jc, tc = configs(arch, "auto")
    jp, tp = params(jc, tc)
    kp, vp = _pools(tc, nb=9, bs=4, layers=tc.n_layers)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tables = np.array([[1, 2, 3, 6], [4, 5, 7, 0]], np.int32)
    tok = np.array([[3], [7]])
    for pos, bids, offs in ((np.array([9, 7]), np.array([3, 5]), np.array([1, 3])),
                            (np.array([10, 8]), np.array([3, 7]), np.array([2, 0]))):
        jl, jk, jv = jmodel.paged_decode_step(
            jp, jnp.asarray(tok, jnp.int32), jk, jv, jnp.asarray(tables),
            jnp.asarray(pos, jnp.int32), jnp.asarray(bids, jnp.int32),
            jnp.asarray(offs, jnp.int32), jc, interpret=True)
        tl, tk2, tv2 = tmodel.paged_decode_step(tp, torch.from_numpy(tok), tk, tv,
                                                tables, pos, bids, offs, tc)
        assert tk2 is tk and tv2 is tv
        close(tl, jl)
        tok = np.array(jnp.argmax(jl[:, :jc.vocab_size], -1))[:, None]
    close(tk, jk)
    close(tv, jv)


# --- BlockAllocator: the copy against repro's --------------------------------------
def _roundtrip(a):
    a.create("s")
    ids = [a.append_pos("s") for _ in range(5)]
    assert [off for _, off, _ in ids] == [0, 1, 0, 1, 0]
    assert all(c is None for _, _, c in ids)
    assert a.blocks_in_use == 3 and a.lengths["s"] == 5
    a.check()
    a.free("s")
    assert a.blocks_in_use == 0 and a.high_water == 3


def _fork_cow(a):
    a.create("src")
    for _ in range(6):                      # 1.5 blocks
        a.append_pos("src")
    a.fork("src", "dst")                    # share both blocks
    assert a.blocks_in_use == 2 and a.refcount[a.tables["src"][0]] == 2
    a.check()
    bid, off, cow = a.append_pos("dst")     # tail block shared -> COW
    assert cow == a.tables["src"][1] and off == 2 and bid != cow
    assert a.cow_copies == 1 and a.blocks_in_use == 3
    _, _, cow2 = a.append_pos("dst")        # tail now private
    assert cow2 is None
    a.free("src")
    assert a.blocks_in_use == 2             # dst keeps its copies
    a.free("dst")


def _fork_trim(a):
    a.create("src")
    for _ in range(6):
        a.append_pos("src")
    a.fork("src", "d1", n_tokens=3)         # 2 blocks referenced
    assert len(a.tables["d1"]) == 2 and a.lengths["d1"] == 3
    a.trim("d1", 1)                         # drops the second block
    assert len(a.tables["d1"]) == 1 and a.lengths["d1"] == 1
    a.check()
    a.trim("d1", 0)
    assert a.tables["d1"] == []
    a.free("d1")
    a.free("src")


def _exhaustion(a, out_of_blocks):
    a.create("s")
    a.append_pos("s")
    a.append_pos("s")
    with pytest.raises(out_of_blocks):
        a.append_pos("s")
    a.check()
    assert a.lengths["s"] == 2              # failed append reserved nothing
    a.free("s")


def _double_free(a):
    a.create("s")
    bid, _, _ = a.append_pos("s")
    a.free("s")
    with pytest.raises(AssertionError, match="double free"):
        a.decref(bid)


ALLOC_SCRIPTS = {  # name -> (n_blocks, block_size, script)
    "roundtrip": (4, 2, lambda a, mod: _roundtrip(a)),
    "fork_cow": (8, 4, lambda a, mod: _fork_cow(a)),
    "fork_trim": (8, 2, lambda a, mod: _fork_trim(a)),
    "exhaustion": (2, 1, lambda a, mod: _exhaustion(a, mod.OutOfBlocks)),
    "double_free": (2, 1, lambda a, mod: _double_free(a)),
}


@pytest.mark.parametrize("name", list(ALLOC_SCRIPTS))
def test_block_allocator_copy_matches_repro(name):
    """The host invariants of ``tests/test_kvcache.py`` on the copy, and the
    copy ends in the same state as ``repro``'s allocator on the same script."""
    n_blocks, block_size, script = ALLOC_SCRIPTS[name]
    states = []
    for mod in (tkv, jkv):
        a = mod.BlockAllocator(n_blocks, block_size)
        script(a, mod)
        a.check()
        assert a.blocks_in_use == 0
        states.append((a.refcount.tolist(), a.free_list, a.tables, a.lengths,
                       a.high_water, a.cow_copies))
    assert states[0] == states[1]
    assert tkv.BlockAllocator is not jkv.BlockAllocator
    assert not issubclass(tkv.OutOfBlocks, jkv.OutOfBlocks)
    with pytest.raises(ValueError, match="must both be >= 1"):
        tkv.BlockAllocator(0, 4)


def test_paged_compatible_matches_repro():
    for arch, window in (("qwen2.5-3b", None), ("internlm2-1.8b", None),
                         ("qwen2.5-3b", 8)):
        jc, tc = configs(arch, sliding_window=window)
        assert tkv.paged_compatible(tc) == jkv.paged_compatible(jc) == (window is None)


# --- PagedKVCache ---------------------------------------------------------------
def test_pool_gather_equals_dense_slice():
    """write_prefill + per-token writes land where the block table says:
    gathering a sequence back out reproduces the dense K/V exactly; a write
    into a forked sequence's shared tail copies the block first."""
    _, tc = configs("qwen2.5-3b")
    kv = tkv.PagedKVCache(tc, n_blocks=8, block_size=4, device="cpu")
    s, extra = 6, 3
    rng = np.random.default_rng(1)
    shape = (tc.n_layers, s + extra, tc.n_kv_heads, tc.head_dim)
    k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    kv.create("s")
    kv.write_prefill("s", k[:, :s], v[:, :s])
    kv.fork("s", "f")                        # shares blocks 0..1 (6 tokens)
    for t in range(extra):                   # decode-style appends
        bid, off = kv.append("s")
        kv.write_tokens(np.array([bid]), np.array([off]), k[:, None, s + t], v[:, None, s + t])
    tables = kv.table_array(["s", "f"], width=4)
    gk, gv = kv.gather_dense(tables, s_max=s + extra)
    assert torch.equal(gk[:, 0], k) and torch.equal(gv[:, 0], v)
    assert torch.equal(gk[:, 1, :s], k[:, :s])   # the fork still sees the old tail
    assert kv.alloc.cow_copies == 1 and kv.stats()["cow_copies"] == 1
    kv.check()
    jkvc = jkv.PagedKVCache(configs("qwen2.5-3b")[0], n_blocks=8, block_size=4)
    assert kv.block_bytes == jkvc.block_bytes and kv.pool_bytes == jkvc.pool_bytes
    assert set(kv.stats()) == set(jkvc.stats())
    with pytest.raises(ValueError, match="paged KV layout"):
        tkv.PagedKVCache(configs("qwen2.5-3b", sliding_window=8)[1], 4, 4, device="cpu")


# --- engine --------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    jc, tc = configs("qwen2.5-3b")
    jp, tp = params(jc, tc)
    return jc, tc, jp, tp


def _requests(cls, n, prompt_len=10, max_new=8, prefix=()):
    out = []
    for i in range(n):
        body = [int(t) for t in np.random.default_rng(i).integers(1, 100, prompt_len)]
        out.append(cls(id=i, prompt=list(prefix) + body, max_new=max_new))
    return out


def _outputs(eng, reqs):
    for r in reqs:
        eng.add(r)
    done = {r.id: list(r.generated) for r in eng.run()}
    done.update({r.id: list(r.generated) for r in eng.batcher.finished})
    return done


def _both(setup, n_reqs, engine_kw=None, **req_kw):
    """(port paged outputs, JAX paged outputs, port engine, JAX engine)."""
    jc, tc, jp, tp = setup
    kw = dict(n_slots=3, max_seq=64, block_size=16, **(engine_kw or {}))
    port = PagedContinuousEngine(tc, tp, device="cpu", **kw)
    jax_eng = JaxPagedEngine(jc, jp, **kw)
    return (_outputs(port, _requests(GenRequest, n_reqs, **req_kw)),
            _outputs(jax_eng, _requests(JaxGenRequest, n_reqs, **req_kw)), port, jax_eng)


def test_gather_engine_matches_dense_and_jax(setup):
    """The gather path is token-identical to the port's dense engine and to
    JAX's paged engine, and a finished pool keeps only the null block."""
    _, tc, _, tp = setup
    out_p, out_j, port, jax_eng = _both(setup, 5)
    assert out_p == out_j
    dense = ContinuousEngine(tc, tp, n_slots=3, max_seq=64, device="cpu")
    assert out_p == _outputs(dense, _requests(GenRequest, 5))
    port.kv.check()
    assert port.kv_stats() == jax_eng.kv_stats()
    assert port.kv_stats()["blocks_in_use"] == 1
    assert set(port.kv_stats()) == set(jax_eng.kv_stats()) == set(dense.kv_stats())
    with pytest.raises(AttributeError, match="block pool"):
        port.cache
    assert port.device_state[0] is port.kv.k_pool
    assert not dense.register_prefix([1, 2, 3])


def test_prefix_sharing_matches_jax(setup):
    """Requests sharing a registered tenant prefix fork its blocks: the same
    tokens as JAX (and as the dense engine), the same share hits, shared
    tokens and copy-on-write copies (12 % 16 != 0: shared tail block)."""
    jc, tc, jp, tp = setup
    prefix = [int(t) for t in np.random.default_rng(99).integers(1, 100, 12)]
    kw = dict(n_slots=3, max_seq=64, block_size=16)
    port = PagedContinuousEngine(tc, tp, device="cpu", **kw)
    jax_eng = JaxPagedEngine(jc, jp, **kw)
    assert port.register_prefix(prefix) and port.register_prefix(prefix)
    assert jax_eng.register_prefix(prefix)
    out_p = _outputs(port, _requests(GenRequest, 4, prompt_len=6, prefix=prefix))
    out_j = _outputs(jax_eng, _requests(JaxGenRequest, 4, prompt_len=6, prefix=prefix))
    assert out_p == out_j
    dense = ContinuousEngine(tc, tp, n_slots=3, max_seq=64, device="cpu")
    assert out_p == _outputs(dense, _requests(GenRequest, 4, prompt_len=6, prefix=prefix))
    st, jst = port.kv_stats(), jax_eng.kv_stats()
    for key in ("share_hits", "shared_tokens", "cow_copies", "prefill_tokens",
                "blocks_in_use", "blocks_high_water"):
        assert st[key] == jst[key], key
    assert st["share_hits"] == 4 and st["shared_tokens"] == 4 * 12 and st["cow_copies"] >= 4
    port.kv.check()


def test_drain_resume_bit_identical(setup):
    """drain() pins each request's blocks; re-adding re-references them (no
    re-prefill) and the streams equal an uninterrupted run."""
    _, tc, _, tp = setup
    full = _outputs(PagedContinuousEngine(tc, tp, n_slots=3, max_seq=64, device="cpu"),
                    _requests(GenRequest, 5))
    eng = PagedContinuousEngine(tc, tp, n_slots=3, max_seq=64, device="cpu")
    for r in _requests(GenRequest, 5):
        eng.add(r)
    for _ in range(3):
        eng.step()
    parked = eng.drain()
    assert parked and eng.resume_hits == 0 and not eng.batcher.active()
    prefill_before = eng.prefill_tokens
    for r in parked:
        eng.add(r)
    out = {r.id: list(r.generated) for r in eng.run()}
    out.update({r.id: list(r.generated) for r in eng.batcher.finished})
    assert eng.resume_hits >= 1 and eng.kv_stats()["resumed_tokens"] > 0
    assert out == full
    assert eng.prefill_tokens - prefill_before < sum(len(r.prompt) for r in parked)
    eng.kv.check()
    assert eng.kv_stats()["blocks_in_use"] == 1


def test_pool_exhaustion_queues_and_completes(setup):
    """A pool far smaller than n_slots x max_seq still completes every
    request (admission requeue + decode-wave preemption) like JAX's engine,
    with full output lengths and no leaked blocks."""
    out_p, out_j, port, jax_eng = _both(setup, 5, engine_kw=dict(n_blocks=5))
    assert set(out_p) == set(out_j) == set(range(5))
    assert all(len(v) == 8 for v in out_p.values())
    assert out_p == out_j
    st = port.kv_stats()
    assert st["blocks_high_water"] <= 5 and st["mem_preempts"] == jax_eng.kv_stats()["mem_preempts"]
    port.kv.check()
    assert st["blocks_in_use"] == 1


def test_kernel_engine_agrees_with_jax_kernel_and_own_gather(setup):
    """attn="kernel" on the CPU runs the plain paged attention: it agrees
    with JAX's kernel-path engine (Pallas in interpret mode) on at least
    0.75 of the tokens, as ``tests/test_kvcache.py`` asks of JAX's own two
    paths, and equals the port's gather path."""
    jc, tc, jp, tp = setup
    kw = dict(n_slots=2, max_seq=64, block_size=16, attn="kernel")
    port = _outputs(PagedContinuousEngine(tc, tp, device="cpu", **kw),
                    _requests(GenRequest, 3, max_new=4))
    ref_ = _outputs(JaxPagedEngine(jc, jp, **kw), _requests(JaxGenRequest, 3, max_new=4))
    gather = _outputs(PagedContinuousEngine(tc, tp, device="cpu", **dict(kw, attn="gather")),
                      _requests(GenRequest, 3, max_new=4))
    assert set(port) == set(ref_) == set(gather)
    flat = [a == b for k in ref_ for a, b in zip(ref_[k], port[k])]
    assert sum(flat) / len(flat) >= 0.75, (port, ref_)
    assert port == gather


def test_paged_engine_rejects_what_it_cannot_serve(setup):
    _, tc, _, tp = setup
    with pytest.raises(ValueError, match="unknown attn"):
        PagedContinuousEngine(tc, tp, attn="flash", device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        PagedContinuousEngine(tc, tp, max_seq=40, block_size=16, device="cpu")
    _, swa = configs("qwen2.5-3b", sliding_window=8)
    with pytest.raises(ValueError, match="paged KV layout"):
        PagedContinuousEngine(swa, tp, device="cpu")

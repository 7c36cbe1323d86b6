"""The port's chunked attention and sharded-activation paths against
``repro``'s at float32 on the smoke configs: ``chunked_mha`` itself (causal,
sliding window, not causal, S a multiple of neither chunk), and
``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` under
``attn_impl="chunked"``, ``shard_activations=True`` and, for the MoE archs,
``moe_dispatch_constraints=True``, within 5e-5/5e-4; and the cleaned
activation constraints of every ``maybe_shard`` site against the specs
``repro`` hands ``jax.lax.with_sharding_constraint`` under an ambient mesh
of data 16 x model 16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, configs, params
from repro.distributed import sharding as jsharding
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.distributed import sharding as tsharding
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel

pytestmark = pytest.mark.slow


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("causal,window,s,cq,ck", [
    (True, None, 48, 16, 8),      # causal, S a multiple of both chunks
    (True, 7, 48, 16, 8),         # sliding window
    (False, None, 48, 16, 8),     # not causal (encoder)
    (True, None, 37, 16, 12),     # S a multiple of neither chunk: padded, masked
])
def test_chunked_mha_matches_jax(causal, window, s, cq, ck):
    jc, tc = configs("qwen2.5-3b", encoder_only=not causal, sliding_window=window)
    q, k, v = (_x(2, s, 4, 16, seed=i) for i in range(3))
    want = jattn.chunked_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                             chunk_q=cq, chunk_k=ck)
    got = tattn.chunked_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tc,
                            chunk_q=cq, chunk_k=ck)
    assert tuple(got.shape) == (2, s, 4 * 16)
    close(got, want)
    # the chunked core equals the materialised einsum core of the port too
    pos = torch.arange(s).expand(2, s)
    close(got, tattn._mha_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               pos, tc))


MODES = {"chunked": dict(attn_impl="chunked"),
         "sharded": dict(shard_activations=True),
         "sharded_moe_dispatch": dict(shard_activations=True, moe_dispatch_constraints=True)}
# chunked: GQA (qkv bias), sliding window, the encoder (MLA has no chunked
# path, in repro as here); sharded: the dense and gelu/LayerNorm sites, and
# both MoE archs (MLA's sites with deepseek) with the dispatch constraints on
CASES = [(a, "chunked") for a in ("qwen2.5-3b", "mixtral-8x22b", "hubert-xlarge")]
CASES += [(a, "sharded") for a in ("qwen2.5-3b", "hubert-xlarge")]
CASES += [(a, "sharded_moe_dispatch") for a in ("mixtral-8x22b", "deepseek-v2-lite-16b")]


@functools.lru_cache(maxsize=None)
def _params(arch):
    """One arch's parameters on both sides; the modes change no leaf."""
    return params(*configs(arch))


def _batch(cfg, s=19, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        out = {"frames": rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, s))}
    out["labels"] = rng.integers(0, cfg.vocab_size, size=(2, s))
    return out


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,mode", CASES)
def test_model_paths_match_jax(arch, mode):
    jc, tc = configs(arch, **MODES[mode])
    jp, tp = _params(arch)
    batch = _batch(tc)
    jl, jaux = jmodel.forward(jp, _jax(batch), jc)
    tl, taux = tmodel.forward(tp, _torch(batch), tc)
    close(tl, jl)
    close(taux["lb_loss"], jaux["lb_loss"])
    jloss, _ = jmodel.loss_fn(jp, _jax(batch), jc)
    tloss, _ = tmodel.loss_fn(tp, _torch(batch), tc)
    close(tloss, jloss)
    if tc.encoder_only:
        return
    prompt = {"tokens": batch["tokens"]}
    jl, jcache = jmodel.prefill(jp, _jax(prompt), jc)
    tl, tcache = tmodel.prefill(tp, _torch(prompt), tc)
    close(tl, jl)
    # decode from an empty cache: a scalar position, then per-row positions
    jcache, tcache = jmodel.init_cache(jc, 2, 16), tmodel.init_cache(tc, 2, 16, device="cpu")
    for i, pos in enumerate((0, np.array([1, 5]))):
        tok = np.array([[3 + i], [7 + i]])
        jl, jcache = jmodel.decode_step(jp, jnp.asarray(tok, jnp.int32), jcache,
                                        jnp.asarray(pos, jnp.int32), jc)
        tl, tcache = tmodel.decode_step(tp, torch.from_numpy(tok), tcache,
                                        torch.as_tensor(pos) if i else pos, tc)
        close(tl, jl)


def test_decode_takes_a_0d_tensor_position_without_reading_it():
    """A 0-d tensor position (the dry run's, on ``meta``) gives what the
    same int gives, and a ring's slot wraps as ``repro``'s does."""
    for arch in ("qwen2.5-3b", "mixtral-8x22b", "deepseek-v2-lite-16b"):
        jc, tc = configs(arch)
        _, tp = _params(arch)
        caches = [tmodel.init_cache(tc, 2, 32, device="cpu") for _ in range(2)]
        for pos in (0, 1, 20, 21):
            tok = torch.tensor([[3], [5]])
            a, caches[0] = tmodel.decode_step(tp, tok, caches[0], pos, tc)
            b, caches[1] = tmodel.decode_step(tp, tok, caches[1], torch.tensor(pos), tc)
            close(b, a, dict(atol=0, rtol=0))
        for x, y in zip(tmodel.tree_leaves(caches[0]), tmodel.tree_leaves(caches[1])):
            assert torch.equal(x, y)


# --- the sharded activations' specs ---------------------------------------------------------
SIZES = {"data": 16, "model": 16}


def _canon(spec):
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a for a in spec)


def _jax_specs(monkeypatch, fn):
    """(shape, spec) of every constraint ``repro``'s model code applies
    while ``fn`` runs under an ambient mesh of SIZES."""
    seen = []
    monkeypatch.setattr(jsharding, "ambient_mesh_sizes", lambda: dict(SIZES))

    def capture(x, spec):
        seen.append((tuple(x.shape), _canon(spec)))
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    fn()
    monkeypatch.undo()
    return seen


def _torch_specs(monkeypatch, fn):
    seen = []
    real = tsharding.shard_spec

    def capture(shape, *axes, sizes):
        spec = real(shape, *axes, sizes=sizes)
        seen.append((tuple(shape), _canon(spec)))
        return spec
    monkeypatch.setattr(tsharding, "shard_spec", capture)
    with tsharding.AbstractMesh(tuple(SIZES.values()), tuple(SIZES)):
        fn()
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x22b", "deepseek-v2-lite-16b"])
def test_maybe_shard_specs_match_jax(arch, monkeypatch):
    """Every site with repro's cleaned spec: axes the mesh lacks ("pod") or
    larger than the dimension are dropped. JAX traces a scanned layer once
    and the port runs every layer, so the sites compare as sets of (shape,
    spec), each layer's the same."""
    jc, tc = configs(arch, shard_activations=True)
    jp, tp = _params(arch)
    batch = _batch(tc, s=20)

    def run_jax():
        jmodel.loss_fn(jp, _jax(batch), jc)
        jmodel.decode_step(jp, jnp.ones((2, 1), jnp.int32), jmodel.init_cache(jc, 2, 16),
                           jnp.asarray(3, jnp.int32), jc)

    def run_torch():
        tmodel.loss_fn(tp, _torch(batch), tc)
        tmodel.decode_step(tp, torch.ones((2, 1), dtype=torch.int64),
                           tmodel.init_cache(tc, 2, 16, device="cpu"), 3, tc)
    want, got = _jax_specs(monkeypatch, run_jax), _torch_specs(monkeypatch, run_torch)
    assert len(got) > len(want) >= 8
    assert set(got) == set(want)
    # a dimension smaller than its axis is left unsharded, a tuple kept whole
    assert tsharding.shard_spec((8, 32), ("pod", "data"), "model", sizes=SIZES) == (None, "model")
    assert tsharding.shard_spec((32, 4), ("pod", "data"), None, sizes={"pod": 2, "data": 16}) \
        == (("pod", "data"), None)


def test_maybe_shard_is_the_identity_and_refuses_a_mesh_over_several_devices():
    x = torch.ones(4, 8)
    assert tsharding.maybe_shard(x, "data", "model") is x
    assert tsharding.ambient_mesh_sizes() is None
    with tsharding.Mesh([torch.device("cpu")], ("model",)):
        assert tsharding.maybe_shard(x, "data", "model") is x
        with tsharding.AbstractMesh((2, 4), ("data", "model")) as inner:
            assert tsharding.ambient_mesh_sizes() == {"data": 2, "model": 4}
            assert tsharding.ambient_mesh() is inner
        assert tsharding.ambient_mesh_sizes() == {"model": 1}
    assert tsharding.ambient_mesh() is None
    two = tsharding.Mesh([torch.device("cpu"), torch.device("meta")], ("model",))
    with two, pytest.raises(NotImplementedError, match="distinct devices"):
        tsharding.maybe_shard(x, None, "model")
    assert tsharding.ambient_mesh() is None

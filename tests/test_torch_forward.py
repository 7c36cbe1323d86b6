"""The port's full-sequence path against ``repro``'s at float32 on the
smoke configs of all ten archs: ``forward`` (logits and the MoE
load-balance loss), ``loss_fn`` and ``ServingEngine.score`` on the same
parameters and the same numpy batch (tokens, hubert's audio frames,
internvl2's vision patches), within 5e-5/5e-4; LayerNorm and the gelu MLP;
``make_batch``; and which norm form each norm of a forward takes under
``auto``. Under ``auto`` the JAX side runs its Pallas kernels in interpret
mode and the port its plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, configs, params
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import ARCH_IDS, get_config, with_kernel_impls
from repro_torch.kernels import ops as kops
from repro_torch.models import frontends
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.serving.engine import ServingEngine

pytestmark = pytest.mark.slow

S = 24  # sequence length of every batch (vision: frontend_seq patches + text)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _batch(cfg, seed=0, b=2, s=S):
    """The family's batch as numpy: tokens and labels, audio frames, or
    vision patches followed by text."""
    rng = np.random.default_rng(seed)
    out = {}
    n = s
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    else:
        if cfg.frontend == "vision":
            out["vision_embeds"] = rng.standard_normal((b, cfg.frontend_seq, cfg.d_model),
                                                       dtype=np.float32)
            n = s - cfg.frontend_seq
        out["tokens"] = rng.integers(0, cfg.vocab_size, size=(b, n))
    out["labels"] = rng.integers(0, cfg.vocab_size, size=(b, n))
    return out


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_the_port_has_repros_ten_archs():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("impls", ["reference", "auto"])
@pytest.mark.parametrize("arch", sorted(JAX_ARCH_IDS))
def test_forward_and_loss_match_jax(arch, impls):
    jc, tc = configs(arch, impls)
    jp, tp = params(jc, tc)
    batch = _batch(tc, seed=1)
    jl, jaux = jmodel.forward(jp, _jax(batch), jc)
    tl, taux = tmodel.forward(tp, _torch(batch), tc)
    n_text = batch["labels"].shape[1]
    assert tuple(tl.shape) == jl.shape == (2, n_text, tc.vocab_padded)
    close(tl, jl)
    close(taux["lb_loss"], jaux["lb_loss"])
    assert (float(taux["lb_loss"]) > 0) == (tc.n_experts > 0)
    jloss, jm = jmodel.loss_fn(jp, _jax(batch), jc)
    tloss, tm = tmodel.loss_fn(tp, _torch(batch), tc)
    close(tloss, jloss)
    for key in ("ce", "lb_loss", "loss"):
        close(tm[key], jm[key])
    close(tmodel.loss_fn(tp, _torch(batch), tc, lb_coef=0.5)[0],
          jmodel.loss_fn(jp, _jax(batch), jc, lb_coef=0.5)[0])


@pytest.mark.parametrize("arch", sorted(JAX_ARCH_IDS))
def test_score_matches_jax(arch):
    """``ServingEngine.score``: the mean NLL of a token batch. The encoder
    (hubert) is refused at construction, and the vision arch's score
    (tokens only, no patches) fails in ``_embed_inputs``, on both sides."""
    jc, tc = configs(arch, "auto")
    jp, tp = params(jc, tc)
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, size=(2, 17))
    if not tc.is_autoregressive:
        with pytest.raises(ValueError, match="encoder-only"):
            JaxServingEngine(jc, jp)
        with pytest.raises(ValueError, match="encoder-only"):
            ServingEngine(tc, tp, device="cpu")
        return
    jeng, teng = JaxServingEngine(jc, jp, max_seq=32), ServingEngine(tc, tp, max_seq=32,
                                                                     device="cpu")
    if tc.frontend == "vision":
        with pytest.raises(KeyError, match="vision_embeds"):
            jeng.score(toks)
        with pytest.raises(KeyError, match="vision_embeds"):
            teng.score(toks)
        return
    got, want = teng.score(toks), jeng.score(toks)
    assert isinstance(got, float)
    close(got, want)


@pytest.mark.parametrize("arch", ["internvl2-26b", "qwen2.5-3b"])
def test_prefill_takes_the_frontend_batch(arch):
    """``prefill`` goes through ``_embed_inputs`` as ``repro``'s does: the
    vision patches ahead of the text; its last logits equal the forward's."""
    jc, tc = configs(arch)
    jp, tp = params(jc, tc)
    batch = _batch(tc, seed=3)
    batch.pop("labels")
    jl, _ = jmodel.prefill(jp, _jax(batch), jc)
    tl, _ = tmodel.prefill(tp, _torch(batch), tc)
    close(tl, jl)
    close(tl, tmodel.forward(tp, _torch(batch), tc)[0][:, -1])


def test_layer_norm_matches_jax():
    x, w, b = _x(3, 7, 64), _x(64, seed=1), _x(64, seed=2)
    close(tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5),
          jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    # bf16 activations: statistics in fp32, then cast, as in repro
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tlayers.layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    want = jlayers.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), 1e-5)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), dict(atol=2e-2, rtol=2e-2))


def test_gelu_mlp_matches_jax():
    jc, tc = configs("hubert-xlarge")
    jp, tp = params(jc, tc)
    assert sorted(tp["stack"]["dense"]["mlp"]) == ["w_down", "w_up"]
    assert sorted(tp["stack"]["dense"]["ln1"]) == ["b", "w"] and "embed" not in tp
    jm = {k: v[0] for k, v in jp["stack"]["dense"]["mlp"].items()}
    tm = {k: v[0] for k, v in tp["stack"]["dense"]["mlp"].items()}
    x = _x(2, 5, tc.d_model)
    close(tlayers.apply_mlp(tm, torch.from_numpy(x), tc), jlayers.apply_mlp(jm, jnp.asarray(x), jc))


@pytest.mark.parametrize("arch", sorted(JAX_ARCH_IDS))
def test_make_batch_has_the_familys_keys_and_shapes(arch):
    """The port's stub batch has ``repro``'s keys, shapes and kinds (bf16
    embeddings, integer tokens in the vocab), is the same for the same
    seed, and ``loss_fn`` takes it."""
    cfg = get_config(arch, smoke=True)
    s = 20
    batch = frontends.make_batch(torch.Generator().manual_seed(0), cfg, 3, s, device="cpu")
    want = jfrontends.make_batch(jax.random.PRNGKey(0), jax_get_config(arch, smoke=True), 3, s)
    assert sorted(batch) == sorted(want)
    for k, v in batch.items():
        assert tuple(v.shape) == want[k].shape, k
        floating = jnp.issubdtype(want[k].dtype, jnp.floating)
        assert v.dtype == (torch.bfloat16 if floating else torch.int64), k
        if not floating:
            assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
    again = frontends.make_batch(torch.Generator().manual_seed(0), cfg, 3, s, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    loss, _ = tmodel.loss_fn(tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                             batch, cfg)
    assert bool(torch.isfinite(loss))


def _norms_per_forward(cfg):
    """(plain, residual, gated) rmsnorm calls of one forward under
    ``auto``: as for a prefill, one plain call, a gated one per Mamba2
    mixer and the residual form for every other norm; gelu archs norm with
    LayerNorm, which has no kernel."""
    if cfg.act == "gelu":
        return {"plain": 0, "residual": 0, "gated": 0}
    gated = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    total = 2 * cfg.n_layers + 1 + (2 * cfg.n_attn_layers if cfg.family == "hybrid" else 0)
    return {"plain": 1, "residual": total - 1 - gated, "gated": gated}


@pytest.mark.parametrize("arch", sorted(JAX_ARCH_IDS))
def test_forward_norms_take_the_residual_form(arch, monkeypatch):
    """Under ``auto`` the forward's norms take the kernel's forms as a
    prefill's do, and the other sites their kernel ops once a layer."""
    tc = with_kernel_impls(dataclasses.replace(get_config(arch, smoke=True), dtype="float32"),
                           "auto")
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    calls = {"plain": 0, "residual": 0, "gated": 0, "flash": 0, "gmm": 0}
    for name, key in (("rmsnorm_op", "plain"), ("add_rmsnorm_op", "residual"),
                      ("gated_rmsnorm_op", "gated"), ("flash_attention_op", "flash"),
                      ("moe_gmm_capacity", "gmm"), ("moe_gmm_op", "gmm")):
        def counted(*args, _fn=getattr(kops, name), _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(kops, name, counted)
    batch = frontends.make_batch(torch.Generator().manual_seed(1), tc, 2, S, device="cpu")
    for k, v in batch.items():
        if v.is_floating_point():
            batch[k] = v.float()
    tmodel.forward(tp, batch, tc)
    want = _norms_per_forward(tc)
    want["flash"] = tc.n_attn_layers if not tc.use_mla else 0
    want["gmm"] = 3 * (tc.n_layers - tc.first_dense_layers) if tc.n_experts else 0
    assert calls == want

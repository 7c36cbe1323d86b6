"""The MLA prefill kernel's routing and plain version, on the CPU.

- ``ref.mla_prefill_attention_ref`` is the einsum core of
  ``attention._mla_full`` bit for bit at float32 (through ``wo``, against
  ``mla_attention``), with ``repro``'s defaults and with DeepSeek-V2's
  published YaRN temperature in the scale.
- ``mla_prefill`` takes the kernel op exactly where ``_mla_kernel_fits``
  says so, and then counts ``kernel`` 1 and ``score_bytes`` 0 on its span;
  ``mla_attention`` (the forward and ``loss_fn`` path) never reaches the op.
- Under grad, with parameters that require it, ``mla_prefill`` takes the
  einsum and back-propagates; the op itself refuses such inputs.
- The wrapper on the CPU is the plain version.

The kernel itself runs only on the card (``test_torch_mla_prefill_gpu.py``).
This file imports no JAX.
"""
import dataclasses

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_config, with_kernel_impls
from repro_torch.distributed.tensor_parallel import row_parallel
from repro_torch.kernels import mla_prefill as kern
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import model as M

YARN = {"rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707}}


def _cfg(**replace):
    return dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True), dtype="float32",
                               **replace)


def _layer(cfg, seed=0):
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return {k: v[0] for k, v in params["stack"]["moe"]["attn"].items()}


def _x(cfg, b, s, seed=1):
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(seed))
    return x, torch.arange(s).expand(b, s)


def _heads(p, x, positions, cfg):
    """(q_nope, q_rope, k_nope, k_rope, v) as ``_mla_full`` makes them."""
    b, s, _ = x.shape
    q_nope, q_rope = attn._mla_q(p, x, positions, cfg)
    c_kv, k_rope = attn._mla_latent(p, x, positions, cfg)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, cfg.n_heads, cfg.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, cfg.n_heads, cfg.v_head_dim)
    return q_nope, q_rope, k_nope, k_rope, v


@pytest.mark.parametrize("b,s", [(1, 1), (2, 11), (1, 37)])
@pytest.mark.parametrize("settings", [{}, YARN], ids=["defaults", "yarn"])
def test_plain_version_is_the_einsum_core_bit_for_bit(b, s, settings):
    cfg = _cfg(**settings)
    p = _layer(cfg)
    x, positions = _x(cfg, b, s)
    out = ref.mla_prefill_attention_ref(*_heads(p, x, positions, cfg),
                                        scale=attn.mla_softmax_scale(cfg))
    assert out.shape == (b, s, cfg.n_heads, cfg.v_head_dim)
    got = row_parallel(out.reshape(b, s, -1), p["wo"], None)
    assert torch.equal(got, attn.mla_attention(p, x, positions, cfg))


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    cfg = _cfg(**YARN)
    p = _layer(cfg)
    x, positions = _x(cfg, 2, 9)
    ins = _heads(p, x, positions, cfg)
    scale = attn.mla_softmax_scale(cfg)
    before = ops.launch_counts()["mla_prefill"]
    with torch.no_grad():
        got = ops.mla_prefill_attention_op(*ins, scale=scale)
    assert torch.equal(got, ref.mla_prefill_attention_ref(*ins, scale=scale))
    assert ops.launch_counts()["mla_prefill"] == before


def test_the_op_refuses_inputs_that_require_grad():
    cfg = _cfg()
    p = {k: v.requires_grad_() for k, v in _layer(cfg).items()}
    x, positions = _x(cfg, 1, 5)
    ins = _heads(p, x, positions, cfg)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.mla_prefill_attention_op(*ins, scale=1.0)


def test_fits_only_bf16_cuda_tensors_at_the_kernels_widths():
    """On the CPU nothing fits; the smoke widths would not fit on the card
    either (the engine's smoke runs there keep the einsum)."""
    cfg = _cfg()
    p = _layer(cfg)
    x, positions = _x(cfg, 1, 4)
    ins = _heads(p, x, positions, cfg)
    assert not attn._mla_kernel_fits(ins)
    assert not attn._mla_kernel_fits(tuple(t.to(torch.bfloat16) for t in ins))
    assert (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim) != (
        kern.NOPE_DIM, kern.ROPE_DIM, kern.V_DIM)
    full = get_config("deepseek-v2-lite-16b")
    assert (full.qk_nope_dim, full.qk_rope_dim, full.v_head_dim) == (
        kern.NOPE_DIM, kern.ROPE_DIM, kern.V_DIM)


def _recording_op(calls):
    def op(q_nope, q_rope, k_nope, k_rope, v, *, scale):
        calls.append(tuple(q_nope.shape))
        return ref.mla_prefill_attention_ref(q_nope, q_rope, k_nope, k_rope, v, scale)
    return op


def _prefill_counts(p, x, positions, cfg):
    spans.clear()
    out, latent = attn.mla_prefill(p, x, positions, cfg)
    (rec,) = [r for r in spans.records() if r.name == "model.mla_prefill"]
    return out, latent, rec.counts


def test_prefill_takes_the_op_where_it_fits_and_counts_it(monkeypatch):
    """With ``_mla_kernel_fits`` made true, ``mla_prefill`` calls the op once
    and counts ``kernel`` 1 and no score bytes; its result is the einsum's
    (the recording op is the plain version). ``mla_attention`` with the
    same routing never calls it."""
    cfg = _cfg(**YARN)
    p = _layer(cfg)
    x, positions = _x(cfg, 2, 13)
    b, s = 2, 13
    want_out, want_latent, counts = _prefill_counts(p, x, positions, cfg)
    assert counts == {"tokens": b * s, "score_bytes": b * cfg.n_heads * s * s * 4}

    calls = []
    monkeypatch.setattr(attn, "_mla_kernel_fits", lambda ins: True)
    monkeypatch.setattr(ops, "mla_prefill_attention_op", _recording_op(calls))
    out, latent, counts = _prefill_counts(p, x, positions, cfg)
    assert calls == [(b, s, cfg.n_heads, cfg.qk_nope_dim)]
    assert counts == {"tokens": b * s, "score_bytes": 0, "kernel": 1}
    assert torch.equal(out, want_out) and torch.equal(latent, want_latent)

    assert torch.equal(attn.mla_attention(p, x, positions, cfg), want_out)
    assert len(calls) == 1


def test_forward_and_loss_never_reach_the_op(monkeypatch):
    """The forward (whose MLA is ``mla_attention``) runs no MLA kernel even
    where every input would fit, under ``auto`` and ``reference``."""
    def refuse(*a, **k):
        raise AssertionError("the forward reached mla_prefill_attention_op")
    monkeypatch.setattr(attn, "_mla_kernel_fits", lambda ins: True)
    monkeypatch.setattr(ops, "mla_prefill_attention_op", refuse)
    for policy in ("auto", "reference"):
        cfg = with_kernel_impls(_cfg(), policy)
        params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
        tok = torch.randint(0, cfg.vocab_size, (1, 9), generator=torch.Generator().manual_seed(3))
        logits, _ = M.forward(params, {"tokens": tok}, cfg)
        assert torch.isfinite(logits).all()


def test_prefill_under_grad_takes_the_einsum_and_backpropagates(monkeypatch):
    """Parameters that require grad, grad on: the predicate is false, so the
    einsum runs (the op would raise), and a backward reaches every MLA
    weight."""
    def refuse(*a, **k):
        raise AssertionError("a differentiated prefill reached mla_prefill_attention_op")
    monkeypatch.setattr(ops, "mla_prefill_attention_op", refuse)
    cfg = _cfg(**YARN)
    p = {k: v.requires_grad_() for k, v in _layer(cfg).items()}
    x, positions = _x(cfg, 1, 7)
    ins = _heads(p, x, positions, cfg)
    assert torch.is_grad_enabled() and not attn._mla_kernel_fits(ins)
    out, latent, counts = _prefill_counts(p, x, positions, cfg)
    assert "kernel" not in counts
    (out.square().sum() + latent.square().sum()).backward()
    for name in ("wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"):
        assert p[name].grad is not None and bool(p[name].grad.abs().sum() > 0), name

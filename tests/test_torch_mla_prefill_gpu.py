"""The MLA prefill kernel against its plain version, on the card.

Every test here needs a CUDA card and skips without one; the file imports
no JAX:

    python -m pytest -m gpu tests/test_torch_mla_prefill_gpu.py

Tolerance. Both sides read the same bf16 inputs and round P to bf16 before
the value product, but the plain path (today's einsum) also rounds the
summed scores to bf16 before the float32 softmax, which the kernel never
does: on YaRN-scaled scores that moves outputs by a few bf16 ulps. So the
kernel is held against the same math in float32 (the inputs upcast, no
rounding but their own), where it must come at least as close as the plain
bf16 path does, and within ``TRUTH_ATOL`` (outputs of magnitude up to
about 3; the plain path reads 2.6e-2 to 3.7e-2 there, the kernel 8e-3 to
1e-2, NVIDIA H100); against the plain bf16 path itself at ``BF16_TOL``,
the port's bf16 kernel tolerance.
"""
import dataclasses

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_config, with_kernel_impls
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine

pytestmark = pytest.mark.gpu

BF16_TOL = dict(atol=5e-2, rtol=5e-2)
TRUTH_ATOL = 2e-2
# DeepSeek-V2-Lite's softmax scale with YaRN's temperature (factor 40,
# mscale_all_dim 0.707): 192 ** -0.5 * yarn_mscale(40, 0.707) ** 2
YARN = {"rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run these tests on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scale():
    return attn.mla_softmax_scale(dataclasses.replace(get_config("deepseek-v2-lite-16b"), **YARN))


def _inputs(b, s, h, layout, seed=0):
    """(q_nope, q_rope, k_nope, k_rope, v) in bf16. ``contiguous``: each its
    own tensor; ``model``: as the prefill makes them, q_nope and q_rope
    views of one (B,S,H,192) projection, k_rope a view of the latent's
    (B,S,512+64) row; ``misaligned``: every input starting one element into
    its buffer (the wrapper copies them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    off = 1 if layout == "misaligned" else 0

    def rnd(*shape):
        t = torch.randn(*shape[:-1], shape[-1] + off, device="cuda", generator=g)
        return t.to(torch.bfloat16)[..., off:]
    if layout == "contiguous":
        return (rnd(b, s, h, 128), rnd(b, s, h, 64), rnd(b, s, h, 128), rnd(b, s, 64),
                rnd(b, s, h, 128))
    q_nope, q_rope = rnd(b, s, h, 192).split([128, 64], dim=-1)
    k_rope = rnd(b, s, 512 + 64)[..., 512:]
    return q_nope, q_rope, rnd(b, s, h, 128), k_rope, rnd(b, s, h, 128)


def _check(ins, scale):
    before = ops.launch_counts()["mla_prefill"]
    with torch.no_grad():
        out = ops.mla_prefill_attention_op(*ins, scale=scale)
        again = ops.mla_prefill_attention_op(*ins, scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mla_prefill"] == before + 2
    assert out.shape == ins[4].shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.equal(out, again)                       # no atomics: the same bits
    plain = ref.mla_prefill_attention_ref(*ins, scale=scale)
    truth = ref.mla_prefill_attention_ref(*(t.float() for t in ins), scale=scale)
    err, err_plain = ((x.float() - truth).abs().max().item() for x in (out, plain))
    assert err <= max(err_plain, 1e-6) and err <= TRUTH_ATOL, (err, err_plain)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)


@pytest.mark.parametrize("h", [16, 8])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 2048, 4097, 8192])
def test_kernel_matches_plain_on_card(cuda, s, h):
    """Strided as the model reads them, at 16 heads and a TP-2 rank's 8."""
    _check(_inputs(1, s, h, "model", seed=s + h), _scale())


@pytest.mark.parametrize("layout", ["contiguous", "model", "misaligned"])
@pytest.mark.parametrize("b,s,h", [(2, 200, 8), (1, 300, 16)])
def test_kernel_layouts_and_batches_on_card(cuda, layout, b, s, h):
    _check(_inputs(b, s, h, layout, seed=b * s), _scale())


def test_kernel_refuses_what_it_does_not_take(cuda):
    ins = _inputs(1, 64, 16, "contiguous")
    with pytest.raises(TypeError):
        ops.mla_prefill_attention_op(*(t.float() for t in ins), scale=1.0)
    with pytest.raises(ValueError):
        ops.mla_prefill_attention_op(ins[0][..., :64], *ins[1:], scale=1.0)
    with pytest.raises(ValueError):
        ops.mla_prefill_attention_op(*ins[:4], ins[4].transpose(1, 2), scale=1.0)
    req = tuple(t.detach().requires_grad_() for t in ins)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.mla_prefill_attention_op(*req, scale=1.0)
    assert ops.launch_counts() == before


def _deepseek(n_layers=3, seed=0):
    """Full-width DeepSeek-V2-Lite with its published YaRN, cut to one dense
    and two moe layers, bf16 weights on the card."""
    cfg = with_kernel_impls(dataclasses.replace(
        get_config("deepseek-v2-lite-16b"), n_layers=n_layers, param_dtype="bfloat16",
        mla_latent_norm=True, **YARN), "auto")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    return cfg, params


def test_an_admission_runs_the_kernel_once_a_layer(cuda, monkeypatch):
    """One request admitted through ``ContinuousEngine``: the kernel once a
    layer, each ``model.mla_prefill`` span counting ``kernel`` 1 and no
    score bytes, no flash launch; its first token's logits close to the
    einsum's on the same weights: against the float32 prefill of those
    weights no further than twice the einsum's distance plus 1e-2 (read on an
    H100: 5.97e-2 against 6.97e-2, on logits of a few units)."""
    cfg, params = _deepseek()
    engine = ContinuousEngine(cfg, params, n_slots=2, max_seq=640, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (600,), generator=torch.Generator().manual_seed(1))
    picked = []
    pick = engine._pick_row
    engine._pick_row = lambda logits: (picked.append(logits[0].float().clone()), pick(logits))[1]
    ops.reset_launch_counts()
    spans.clear()
    with torch.no_grad():
        engine.add(GenRequest(id=0, prompt=prompt.tolist(), max_new=1))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["mla_prefill"] == cfg.n_layers and counts["flash_attention"] == 0
    layers = [r for r in spans.records() if r.name == "model.mla_prefill"]
    assert [r.counts for r in layers] == [
        {"tokens": 600, "score_bytes": 0, "kernel": 1}] * cfg.n_layers
    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(attn, "_mla_kernel_fits", lambda ins: False)
            einsum, _ = M.prefill(params, {"tokens": prompt[None].cuda()}, cfg)
        f32, _ = M.prefill(M.tree_map(lambda t: t.float(), params),
                           {"tokens": prompt[None].cuda()},
                           dataclasses.replace(cfg, dtype="float32", param_dtype="float32"))
    v = cfg.vocab_size
    got, plain, truth = picked[0][:v], einsum[0, :v].float(), f32[0, :v].float()
    err, err_plain = (got - truth).abs().max().item(), (plain - truth).abs().max().item()
    print(f"admission logits against float32: kernel {err:.4e}, einsum {err_plain:.4e}")
    assert err <= 2 * err_plain + 1e-2


def test_prefill_under_grad_takes_the_einsum_on_card(cuda):
    """Weights that require grad, grad on, under ``reference`` (as training
    runs; the latent's norm would otherwise refuse them on the rmsnorm
    kernel): no MLA kernel launch, the span counts the einsum's scores, and
    a backward reaches the MLA weights. The same call under no_grad
    launches the kernel: ``kernel_impls`` does not choose it."""
    cfg, params = _deepseek(n_layers=2)
    cfg = with_kernel_impls(cfg, "reference")
    p = {k: v[0].detach().requires_grad_() for k, v in params["stack"]["moe"]["attn"].items()}
    x = torch.randn(1, 96, cfg.d_model, device="cuda").to(torch.bfloat16)
    positions = torch.arange(96, device="cuda")[None]
    ops.reset_launch_counts()
    spans.clear()
    out, latent = attn.mla_prefill(p, x, positions, cfg)
    assert ops.launch_counts()["mla_prefill"] == 0
    (rec,) = [r for r in spans.records() if r.name == "model.mla_prefill"]
    assert rec.counts == {"tokens": 96, "score_bytes": cfg.n_heads * 96 * 96 * 4}
    (out.float().square().sum() + latent.float().square().sum()).backward()
    for name in ("wq", "w_dkv", "w_uk", "w_uv", "wo"):
        assert p[name].grad is not None and bool(torch.isfinite(p[name].grad).all()), name
    with torch.no_grad():
        attn.mla_prefill(p, x, positions, cfg)
    assert ops.launch_counts()["mla_prefill"] == 1

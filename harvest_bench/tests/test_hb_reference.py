"""The plain references against the port at smoke size on the CPU, both at
float32: the prefill's last logits and the full forward's at every
position, the same weights handed to both."""
import dataclasses

import pytest
import torch

from harvest_bench.harness.check import hyperparameters, reference_module
from harvest_bench.harness.spec import BENCH_DIR, port_config, read_json
from harvest_bench.harness.weights import make_weights
from harvest_bench.reference.common import (Exact, Fp8, fp8_round, rope, rope_frequencies,
                                            yarn_mscale)

CONFIGS = ["mixtral-8x22b-s7", "deepseek-v2-lite-16b"]


def config_file(name):
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


def port_and_reference(name, seed, tokens, hp=None, **replace):
    """The port's full-forward logits and the reference's (float32, smoke
    size, the same weights) over ``tokens`` random tokens."""
    from repro_torch.models import model as M
    config = config_file(name)
    cfg = dataclasses.replace(port_config(config, rehearsal=True), **replace)
    assert cfg.dtype == "float32"
    w = make_weights(cfg, seed, torch.device("cpu"))
    tok = torch.randint(0, cfg.vocab_size, (1, tokens),
                        generator=torch.Generator().manual_seed(seed))
    hp = hyperparameters(config, True) if hp is None else hp
    with torch.no_grad():
        last, _ = M.prefill(M.cast_params(w, cfg), {"tokens": tok}, cfg)
        full, _ = M.forward(M.cast_params(w, cfg), {"tokens": tok}, cfg)
        ref = reference_module(config).logits(w, hp, [tok[0].tolist()], [tokens], Exact())[0]
    v = cfg.vocab_size
    return last[0, :v], full[0, :, :v], ref


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", [0, 3])
def test_reference_matches_the_port_at_float32(config, seed):
    last, full, ref = port_and_reference(config, seed, 29)
    torch.testing.assert_close(last, ref[-1], atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(full, ref, atol=2e-5, rtol=1e-5)


def test_the_window_masks_in_the_reference():
    hp = dict(hyperparameters(config_file(CONFIGS[0]), True), sliding_window=8)
    _, full, ref = port_and_reference(CONFIGS[0], 1, 20, hp, sliding_window=8)
    torch.testing.assert_close(full, ref, atol=2e-5, rtol=1e-5)


def test_yarn_as_published():
    """DeepSeek-V2-Lite's ``rope_scaling`` at its 64 rotary dims: the
    correction range of ``modeling_deepseek.py`` is dims 10 to 23 of 32
    (floor and ceil of 10.47 and 22.52), below it the frequencies are kept,
    above it divided by 40; cos and sin keep amplitude 1 (mscale equals
    mscale_all_dim); the softmax temperature is 0.1 * 0.707 * ln 40 + 1."""
    scaling = config_file("deepseek-v2-lite-16b")["rope_scaling"]
    plain, _ = rope_frequencies(64, 10000.0)
    inv, amp = rope_frequencies(64, 10000.0, scaling)
    assert amp == 1.0
    torch.testing.assert_close(inv[:11], plain[:11], rtol=0, atol=0)
    torch.testing.assert_close(inv[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    ramp = (torch.arange(11, 23, dtype=torch.float32) - 10) / 13
    torch.testing.assert_close(inv[11:23], plain[11:23] / 40 * ramp + plain[11:23] * (1 - ramp))
    assert yarn_mscale(40, 0.707) == pytest.approx(1.2608, abs=1e-4)
    assert yarn_mscale(1.0, 0.707) == 1.0
    with pytest.raises(ValueError):
        rope_frequencies(64, 10000.0, dict(scaling, type="dynamic"))


def test_the_reference_applies_the_published_yarn():
    """The file's ``rope_scaling`` moves deepseek's reference logits (by
    the frequencies and by the softmax temperature), so a program without
    YaRN could not pass for one with it."""
    config = config_file("deepseek-v2-lite-16b")
    hp = hyperparameters(config, True)
    _, _, plain = port_and_reference("deepseek-v2-lite-16b", 0, 29, hp)
    _, _, yarn = port_and_reference("deepseek-v2-lite-16b", 0, 29,
                                    dict(hp, rope_scaling=config["rope_scaling"]))
    assert (yarn - plain).abs().max() > 1e-3


def test_rope_rotates_pairs_of_halves():
    x = torch.zeros(2, 1, 4)
    x[:, 0, 0] = 1.0
    y = rope(x, 10000.0)
    assert torch.allclose(y[0], x[0])
    assert torch.allclose(y[1, 0], torch.tensor([torch.cos(torch.tensor(1.0)), 0.0,
                                                 torch.sin(torch.tensor(1.0)), 0.0]))


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.linspace(-3, 3, 101)[None, :]
    r = fp8_round(t, -1)
    assert (r - t).abs().max() > 1e-3
    assert ((r - t).abs() <= t.abs() * 2 ** -4 + 1e-6).all()
    x, w = torch.randn(4, 16), torch.randn(16, 8)
    assert not torch.allclose(Fp8().mm(x, w), Exact().mm(x, w), atol=1e-3)

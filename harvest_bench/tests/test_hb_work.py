"""The yardstick's counts against hand counts: a ``moe_gmm`` launch's work
and bound, the recorder over the port's dropless MoE path, model FLOPs."""
import dataclasses

import pytest
import torch

from harvest_bench.harness import work
from harvest_bench.harness.spec import BENCH_DIR, port_config, read_json


def test_gmm_work_by_hand():
    # 10 real rows over 3 used experts, D 4, F 6, bf16, 3 tiles
    flops, nbytes = work.gmm_work(10, 3, 4, 6, 2, 3)
    assert flops == 2 * 10 * 4 * 6
    assert nbytes == 2 * (10 * 4 + 3 * 4 * 6 + 10 * 6) + 4 * 3
    # mixtral's decode wave: 64 rows over 8 experts is bound by the weights
    fl, by = work.gmm_work(64, 8, 6144, 16384, 2, 16)
    assert work.bound_s(fl, by) == pytest.approx(by / work.PEAK_BYTES_PER_S)
    # a large prefill tile is bound by operations
    fl, by = work.gmm_work(100_000, 8, 6144, 16384, 2, 800)
    assert work.bound_s(fl, by) == pytest.approx(fl / work.PEAK_FLOPS_BF16)


def test_recorder_counts_the_dropless_path():
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import param_specs
    config = read_json(BENCH_DIR / "configs" / "deepseek-v2-lite-16b.json")
    cfg = port_config(config, rehearsal=True)
    specs = param_specs(cfg)["stack"]["moe"]["moe"]
    g = torch.Generator().manual_seed(0)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return torch.randn(spec.shape[1:], generator=g) * 0.1
    p = make(specs)
    x = torch.randn(1, 5, cfg.d_model, generator=g)
    rec = work.GmmRecorder()
    rec.install()
    try:
        moe_mod.apply_moe(p, x, cfg)
    finally:
        rec.uninstall()
    assert rec.fault is None and len(rec.launches) == 3
    sizes = rec.launches[0][4]
    assert int(sizes.sum()) == 5 * cfg.top_k
    flops, nbytes, bound = rec.work()
    d, f, used = cfg.d_model, cfg.moe_d_ff, int((sizes > 0).sum())
    tiles = rec.launches[0][3]
    assert flops == 3 * 2 * 10 * d * f
    by_hand = 4 * (10 * d + used * d * f + 10 * f) * 2 + 4 * (10 * f + used * f * d + 10 * d)
    assert nbytes == by_hand + 3 * 4 * tiles
    assert bound > 0
    from repro_torch.kernels import ops
    assert ops.moe_gmm_op.__name__ == "moe_gmm_op"
    assert ops.pad_group_sizes.__module__ == ops.__name__


def test_recorder_flags_a_launch_without_sizes():
    rec = work.GmmRecorder()
    rec.install()
    try:
        from repro_torch.kernels import ops
        lhs = torch.zeros(8, 4)
        ops.moe_gmm_op(lhs, torch.zeros(1, 4, 2), torch.zeros(1, dtype=torch.int32), block_t=8)
    finally:
        rec.uninstall()
    assert rec.fault is not None and not rec.launches


def test_model_flops_by_hand():
    config = read_json(BENCH_DIR / "configs" / "mixtral-8x22b-s7.json")
    cfg = port_config(config)
    d, h, kv, dh, f, v = 6144, 48, 8, 128, 16384, 32768
    per_layer = d * h * dh * 2 + 2 * d * kv * dh + d * 8 + 3 * d * f * 2
    assert work.token_matmul_params(cfg) == 7 * per_layer
    mf = work.ModelFlops(cfg)
    mf.prefill(3)
    attn = 2 * h * 2 * dh * 7
    assert mf.total == 2 * 7 * per_layer * 3 + attn * (1 + 2 + 3) + 2 * d * v
    mf.total = 0
    mf.decode([9, 0])
    assert mf.total == 2 * (2 * 7 * per_layer + 2 * d * v) + attn * (10 + 1)
    windowed = work.ModelFlops(dataclasses.replace(cfg, sliding_window=2))
    windowed.prefill(3)
    assert windowed.total == 2 * 7 * per_layer * 3 + attn * (1 + 2 + 2) + 2 * d * v


def test_model_flops_mla_by_hand():
    config = read_json(BENCH_DIR / "configs" / "deepseek-v2-lite-16b.json")
    cfg = port_config(config)
    d, h, r, nope, rope, dv = 2048, 16, 512, 128, 64, 128
    attn = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + dv) + h * dv * d
    dense = attn + 3 * d * 10944
    moe = attn + d * 64 + 3 * d * 1408 * (6 + 2)
    assert work.token_matmul_params(cfg) == dense + 26 * moe
    assert work.attention_flops_per_key(cfg) == 2 * h * (nope + rope + dv) * 27

"""The port's launch tools against ``repro``'s: the config helpers
(``param_count``, ``ShapeConfig``, ``cell_is_runnable``, ``all_cells``) for
all ten archs x four shapes, the production meshes, the H100 roofline
(``analytic_model_flops`` equal to ``repro``'s, the terms' arithmetic), the
twins of ``tests/test_dryrun.py`` on the meta-device dry run (its input
specs, skip matrix and FLOP scaling; in place of the HLO collective parser,
which has no torch twin, a record's empty ``coll`` and even partition),
full-size ``run_cell`` on ``meta`` for a decode, a prefill and a train cell
with the depth probes equal to the full-depth count, the CLI, and the four
model-side benchmark and example twins at ``--device cpu --smoke``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as JRL
from repro.launch.dryrun import input_specs as jax_input_specs
from repro.launch.mesh import make_production_mesh as jax_production_mesh
from repro_torch.configs import (ARCH_IDS, SHAPES, SHAPES_BY_NAME, all_cells,
                                 cell_is_runnable, get_config)
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as M

pytestmark = pytest.mark.slow


# --- configs -------------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_param_count_and_cells_equal_repro(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for active in (False, True):
        assert cfg.param_count(active) == jcfg.param_count(active)
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == \
            (jshape.name, jshape.seq_len, jshape.global_batch, jshape.kind)
        assert cell_is_runnable(cfg, shape) == cell_is_runnable(jcfg, jshape)
        assert RL.analytic_model_flops(cfg, shape) == JRL.analytic_model_flops(jcfg, jshape)


def test_all_cells_equal_repro():
    mine = sorted((a, s.name, ok, why) for a, s, ok, why in all_cells())
    want = sorted((a, s.name, ok, why) for a, s, ok, why in jax_all_cells())
    assert mine == want and len(mine) == 40
    assert sum(ok for _, _, ok, _ in mine) == 32
    assert get_config("qwen2.5-3b").param_count() == 3_085_846_528
    ds = get_config("deepseek-v2-lite-16b")
    assert (ds.param_count(), ds.param_count(True)) == (15_706_470_400, 2_661_136_384)


def test_production_meshes_equal_repro():
    for multi in (False, True):
        mesh, jmesh = make_production_mesh(multi_pod=multi), jax_production_mesh(multi_pod=multi)
        assert mesh.axis_names == tuple(jmesh.axis_names)
        assert mesh.axis_sizes == tuple(jmesh.devices.shape)
    assert make_mesh((1, 1), ("data", "model")).axis_sizes == (1, 1)


# --- twins of tests/test_dryrun.py ----------------------------------------------------------
def test_input_specs_shapes_per_family():
    train = SHAPES_BY_NAME["train_4k"]
    lm = D.input_specs(get_config("internlm2-1.8b"), train)
    assert lm["tokens"].shape == (256, 4096) and lm["tokens"].dtype == torch.int32
    assert lm["tokens"].device.type == "meta"
    vlm = D.input_specs(get_config("internvl2-26b"), train)
    assert vlm["vision_embeds"].shape == (256, 256, 6144)
    assert vlm["tokens"].shape == (256, 4096 - 256)
    audio = D.input_specs(get_config("hubert-xlarge"), train)
    assert audio["frames"].shape == (256, 4096, 1280)
    dec = D.input_specs(get_config("mamba2-2.7b"), SHAPES_BY_NAME["long_500k"])
    assert dec["token"].shape == (1, 1)
    state = dec["cache"]["ssm"]["state"]
    assert state.shape == (64, 1, 80, 64, 128)  # (L,B,H,P,N)


def test_swa_cache_is_window_bounded():
    dec = D.input_specs(get_config("mixtral-8x22b"), SHAPES_BY_NAME["decode_32k"])
    k = dec["cache"]["moe"]["k"]
    assert k.shape[2] == 4096  # ring buffer of window size, not 32768


def test_mla_cache_is_compressed():
    dec = D.input_specs(get_config("deepseek-v2-lite-16b"), SHAPES_BY_NAME["decode_32k"])
    c = dec["cache"]["moe"]["c"]
    assert c.shape[-1] == 512 + 64  # kv_lora + rope, NOT H*dh


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: tree}


def test_input_specs_equal_repro_for_every_runnable_cell():
    for arch, shape, ok, _ in all_cells():
        if not ok:
            continue
        mine = _flat(D.input_specs(get_config(arch), shape))
        want = _flat(jax_input_specs(jax_get_config(arch), shape))
        assert sorted(mine) == sorted(want), (arch, shape.name)
        for key, t in mine.items():
            assert tuple(t.shape) == tuple(want[key].shape), (arch, shape.name, key)
            assert str(t.dtype).split(".")[1] == jnp.dtype(want[key].dtype).name, key


def test_dry_run_record_has_no_collectives_and_an_even_partition():
    """The port produces no HLO (no collective parser to twin): a record's
    collective bytes are empty and per-device counts are the global ones
    split evenly over the chips."""
    rec = D.run_cell("qwen2.5-3b", "decode_32k", make_production_mesh(), "single",
                     probes=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["coll"] == {} and rec["roofline"]["coll_breakdown"] == {}
    assert rec["roofline"]["t_collective_s"] == 0.0
    assert rec["partition"] == "even" and rec["bytes_count"] == "unfused"
    assert rec["device"] == "meta"
    assert rec["roofline"]["flops_per_dev"] == rec["full_depth"]["flops"] / 256
    assert rec["memory_analysis"]["temp_bytes_per_dev"] is None


def test_analytic_model_flops_scales():
    cfg = get_config("internlm2-1.8b")
    train = RL.analytic_model_flops(cfg, SHAPES_BY_NAME["train_4k"])
    # 6 N D dominates: N=1.89e9, D=1.05e6 -> ~1.2e16
    assert 1e16 < train < 2e16
    dec = RL.analytic_model_flops(cfg, SHAPES_BY_NAME["decode_32k"])
    assert dec < train / 1000
    # MoE counts ACTIVE params only
    mx = get_config("mixtral-8x22b")
    t_moe = RL.analytic_model_flops(mx, SHAPES_BY_NAME["train_4k"])
    n_total = mx.param_count(active_only=False)
    n_active = mx.param_count(active_only=True)
    assert n_active < 0.45 * n_total
    assert t_moe < 6 * n_total * 256 * 4096  # strictly below dense-equivalent


def test_skip_matrix():
    hub = get_config("hubert-xlarge")
    assert not cell_is_runnable(hub, SHAPES_BY_NAME["decode_32k"])[0]
    assert not cell_is_runnable(hub, SHAPES_BY_NAME["long_500k"])[0]
    assert cell_is_runnable(hub, SHAPES_BY_NAME["prefill_32k"])[0]
    for a in ("mamba2-2.7b", "zamba2-2.7b", "mixtral-8x22b"):
        assert cell_is_runnable(get_config(a), SHAPES_BY_NAME["long_500k"])[0], a
    for a in ("internlm2-1.8b", "deepseek-v2-lite-16b", "internvl2-26b"):
        assert not cell_is_runnable(get_config(a), SHAPES_BY_NAME["long_500k"])[0], a


def test_roofline_terms_math():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 450e9)
    t = RL.RooflineTerms(flops_per_dev=989e12, bytes_per_dev=3.35e12,
                         coll_bytes_per_dev=0.0, chips=256,
                         model_flops=989e12 * 256 * 0.5)
    assert abs(t.t_compute - 1.0) < 1e-9
    assert abs(t.t_memory - 1.0) < 1e-9
    assert t.bottleneck in ("compute", "memory")
    assert abs(t.roofline_fraction - 0.5) < 1e-9
    assert RL.RooflineTerms(0.0, 0.0, 450e9, 1).t_collective == 1.0


# --- full-size cells on meta ----------------------------------------------------------------
@pytest.mark.parametrize("shape_name", ["decode_32k", "prefill_32k", "train_4k"])
def test_run_cell_full_size_on_meta_probes_equal_full_depth(shape_name):
    """internlm2-1.8b at full width and depth on the single-pod mesh: the
    probes' linear extrapolation equals the full-depth count, the counted
    FLOPs are near the analytic useful FLOPs (above them but for decode,
    whose analytic count takes the embedding gather as a product), and the
    parameters' bytes a device are their shards' over data 16 x model 16."""
    rec = D.run_cell("internlm2-1.8b", shape_name, make_production_mesh(), "single")
    assert rec["status"] == "ok", rec.get("error")
    full, probes = rec["full_depth"], rec["probes"]
    assert probes["flops"] == full["flops"] and probes["bytes"] == full["bytes"]
    r = rec["roofline"]
    assert r["model_flops"] == RL.analytic_model_flops(get_config("internlm2-1.8b"),
                                                       SHAPES_BY_NAME[shape_name])
    assert 0.5 < r["useful_ratio"] < (1.1 if shape_name == "decode_32k" else 1.0)
    assert r["bottleneck"] in ("compute", "memory")
    parts = rec["memory_analysis"]["argument_breakdown_per_dev"]
    n_params = sum(t.numel() for t in M.tree_leaves(D._params_shape(get_config("internlm2-1.8b"))))
    assert n_params * 4 / 256 <= parts["params"] < n_params * 4 / 64
    if shape_name == "train_4k":
        assert rec["overrides"] == {"remat": "dots_saveable"}
        assert parts["opt"] == 2 * parts["params"] + 4


@pytest.mark.parametrize("arch,shape_name", [("mixtral-8x22b", "decode_32k"),
                                             ("deepseek-v2-lite-16b", "prefill_32k")])
def test_ragged_moe_dry_run_on_meta(arch, shape_name):
    """``--moe-impl ragged`` on ``meta``: the product reads no group size on
    the host, so the cell records ok (it erred with ``Cannot copy out of
    meta tensor`` before)."""
    rec = D.run_cell(arch, shape_name, make_production_mesh(), "single", probes=False,
                     moe_impl="ragged")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["overrides"]["moe_impl"] == "ragged"
    assert rec["full_depth"]["flops"] > 0


def test_ragged_dot_counts_its_products_on_meta_and_keeps_its_bits():
    """On ``meta`` the ragged product counts 2 * rows * d * f FLOPs (each
    row times its expert's weight once); on real tensors it gives the bits
    of one product per expert group, as before."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.moe import _ragged_dot
    rows, d, f, e = 40, 64, 48, 8
    sizes = torch.tensor([5, 0, 12, 3, 9, 0, 7, 4], dtype=torch.int32)
    with FlopCounterMode(display=False) as counter:
        out = _ragged_dot(torch.empty(rows, d, device="meta"), torch.empty(e, d, f, device="meta"),
                          sizes.to("meta"))
    assert out.shape == (rows, f) and out.device.type == "meta"
    assert counter.get_total_flops() == 2 * rows * d * f
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(dtype)
        w = torch.from_numpy(rng.standard_normal((e, d, f), dtype=np.float32)).to(dtype)
        want = torch.zeros(rows, f, dtype=dtype)
        start = 0
        for g, n in enumerate(sizes.tolist()):
            want[start:start + n] = xs[start:start + n] @ w[g]
            start += n
        assert torch.equal(_ragged_dot(xs, w, sizes), want)


def test_argument_bytes_on_one_card_are_the_parameters():
    """On a 1 x 1 mesh the parameters' argument bytes are every leaf's fp32
    bytes; ``param_count`` leaves out the QKV biases (its norm count is
    exact for qwen2.5-3b), 2,560 a layer."""
    cfg = get_config("qwen2.5-3b")
    _, _, mem = D._build(cfg, SHAPES_BY_NAME["prefill_32k"], make_mesh((1, 1), ("data", "model")))
    leaves = M.tree_leaves(D._params_shape(cfg))
    assert all(t.device.type == "meta" for t in leaves)
    assert mem["parts"]["params"] == sum(t.numel() * 4 for t in leaves) == 12_343_754_752
    qkv_bias = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    assert mem["parts"]["params"] // 4 - cfg.param_count() == qkv_bias


def test_dryrun_cli(tmp_path):
    out = tmp_path / "dry.json"
    D.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--shape", "long_500k",
            "--mesh", "single", "--no-probes", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [(r["shape"], r["status"]) for r in recs] == [("decode_32k", "ok"),
                                                         ("long_500k", "skipped")]
    assert recs[1]["reason"] == "pure full-attention arch: no sub-quadratic path at 500k"
    D.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(out)])   # done cells are not run again
    assert len(json.loads(out.read_text())) == 2
    with pytest.raises(SystemExit):
        D.main(["--out", str(tmp_path / "dryrun.json")])


# --- the model-side benchmark and example twins ---------------------------------------------
@pytest.fixture
def one_thread():
    """The twins run thousands of tiny ops on smoke models: with the other
    test workers busy, torch's intra-op threads only contend (a twin took
    40x its time alone), so each twin runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serving_matrix_twin(tmp_path, one_thread):
    from repro_torch.benchmarks import serving_matrix
    d = serving_matrix.main(["--device", "cpu", "--smoke", "--assert-equal",
                             "--out", str(tmp_path / "BENCH_torch_serving_matrix_smoke.json")])
    d = d["serving_matrix"]
    assert d["all_tokens_equal"] and d["n_archs"] == 3
    assert d["archs"]["mamba2-2.7b"]["kernel_sites"] == ("rmsnorm", "ssm")
    for arch, rec in d["archs"].items():
        for p in rec["points"]:   # on the CPU the plain versions launch nothing
            assert not any(p["reference"]["launches"].values()), arch
            assert not any(p["kernel"]["launches"].values()), arch
    with pytest.raises(SystemExit):
        serving_matrix.main(["--device", "cpu", "--out", "results/BENCH_serving_matrix.json"])


def test_paged_kv_twin(tmp_path, one_thread):
    from repro_torch.benchmarks import paged_kv
    d = paged_kv.main(["--device", "cpu", "--smoke", "--requests", "8",
                       "--assert-slot-ratio", "2",
                       "--out", str(tmp_path / "BENCH_torch_paged_kv_smoke.json")])["paged_kv"]
    assert d["outputs_match"] and d["resume_outputs_match"] and d["slot_ratio"] >= 2
    assert d["kernel_token_agreement"] == 1.0
    assert d["kernel_launches"]["paged_attention"] == 0   # the plain version on the CPU


def test_quickstart_twin(one_thread):
    from repro_torch.launch import quickstart
    out = quickstart.main(["--device", "cpu", "--smoke"])
    assert np.isfinite(out["loss"]) and len(out["tokens"]) == 8
    assert out["specs"]["tokens"] == (256, 4096)


def test_elastic_faas_demo_twin(one_thread):
    from repro_torch.launch import elastic_faas_demo
    out = elastic_faas_demo.main(["--device", "cpu", "--smoke"])
    assert out["steps"] == 6 and np.isfinite(out["loss_last"])
    assert set(out["coverage"]) == {"fib", "var"}


def test_twins_need_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.benchmarks import paged_kv, serving_matrix
    from repro_torch.launch import elastic_faas_demo, quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (serving_matrix.main, paged_kv.main, quickstart.main, elastic_faas_demo.main):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(["--smoke", "--out", "unused.json"] if main in (serving_matrix.main,
                                                                  paged_kv.main) else [])

"""The batched decode cut into pieces at its MoE layers, and the CUDA graphs
of those pieces (``repro_torch.models.decode_graphs``).

On the CPU: the pieces run in order give the bits of the decode before the
cut (one block at a time, its MoE inside), on the mixtral smoke preset with
per-row positions, a dense GQA preset, mixtral's ring at window 16 past its
wrap, and deepseek's MLA, also with DeepSeek-V2's published settings (YaRN,
un-renormalised top-k, the latent norm); which configs, devices and groups
can be graphed; an eager step's span. On the card (``-m gpu``; this file
imports no JAX): the graphed engine against the eager one, step for step,
bit for bit, on every text decoder that can be graphed and on deepseek with
the published settings (whose MLA prefill spans stay in the admissions); a
new cache; a capture that fails; the engines that stay eager.

    python -m pytest -m gpu tests/test_torch_decode_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import ARCH_IDS, get_config, with_kernel_impls
from repro_torch.distributed.tensor_parallel import TPGroup
from repro_torch.kernels import ops
from repro_torch.models import decode_graphs
from repro_torch.models import model as tmodel
from repro_torch.models import transformer
from repro_torch.models.attention import gqa_decode, mla_decode
from repro_torch.models.layers import embed_tokens, logits_from_hidden
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine


def _config(arch, dtype="float32", **overrides):
    return with_kernel_impls(dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                                                 **overrides), "auto")


def _params(cfg, device="cpu", seed=0):
    return tmodel.cast_params(
        tmodel.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device), cfg)


def _presplit_decode(params, token, cache, pos, cfg):
    """The decode as it ran before the cut: block after block, each with
    its feed-forward (the MoE inside), then the final norm and the head."""
    x = embed_tokens(params["embed"], token, cfg)
    h = None
    for seg in transformer.segments_for(cfg):
        p, c = params["stack"][seg.name], cache[seg.name]
        for i in range(seg.n):
            lp, lc = transformer._layer(p, i), transformer._layer(c, i)
            if cfg.use_mla:
                def attend(y, lp=lp, lc=lc):
                    return mla_decode(lp["attn"], y, lc["c"], pos, cfg)
            else:
                def attend(y, lp=lp, lc=lc):
                    return gqa_decode(lp["attn"], y, lc["k"], lc["v"], pos, cfg)
            x, h, *_ = transformer._dense_block(lp, x, h, attend, cfg)
    _, x = transformer._add_norm(x, h, params["final_norm"], cfg)
    return logits_from_hidden(tmodel._head_weight(params, cfg), x, cfg)[:, 0]


# DeepSeek-V2-Lite's published math (config.json's rope_scaling, norm_topk_prob
# false, the latent's RMSNorm), which the deepseek preset leaves off
PUBLISHED_DEEPSEEK = {
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
    "norm_topk_prob": False, "mla_latent_norm": True}

# (arch, config overrides, cache length, the rows' positions)
PIECE_CASES = {
    "mixtral-per-row": ("mixtral-8x22b", {}, 16, [0, 5, 11, 15]),
    "dense-gqa": ("qwen2.5-3b", {}, 24, [3, 0, 17, 23]),
    "ring-window16": ("mixtral-8x22b", {"sliding_window": 16}, 48, [15, 16, 29, 47]),
    "mla": ("deepseek-v2-lite-16b", {}, 20, [1, 19, 7, 12]),
    "mla-published": ("deepseek-v2-lite-16b", PUBLISHED_DEEPSEEK, 20, [1, 19, 7, 12]),
}


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_pieces_in_order_match_the_decode_before_the_cut(case):
    arch, overrides, seq, positions = PIECE_CASES[case]
    cfg = _config(arch, **overrides)
    params = _params(cfg)
    b = len(positions)
    g = torch.Generator().manual_seed(1)
    orig = tmodel.tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
                           tmodel.init_cache(cfg, b, seq, "cpu"))
    token = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
    pos = torch.tensor(positions)
    want_cache = tmodel.tree_map(torch.clone, orig)
    want = _presplit_decode(params, token, want_cache, pos, cfg)

    cache = tmodel.tree_map(torch.clone, orig)
    pieces, moes = tmodel.decode_pieces(params, cache, pos, cfg)
    n_moe = sum(s.n for s in transformer.segments_for(cfg) if s.kind == "moe")
    assert len(moes) == n_moe and len(pieces) == n_moe + 1
    out = pieces[0](token)
    for moe, piece in zip(moes, pieces[1:]):
        x, y = out
        out = piece(x, moe(y))
    (got,) = out
    # decode_step is their composition
    step_cache = tmodel.tree_map(torch.clone, orig)
    logits, _ = tmodel.decode_step(params, token, step_cache, pos, cfg)
    for got_logits, got_cache in ((got, cache), (logits, step_cache)):
        assert torch.equal(got_logits, want)
        for a, w in zip(tmodel.tree_leaves(got_cache), tmodel.tree_leaves(want_cache)):
            assert torch.equal(a, w)
    assert not torch.equal(tmodel.tree_leaves(orig)[0], tmodel.tree_leaves(cache)[0])


def _tp2():
    cpu = torch.device("cpu")
    return TPGroup(group=None, rank=0, size=2, device=cpu, devices=(cpu, cpu), backend="gloo")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("group", [None, "tp2"])
def test_graphable(arch, smoke, device, group):
    cfg = get_config(arch, smoke=smoke)
    tp = _tp2() if group else None
    want = (device == "cuda" and tp is None
            and arch not in ("mamba2-2.7b", "zamba2-2.7b"))
    assert decode_graphs.graphable(cfg, torch.device(device), tp) is want


def test_an_eager_step_counts_graphed_0_and_holds_its_moe_layers():
    cfg = _config("mixtral-8x22b", n_layers=7)
    engine = ContinuousEngine(cfg, _params(cfg), n_slots=2, max_seq=32, device="cpu")
    rng = np.random.default_rng(0)
    for i, n in enumerate((9, 5)):
        engine.add(GenRequest(id=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                              max_new=3))
    spans.clear()
    engine.run()
    recs = spans.records()
    steps = {r.seq for r in recs if r.name == "engine.step"}
    dispatch = [r for r in recs if r.name == "model.decode_step"]
    assert len(dispatch) == engine.n_decode_steps == 2
    for d in dispatch:
        assert d.parent in steps and d.counts == {"graphed": 0}
        kids = [r.name for r in recs if r.parent == d.seq]
        assert kids == ["model.moe"] * 7


def test_launch_state_round_trip():
    before = ops.launch_state()
    ops.add_launches({"rmsnorm.residual": 3, "moe_gmm.wide": 2})
    counts = ops.launch_counts()
    ops.add_launches({"rmsnorm.residual": -3, "moe_gmm.wide": -2})
    assert ops.launch_state() == before
    assert counts["moe_gmm"] == sum(v for k, v in before.items() if k.startswith("moe_gmm.")) + 2
    assert counts["rmsnorm"] == sum(v for k, v in before.items() if k.startswith("rmsnorm.")) + 3


# --- on the card --------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run these tests on the chip)")
    return torch.device("cuda")


def _requests(vocab, seed=5):
    """Nine requests of 3-20 prompt tokens and 2-9 new tokens, so slots
    free and refill between steps, then three of 30 new tokens that keep
    the engine decoding through the 40th step."""
    rng = np.random.default_rng(seed)
    return [GenRequest(id=i, prompt=rng.integers(0, vocab, int(rng.integers(3, 21))).tolist(),
                       max_new=int(rng.integers(2, 10)) if i < 9 else 30) for i in range(12)]


def _drive(engine, steps=40, on_step=None):
    """Queue the requests, then ``steps`` steps (new requests come in at
    steps 5 and 10), every one of which decodes; returns every step's logits and cache, the finished
    streams and the launch counts."""
    seen = []
    decode = engine._decode_active

    def record(pos):
        logits = decode(pos)
        seen.append([logits.clone()] + [t.clone() for t in tmodel.tree_leaves(engine.cache)])
        return logits
    engine._decode_active = record
    vocab = engine.cfg.vocab_size
    queue = _requests(vocab)
    ops.reset_launch_counts()
    for r in queue[:6]:
        engine.add(r)
    for i in range(steps):
        if i == 5:
            for r in queue[6:9]:
                engine.add(r)
        if i == 10:
            for r in queue[9:]:
                engine.add(r)
        if on_step:
            on_step(engine, i)
        engine.step()
    torch.cuda.synchronize()
    assert engine.n_decode_steps == len(seen) == steps
    streams = {r.id: list(r.generated) for r in engine.batcher.finished}
    return seen, streams, ops.launch_counts(), ops.rmsnorm_form_counts()


def _engine(cfg, params, graphed, **kw):
    engine = ContinuousEngine(cfg, params, n_slots=4, max_seq=64, device="cuda", **kw)
    if not graphed:
        engine._graphable = False
    return engine


# every decoder the engine serves from text whose decode can be graphed: the
# MoE stacks (deepseek's MLA behind a dense layer) and the dense ones
GRAPHED_ARCHS = ["deepseek-v2-lite-16b", "internlm2-1.8b", "mixtral-8x22b", "qwen1.5-4b",
                 "qwen2.5-3b", "stablelm-12b"]


def _graphed_matches_eager(cfg):
    """Drives an eager engine and a graphed one over the same requests and
    holds every step's logits and caches, the streams and the launch
    counts equal; returns the graphed run's span records."""
    params = _params(cfg, "cuda")
    want = _drive(_engine(cfg, params, graphed=False))
    spans.clear()
    got = _drive(_engine(cfg, params, graphed=True))
    recs = spans.records()
    flags = [r.counts["graphed"] for r in recs if r.name == "model.decode_step"]
    assert flags == [0] + [1] * 39
    assert len(got[0]) == len(want[0]) == 40
    for step, (g, w) in enumerate(zip(got[0], want[0])):
        for a, b in zip(g, w):
            assert torch.equal(a, b), f"step {step}"
    assert got[1] == want[1] and len(got[1]) >= 6          # temperature-0 streams
    assert got[2] == want[2] and got[3] == want[3]          # launch counts
    return recs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPHED_ARCHS)
def test_graphed_engine_matches_eager_bit_for_bit(cuda, arch):
    _graphed_matches_eager(_config(arch, dtype="bfloat16"))


@pytest.mark.gpu
def test_graphed_engine_matches_eager_with_deepseeks_published_settings(cuda):
    cfg = _config("deepseek-v2-lite-16b", dtype="bfloat16", **PUBLISHED_DEEPSEEK)
    recs = _graphed_matches_eager(cfg)
    by_seq = {r.seq: r for r in recs}
    layers = [r for r in recs if r.name == "model.mla_prefill"]
    admits = [r for r in recs if r.name == "engine.admit"]
    assert len(layers) == cfg.n_layers * len(admits) > 0
    assert {by_seq[r.parent].name for r in layers} == {"engine.admit"}


@pytest.mark.gpu
def test_a_new_cache_drops_the_graphs(cuda):
    cfg = _config("mixtral-8x22b", dtype="bfloat16")
    params = _params(cfg, "cuda")

    def transplant(engine, i):
        if i == 20:
            engine.cache = tmodel.tree_map(torch.clone, engine.cache)
            assert engine._graphs is None
    want = _drive(_engine(cfg, params, graphed=False), on_step=transplant)
    spans.clear()
    got = _drive(_engine(cfg, params, graphed=True), on_step=transplant)
    flags = [r.counts["graphed"] for r in spans.records() if r.name == "model.decode_step"]
    assert flags == [0] + [1] * 19 + [0] + [1] * 19
    for g, w in zip(got[0], want[0]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert got[1] == want[1]


@pytest.mark.gpu
def test_a_piece_that_waits_for_the_card_falls_back_to_eager(cuda, monkeypatch, capsys):
    cfg = _config("qwen2.5-3b", dtype="bfloat16")
    params = _params(cfg, "cuda")
    want = _drive(_engine(cfg, params, graphed=False))
    pieces = tmodel.decode_pieces

    def syncing(*a, **kw):
        ps, moes = pieces(*a, **kw)
        first = ps[0]

        def waits(*args):
            out = first(*args)
            out[0].sum().item()
            return out
        return [waits] + ps[1:], moes
    monkeypatch.setattr(decode_graphs, "decode_pieces", syncing)
    spans.clear()
    engine = _engine(cfg, params, graphed=True)
    got = _drive(engine)
    assert capsys.readouterr().err.count("decoding eagerly from here on") == 1
    assert engine._graphs is None and not engine._graphable
    flags = [r.counts["graphed"] for r in spans.records() if r.name == "model.decode_step"]
    assert flags == [0] * 40
    for g, w in zip(got[0], want[0]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert got[1:] == want[1:]


@pytest.mark.gpu
def test_ssm_and_tp_stay_eager(cuda):
    cfg = _config("mamba2-2.7b", dtype="bfloat16")
    assert not decode_graphs.graphable(_config("mixtral-8x22b"), cuda, _tp2())
    engine = _engine(cfg, _params(cfg, "cuda"), graphed=True)
    assert not engine._graphable
    spans.clear()
    _drive(engine, steps=6)
    flags = [r.counts["graphed"] for r in spans.records() if r.name == "model.decode_step"]
    assert flags == [0] * 6 and engine._graphs is None

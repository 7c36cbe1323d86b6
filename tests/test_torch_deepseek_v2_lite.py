"""DeepSeek-V2-Lite as published, in the port, against the benchmark's plain
reference (``harvest_bench/reference/deepseek_v2_lite.py``): on the CPU at
float32, at the smoke size of the configuration file's ``rehearsal``
section (``harvest_bench/configs/deepseek-v2-lite.json``), on seeded random
weights made as the benchmark makes them.

- The full forward and ``ContinuousEngine``'s prefill then decode through
  the latent cache, over prompts that reuse slots, match the reference's
  logits; each of the three published settings (YaRN ``rope_scaling``,
  ``norm_topk_prob`` false, the latent's RMSNorm) turned off alone fails
  that comparison.
- The port's YaRN frequencies, amplitude and softmax scale are the
  reference's; the file's ``port.replace`` carries the settings.
- With the defaults, MLA and the router compute the bits of the functions
  before the settings existed (transcribed below).
- The span ``model.mla_prefill`` sits under ``engine.admit`` with its
  counts and never in a decode step; the two readers of it
  (``mla_score_gib.admit``, ``host_ms.admit_mla``) by hand.
- Two tensor-parallel ranks over gloo with the settings on give one rank's
  logits.

This file imports no JAX.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from harvest_bench import run  # noqa: E402
from harvest_bench.harness import program_spans as ps  # noqa: E402
from harvest_bench.harness.check import hyperparameters  # noqa: E402
from harvest_bench.harness.loop import Window  # noqa: E402
from harvest_bench.harness.spec import BENCH_DIR, port_config, read_json  # noqa: E402
from harvest_bench.harness.weights import make_weights  # noqa: E402
from harvest_bench.reference import deepseek_v2_lite as reference  # noqa: E402
from harvest_bench.reference.common import Exact, rope_frequencies, yarn_mscale  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import rope_amplitude, rope_freqs  # noqa: E402
from repro_torch.serving.batching import GenRequest  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.spans import Record  # noqa: E402

CONFIG = read_json(BENCH_DIR / "configs" / "deepseek-v2-lite.json")
HP = hyperparameters(CONFIG, True)
# float32 on both sides with the same math; the products and sums run in
# another order (fused projections, the einsum scores), a few ulps of
# logits of magnitude 3
FORWARD_TOL = dict(atol=2e-5, rtol=1e-5)
# the engine decodes with the up-projections absorbed into the query and
# the output (products in another association than the reference's full
# forward): repro's decode==forward tolerance (tests/test_models.py)
DECODE_TOL = dict(atol=2e-4, rtol=2e-3)
SETTINGS_OFF = {"rope_scaling": (), "norm_topk_prob": True, "mla_latent_norm": False}
SRC = ROOT / "src"


def _cfg(**replace):
    return dataclasses.replace(port_config(CONFIG, rehearsal=True), **replace)


def _weights(seed):
    return make_weights(_cfg(), seed, torch.device("cpu"))


def _tokens(n, seed, vocab=None):
    return torch.randint(0, vocab or HP["vocab_size"], (1, n),
                         generator=torch.Generator().manual_seed(seed))


def _forward(w, tok, cfg):
    with torch.no_grad():
        full, _ = M.forward(M.cast_params(w, cfg), {"tokens": tok}, cfg)
    return full[0, :, :cfg.vocab_size]


def _reference(w, seqs, n_last):
    with torch.no_grad():
        return reference.logits(w, HP, seqs, n_last, Exact())


# --- against the reference ----------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_forward_matches_the_reference(seed):
    w, tok, cfg = _weights(seed), _tokens(37, seed), _cfg()
    want = _reference(w, [tok[0].tolist()], [37])[0]
    torch.testing.assert_close(_forward(w, tok, cfg), want, **FORWARD_TOL)
    with torch.no_grad():
        last, _ = M.prefill(M.cast_params(w, cfg), {"tokens": tok}, cfg)
    torch.testing.assert_close(last[0, :cfg.vocab_size], want[-1], **FORWARD_TOL)


def _engine_logits(engine):
    """Wraps the engine's picks: every served token's logits row, by request
    id in order (the admission's row, then each decode step's)."""
    seen, admitting = {}, []
    into, pick = engine._context_into_slot, engine._pick_row

    def context_into_slot(slot, req, context):
        admitting.append(req)
        return into(slot, req, context)

    def pick_row(logits):
        if admitting:
            seen.setdefault(admitting.pop().id, []).append(logits[0].clone())
        else:
            for slot, req in engine.batcher.active().items():
                seen.setdefault(req.id, []).append(logits[slot].clone())
        return pick(logits)
    engine._context_into_slot, engine._pick_row = context_into_slot, pick_row
    return seen


def test_engine_prefill_then_decode_matches_the_reference():
    """Two slots, five requests: the later ones are prefilled into slots
    whose latent cache rows still hold a longer request's entries."""
    cfg, w = _cfg(), _weights(5)
    engine = ContinuousEngine(cfg, w, n_slots=2, max_seq=40, eos_id=None, temperature=0.0,
                              device="cpu")
    seen = _engine_logits(engine)
    rng = np.random.default_rng(5)
    lengths = [(31, 7), (12, 6), (26, 8), (17, 5), (33, 6)]
    reqs = [GenRequest(id=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new=m)
            for i, (n, m) in enumerate(lengths)]
    with torch.no_grad():
        for r in reqs:
            engine.add(r)
        done = engine.run()
    assert sorted(r.id for r in done) == list(range(5))
    for r in done:
        got = torch.stack(seen[r.id])[:, :cfg.vocab_size]
        want = _reference(w, [list(r.prompt) + list(r.generated[:-1])], [len(r.generated)])[0]
        assert got.shape == want.shape == (r.max_new, cfg.vocab_size)
        torch.testing.assert_close(got, want, **DECODE_TOL)


@pytest.mark.parametrize("setting", list(SETTINGS_OFF))
def test_each_setting_off_fails_the_comparison(setting):
    """The same weights (the latent norm's weight, ones, is in the tree and
    left unread when the norm is off): each setting at the default that
    keeps repro's math moves the logits far past the tolerance."""
    w, tok = _weights(0), _tokens(37, 0)
    want = _reference(w, [tok[0].tolist()], [37])[0]
    got = _forward(w, tok, _cfg(**{setting: SETTINGS_OFF[setting]}))
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **DECODE_TOL)
    assert (got - want).abs().max() > 0.1


# --- the settings themselves ---------------------------------------------------------
@pytest.mark.parametrize("dims", [64, 8], ids=["published", "smoke"])
@pytest.mark.parametrize("mscale", [0.707, 1.0], ids=["as-published", "amplitude"])
def test_yarn_frequencies_amplitude_and_scale_are_the_references(dims, mscale):
    """At the published 64 rotary dims and the smoke 8; with ``mscale``
    1.0 against ``mscale_all_dim`` 0.707 cos and sin take an amplitude."""
    scaling = dict(CONFIG["rope_scaling"], mscale=mscale)
    cfg = _cfg(rope_scaling=scaling, qk_rope_dim=dims)
    inv, amp = rope_frequencies(dims, 10000.0, scaling)
    assert torch.equal(rope_freqs(dims, 10000.0, None, cfg.yarn), inv)
    assert rope_amplitude(cfg.yarn) == amp and (amp == 1.0) == (mscale == 0.707)
    want = (cfg.qk_nope_dim + dims) ** -0.5 * yarn_mscale(40, 0.707) ** 2
    assert attn.mla_softmax_scale(cfg) == want
    plain = _cfg(rope_scaling=())
    assert rope_freqs(8, 10000.0, None, plain.yarn).equal(rope_frequencies(8, 10000.0)[0])
    assert attn.mla_softmax_scale(plain) == (plain.qk_nope_dim + plain.qk_rope_dim) ** -0.5


@pytest.mark.parametrize("rehearsal", [True, False], ids=["rehearsal", "published"])
def test_port_config_carries_the_files_settings(rehearsal):
    cfg = port_config(CONFIG, rehearsal)
    assert dict(cfg.rope_scaling) == CONFIG["rope_scaling"]
    assert cfg.yarn["mscale_all_dim"] == 0.707 and cfg.yarn["factor"] == 40
    assert cfg.norm_topk_prob is False and cfg.mla_latent_norm is True
    specs = M.param_specs(cfg)["stack"]
    for seg in ("dense0", "moe"):
        assert specs[seg]["attn"]["kv_norm"].shape == (specs[seg]["attn"]["wq"].shape[0],
                                                       cfg.kv_lora_rank)
    assert cfg.kv_lora_rank == (32 if rehearsal else 512)


def test_the_settings_are_refused_off_mla():
    mixtral = get_config("mixtral-8x22b", smoke=True)
    with pytest.raises(ValueError, match="rope_scaling"):
        dataclasses.replace(mixtral, rope_scaling=CONFIG["rope_scaling"])
    with pytest.raises(ValueError, match="mla_latent_norm"):
        dataclasses.replace(mixtral, mla_latent_norm=True)
    with pytest.raises(ValueError, match="yarn"):
        _cfg(rope_scaling=dict(CONFIG["rope_scaling"], type="dynamic"))


# --- the defaults: the functions before the settings, transcribed ---------------------
def _rope_before(x, positions, theta):
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32) / dh))
    ang = positions[..., None].float() * inv
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _mla_before(p, x, positions, cfg):
    """(q_nope, q_rope, c_kv, k_rope, scale) of MLA before the settings."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    k_rope = _rope_before((x @ p["w_krope"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return (q_nope, _rope_before(q_rope, positions, cfg.rope_theta), x @ p["w_dkv"], k_rope,
            (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)


def _prefill_before(p, x, positions, cfg):
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope, scale = _mla_before(p, x, positions, cfg)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, cfg.n_heads, cfg.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, cfg.n_heads, cfg.v_head_dim)
    scores = (torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope)).float() * scale
    mask = positions[:, None, :] <= positions[:, :, None]
    scores = scores.masked_fill(~mask[:, None], attn.NEG_INF)
    out = torch.einsum("bhqs,bshd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.reshape(b, s, -1) @ p["wo"], torch.cat([c_kv, k_rope], dim=-1)


def _decode_before(p, x, cache, pos, cfg):
    b, r = x.shape[0], cfg.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope, scale = _mla_before(p, x, pos[:, None], cfg)
    cache = cache.clone()
    cache[torch.arange(b), pos] = torch.cat([c_kv, k_rope], dim=-1)[:, 0]
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p["w_uk"].reshape(r, cfg.n_heads, cfg.qk_nope_dim))
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, cache[..., :r])
              + torch.einsum("bqhd,bsd->bhqs", q_rope, cache[..., r:])).float() * scale
    valid = torch.arange(cache.shape[1]) <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], attn.NEG_INF)
    ctx = torch.einsum("bhqs,bsr->bqhr", torch.softmax(scores, dim=-1), cache[..., :r])
    out = torch.einsum("bqhr,rhd->bqhd", ctx, p["w_uv"].reshape(r, cfg.n_heads, cfg.v_head_dim))
    return out.reshape(b, 1, -1) @ p["wo"], cache


def test_defaults_keep_mla_and_routing_bit_for_bit():
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True), dtype="float32")
    assert cfg.rope_scaling == () and cfg.norm_topk_prob and not cfg.mla_latent_norm
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    p = {k: v[0] for k, v in params["stack"]["moe"]["attn"].items()}
    assert "kv_norm" not in p
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 11, cfg.d_model, generator=g)
    positions = torch.arange(11).expand(2, 11)
    out, latent = attn.mla_prefill(p, x, positions, cfg)
    want_out, want_latent = _prefill_before(p, x, positions, cfg)
    assert torch.equal(out, want_out) and torch.equal(latent, want_latent)
    assert torch.equal(attn.mla_attention(p, x, positions, cfg), want_out)

    cache = torch.randn(2, 16, cfg.kv_cache_head_dim, generator=g)
    pos = torch.tensor([4, 15])
    want_out, want_cache = _decode_before(p, x[:, :1], cache, pos, cfg)
    out, got_cache = attn.mla_decode(p, x[:, :1], cache.clone(), pos, cfg)
    assert torch.equal(out, want_out) and torch.equal(got_cache, want_cache)

    router = params["stack"]["moe"]["moe"]["router"][0]
    probs = torch.softmax(x.reshape(-1, cfg.d_model) @ router, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
    weights, got_idx, _ = moe.route(router, x.reshape(-1, cfg.d_model), cfg)
    assert torch.equal(got_idx, idx)
    assert torch.equal(weights, top / top.sum(dim=-1, keepdim=True))
    kept, _, _ = moe.route(router, x.reshape(-1, cfg.d_model),
                           dataclasses.replace(cfg, norm_topk_prob=False))
    assert torch.equal(kept, top)


# --- the span and its readers ----------------------------------------------------------
def test_mla_prefill_span_sits_under_admit_and_never_in_a_decode_step():
    cfg = _cfg()
    engine = ContinuousEngine(cfg, _weights(1), n_slots=2, max_seq=40, eos_id=None,
                              device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (21, 9, 30)]
    spans.clear()
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            engine.add(GenRequest(id=i, prompt=prompt, max_new=4))
        engine.run()
    recs = spans.records()
    by_seq = {r.seq: r for r in recs}
    admits = [r for r in recs if r.name == "engine.admit"]
    layers = [r for r in recs if r.name == "model.mla_prefill"]
    assert len(admits) == 3 and len(layers) == 3 * cfg.n_layers
    for a, prompt in zip(sorted(admits, key=lambda r: r.id), prompts):
        kids = [r for r in layers if r.parent == a.seq]
        s = len(prompt)
        assert [k.counts for k in kids] == [{"tokens": s,
                                              "score_bytes": cfg.n_heads * s * s * 4}] * cfg.n_layers
        # the MoE spans stay the admission's own children
        assert [r.name for r in recs if r.parent == a.seq].count("model.moe") == cfg.n_layers - 1
    assert {by_seq[r.parent].name for r in layers} == {"engine.admit"}
    steps = [r for r in recs if r.name == "model.decode_step"]
    assert len(steps) == engine.n_decode_steps > 0
    assert not [r for r in recs if r.parent in {d.seq for d in steps}
                and r.name == "model.mla_prefill"]


MS = 1_000_000     # ns
READERS = ("mla_score_gib.admit", "host_ms.admit_mla")


def _admission(seq, t_ms, s, layer_ms, n_layers=3, parent=None):
    """An admission at ``t_ms`` of an ``s``-token prompt: ``n_layers`` MLA
    prefill spans of ``layer_ms`` each, then a MoE span, inside it."""
    t0 = t_ms * MS
    out = []
    for i in range(n_layers):
        a = t0 + i * 2 * layer_ms * MS
        out.append(Record(seq + 1 + i, "model.mla_prefill", a, a + layer_ms * MS, seq, None,
                          {"tokens": s, "score_bytes": 16 * s * s * 4}))
    end = t0 + n_layers * 2 * layer_ms * MS
    out.append(Record(seq + 1 + n_layers, "model.moe", end - MS // 2, end, seq, None,
                      {"rows": 6 * s, "rows_launched": 8 * s}))
    out.append(Record(seq, "engine.admit", t0, end + MS // 10, parent, seq, None))
    return out


def _made_run(recs, monkeypatch, recorder=True):
    class Recorder:
        def records(self):
            return recs

        def dropped(self):
            return 0
    monkeypatch.setattr(ps, "recorder", lambda: Recorder() if recorder else None)
    return SimpleNamespace(window=Window(t0=1.0, stop=3.0), trace={"window_s": 0.5})


def test_readers_by_hand(monkeypatch):
    recs = (_admission(0, 900, 8192, 5)          # before the window
            + _admission(10, 1000, 4096, 2)
            + _admission(20, 1100, 2048, 1)
            + _admission(30, 1200, 8192, 4)
            + _admission(40, 2600, 4096, 9))     # in the profiled part
    got = {m: run.load_reader(m)(_made_run(recs, monkeypatch)) for m in READERS}
    assert got["mla_score_gib.admit"] == pytest.approx(16 * 4096 ** 2 * 4 / 2 ** 30)  # 1 GiB
    assert got["host_ms.admit_mla"] == pytest.approx(6.0)                            # 3 x 2 ms
    # a port without the span: admissions with their MoE spans only
    bare = [r for r in recs if r.name != "model.mla_prefill"]
    assert [run.load_reader(m)(_made_run(bare, monkeypatch)) for m in READERS] == [None] * 2
    assert [run.load_reader(m)(_made_run(recs, monkeypatch, recorder=False))
            for m in READERS] == [None] * 2


# --- two tensor-parallel ranks ---------------------------------------------------------
TP_SCRIPT = textwrap.dedent('''
    import dataclasses, json, pickle, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.models import model as M


    def published(scaling):
        return dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                                   dtype="float32", rope_scaling=scaling, norm_topk_prob=False,
                                   mla_latent_norm=True)


    def logits(cfg, tokens, tp=None):
        """The full forward's logits, the prefill's and one decode step's."""
        params = M.cast_params(
            M.init_params(cfg, torch.Generator().manual_seed(4), "cpu", tp=tp), cfg)
        with torch.no_grad():
            full, _ = M.forward(params, {"tokens": tokens}, cfg, tp)
            last, cache = M.prefill(params, {"tokens": tokens[:, :-1]}, cfg, tp)
            cache = M.tree_map(lambda t: torch.cat(
                [t, torch.zeros(t.shape[:2] + (4,) + t.shape[3:])], dim=2), cache)
            step, _ = M.decode_step(params, tokens[:, -1:], cache,
                                    tokens.shape[1] - 1, cfg, tp)
        return {"full": full, "last": last, "step": step}


    def rank_main(tp, scaling, tokens):
        torch.set_num_threads(1)
        return logits(published(scaling), tokens, tp)


    if __name__ == "__main__":
        scaling, tokens, out = json.loads(sys.argv[1]), torch.tensor(json.loads(sys.argv[2])), sys.argv[3]
        ranks = T.spawn_tp(rank_main, 2, device="cpu", args=(scaling, tokens), timeout=100)
        with open(out, "wb") as f:
            pickle.dump({"ranks": ranks, "one": logits(published(scaling), tokens)}, f)
''')


def test_two_ranks_give_one_ranks_logits(tmp_path):
    """The settings under TP 2: the heads split, the latent and its norm
    whole on each rank, the experts split; the whole logits of the
    forward, the prefill and a decode step within the port's TP tolerance
    of one rank (``tests/_torch_parity.py``'s F32_TOL, 5e-5/5e-4)."""
    script = tmp_path / "tp_ranks.py"
    script.write_text(TP_SCRIPT)
    tokens = _tokens(14, 9, vocab=128).repeat(2, 1)
    tokens[1] = tokens[1].flip(0)
    out = tmp_path / "out.pkl"
    subprocess.run([sys.executable, str(script), json.dumps(CONFIG["rope_scaling"]),
                    json.dumps(tokens.tolist()), str(out)], check=True, timeout=170,
                   env=dict(os.environ, PYTHONPATH=str(SRC)))
    with open(out, "rb") as f:
        got = pickle.load(f)
    for rank in got["ranks"]:
        for key, want in got["one"].items():
            torch.testing.assert_close(rank[key], want, atol=5e-5, rtol=5e-4)

"""Physical tensor parallelism in the port (``repro_torch.distributed.
tensor_parallel``) against ``repro`` on one device, on the CPU at float32.

Ranks are processes of their own over gloo, started by ``spawn_tp`` (a
``file://`` store) from a script that a subprocess runs under a timeout of
its own, so a hung rendezvous fails the test and not the suite's clock.
Each group of ranks starts once per module: two ranks, then four; the
checks read what the ranks wrote.

- Logits: qwen2.5-3b's smoke config (4 query heads on 1 KV head, so 2 and
  4 ranks replicate the KV head) on 2 and 4 ranks against ``repro``'s
  embedding, attention block, MLP, head, ``prefill`` and ``decode_step`` on
  one device, from the same numpy weights, at 5e-5/5e-4.
- Streams: the port's ``ElasticReplica`` on 2 ranks equals ``repro``'s on
  2 devices and the port's one-device replica token for token at
  temperature 0.
- A physical shrink 2 -> 1 in the middle of the streams in each KV mode:
  every leaf whole on the survivor, nothing on the leaving rank, the
  streams and ``MigrationRecord``s equal to ``repro``'s run (under
  ``migrate_int8`` the records and completions, as ``repro``'s test does);
  a grow 1 -> 2 ends with the unbroken run's streams, and so do 4 ranks
  resized 4 -> 2 -> 4 -> 1.
- The platform: ``sharded-serving`` over 2 ranks ends a short
  ``elastic_storm`` with ``repro``'s gang counters and outcomes.
- The rules: every family gets its rank's heads (and SSM widths) under a
  group of more than one rank, the frontends included; a config that
  does not split raises; ranks that share a device use gloo.
"""
import dataclasses
import itertools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.platform as jplat
from _torch_parity import F32_TOL, close, configs, params
from repro.distributed.elastic_serving import ElasticReplica as JaxReplica
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving.batching import GenRequest as JaxGenRequest
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import tensor_parallel as T
from repro_torch.distributed.elastic_serving import ElasticReplica
from repro_torch.models.model import tree_leaves
from repro_torch.serving.batching import GenRequest

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
RECORD_FIELDS = ("n_before", "n_after", "kv_mode", "param_bytes", "kv_bytes",
                 "wire_bytes", "n_requests_live")
KV_MODES = ("migrate", "replay", "migrate_int8")
STORM_S = 240.0
B, S, N_DECODE = 2, 7, 3

# the ranks' program: ``python tp_ranks.py <world> <inputs.pkl> <out.pkl>``
_RANKS = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.elastic_serving import ElasticReplica, serving_mesh
    from repro_torch.distributed.sharding import mesh_device
    from repro_torch.models import model as M
    from repro_torch.models.attention import gqa_attention
    from repro_torch.models.layers import apply_mlp, embed_tokens, logits_from_hidden
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.serving.batching import GenRequest


    def layer0(tree):
        return {k: layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


    def leaves(tree):
        return [] if tree is None else M.tree_leaves(tree)


    def requests(d):
        return [GenRequest(id=i, prompt=list(p), max_new=d["max_new"])
                for i, p in enumerate(d["prompts"])]


    def served(rep, d, plan=()):
        """Rank 0 drives the replica, resizing it to ``n`` after ``steps``
        for each (steps, n) of ``plan``; the others follow. Each rank
        returns what it holds after."""
        out = {}
        if rep.tp.rank == 0:
            reqs = requests(d)
            for r in reqs:
                rep.add(r)
            out["records"] = []
            for steps, n in plan:
                for _ in range(steps):
                    rep.step()
                out["records"].append(dataclasses.asdict(rep.resize(n)))
            out["record"] = out["records"][0] if plan else None
            out["streams"] = {r.id: list(r.generated) for r in rep.run()}
            rep.close()
        else:
            rep.follow()
        out["in_gang"] = rep.in_gang
        out["engine"] = rep.engine is not None
        out["leaves"] = [(tuple(t.shape), str(t.device)) for t in leaves(rep.params)]
        out["cache"] = [tuple(t.shape) for t in leaves(rep.engine and rep.engine.cache)]
        out["last_resize"] = rep.last_resize
        return out


    def rank_main(tp, d):
        torch.set_num_threads(1)
        cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype="float32")
        shard = params_from_numpy(d["params"], cfg, "cpu", tp)
        local = T.tp_local(cfg, tp)
        out = {"backend": tp.backend, "local": (local.n_heads, local.n_kv_heads, local.d_ff),
               "mesh_device": str(mesh_device(serving_mesh(tp.size, tp=tp)))}
        tok = torch.as_tensor(d["tokens"])
        x = torch.as_tensor(d["x"])
        pos = torch.arange(x.shape[1]).expand(x.shape[0], x.shape[1])
        l0 = layer0(shard["stack"]["dense"])
        out["embed"] = embed_tokens(shard["embed"], tok, cfg, tp).numpy()
        out["attention"] = gqa_attention(l0["attn"], x, pos, local, tp).numpy()
        out["mlp"] = apply_mlp(l0["mlp"], x, cfg, tp).numpy()
        out["head"] = logits_from_hidden(shard["embed"]["tokens"].T, x, cfg, tp).numpy()
        logits, pre = M.prefill(shard, {"tokens": tok}, cfg, tp)
        out["prefill"] = logits.numpy()
        cache = M.init_cache(cfg, tok.shape[0], tok.shape[1] + d["next"].shape[1], "cpu", tp)
        for key in ("k", "v"):
            cache["dense"][key][:, :, :tok.shape[1]] = pre["dense"][key]
        out["cache_shape"] = tuple(cache["dense"]["k"].shape)
        out["decode"] = []
        for i in range(d["next"].shape[1]):
            logits, cache = M.decode_step(shard, torch.as_tensor(d["next"][:, i:i + 1]), cache,
                                          tok.shape[1] + i, cfg, tp)
            out["decode"].append(logits.numpy())
        full = params_from_numpy(d["params"], cfg, "cpu")
        kw = dict(n_slots=2, tp=tp)
        if tp.size == 4:
            # subgroups of 2 made and dropped, survivors besides rank 0, 3 joiners
            out["resizes"] = served(ElasticReplica(cfg, full, 4, **kw), d,
                                    ((2, 2), (2, 4), (2, 1)))
            return out
        out["tp2"] = served(ElasticReplica(cfg, full, 2, **kw), d)
        for mode in ("migrate", "replay", "migrate_int8"):
            out[mode] = served(ElasticReplica(cfg, full, 2, kv_mode=mode, **kw), d, ((4, 1),))
        out["grow"] = served(ElasticReplica(cfg, full, 1, **kw), d, ((4, 2),))
        out["storm"] = storm(tp, d)
        return out


    def storm(tp, d):
        """``elastic_storm`` with ``sharded-serving`` over the group: rank 0
        runs the platform, rank 1 serves its calls in the factory."""
        import itertools
        import repro_torch.core.queues as queues
        import repro_torch.platform as plat
        import repro_torch.platform.elastic as elastic
        queues._REQ_IDS, elastic._GANG_IDS = itertools.count(), itertools.count()
        if tp.rank != 0:
            assert plat.build_sharded_serving(None, tp=tp, gang_size=3, device="cpu") is None
            return None
        sc = plat.ScenarioConfig.elastic_storm(duration=d["storm_s"])
        sc.platform.executor = "sharded-serving"
        sc.platform.executor_params = {"device": "cpu", "n_new": 4, "tp": tp}
        p = plat.Platform.build(sc)
        res = p.run()
        p.executor.replica.close()
        m = p.metrics
        return {"outcomes": res.outcome_counts,
                "counters": {name: {str(k): c.value for k, c in m.counters_matching(name).items()}
                             for name in d["counters"]},
                "migrations": len(p.executor.replica.migrations),
                "mesh_size": p.executor.replica.mesh_size}


    if __name__ == "__main__":
        world, inputs, output = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        with open(inputs, "rb") as f:
            d = pickle.load(f)
        results = T.spawn_tp(rank_main, world, device="cpu", args=(d,), timeout=100)
        with open(output, "wb") as f:
            pickle.dump(results, f)
''')

COUNTERS = ("gang_migrations_total", "gang_migrated_bytes_total", "gang_wire_bytes_total",
            "gang_replica_losses_total")


def _requests(cls, cfg, n=3, max_new=8):
    rng = np.random.default_rng(3)
    return [cls(id=i, prompt=rng.integers(0, cfg.vocab_size, size=5 + i).tolist(),
                max_new=max_new) for i in range(n)]


@pytest.fixture(scope="module")
def qwen():
    jc, tc = configs("qwen2.5-3b")
    jp, tp = params(jc, tc)
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def inputs(qwen):
    jc, _, jp, _ = qwen
    rng = np.random.default_rng(23)
    return {"params": jax.tree.map(np.asarray, jp),
            "tokens": rng.integers(0, jc.vocab_size, size=(B, S)),
            "next": rng.integers(0, jc.vocab_size, size=(B, N_DECODE)),
            "x": rng.standard_normal((B, S, jc.d_model), dtype=np.float32),
            "prompts": [r.prompt for r in _requests(GenRequest, jc)], "max_new": 8,
            "storm_s": STORM_S, "counters": COUNTERS}


def _start(world: int, inputs, tmp: Path):
    """Start ``world`` ranks in the background; returns a function that
    waits for them (120 s at most) and gives each rank's results."""
    script = tmp / "tp_ranks.py"
    script.write_text(_RANKS)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    proc = subprocess.Popen([sys.executable, str(script), str(world), str(tmp / "in.pkl"),
                             str(tmp / "out.pkl")],
                            env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=str(tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            raise AssertionError(f"{world} ranks: no end within 120 s\n{err[-4000:]}")
        assert proc.returncode == 0, err[-4000:]
        with open(tmp / "out.pkl", "rb") as f:
            return pickle.load(f)
    return wait


def _storm_counters(plat, **params):
    with pytest.MonkeyPatch.context() as mp:
        import repro.core.queues as jqueues
        import repro.platform.elastic as jelastic
        mp.setattr(jqueues, "_REQ_IDS", itertools.count())
        mp.setattr(jelastic, "_GANG_IDS", itertools.count())
        sc = plat.ScenarioConfig.elastic_storm(duration=STORM_S)
        sc.platform.executor = "sharded-serving"
        sc.platform.executor_params = {"n_new": 4, **params}
        p = plat.Platform.build(sc)
        res = p.run()
    m = p.metrics
    return {"outcomes": res.outcome_counts,
            "counters": {name: {str(k): c.value for k, c in m.counters_matching(name).items()}
                         for name in COUNTERS},
            "migrations": len(p.executor.replica.migrations)}


def _jax_run(rep, reqs, steps=None, n_after=None):
    for r in reqs:
        rep.add(r)
    rec = None
    if n_after is not None:
        for _ in range(steps):
            rep.step()
        rec = rep.resize(n_after)
    return {r.id: list(r.generated) for r in rep.run()}, rec


@pytest.fixture(scope="module")
def runs(qwen, inputs, tmp_path_factory):
    """Both groups of ranks, and ``repro``'s references computed while the
    ranks run: the two-device replica, the shrinks in each KV mode and the
    storm; the port's one-device replica."""
    jc, tc, jp, tp = qwen
    wait2 = _start(2, inputs, tmp_path_factory.mktemp("tp2"))
    wait4 = _start(4, inputs, tmp_path_factory.mktemp("tp4"))
    devs = jax.devices()[:2]
    ref = {"tp2": _jax_run(JaxReplica(jc, jp, 2, n_slots=2, devices=devs),
                           _requests(JaxGenRequest, jc))[0]}
    for mode in KV_MODES:
        ref[mode] = _jax_run(JaxReplica(jc, jp, 2, n_slots=2, kv_mode=mode, devices=devs),
                             _requests(JaxGenRequest, jc), 4, 1)
    ref["storm"] = _storm_counters(jplat)
    one = _jax_run(ElasticReplica(tc, tp, 1, n_slots=2, device="cpu"),
                   _requests(GenRequest, tc))[0]
    return {2: wait2(), 4: wait4(), "repro": ref, "one": one}


# --- logits -----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(qwen, inputs):
    """``repro``'s outputs of every part on one device."""
    jc, _, jp, _ = qwen
    tok = jnp.asarray(inputs["tokens"], jnp.int32)
    x = jnp.asarray(inputs["x"])
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    l0 = jax.tree.map(lambda v: v[0], jp["stack"]["dense"])
    out = {"embed": jlayers.embed_tokens(jp["embed"], tok, jc),
           "attention": jattn.gqa_attention(l0["attn"], x, pos, jc),
           "mlp": jlayers.apply_mlp(l0["mlp"], x, jc),
           "head": jlayers.logits_from_hidden(jp["embed"]["tokens"].T, x, jc)}
    logits, pre = jmodel.prefill(jp, {"tokens": tok}, jc)
    out["prefill"] = logits
    cache = jax.tree.map(lambda z, c: z.at[:, :, :S].set(c),
                         jmodel.init_cache(jc, B, S + N_DECODE), pre)
    out["decode"] = []
    for i in range(N_DECODE):
        logits, cache = jmodel.decode_step(jp, jnp.asarray(inputs["next"][:, i:i + 1], jnp.int32),
                                           cache, S + i, jc)
        out["decode"].append(logits)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("part", ["embed", "attention", "mlp", "head", "prefill", "decode"])
def test_logits_equal_repros_on_one_device(qwen, reference, runs, world, part):
    tc = qwen[1]
    want = reference[part]
    for rank, got in enumerate(runs[world]):
        if part == "decode":
            assert len(got[part]) == N_DECODE
            for g, w in zip(got[part], want):
                close(g, w, F32_TOL)
        else:
            close(got[part], want, F32_TOL)
        assert got["backend"] == "gloo" and got["mesh_device"] == "cpu", rank
        # the one KV head replicated on every rank
        assert got["local"] == (tc.n_heads // world, 1, tc.d_ff // world)
        assert got["cache_shape"] == (tc.n_layers, B, S + N_DECODE, 1, tc.head_dim)


# --- streams, resizes, the platform --------------------------------------------------------
def test_two_ranks_stream_like_repros_two_devices_and_one_device(runs):
    got = runs[2][0]["tp2"]["streams"]
    assert got == runs["repro"]["tp2"] == runs["one"]
    assert sorted(got) == [0, 1, 2] and all(len(s) == 8 for s in got.values())
    for rank in (0, 1):
        held = runs[2][rank]["tp2"]
        assert held["in_gang"] and held["engine"]


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_physical_shrink_lands_on_the_survivor_like_repro(qwen, runs, kv_mode):
    _, tc, _, tp = qwen
    survivor, leaver = runs[2][0][kv_mode], runs[2][1][kv_mode]
    jstreams, jrec = runs["repro"][kv_mode]
    rec = survivor["record"]
    assert {f: rec[f] for f in RECORD_FIELDS} == {f: getattr(jrec, f) for f in RECORD_FIELDS}
    assert (rec["n_before"], rec["n_after"]) == (2, 1)
    if kv_mode == "migrate_int8":
        assert set(survivor["streams"]) == set(jstreams)
        assert all(len(s) == 8 for s in survivor["streams"].values())
    else:
        assert survivor["streams"] == jstreams == runs["one"]
    # every leaf whole on the survivor; nothing left on the leaving rank
    whole = [(tuple(t.shape), "cpu") for t in tree_leaves(tp)]
    assert survivor["leaves"] == whole and survivor["in_gang"] and survivor["engine"]
    assert survivor["cache"] == [(tc.n_layers, 2, 64, tc.n_kv_heads, tc.head_dim)] * 2
    assert leaver == {"in_gang": False, "engine": False, "leaves": [], "cache": [],
                      "last_resize": survivor["last_resize"]}
    assert survivor["last_resize"]["gathered_bytes"] > 0
    assert survivor["last_resize"]["shipped_bytes"] == 0


def test_physical_grow_finishes_with_the_unbroken_streams(runs):
    first, joiner = runs[2][0]["grow"], runs[2][1]["grow"]
    assert first["streams"] == runs["one"]
    assert (first["record"]["n_before"], first["record"]["n_after"]) == (1, 2)
    assert joiner["in_gang"] and joiner["engine"] and joiner["leaves"]
    assert [s for s, _ in joiner["leaves"]] == [s for s, _ in first["leaves"]]
    assert joiner["last_resize"]["shipped_bytes"] == first["last_resize"]["shipped_bytes"] > 0


def test_four_ranks_resize_through_subgroups_with_the_unbroken_streams(runs):
    """4 -> 2 -> 4 -> 1 ranks, two decode steps apart: a subgroup of 2
    made, the joining ranks fed by rank 0 while rank 1 survives, all but
    rank 0 leaving at the end."""
    first = runs[4][0]["resizes"]
    assert first["streams"] == runs["one"]
    assert [(r["n_before"], r["n_after"]) for r in first["records"]] == [(4, 2), (2, 4), (4, 1)]
    assert first["in_gang"] and [r["resizes"]["in_gang"] for r in runs[4][1:]] == [False] * 3
    assert all(r["resizes"]["leaves"] == [] for r in runs[4][1:])


def test_sharded_serving_over_two_ranks_ends_with_repros_counters(runs):
    got, want = runs[2][0]["storm"], runs["repro"]["storm"]
    assert got["mesh_size"] in (1, 2) and got["migrations"] > 0
    assert {k: got[k] for k in want} == want
    assert runs[2][1]["storm"] is None


# --- the rules ---------------------------------------------------------------------------
def test_architectures_outside_the_slice_raise_under_a_group():
    """Every family now splits, the frontends too (hubert's audio encoder
    and internvl2's vision model get their rank's heads like the dense
    family); what still raises is a config that does not divide over the
    ranks, naming what does not."""
    group = T.TPGroup(None, 0, 2, torch.device("cpu"), (torch.device("cpu"),) * 2, "gloo")
    covered = {a for a in ARCH_IDS if get_config(a).family in ("dense", "moe", "ssm", "hybrid")
               and get_config(a).frontend is None}
    assert {"qwen2.5-3b", "mixtral-8x22b", "deepseek-v2-lite-16b", "mamba2-2.7b",
            "zamba2-2.7b"} <= covered
    assert set(ARCH_IDS) - covered == {"hubert-xlarge", "internvl2-26b"}
    for arch in sorted(ARCH_IDS):
        cfg = get_config(arch)
        assert T.tp_local(cfg, None) is cfg
        local = T.tp_local(cfg, group)
        # the rank's heads; the MoE family keeps the global experts and top_k
        assert local.n_heads == cfg.n_heads // 2
        assert local.n_kv_heads == (max(1, cfg.n_kv_heads // 2) if cfg.n_kv_heads else 0)
        assert (local.n_experts, local.top_k) == (cfg.n_experts, cfg.top_k)
        assert (local.d_ff, local.vocab_padded, local.frontend) == (
            cfg.d_ff // 2, cfg.vocab_padded, cfg.frontend)
        if cfg.family in ("ssm", "hybrid"):
            # the rank's SSM widths: half the heads, the one B/C group whole
            loc = T.ssm_local(local, group)
            assert (loc.n_heads, loc.first_head) == (cfg.n_ssm_heads // 2, 0)
            assert loc.d_inner == cfg.d_inner // 2
            assert (loc.n_groups, loc.first_group) == (cfg.ssm_ngroups, 0) == (1, 0)
            assert loc.conv_dim == cfg.d_inner // 2 + 2 * cfg.ssm_state
            assert T.ssm_local(local, None) == T.ssm_local(cfg, None)
            assert T.ssm_local(cfg, None).conv_dim == cfg.conv_dim
    # hubert at TP 2: 8 query heads of 80 on 8 KV heads, its padded
    # vocabulary of 512 split in the head's columns; internvl2: 24 on 4
    hub = T.tp_local(get_config("hubert-xlarge"), group)
    assert (hub.n_heads, hub.n_kv_heads, hub.head_dim) == (8, 8, 80)
    vl = T.tp_local(get_config("internvl2-26b"), group)
    assert (vl.n_heads, vl.n_kv_heads, vl.head_dim) == (24, 4, 128)
    assert T.backend_for(["cpu", "cpu"]) == "gloo"
    assert T.backend_for(["cuda:0", "cuda:0"]) == "gloo"   # two ranks on one card
    assert T.backend_for(["cuda:0", "cpu"]) == "gloo"
    assert T.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert T.backend_for(["cuda:0"]) == "nccl"
    with pytest.raises(ValueError, match="do not split"):
        T.tp_local(dataclasses.replace(get_config("qwen2.5-3b"), n_heads=15), group)
    three = T.TPGroup(None, 0, 3, torch.device("cpu"), (torch.device("cpu"),) * 3, "gloo")
    with pytest.raises(ValueError, match="vocab_padded 512 .*the head's columns"):
        T.tp_local(get_config("hubert-xlarge"), three)
    with pytest.raises(ValueError, match="do not split"):
        ElasticReplica(dataclasses.replace(get_config("internvl2-26b", smoke=True), n_heads=7),
                       {}, 2, tp=group)


def test_init_tp_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.init_tp(1, 0, "file:///nonexistent")
    one = T.TPGroup(None, 0, 1, torch.device("cpu"), (torch.device("cpu"),), "gloo")
    x = torch.ones(2, 3)
    assert T.all_sum(x, None) is x and T.gather_last(x, one) is x
    assert T.row_parallel(x, torch.ones(3, 4), one).shape == (2, 4)

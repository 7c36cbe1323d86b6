"""Tensor parallelism for the MoE family, GQA and MLA, in the port
(``repro_torch.distributed.tensor_parallel``) against ``repro``, on the CPU
at float32.

As in ``tests/test_torch_tp.py``, ranks are processes of their own over
gloo, started by ``spawn_tp`` from a script that a subprocess runs under a
timeout of its own; one group of two ranks and one of four start once for
the module, and ``repro``'s references are computed while they run.

- Blocks and logits: mixtral-8x22b's smoke config (4 experts top-2, 4 query
  heads on 2 KV heads) and deepseek-v2-lite-16b's (8 experts top-2, one
  shared expert, a dense layer 0, MLA) on 2 and 4 ranks, from the same
  numpy weights, against ``repro``'s MoE block, MLA block, ``prefill`` and
  ``decode_step`` on one device at 5e-5/5e-4, under ``moe_impl`` ``ragged``,
  ``scatter`` (a capacity factor of 0.5, so tokens drop), ``dense`` (the
  oracle, its MoE block only), and
  the two ``gmm`` twins under ``auto`` (the plain versions of ``moe_gmm``
  on the CPU, held against ``repro``'s reference impl of the same drops);
  an in-expert variant of each with 6 experts, which 4 ranks do not divide
  (``repro``'s ``param_specs`` takes ``_EXPERT_RULES_TP`` there). Every
  rank's top-k picks are the same.
- Shards: ``local_shard`` of every leaf of all ten full configs on ``meta``
  against ``repro``'s ``param_specs`` shard shapes over a ``model`` axis of
  2 and of 4, and ``assemble_shards`` giving the whole leaf back (at smoke
  size with values, bit for bit); ``init_params`` under a group equal to
  the cut of the whole tree.
- Streams: the port's ``ElasticReplica`` on 2 ranks (from the whole
  parameters, and from each rank's shards alone) equals ``repro``'s on 2
  devices and the port's one-device replica token for token at
  temperature 0; a physical shrink 2 -> 1 in each KV mode gives
  ``repro``'s ``MigrationRecord``s; a grow 1 -> 2 ends with the unbroken
  streams; 4 ranks of the in-expert variant resize 4 -> 2 -> 1, from
  in-expert to expert-parallel to whole.
- The platform: ``sharded-serving`` with deepseek over 2 ranks ends a short
  ``elastic_storm`` with ``repro``'s counters and outcomes.
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
from _torch_parity import F32_TOL, close, configs
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jshard
from repro.distributed.elastic_serving import ElasticReplica as JaxReplica
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving.batching import GenRequest as JaxGenRequest
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as tshard
from repro_torch.distributed import tensor_parallel as T
from repro_torch.distributed.elastic_serving import ElasticReplica
from repro_torch.models import model as tmodel
from repro_torch.models.moe import _capacity
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving.batching import GenRequest

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("mixtral-8x22b", "deepseek-v2-lite-16b")
RECORD_FIELDS = ("n_before", "n_after", "kv_mode", "param_bytes", "kv_bytes",
                 "wire_bytes", "n_requests_live")
KV_MODES = ("migrate", "replay", "migrate_int8")
STORM_S = 240.0
B, S, N_DECODE = 2, 9, 3
# (name, kernel policy, config overrides): the port's impl under the policy
# and repro's reference impl with the same drops
VARIANTS = (("ragged", "reference", {}),
            ("scatter", "reference", {"moe_impl": "scatter", "capacity_factor": 0.5}),
            ("dense", "reference", {"moe_impl": "dense"}),
            ("gmm dropless", "auto", {}),
            ("gmm capacity", "auto", {"moe_impl": "scatter", "capacity_factor": 0.5}),
            ("in-expert", "reference", {"n_experts": 6}),
            ("in-expert gmm", "auto", {"n_experts": 6}))
COUNTERS = ("gang_migrations_total", "gang_migrated_bytes_total", "gang_wire_bytes_total",
            "gang_replica_losses_total")

# the ranks' program: ``python tp_moe_ranks.py <world> <inputs.pkl> <out.pkl>``
_RANKS = textwrap.dedent('''
    import dataclasses, sys
    import pickle
    import torch

    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.models import model as M
    from repro_torch.models.attention import mla_decode, mla_prefill
    from repro_torch.models.moe import apply_moe, route
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.serving.batching import GenRequest


    def config(arch, impls, overrides):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **overrides)
        return with_kernel_impls(cfg, impls)


    def layer0(tree):
        return {k: layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


    def served(rep, d, plan=()):
        """Rank 0 drives the replica, resizing it to ``n`` after ``steps``
        for each (steps, n) of ``plan``; the others follow."""
        out = {}
        if rep.tp.rank == 0:
            for i, p in enumerate(d["prompts"]):
                rep.add(GenRequest(id=i, prompt=list(p), max_new=d["max_new"]))
            out["records"] = []
            for steps, n in plan:
                for _ in range(steps):
                    rep.step()
                out["records"].append(dataclasses.asdict(rep.resize(n)))
            out["streams"] = {r.id: list(r.generated) for r in rep.run()}
            rep.close()
        else:
            rep.follow()
        out["in_gang"] = rep.in_gang
        out["leaves"] = [tuple(t.shape) for t in M.tree_leaves(rep.params or {})]
        out["last_resize"] = rep.last_resize
        return out


    def blocks(tp, d, arch, name, impls, overrides):
        """The MoE block, the ranks' picks, the MLA block, prefill and
        decode_step of one variant on this rank's shards."""
        cfg = config(arch, impls, overrides)
        local = T.tp_local(cfg, tp)
        shard = params_from_numpy(d["params"][arch, cfg.n_experts], cfg, "cpu", tp)
        x = torch.as_tensor(d["x"])
        tok = torch.as_tensor(d["tokens"])
        pos = torch.arange(x.shape[1]).expand(x.shape[0], x.shape[1])
        out = {"local": (local.n_heads, local.n_kv_heads, local.n_experts, local.top_k,
                         local.moe_d_ff, local.d_ff),
               "experts": T.expert_span(cfg, tp)}
        moe = layer0(shard["stack"]["moe"]["moe"])
        x_moe = torch.as_tensor(d["x_moe"])
        out["moe"] = apply_moe(moe, x_moe, local, tp=tp)[0].numpy()
        out["idx"] = route(moe["router"], x_moe.reshape(-1, x.shape[-1]), local)[1].numpy()
        if cfg.use_mla and name == "ragged":
            attn = layer0(shard["stack"]["dense0"]["attn"])
            o, lat = mla_prefill(attn, x, pos, local, tp)
            cache = torch.zeros(x.shape[0], x.shape[1] + 1, lat.shape[-1])
            cache[:, :x.shape[1]] = lat
            dec, _ = mla_decode(attn, torch.as_tensor(d["x_next"]), cache, x.shape[1], local, tp)
            out["mla"], out["latent"], out["mla_decode"] = o.numpy(), lat.numpy(), dec.numpy()
        logits, pre = M.prefill(shard, {"tokens": tok}, cfg, tp)
        out["prefill"] = logits.numpy()
        cache = M.init_cache(cfg, tok.shape[0], tok.shape[1] + d["next"].shape[1], "cpu", tp)
        for seg in pre:
            for key in pre[seg]:
                cache[seg][key][:, :, :tok.shape[1]] = pre[seg][key]
        out["cache"] = {seg: {k: tuple(v.shape) for k, v in c.items()} for seg, c in cache.items()}
        out["decode"] = []
        for i in range(d["next"].shape[1]):
            logits, cache = M.decode_step(shard, torch.as_tensor(d["next"][:, i:i + 1]), cache,
                                          tok.shape[1] + i, cfg, tp)
            out["decode"].append(logits.numpy())
        return out


    def rank_main(tp, d):
        torch.set_num_threads(1)
        out = {"blocks": {(arch, name): blocks(tp, d, arch, name, impls, ov)
                          for arch in d["archs"] for name, impls, ov in d["variants"]}}
        kw = dict(n_slots=2, tp=tp)
        if tp.size == 4:
            # in-expert at 4 ranks, expert-parallel at 2, whole at 1
            cfg = config("deepseek-v2-lite-16b", "reference", {"n_experts": 6})
            full = params_from_numpy(d["params"]["deepseek-v2-lite-16b", 6], cfg, "cpu")
            out["resizes"] = served(ElasticReplica(cfg, full, 4, **kw), d, ((2, 2), (2, 1)))
            return out
        for arch in d["archs"]:
            cfg = config(arch, "reference", {})
            numpy_params = d["params"][arch, cfg.n_experts]
            full = params_from_numpy(numpy_params, cfg, "cpu")
            out[arch, "tp2"] = served(ElasticReplica(cfg, full, 2, **kw), d)
            shard = params_from_numpy(numpy_params, cfg, "cpu", tp)
            out[arch, "sharded"] = served(ElasticReplica(cfg, shard, 2, sharded=True, **kw), d)
            for mode in d["kv_modes"][arch]:
                out[arch, mode] = served(ElasticReplica(cfg, full, 2, kv_mode=mode, **kw), d,
                                         ((4, 1),))
            out[arch, "grow"] = served(ElasticReplica(cfg, full, 1, **kw), d, ((4, 2),))
        out["storm"] = storm(tp, d)
        return out


    def storm(tp, d):
        """``elastic_storm`` with ``sharded-serving`` hosting deepseek over
        the group: rank 0 runs the platform, rank 1 serves its calls."""
        import itertools
        import repro_torch.core.queues as queues
        import repro_torch.platform as plat
        import repro_torch.platform.elastic as elastic
        queues._REQ_IDS, elastic._GANG_IDS = itertools.count(), itertools.count()
        arch = "deepseek-v2-lite-16b"
        if tp.rank != 0:
            assert plat.build_sharded_serving(None, arch=arch, tp=tp, gang_size=3,
                                              device="cpu") is None
            return None
        sc = plat.ScenarioConfig.elastic_storm(duration=d["storm_s"])
        sc.platform.executor = "sharded-serving"
        sc.platform.model = arch
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
        results = T.spawn_tp(rank_main, world, device="cpu", args=(d,), timeout=150)
        with open(output, "wb") as f:
            pickle.dump(results, f)
''')


def _config_pair(arch, impls="reference", **overrides):
    return configs(arch, impls, **overrides)


def _requests(cls, cfg, n=3, max_new=8):
    rng = np.random.default_rng(3)
    return [cls(id=i, prompt=rng.integers(0, cfg.vocab_size, size=5 + i).tolist(),
                max_new=max_new) for i in range(n)]


@pytest.fixture(scope="module")
def jax_params():
    """``repro``'s parameters of each arch and expert count (seed 0)."""
    out = {}
    for arch in ARCHS:
        for n_e in (None, 6):
            jc, _ = _config_pair(arch, **({"n_experts": n_e} if n_e else {}))
            out[arch, jc.n_experts] = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return out


@pytest.fixture(scope="module")
def inputs(jax_params):
    rng = np.random.default_rng(24)
    jc, _ = _config_pair("deepseek-v2-lite-16b")
    return {"params": {k: jax.tree.map(np.asarray, v) for k, v in jax_params.items()},
            "archs": ARCHS, "variants": VARIANTS,
            "tokens": rng.integers(0, jc.vocab_size, size=(B, S)),
            "next": rng.integers(0, jc.vocab_size, size=(B, N_DECODE)),
            "x": rng.standard_normal((B, S, jc.d_model), dtype=np.float32),
            "x_moe": rng.standard_normal((B, 4 * S, jc.d_model), dtype=np.float32),
            "x_next": rng.standard_normal((B, 1, jc.d_model), dtype=np.float32),
            "prompts": [r.prompt for r in _requests(GenRequest, jc)], "max_new": 8,
            "kv_modes": {"mixtral-8x22b": ("migrate",), "deepseek-v2-lite-16b": KV_MODES},
            "storm_s": STORM_S, "counters": COUNTERS}


def _start(world: int, inputs, tmp: Path):
    """Start ``world`` ranks in the background; returns a function that
    waits for them (180 s at most) and gives each rank's results."""
    script = tmp / "tp_moe_ranks.py"
    script.write_text(_RANKS)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    proc = subprocess.Popen([sys.executable, str(script), str(world), str(tmp / "in.pkl"),
                             str(tmp / "out.pkl")],
                            env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=str(tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            _, err = proc.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            raise AssertionError(f"{world} ranks: no end within 180 s\n{err[-4000:]}")
        assert proc.returncode == 0, err[-4000:]
        with open(tmp / "out.pkl", "rb") as f:
            return pickle.load(f)
    return wait


def _jax_run(rep, reqs, steps=None, n_after=None):
    for r in reqs:
        rep.add(r)
    rec = None
    if n_after is not None:
        for _ in range(steps):
            rep.step()
        rec = rep.resize(n_after)
    return {r.id: list(r.generated) for r in rep.run()}, rec


def _storm_counters(arch):
    with pytest.MonkeyPatch.context() as mp:
        import repro.core.queues as jqueues
        import repro.platform.elastic as jelastic
        mp.setattr(jqueues, "_REQ_IDS", itertools.count())
        mp.setattr(jelastic, "_GANG_IDS", itertools.count())
        sc = jplat.ScenarioConfig.elastic_storm(duration=STORM_S)
        sc.platform.executor = "sharded-serving"
        sc.platform.model = arch
        sc.platform.executor_params = {"n_new": 4}
        p = jplat.Platform.build(sc)
        res = p.run()
    m = p.metrics
    return {"outcomes": res.outcome_counts,
            "counters": {name: {str(k): c.value for k, c in m.counters_matching(name).items()}
                         for name in COUNTERS},
            "migrations": len(p.executor.replica.migrations)}


@pytest.fixture(scope="module")
def runs(jax_params, inputs, tmp_path_factory):
    """Both groups of ranks, and what they are held against, computed while
    the ranks run: ``repro``'s two-device replicas, its shrinks and the
    storm; the port's one-device replicas."""
    wait2 = _start(2, inputs, tmp_path_factory.mktemp("tp2"))
    wait4 = _start(4, inputs, tmp_path_factory.mktemp("tp4"))
    devs = jax.devices()[:2]
    ref, one = {}, {}
    for arch in ARCHS:
        jc, tc = _config_pair(arch)
        jp = jax_params[arch, jc.n_experts]
        ref[arch, "tp2"] = _jax_run(JaxReplica(jc, jp, 2, n_slots=2, devices=devs),
                                    _requests(JaxGenRequest, jc))[0]
        for mode in inputs["kv_modes"][arch]:
            ref[arch, mode] = _jax_run(JaxReplica(jc, jp, 2, n_slots=2, kv_mode=mode,
                                                  devices=devs),
                                       _requests(JaxGenRequest, jc), 4, 1)
        tp = params_from_numpy(inputs["params"][arch, jc.n_experts], tc, "cpu")
        one[arch] = _jax_run(ElasticReplica(tc, tp, 1, n_slots=2, device="cpu"),
                             _requests(GenRequest, tc))[0]
    _, tc6 = _config_pair("deepseek-v2-lite-16b", n_experts=6)
    tp6 = params_from_numpy(inputs["params"]["deepseek-v2-lite-16b", 6], tc6, "cpu")
    one["in-expert"] = _jax_run(ElasticReplica(tc6, tp6, 1, n_slots=2, device="cpu"),
                                _requests(GenRequest, tc6))[0]
    ref["storm"] = _storm_counters("deepseek-v2-lite-16b")
    return {2: wait2(), 4: wait4(), "repro": ref, "one": one}


# --- blocks and logits --------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(jax_params, inputs):
    """``repro``'s outputs of every variant on one device: its reference
    impl of the variant's ``moe_impl`` (the port's gmm twins under ``auto``
    keep its drops: ``ragged`` dropless, ``scatter`` the capacity's)."""
    x = jnp.asarray(inputs["x"])
    tok = jnp.asarray(inputs["tokens"], jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    x_moe = jnp.asarray(inputs["x_moe"])
    out, seen = {}, {}
    for arch in ARCHS:
        for name, _, ov in VARIANTS:
            key = (arch, tuple(sorted(ov.items())))
            if key in seen:      # a gmm twin: repro's reference impl of its drops
                out[arch, name] = seen[key]
                continue
            jc, _ = _config_pair(arch, **ov)
            jp = jax_params[arch, jc.n_experts]
            moe = jax.tree.map(lambda v: v[0], jp["stack"]["moe"]["moe"])
            got = {"moe": jmoe.apply_moe(moe, x_moe, jc)[0],
                   "idx": jmoe.route(moe["router"], x_moe.reshape(-1, jc.d_model), jc)[1]}
            if jc.use_mla and name == "ragged":
                attn = jax.tree.map(lambda v: v[0], jp["stack"]["dense0"]["attn"])
                o, lat = jattn.mla_prefill(attn, x, pos, jc)
                cache = jnp.zeros((B, S + 1, lat.shape[-1]), jnp.float32).at[:, :S].set(lat)
                dec, _ = jattn.mla_decode(attn, jnp.asarray(inputs["x_next"]), cache, S, jc)
                got.update(mla=o, latent=lat, mla_decode=dec)
            if name == "dense":   # the oracle: its MoE block only
                out[arch, name] = seen[key] = got
                continue
            logits, pre = jmodel.prefill(jp, {"tokens": tok}, jc)
            got["prefill"] = logits
            cache = jax.tree.map(lambda z, c: z.at[:, :, :S].set(c),
                                 jmodel.init_cache(jc, B, S + N_DECODE), pre)
            got["decode"] = []
            for i in range(N_DECODE):
                logits, cache = jmodel.decode_step(
                    jp, jnp.asarray(inputs["next"][:, i:i + 1], jnp.int32), cache, S + i, jc)
                got["decode"].append(logits)
            if name == "scatter":
                # the capacity drops some picks of the block's tokens
                got["drops"] = _drops(np.asarray(got["idx"]), jc,
                                      _capacity(x_moe.shape[0] * x_moe.shape[1], jc))
            out[arch, name] = seen[key] = got
    return out


def _drops(idx: np.ndarray, cfg, cap: int) -> bool:
    """Whether some (token, pick) of ``idx`` finds its expert's ``cap`` rows
    taken."""
    counts = np.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return bool((counts > cap).any())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_blocks_and_logits_equal_repros_on_one_device(runs, reference, world, arch, variant):
    want = reference[arch, variant]
    _, tc = _config_pair(arch, **{n: ov for n, _, ov in VARIANTS}[variant])
    ep = tc.n_experts % world == 0
    for rank, held in enumerate(runs[world]):
        got = held["blocks"][arch, variant]
        if tc.use_mla and variant == "ragged":   # the MLA block, once an arch
            assert {"mla", "latent", "mla_decode"} <= set(got)
        for part in ("moe", "prefill", "mla", "latent", "mla_decode"):
            if part in got and part in want:
                close(got[part], want[part], F32_TOL)
        for g, w in zip(got["decode"], want.get("decode", ())):
            close(g, w, F32_TOL)
        assert len(got["decode"]) == N_DECODE
        # the same picks on every rank, and repro's
        np.testing.assert_array_equal(got["idx"], runs[world][0]["blocks"][arch, variant]["idx"])
        np.testing.assert_array_equal(got["idx"], np.asarray(want["idx"]))
        # the rank's heads, the global expert count and top_k, its experts
        # (expert-parallel) or its share of every expert's width (in-expert)
        heads, kv, n_e, top_k, moe_d_ff, d_ff = got["local"]
        assert (heads, n_e, top_k, d_ff) == (tc.n_heads // world, tc.n_experts, tc.top_k,
                                            tc.d_ff // world)
        assert kv == max(1, tc.n_kv_heads // world)
        per = tc.n_experts // world
        assert got["experts"] == ((rank * per, (rank + 1) * per) if ep else (0, tc.n_experts))
        assert moe_d_ff == (tc.moe_d_ff if ep else tc.moe_d_ff // world)
        # MLA's latent cache whole on every rank, GQA's KV heads split
        for seg, leaves in got["cache"].items():
            if tc.use_mla:
                assert leaves["c"][-1] == tc.kv_lora_rank + tc.qk_rope_dim, seg
            else:
                assert leaves["k"][-2] == max(1, tc.n_kv_heads // world), seg
    if variant == "scatter":
        assert want["drops"], "the scatter variant's capacity drops no pick"


def test_in_expert_variant_takes_repros_tensor_parallel_expert_rules():
    """6 experts over 4 ranks: ``repro`` cuts each expert's ``moe_d_ff``
    (``_EXPERT_RULES_TP``), and so does the port; over 2 ranks both hold
    whole experts."""
    for arch in ARCHS:
        jc, tc = _config_pair(arch, n_experts=6)
        shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jc))
        for n, rules in ((4, jshard._EXPERT_RULES_TP), (2, jshard._EXPERT_RULES_EP)):
            mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("model",))
            specs = jshard.param_specs(shapes, jc, mesh)["stack"]["moe"]["moe"]
            for key in ("w_gate", "w_up", "w_down"):
                want = jshard._fit(rules[key], shapes["stack"]["moe"]["moe"][key].shape, mesh)
                assert tuple(specs[key]) == tuple(want), (arch, n, key)
            kind = tshard.tp_split(("stack", "moe", "moe", "w_gate"), tc, n)[0]
            assert kind == ("expert_ff" if n == 4 else "experts")


# --- the shards of every config -----------------------------------------------------------
def _shard_shape(shape, spec, n: int):
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(d // n if ax == "model" else d for d, ax in zip(shape, spec))


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_local_shards_of_full_configs_match_repros_spec_and_reassemble(arch):
    """Every leaf of the full config on ``meta``: each rank's
    ``local_shard`` has the shape of ``repro``'s ``param_specs`` shard over
    a ``model`` axis of 2 and of 4 (where the port covers the architecture;
    with fewer KV heads than ranks the port replicates a KV head where
    ``repro`` splits its columns; Mamba2's ``in_proj``, ``conv_w`` and
    ``conv_b`` take the rank's components of the fused axis, ``z``, ``x``
    and ``dt`` of its heads and B and C of its groups, where ``repro``
    cuts the axis evenly), and ``assemble_shards`` of the ranks' shards
    has the whole leaf's shape."""
    tc, jc = get_config(arch), jax_get_config(arch)
    jshapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jc))
    tree = tmodel.tree_map(lambda s: torch.empty(s.shape, device="meta"),
                           tmodel.param_specs(tc))
    for n in (2, 4):
        try:
            T.tp_local(tc, _group(0, n))
            covered = True
        except NotImplementedError:
            covered = False
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("model",))
        specs = jshard.param_specs(jshapes, jc, mesh)

        def check(names, leaf, n=n, specs=specs, covered=covered):
            parts = [tshard.local_shard(leaf, names, tc, _group(r, n)) for r in range(n)]
            assert tshard.assemble_shards(parts, names, tc).shape == leaf.shape, names
            if not covered:
                return
            spec = specs
            for k in names:
                spec = spec[k]
            want = _shard_shape(leaf.shape, spec, n)
            replicated_kv = names[-1] in ("wk", "wv", "bk", "bv") and tc.n_kv_heads < n
            if replicated_kv:
                want = leaf.shape[:-1] + (tc.head_dim,)
            if names[-1] in ("in_proj", "conv_w", "conv_b"):
                # the fused axis by components, where repro cuts it evenly:
                # z, x and dt of the rank's heads, B and C of its groups
                loc = T.ssm_local(tc, _group(0, n))
                gn = loc.n_groups * tc.ssm_state
                assert loc.d_inner == tc.d_inner // n and loc.n_heads == tc.n_ssm_heads // n
                assert loc.n_groups == max(1, tc.ssm_ngroups // n)
                width = (2 * loc.d_inner + 2 * gn + loc.n_heads if names[-1] == "in_proj"
                         else loc.d_inner + 2 * gn)
                axis = -2 if names[-1] == "conv_w" else -1
                want = list(leaf.shape)
                want[axis] = width
                want = tuple(want)
            assert all(tuple(p.shape) == want for p in parts), (names, parts[0].shape, want)

        tshard.map_with_names(check, tree)


def _group(rank: int, size: int) -> T.TPGroup:
    """A group's place without a process group: what ``local_shard`` and
    ``tp_local`` read."""
    cpu = torch.device("cpu")
    return T.TPGroup(None, rank, size, cpu, (cpu,) * size, "gloo")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_and_reassembly_keep_every_value(arch):
    """``init_params`` under a group gives the cut of the whole tree, bit
    for bit, for the expert-parallel and in-expert layouts, and the ranks'
    shards reassemble into the whole tree."""
    for n_e in (None, 6):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                                  **({"n_experts": n_e} if n_e else {}))
        whole = tmodel.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        for n in (2, 4):
            shards = [tmodel.init_params(cfg, torch.Generator().manual_seed(5), "cpu",
                                         tp=_group(r, n)) for r in range(n)]

            def check(names, leaf, n=n, shards=shards):
                parts = []
                for r, tree in enumerate(shards):
                    for k in names:
                        tree = tree[k]
                    assert torch.equal(tree, tshard.local_shard(leaf, names, cfg, _group(r, n)))
                    parts.append(tree)
                assert torch.equal(tshard.assemble_shards(parts, names, cfg), leaf), names

            tshard.map_with_names(check, whole)


# --- streams, resizes, the platform --------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_stream_like_repros_two_devices_and_one_device(runs, arch):
    got = runs[2][0][arch, "tp2"]["streams"]
    assert got == runs["repro"][arch, "tp2"] == runs["one"][arch]
    assert sorted(got) == [0, 1, 2] and all(len(s) == 8 for s in got.values())
    # built from each rank's shards alone
    assert runs[2][0][arch, "sharded"]["streams"] == got
    for rank in (0, 1):
        assert runs[2][rank][arch, "tp2"]["in_gang"]
        assert runs[2][rank][arch, "sharded"]["leaves"] == runs[2][rank][arch, "tp2"]["leaves"]


@pytest.mark.parametrize("arch,kv_mode", [("deepseek-v2-lite-16b", m) for m in KV_MODES]
                         + [("mixtral-8x22b", "migrate")])
def test_physical_shrink_gives_repros_records(runs, arch, kv_mode):
    _, tc = _config_pair(arch)
    survivor, leaver = runs[2][0][arch, kv_mode], runs[2][1][arch, kv_mode]
    jstreams, jrec = runs["repro"][arch, kv_mode]
    rec = survivor["records"][0]
    assert {f: rec[f] for f in RECORD_FIELDS} == {f: getattr(jrec, f) for f in RECORD_FIELDS}
    assert (rec["n_before"], rec["n_after"]) == (2, 1)
    if kv_mode == "migrate_int8":
        assert set(survivor["streams"]) == set(jstreams)
        assert all(len(s) == 8 for s in survivor["streams"].values())
    else:
        assert survivor["streams"] == jstreams == runs["one"][arch]
    # every leaf whole on the survivor (the experts gathered), none on the leaver
    whole = [tuple(s.shape) for s in tmodel.tree_leaves(tmodel.param_specs(tc))]
    assert survivor["leaves"] == whole and survivor["in_gang"]
    assert leaver["leaves"] == [] and not leaver["in_gang"]
    assert survivor["last_resize"]["gathered_bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_physical_grow_finishes_with_the_unbroken_streams(runs, arch):
    first, joiner = runs[2][0][arch, "grow"], runs[2][1][arch, "grow"]
    assert first["streams"] == runs["one"][arch]
    assert [(r["n_before"], r["n_after"]) for r in first["records"]] == [(1, 2)]
    assert joiner["in_gang"] and joiner["leaves"] == first["leaves"]
    assert joiner["last_resize"]["shipped_bytes"] == first["last_resize"]["shipped_bytes"] > 0


def test_four_ranks_go_from_in_expert_to_expert_parallel_to_whole(runs):
    """6 experts: each of 4 ranks holds a quarter of every expert's width,
    each of 2 ranks 3 whole experts, 1 rank all of them; the streams are
    the one-device replica's."""
    _, tc = _config_pair("deepseek-v2-lite-16b", n_experts=6)
    first = runs[4][0]["resizes"]
    assert first["streams"] == runs["one"]["in-expert"]
    assert [(r["n_before"], r["n_after"]) for r in first["records"]] == [(4, 2), (2, 1)]
    whole = [tuple(s.shape) for s in tmodel.tree_leaves(tmodel.param_specs(tc))]
    assert first["leaves"] == whole
    assert all(r["resizes"]["leaves"] == [] for r in runs[4][1:])


def test_sharded_serving_of_deepseek_over_two_ranks_ends_with_repros_counters(runs):
    got, want = runs[2][0]["storm"], runs["repro"]["storm"]
    assert got["mesh_size"] in (1, 2) and got["migrations"] > 0
    assert {k: got[k] for k in want} == want
    assert runs[2][1]["storm"] is None


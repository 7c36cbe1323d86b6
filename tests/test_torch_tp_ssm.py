"""Tensor parallelism for the SSM and hybrid families in the port
(``repro_torch.distributed.tensor_parallel``) against ``repro``, on the CPU
at float32.

As in ``tests/test_torch_tp_moe.py``, ranks are processes of their own over
gloo, started by ``spawn_tp`` from a script that a subprocess runs under a
timeout of its own; one group of two ranks and one of four start once for
the module, and ``repro``'s references are computed while they run.

- Blocks and logits: mamba2-2.7b's smoke config (8 SSM heads, one B/C
  group) and zamba2-2.7b's (the same trunk, a shared attention and MLP
  block every two mamba layers) on 2 and 4 ranks, from the same numpy
  weights, against ``repro``'s ``mamba_block``, ``mamba_decode``,
  ``prefill`` and ``decode_step`` on one device at 5e-5/5e-4, under
  ``reference`` and ``auto`` (on the CPU the plain versions of ``ssd`` and
  of both passes of the gated norm split over ranks), and a variant with
  ``ssm_ngroups=2`` (one group a rank at 2 ranks, one group shared by two
  ranks at 4). The rank's state and conv window are ``repro``'s cut by
  its heads and channels.
- The gated norm: the plain versions of its two passes, summed over the
  ranks' slices of a row, against ``repro``'s ``gated_rms_norm`` on the
  whole row.
- Shards: ``init_params`` under a group equals the cut of the whole tree,
  and the ranks' shards reassemble it bit for bit.
- Streams: the port's ``ElasticReplica`` on 2 ranks (from the whole
  parameters, and from each rank's shards alone) equals ``repro``'s on 2
  devices and the port's one-device replica token for token at
  temperature 0; a physical shrink 2 -> 1 in each KV mode gives
  ``repro``'s ``MigrationRecord``s; a grow 1 -> 2 ends with the unbroken
  streams; 4 ranks of mamba2 resize 4 -> 2 -> 1; 2-token prompts (a conv
  tail shorter than the window, grafted right-padded) stream as
  ``repro``'s.
- The platform: ``sharded-serving`` with mamba2 over 2 ranks ends a short
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
from repro.distributed.elastic_serving import ElasticReplica as JaxReplica
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.serving.batching import GenRequest as JaxGenRequest
from repro_torch.distributed import sharding as tshard
from repro_torch.distributed import tensor_parallel as T
from repro_torch.distributed.elastic_serving import ElasticReplica
from repro_torch.kernels import ref as tref
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from repro_torch.serving.batching import GenRequest

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
RECORD_FIELDS = ("n_before", "n_after", "kv_mode", "param_bytes", "kv_bytes",
                 "wire_bytes", "n_requests_live")
KV_MODES = ("migrate", "replay", "migrate_int8")
STORM_S = 240.0
# S 40 pads to two of the smoke configs' 32-token chunks
B, S, N_DECODE = 2, 40, 3
# (name, kernel policy, config overrides)
VARIANTS = (("reference", "reference", {}),
            ("auto", "auto", {}),
            ("groups 2", "reference", {"ssm_ngroups": 2}),
            ("groups 2 auto", "auto", {"ssm_ngroups": 2}))
COUNTERS = ("gang_migrations_total", "gang_migrated_bytes_total", "gang_wire_bytes_total",
            "gang_replica_losses_total")

# the ranks' program: ``python tp_ssm_ranks.py <world> <inputs.pkl> <out.pkl>``
_RANKS = textwrap.dedent('''
    import dataclasses, sys
    import pickle
    import torch

    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.models import model as M
    from repro_torch.models.ssm import mamba_block, mamba_decode
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.serving.batching import GenRequest


    def config(arch, impls, overrides):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **overrides)
        return with_kernel_impls(cfg, impls)


    def layer0(tree):
        return {k: layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


    def mixer0(shard, cfg):
        stack = shard["stack"]["ssm" if cfg.family == "ssm" else "hybrid"]
        tree = stack if cfg.family == "ssm" else layer0(stack["mamba"])
        return layer0(tree)["mixer"]


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


    def blocks(tp, d, arch, impls, overrides):
        """Layer 0's mamba block and decode, prefill and decode_step of one
        variant on this rank's shards."""
        cfg = config(arch, impls, overrides)
        local = T.tp_local(cfg, tp)
        loc = T.ssm_local(local, tp)
        shard = params_from_numpy(d["params"][arch, cfg.ssm_ngroups], cfg, "cpu", tp)
        tok = torch.as_tensor(d["tokens"])
        out = {"local": dataclasses.astuple(loc), "heads": (local.n_heads, local.n_kv_heads)}
        mixer = mixer0(shard, cfg)
        y, state, tail = mamba_block(mixer, torch.as_tensor(d["u"]), local, tp=tp)
        out["block"] = (y.numpy(), state.numpy(), tail.numpy())
        ref_state, ref_conv = (torch.as_tensor(d["dec_in"][arch, cfg.ssm_ngroups][k])
                               for k in ("state", "conv"))
        names = ("stack", "ssm", "state")
        st = S.local_shard(ref_state, names, cfg, tp, cache=True)
        cv = S.local_shard(ref_conv, names[:2] + ("conv",), cfg, tp, cache=True)
        y, st, cv = mamba_decode(mixer, torch.as_tensor(d["u_next"]), st, cv, local, tp)
        out["decode_block"] = (y.numpy(), st.numpy(), cv.numpy())
        logits, pre = M.prefill(shard, {"tokens": tok}, cfg, tp)
        out["prefill"] = logits.numpy()
        out["prefill_cache"] = {seg: {k: v.numpy() for k, v in c.items()}
                                for seg, c in pre.items()}
        cache = M.init_cache(cfg, tok.shape[0], tok.shape[1] + d["next"].shape[1], "cpu", tp)
        for seg in pre:
            for key, leaf in pre[seg].items():
                if key in ("k", "v"):
                    cache[seg][key][:, :, :tok.shape[1]] = leaf
                else:
                    cache[seg][key].copy_(leaf)
        out["cache"] = {seg: {k: tuple(v.shape) for k, v in c.items()} for seg, c in cache.items()}
        out["decode"] = []
        for i in range(d["next"].shape[1]):
            logits, cache = M.decode_step(shard, torch.as_tensor(d["next"][:, i:i + 1]), cache,
                                          tok.shape[1] + i, cfg, tp)
            out["decode"].append(logits.numpy())
        return out


    def rank_main(tp, d):
        torch.set_num_threads(1)
        out = {"blocks": {(arch, name): blocks(tp, d, arch, impls, ov)
                          for arch in d["archs"] for name, impls, ov in d["variants"]}}
        kw = dict(n_slots=2, tp=tp)
        if tp.size == 4:
            cfg = config("mamba2-2.7b", "reference", {})
            full = params_from_numpy(d["params"]["mamba2-2.7b", 1], cfg, "cpu")
            out["resizes"] = served(ElasticReplica(cfg, full, 4, **kw), d, ((2, 2), (2, 1)))
            return out
        for arch in d["archs"]:
            cfg = config(arch, "reference", {})
            numpy_params = d["params"][arch, 1]
            full = params_from_numpy(numpy_params, cfg, "cpu")
            out[arch, "tp2"] = served(ElasticReplica(cfg, full, 2, **kw), d)
            shard = params_from_numpy(numpy_params, cfg, "cpu", tp)
            out[arch, "sharded"] = served(ElasticReplica(cfg, shard, 2, sharded=True, **kw), d)
            for mode in d["kv_modes"]:
                out[arch, mode] = served(ElasticReplica(cfg, full, 2, kv_mode=mode, **kw), d,
                                         ((4, 1),))
            out[arch, "grow"] = served(ElasticReplica(cfg, full, 1, **kw), d, ((4, 2),))
            # prompts shorter than the conv window: the rank's short conv tail grafted
            out[arch, "short"] = served(ElasticReplica(cfg, full, 2, **kw),
                                        dict(d, prompts=d["short_prompts"]))
        out["storm"] = storm(tp, d)
        return out


    def storm(tp, d):
        """``elastic_storm`` with ``sharded-serving`` hosting mamba2 over
        the group: rank 0 runs the platform, rank 1 serves its calls."""
        import itertools
        import repro_torch.core.queues as queues
        import repro_torch.platform as plat
        import repro_torch.platform.elastic as elastic
        queues._REQ_IDS, elastic._GANG_IDS = itertools.count(), itertools.count()
        arch = "mamba2-2.7b"
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


def _mixer0(tree, cfg):
    stack = tree["stack"]["ssm" if cfg.family == "ssm" else "hybrid"]
    lead = 1 if cfg.family == "ssm" else 2
    sub = stack if cfg.family == "ssm" else stack["mamba"]
    return jax.tree.map(lambda v: v[(0,) * lead], sub)["mixer"]


@pytest.fixture(scope="module")
def jax_params():
    """``repro``'s parameters of each arch and group count (seed 0)."""
    out = {}
    for arch in ARCHS:
        for g in (1, 2):
            jc, _ = _config_pair(arch, ssm_ngroups=g)
            out[arch, g] = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return out


@pytest.fixture(scope="module")
def inputs(jax_params):
    """The numpy inputs both sides read, with ``repro``'s layer-0 block
    state that the ranks' ``mamba_decode`` starts from."""
    rng = np.random.default_rng(25)
    jc, _ = _config_pair("mamba2-2.7b")
    u = rng.standard_normal((B, S, jc.d_model), dtype=np.float32)
    dec_in = {}
    for (arch, g), jp in jax_params.items():
        jc, _ = _config_pair(arch, ssm_ngroups=g)
        _, state, tail = jssm.mamba_block(_mixer0(jp, jc), jnp.asarray(u), jc)
        dec_in[arch, g] = {"state": np.asarray(state), "conv": np.asarray(tail)}
    return {"params": {k: jax.tree.map(np.asarray, v) for k, v in jax_params.items()},
            "archs": ARCHS, "variants": VARIANTS, "u": u,
            "u_next": rng.standard_normal((B, 1, jc.d_model), dtype=np.float32),
            "dec_in": dec_in,
            "tokens": rng.integers(0, jc.vocab_size, size=(B, S)),
            "next": rng.integers(0, jc.vocab_size, size=(B, N_DECODE)),
            "prompts": [r.prompt for r in _requests(GenRequest, jc)], "max_new": 8,
            "short_prompts": [r.prompt[:2] for r in _requests(GenRequest, jc)],
            "kv_modes": KV_MODES, "storm_s": STORM_S, "counters": COUNTERS}


def _start(world: int, inputs, tmp: Path):
    """Start ``world`` ranks in the background; returns a function that
    waits for them (180 s at most) and gives each rank's results."""
    script = tmp / "tp_ssm_ranks.py"
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
        jp = jax_params[arch, 1]
        ref[arch, "tp2"] = _jax_run(JaxReplica(jc, jp, 2, n_slots=2, devices=devs),
                                    _requests(JaxGenRequest, jc))[0]
        for mode in KV_MODES:
            ref[arch, mode] = _jax_run(JaxReplica(jc, jp, 2, n_slots=2, kv_mode=mode,
                                                  devices=devs),
                                       _requests(JaxGenRequest, jc), 4, 1)
        tp = params_from_numpy(inputs["params"][arch, 1], tc, "cpu")
        one[arch] = _jax_run(ElasticReplica(tc, tp, 1, n_slots=2, device="cpu"),
                             _requests(GenRequest, tc))[0]
        short = [dataclasses.replace(r, prompt=r.prompt[:2]) for r in _requests(JaxGenRequest, jc)]
        ref[arch, "short"] = _jax_run(JaxReplica(jc, jp, 2, n_slots=2, devices=devs), short)[0]
    ref["storm"] = _storm_counters("mamba2-2.7b")
    return {2: wait2(), 4: wait4(), "repro": ref, "one": one}


# --- blocks and logits --------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(jax_params, inputs):
    """``repro``'s outputs of every arch and group count on one device (its
    reference path: the port's ``auto`` is held against it too)."""
    u, u_next = jnp.asarray(inputs["u"]), jnp.asarray(inputs["u_next"])
    tok = jnp.asarray(inputs["tokens"], jnp.int32)
    out = {}
    for (arch, g), jp in jax_params.items():
        jc, _ = _config_pair(arch, ssm_ngroups=g)
        mixer = _mixer0(jp, jc)
        got = {"block": jssm.mamba_block(mixer, u, jc)}
        dec = inputs["dec_in"][arch, g]
        got["decode_block"] = jssm.mamba_decode(mixer, u_next, jnp.asarray(dec["state"]),
                                                jnp.asarray(dec["conv"]), jc)
        logits, pre = jmodel.prefill(jp, {"tokens": tok}, jc)
        got["prefill"], got["prefill_cache"] = logits, jax.tree.map(np.asarray, pre)
        cache = jmodel.init_cache(jc, B, S + N_DECODE)
        cache = {seg: {k: (z.at[:, :, :S].set(pre[seg][k]) if k in ("k", "v") else pre[seg][k])
                       for k, z in c.items()} for seg, c in cache.items()}
        got["decode"] = []
        for i in range(N_DECODE):
            logits, cache = jmodel.decode_step(
                jp, jnp.asarray(inputs["next"][:, i:i + 1], jnp.int32), cache, S + i, jc)
            got["decode"].append(logits)
        out[arch, g] = got
    return out


def _group(rank: int, size: int) -> T.TPGroup:
    """A group's place without a process group: what ``local_shard`` and
    ``tp_local`` read."""
    cpu = torch.device("cpu")
    return T.TPGroup(None, rank, size, cpu, (cpu,) * size, "gloo")


def _cut(whole, names, cfg, rank, size):
    return tshard.local_shard(torch.from_numpy(np.array(whole)), names, cfg,
                              _group(rank, size), cache=True).numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
def test_blocks_and_logits_equal_repros_on_one_device(runs, reference, world, arch, variant):
    ov = {n: o for n, _, o in VARIANTS}[variant]
    _, tc = _config_pair(arch, **ov)
    g = tc.ssm_ngroups
    want = reference[arch, g]
    h, p = tc.n_ssm_heads, tc.ssm_headdim
    for rank, held in enumerate(runs[world]):
        got = held["blocks"][arch, variant]
        # the rank's heads and the groups they read
        di, heads, groups, conv_dim, h0, g0 = got["local"]
        per = h // world
        assert (heads, h0, di) == (per, rank * per, per * p)
        assert groups == (g // world if g % world == 0 else 1)
        assert g0 == rank * per // (h // g)
        assert conv_dim == di + 2 * groups * tc.ssm_state
        assert got["heads"] == (tc.n_heads // world, max(1, tc.n_kv_heads // world)
                                if tc.n_kv_heads else 0)
        # the block: the whole y, the rank's heads of the state and channels of the tail
        for (gy, gs, gc), (wy, ws, wc) in ((got["block"], want["block"]),
                                           (got["decode_block"], want["decode_block"])):
            close(gy, wy, F32_TOL)
            close(gs, _cut(ws, ("stack", "ssm", "state"), tc, rank, world), F32_TOL)
            close(gc, _cut(wc, ("stack", "ssm", "conv"), tc, rank, world), F32_TOL)
        close(got["prefill"], want["prefill"], F32_TOL)
        for seg, leaves in got["prefill_cache"].items():
            for key, leaf in leaves.items():
                close(leaf, _cut(want["prefill_cache"][seg][key], (seg, key), tc, rank, world),
                      F32_TOL)
        for gl, wl in zip(got["decode"], want["decode"]):
            close(gl, wl, F32_TOL)
        assert len(got["decode"]) == N_DECODE
        for seg, leaves in got["cache"].items():
            assert leaves["state"][-3] == per, seg
            assert leaves["conv"][-1] == conv_dim, seg
            if "k" in leaves:
                assert leaves["k"][-2] == tc.n_kv_heads // world, seg


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("groups", [1, 2])
def test_split_gated_norm_plain_passes_equal_repros_whole_row(world, groups):
    """Each rank's slice of a row through the plain pass A, the sums added
    over the ranks, each slice through pass B, side by side: ``repro``'s
    ``gated_rms_norm`` of the whole row (bf16 and f32 inputs alike read at
    f32 here)."""
    rng = np.random.default_rng(groups)
    rows, d = 6, 128
    x, z = (rng.standard_normal((rows, d), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal(d, dtype=np.float32)
    want = jlayers.gated_rms_norm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), 1e-5)
    parts = [(torch.as_tensor(x[:, r * d // world:(r + 1) * d // world]),
              torch.as_tensor(z[:, r * d // world:(r + 1) * d // world]),
              torch.as_tensor(w[r * d // world:(r + 1) * d // world])) for r in range(world)]
    ssq = sum(tref.gated_rmsnorm_ssq_ref(xs, zs) for xs, zs, _ in parts)
    got = torch.cat([tref.gated_rmsnorm_scale_ref(xs, zs, ws, ssq, d, 1e-5)
                     for xs, zs, ws in parts], dim=-1)
    close(got.numpy(), want, F32_TOL)
    # one rank: pass B of pass A is the one-pass plain version
    xt, zt, wt = map(torch.as_tensor, (x, z, w))
    close(tref.gated_rmsnorm_scale_ref(xt, zt, wt, tref.gated_rmsnorm_ssq_ref(xt, zt), d),
          tref.gated_rmsnorm_ref(xt, zt, wt).numpy(), F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [1, 2])
def test_sharded_init_and_reassembly_keep_every_value(arch, groups):
    """``init_params`` under a group gives the cut of the whole tree bit for
    bit, the SSM leaves piecewise, and the ranks' shards reassemble it."""
    cfg = dataclasses.replace(_config_pair(arch)[1], ssm_ngroups=groups)
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
        mixer = shards[0]["stack"]["ssm" if cfg.family == "ssm" else "hybrid"]
        mixer = mixer["mixer"] if cfg.family == "ssm" else mixer["mamba"]["mixer"]
        loc = T.ssm_local(cfg, _group(0, n))
        assert mixer["in_proj"].shape[-1] == (2 * loc.d_inner + 2 * loc.n_groups * cfg.ssm_state
                                              + loc.n_heads)
        assert mixer["conv_w"].shape[-2] == loc.conv_dim


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


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_graft_a_prompt_shorter_than_the_conv_window_like_repro(runs, arch):
    """2-token prompts leave a conv tail of 2 rows of the 3 the window
    holds; each rank grafts its channels of it right-padded, as ``repro``
    grafts the whole (ROADMAP §3), and the streams are ``repro``'s."""
    got = runs[2][0][arch, "short"]["streams"]
    assert got == runs["repro"][arch, "short"]
    assert all(len(s) == 8 for s in got.values())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_mode", KV_MODES)
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
    # every leaf whole on the survivor, none on the leaver
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


def test_four_ranks_of_mamba2_resize_to_two_then_one(runs):
    _, tc = _config_pair("mamba2-2.7b")
    first = runs[4][0]["resizes"]
    assert first["streams"] == runs["one"]["mamba2-2.7b"]
    assert [(r["n_before"], r["n_after"]) for r in first["records"]] == [(4, 2), (2, 1)]
    whole = [tuple(s.shape) for s in tmodel.tree_leaves(tmodel.param_specs(tc))]
    assert first["leaves"] == whole
    assert all(r["resizes"]["leaves"] == [] for r in runs[4][1:])


def test_sharded_serving_of_mamba2_over_two_ranks_ends_with_repros_counters(runs):
    got, want = runs[2][0]["storm"], runs["repro"]["storm"]
    assert got["mesh_size"] in (1, 2) and got["migrations"] > 0
    assert {k: got[k] for k in want} == want
    assert runs[2][1]["storm"] is None

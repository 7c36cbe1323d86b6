"""Elastic sharded serving in the port (``repro_torch.platform.elastic``,
``repro_torch.distributed``) against ``repro``'s, on the CPU at float32.

The gang lifecycle on the platform runs the fast-tier checks of
``tests/test_elastic.py`` through the port and equals ``repro``'s storm
request for request and counter for counter. The sharding rules give
``repro``'s specs for every config. The int8 wire format is ``repro``'s bit
for bit. A mid-stream shrink of an ``ElasticReplica`` equals the port's
unbroken gang and ``repro``'s replica on one device, token for token and
``MigrationRecord`` field for field (``wall_s`` aside). Checkpoints reshard
across the packages and mesh shapes. The port has no tensor parallelism
across cards: a mesh over two distinct devices raises.
"""
import json
import os
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
import repro_torch.platform as tplat
from _torch_parity import assert_same_result, configs, params, reset_ids
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshard
from repro.distributed.elastic import reshard_in_place as jax_reshard_in_place
from repro.distributed.elastic import reshard_restore as jax_reshard_restore
from repro.distributed.elastic_serving import ElasticReplica as JaxReplica
from repro.distributed.elastic_serving import serving_mesh as jax_serving_mesh
from repro.models import model as jmodel
from repro.serving.batching import GenRequest as JaxGenRequest
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tshard
from repro_torch.distributed.elastic import dp_degree, reshard_in_place, reshard_restore
from repro_torch.distributed.elastic_serving import (ElasticReplica, available_gang_devices,
                                                     member_shard_bytes, serving_mesh)
from repro_torch.distributed.elastic_serving.mesh import tree_bytes
from repro_torch.distributed.elastic_serving.migration import int8_wire_bytes
from repro_torch.models import model as tmodel
from repro_torch.serving.batching import GenRequest

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
RECORD_FIELDS = ("n_before", "n_after", "kv_mode", "param_bytes", "kv_bytes",
                 "wire_bytes", "n_requests_live")


# --- gang platform lifecycle ---------------------------------------------------------
@pytest.fixture(scope="module")
def storms():
    """``elastic_storm`` (gang 3, 1800 s) migrating and losing, in both
    packages, each run with its request and gang ids from 0."""
    out = {}
    for migrate in (True, False):
        for name, plat in (("repro", jplat), ("port", tplat)):
            with pytest.MonkeyPatch.context() as mp:
                reset_ids(mp)
                sc = plat.ScenarioConfig.elastic_storm(duration=1800.0, gang_size=3,
                                                       seed=7, migrate=migrate)
                p = plat.Platform.build(sc)
                out[name, migrate] = (p, p.run())
    return out


def test_gang_pool_migrates_and_survives_churn(storms):
    p, res = storms["port", True]
    m = p.metrics
    assert m.total("gang_migrations_total") > 0
    kinds = {dict(k)["kind"] for k in m.counters_matching("gang_migrations_total")}
    assert "shrink" in kinds
    assert m.total("gang_migrated_bytes_total") > 0
    assert m.total("gang_wire_bytes_total") > 0
    assert m.total("gang_replica_losses_total") == 0
    assert len(m.gauges_matching("gang_mesh_size")) >= 1
    assert res.outcome_counts.get("success", 0) > 0


def test_gang_pool_lose_whole_replica_baseline(storms):
    p, res = storms["port", False]
    m = p.metrics
    assert m.total("gang_replica_losses_total") > 0
    assert m.total("gang_migrations_total") == 0
    assert res.outcome_counts.get("success", 0) > 0


def test_elastic_storm_migration_beats_replica_loss_goodput(storms):
    res_m, res_l = storms["port", True][1], storms["port", False][1]
    assert res_m.goodput_s > res_l.goodput_s, (res_m.goodput_s, res_l.goodput_s)


def test_gang_sched_end_is_min_member_lease():
    p = tplat.Platform.build(tplat.ScenarioConfig.elastic_storm(duration=900.0, gang_size=3))
    checked = []

    def check():
        for g in p.gang_pool.gangs:
            if g.state not in ("warming", "healthy") or not g._members:
                continue
            live = [m.sched_end for m in g._members if m.state in ("warming", "healthy")]
            if live:
                assert g.sched_end == min(live)
                checked.append(g.gid)

    for t in range(100, 900, 100):
        p.sim.at(float(t), check)
    p.run()
    assert checked


def test_gang_member_never_registers_with_controller():
    p = tplat.Platform.build(tplat.ScenarioConfig.elastic_storm(duration=600.0, gang_size=3))
    seen = []

    def check():
        for inv in p.controller.invokers.values():
            assert not isinstance(inv, tplat.GangMember) or isinstance(
                inv, tplat.ElasticGangInvoker)
            seen.append(inv)

    for t in range(50, 600, 50):
        p.sim.at(float(t), check)
    p.run()
    assert any(isinstance(inv, tplat.ElasticGangInvoker) for inv in seen)


@pytest.mark.parametrize("migrate", [True, False], ids=["migrate", "lose"])
def test_elastic_storm_equals_repro(storms, migrate):
    """Request for request, and every counter, gauge and histogram of the
    metrics registry (the gang counters, ``gang_mesh_size`` by gang id) at
    the end."""
    (jp, jres), (tp, tres) = storms["repro", migrate], storms["port", migrate]
    assert tres.n_submitted > 0
    assert_same_result(jres, tres)
    np.testing.assert_equal(tp.metrics.collect(), jp.metrics.collect())
    assert tp.gang_pool.n_migrations == jp.gang_pool.n_migrations
    assert tp.gang_pool.migrated_bytes == jp.gang_pool.migrated_bytes
    assert tp.gang_pool.n_replica_losses == jp.gang_pool.n_replica_losses
    assert ([g.gid for g in tp.gang_pool.gangs] == [g.gid for g in jp.gang_pool.gangs])


# --- the sharding rules ----------------------------------------------------------------
MESHES = {"model1": ((1,), ("model",)), "model2": ((2,), ("model",)),
          "model4": ((4,), ("model",)), "model8": ((8,), ("model",)),
          "data2_model4": ((2, 4), ("data", "model"))}


def _jax_mesh(sizes, names):
    n = int(np.prod(sizes))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(sizes), names)


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_repros(arch):
    """Every parameter and cache leaf of the full config, on model meshes of
    1-8 and a (data 2, model 4) mesh, with ``seq_shard`` off and on."""
    jc, tc = jax_get_config(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jc))
    tshapes = tmodel.param_specs(tc)
    batch, seq = 8, 128
    jcache, tcache = jmodel.cache_spec(jc, batch, seq), tmodel.cache_spec(tc, batch, seq)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for label, (sizes, names) in MESHES.items():
        jm, am = _jax_mesh(sizes, names), tshard.AbstractMesh(sizes, names)
        want = jax.tree.map(tuple, jshard.param_specs(jshapes, jc, jm), is_leaf=is_spec)
        assert _as_tuples(tshard.param_specs(tshapes, tc, am)) == want, label
        for seq_shard in (False, True):
            want = jax.tree.map(tuple, jshard.cache_specs(jcache, jc, jm, batch, seq_shard),
                                is_leaf=is_spec)
            got = tshard.cache_specs(tcache, tc, am, batch, seq_shard)
            assert _as_tuples(got) == want, (label, seq_shard)
        assert tuple(tshard.batch_spec(batch, am, 2)) == tuple(jshard.batch_spec(batch, jm, 2))
        assert dp_degree(am) == (2 if "data" in names else 1)


def test_mesh_types_and_input_shardings():
    mesh = tshard.Mesh(np.asarray([torch.device("cpu")] * 4, dtype=object).reshape(2, 2),
                       ("data", "model"))
    assert mesh.axis_sizes == (2, 2) and mesh.devices.size == 4
    tc = get_config("qwen2.5-3b", smoke=True)
    specs = tmodel.param_specs(tc)
    abstract = tshard.AbstractMesh((2, 2), ("data", "model"))
    assert (_as_tuples(tshard.param_specs(specs, tc, mesh))
            == _as_tuples(tshard.param_specs(specs, tc, abstract)))
    batch = {"tokens": torch.zeros(4, 16, dtype=torch.int64), "mask": torch.zeros(3, 16)}
    got = tshard.input_shardings(batch, mesh)
    jm = _jax_mesh((2, 2), ("data", "model"))
    want = jshard.input_shardings({"tokens": np.zeros((4, 16)), "mask": np.zeros((3, 16))}, jm)
    assert {k: tuple(v.spec) for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}
    assert all(s.device == torch.device("cpu") for s in got.values())


# --- the int8 wire format -----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_and_ef_compress_bit_for_bit(dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 4, 16, 8)) * 3.0).astype(np.float32)
    err = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jcomp.quantize(jx)
    tq, ts = tcomp.quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(tcomp.dequantize(tq, ts).numpy(),
                                  np.asarray(jcomp.dequantize(jq, js)))
    jout = jcomp.ef_compress(jx, jnp.asarray(err))
    tout = tcomp.ef_compress(tx, torch.from_numpy(err))
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # within scale/2 everywhere, the wire 2x smaller than bf16
    deq = tcomp.dequantize(tq, ts) - tx.to(torch.float32)
    assert deq.abs().max().item() <= ts.item() / 2 + 1e-7
    assert tq.numel() * tq.element_size() * 2 <= tx.numel() * 2 * (2 if dtype == "float32" else 1)


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import ef_allreduce
    rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    d = np.load(data)
    mean, err = ef_allreduce(torch.from_numpy(d["x"][rank]), torch.from_numpy(d["err"][rank]))
    np.savez(out, mean=mean.numpy(), err=err.numpy())
    dist.destroy_process_group()
""")


def test_ef_allreduce_over_gloo_equals_repros_shard_map(tmp_path):
    """Two gloo ranks on the CPU against ``repro``'s under ``shard_map``
    over 2 devices: the same mean on every rank and the same new error."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    err = (rng.standard_normal((2, 64)) * 0.01).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, err=err)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
                               str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("d",))
    spec = jax.sharding.PartitionSpec("d")
    fn = jax.shard_map(lambda a, e: jcomp.ef_allreduce(a[0], e[0], "d"), mesh=mesh,
                       in_specs=(spec, spec), out_specs=(spec, spec), check_vma=False)
    jmean, jerr = fn(jnp.asarray(x), jnp.asarray(err))
    jmean, jerr = np.asarray(jmean).reshape(2, 64), np.asarray(jerr).reshape(2, 64)
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_array_equal(got["mean"], jmean[r])
        np.testing.assert_array_equal(got["err"], jerr[r])
    np.testing.assert_allclose(jmean[0], x.mean(0), atol=np.abs(x).max() / 127)


# --- the replica's mid-stream resize ------------------------------------------------------
@pytest.fixture(scope="module")
def qwen():
    jc, tc = configs("qwen2.5-3b")
    jp, tp = params(jc, tc)
    return jc, tc, jp, tp


def _requests(cls, cfg, n=3, max_new=8):
    rng = np.random.default_rng(3)
    return [cls(id=i, prompt=rng.integers(0, cfg.vocab_size, size=5 + i).tolist(),
                max_new=max_new) for i in range(n)]


def _run(rep, reqs, shrink_after=None):
    for r in reqs:
        rep.add(r)
    rec = None
    if shrink_after is not None:
        for _ in range(shrink_after):
            rep.step()
        rec = rep.shrink(2)
    return {r.id: list(r.generated) for r in rep.run()}, rec


@pytest.fixture(scope="module")
def shrinks(qwen):
    """Per KV mode, a gang of 4 shrunk to 2 after 4 decode steps, in the
    port and in ``repro`` on a physical mesh of 1 device; and the port's
    unbroken gang of 2."""
    jc, tc, jp, tp = qwen
    out = {"golden": _run(ElasticReplica(tc, tp, 2, n_slots=2, device="cpu"),
                          _requests(GenRequest, tc))[0]}
    for mode in ("migrate", "replay", "migrate_int8"):
        rep = ElasticReplica(tc, tp, 4, n_slots=2, kv_mode=mode, device="cpu")
        jrep = JaxReplica(jc, jp, 4, n_slots=2, kv_mode=mode, devices=jax.devices()[:1])
        out[mode] = (rep, *_run(rep, _requests(GenRequest, tc), 4))
        out["repro", mode] = _run(jrep, _requests(JaxGenRequest, jc), 4)
    return out


@pytest.mark.parametrize("kv_mode", ["migrate", "replay"])
def test_mid_stream_shrink_equals_the_unbroken_gang_and_repro(shrinks, kv_mode):
    rep, got, rec = shrinks[kv_mode]
    jgot, jrec = shrinks["repro", kv_mode]
    assert got == shrinks["golden"]
    assert got == jgot
    assert rep.n_members == 2 and rep.mesh_size == 1 and len(rep.migrations) == 1
    assert rec.n_before == 4 and rec.n_after == 2
    assert rec.bytes_moved > 0 and rec.wire_bytes > 0
    assert {f: getattr(rec, f) for f in RECORD_FIELDS} == {f: getattr(jrec, f) for f in RECORD_FIELDS}
    assert rec.param_bytes == tmodel.nbytes(rep.params) // 2
    assert rec.kv_bytes == tmodel.nbytes(rep.engine.cache) // 2
    if kv_mode == "replay":
        assert rec.wire_bytes == rec.param_bytes
    else:
        assert rec.wire_bytes == rec.param_bytes + rec.kv_bytes


def test_int8_kv_wire_is_smaller_and_completes_like_repro(shrinks):
    rep, got, rec = shrinks["migrate_int8"]
    jgot, jrec = shrinks["repro", "migrate_int8"]
    assert rec.wire_bytes < shrinks["migrate"][2].wire_bytes
    assert rec.kv_bytes > 0
    assert rec.wire_bytes == rec.param_bytes + int8_wire_bytes(rep.engine.cache) // 2
    assert {f: getattr(rec, f) for f in RECORD_FIELDS} == {f: getattr(jrec, f) for f in RECORD_FIELDS}
    assert set(got) == set(shrinks["golden"]) == set(jgot)
    assert all(len(g) == 8 for g in got.values())


def test_migrate_transplants_a_copy_and_the_sampling_stream(qwen):
    """The transplanted cache shares no storage with the old engine's, the
    engine's generator crosses the resize, and the fresh engine reuses the
    old one's compute-dtype parameters; a grow keeps serving."""
    _, tc, _, tp = qwen
    rep = ElasticReplica(tc, tp, 4, n_slots=2, device="cpu", temperature=0.7, seed=3)
    for r in _requests(GenRequest, tc):
        rep.add(r)
    rep.step()
    old = rep.engine
    rep.shrink(2)
    new = rep.engine
    assert new is not old and new._gen is old._gen
    for a, b in zip(tmodel.tree_leaves(old.cache), tmodel.tree_leaves(new.cache)):
        assert a.data_ptr() != b.data_ptr()
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(a is b for a, b in zip(tmodel.tree_leaves(old.params),
                                      tmodel.tree_leaves(new.params)))
    np.testing.assert_array_equal(new.positions, old.positions)
    assert new.positions is not old.positions
    rec = rep.grow(1)
    assert (rec.n_before, rec.n_after, rep.n_members) == (2, 3, 3)
    assert rec.param_bytes == int(rep.param_bytes * (1 / 3))
    done = rep.run()
    assert sorted(r.id for r in done) == [0, 1, 2] and all(len(r.generated) == 8 for r in done)
    assert rep.stats()["n_migrations"] == 2


# --- checkpoints across packages and mesh shapes ------------------------------------------
def test_reshard_restore_from_a_repro_checkpoint(qwen, tmp_path):
    jc, tc, jp, tp = qwen
    jckpt.save(jax_reshard_in_place(jp, jc, jax_serving_mesh(2)), str(tmp_path), step=1)
    restored, man = reshard_restore(tc, tp, str(tmp_path), serving_mesh(1, ["cpu"]))
    assert man["step"] == 1
    for a, b in zip(tmodel.tree_leaves(restored), tmodel.tree_leaves(tp)):
        assert a.device.type == "cpu"
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n_restore", [1, 2, 4])
def test_repro_reshard_restores_a_port_checkpoint(qwen, tmp_path, n_restore):
    jc, tc, jp, tp = qwen
    tckpt.save(reshard_in_place(tp, tc, serving_mesh(3, ["cpu"])), str(tmp_path), step=2)
    mesh = jax_serving_mesh(n_restore)
    restored, man = jax_reshard_restore(jc, jp, str(tmp_path), mesh)
    assert man["step"] == 2
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 restored, jp)
    target = set(np.asarray(mesh.devices).ravel().tolist())
    for leaf in jax.tree.leaves(restored):
        assert leaf.sharding.device_set <= target


# --- devices --------------------------------------------------------------------------------
def test_a_mesh_of_two_distinct_devices_raises(qwen):
    _, tc, _, tp = qwen
    two = ["cpu", "cuda:0"]
    mesh = serving_mesh(2, two)
    assert mesh.axis_sizes == (2,)
    with pytest.raises(NotImplementedError, match="tensor parallelism across cards"):
        reshard_in_place(tp, tc, mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tshard.mesh_device(mesh)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        tshard.NamedSharding(tshard.Mesh(["cuda:0", "cuda:1"], ("model",)), tshard.P()).device
    # one device named twice is one device: placement moves nothing
    same = serving_mesh(2, ["cpu", "cpu"])
    assert tshard.mesh_device(same) == torch.device("cpu")
    placed = reshard_in_place(tp, tc, same)
    assert all(a is b for a, b in zip(tmodel.tree_leaves(placed), tmodel.tree_leaves(tp)))
    assert member_shard_bytes(tp, same) == tree_bytes(tp) // 2
    # the replica takes one device; its mesh is that device
    rep = ElasticReplica(tc, tp, 2, n_slots=1, device="cpu")
    assert rep.mesh_size == 1 and rep.engine.device.type == "cpu"


def test_device_none_raises_without_cuda(qwen, monkeypatch):
    _, tc, _, tp = qwen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert available_gang_devices() == 1
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serving_mesh(2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ElasticReplica(tc, tp, 2)
    rep = ElasticReplica(tc, tp, 3, n_slots=1, device="cpu")
    assert (rep.n_members, rep.mesh_size) == (3, 1)


# --- the benchmark twin -----------------------------------------------------------------------
def test_elastic_serving_benchmark_cli_on_cpu(tmp_path):
    out = tmp_path / "bench.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.elastic_serving",
                        "--device", "cpu", "--smoke", "--out", str(out)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.returncode == 0, r.stderr
    detail = json.loads(out.read_text())
    for size in ("3b", "13b"):
        assert detail[f"{size}_migrate"]["goodput_s"] > detail[f"{size}_lose"]["goodput_s"]
    leg = detail["torch_migration"]
    assert leg["device"] == {"type": "cpu", "name": "cpu"}
    for mode in ("migrate", "replay"):
        assert leg[mode]["tokens_equal"] is True and leg[mode]["n_migrations"] == 1
    r = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.elastic_serving",
                        "--device", "cpu", "--smoke", "--out",
                        str(tmp_path / "BENCH_elastic_serving.json")],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.returncode == 2 and "reference" in r.stderr

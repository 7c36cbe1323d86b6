"""The port's HPC-Whisk platform (``repro_torch.core``, ``.faas``,
``.platform``) against ``repro``'s, on the CPU.

Simulated scenarios give the same ``HarvestResult`` field for field and
request for request on every preset, and the golden pins of
``tests/test_platform.py`` hold through the port with the same literals.
The serving executors hold the port's engines to ``repro``'s at float32 and
temperature 0 on the same parameters: prompts, batched decodes (dense and
paged with a shared tenant prefix), drain and resume, the preemption
hand-off, and whole platform runs with preemptions under equal charged
seconds. Request ids come from a module-level counter in each package;
every test that compares requests starts both counters at 0, and the gang
counters too.
"""
import ast
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.platform as jplat
import repro_torch.core.queues as tqueues
import repro_torch.platform as tplat
from _torch_parity import assert_same_result, configs, params, reset_ids
from repro.platform import executors as jex
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.serving.engine import PagedContinuousEngine as JaxPagedEngine
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.models import model as tmodel
from repro_torch.platform import executors as tex
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import (ContinuousEngine, PagedContinuousEngine,
                                        ServingEngine)

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
PRESETS = ["fib_day", "var_day", "multi_tenant", "multi_tenant_steady",
           "multi_tenant_burst", "preemption_storm", "churn_day", "serving_burst",
           "elastic_storm", "elastic_storm_lose"]


@pytest.fixture
def fresh_ids(monkeypatch):
    reset_ids(monkeypatch)


def _preset(plat, preset: str):
    """The preset at 1800 s; ``elastic_storm_lose`` is ``elastic_storm``'s
    lose-whole-replica baseline (``migrate=False``)."""
    if preset == "elastic_storm_lose":
        return plat.ScenarioConfig.elastic_storm(duration=1800.0, migrate=False)
    return getattr(plat.ScenarioConfig, preset)(duration=1800.0)


# --- simulated scenarios ------------------------------------------------------------
@pytest.mark.parametrize("preset", PRESETS)
def test_preset_runs_equal_repro(preset, fresh_ids):
    jres = jplat.Platform.build(_preset(jplat, preset)).run()
    tres = tplat.Platform.build(_preset(tplat, preset)).run()
    assert tres.n_submitted > 0
    assert_same_result(jres, tres)


def test_hash_run_reproduces_pre_refactor_numbers_through_the_port():
    """``tests/test_platform.py``'s quickstart pin, same literals."""
    sc = tplat.ScenarioConfig(duration=3600.0, seed=0,
                              workload=tplat.WorkloadSection(qps=5.0),
                              scheduling=tplat.SchedulingSection(model="fib"))
    res = tplat.Platform.build(sc).run()
    assert res.n_submitted == 17999
    assert res.outcome_counts == {"success": 8672, "503": 9327}
    assert res.slurm_coverage == 0.7176793559830099
    assert res.sim_upper_bound == 0.5765852603243591
    assert res.response_p50 == 0.5900000000001455
    assert res.response_p95 == 0.5900000000001455
    assert res.invoked_share == 0.48180454469692763
    assert res.success_share == 1.0
    assert res.n_jobs_started == 12
    assert res.n_evicted == 8
    assert float(np.mean(res.worker_samples["healthy"])) == 0.7340720221606648


def test_hash_multi_tenant_run_reproduces_pre_refactor_numbers_through_the_port():
    """``tests/test_platform.py``'s burst-suite pin (static supply), same literals."""
    sc = tplat.ScenarioConfig.multi_tenant_burst(duration=3600.0, scaler="static")
    res = tplat.Platform.build(sc).run()
    assert res.n_submitted == 61340
    assert res.outcome_counts == {"success": 34249, "503": 27091}
    assert res.slurm_coverage == 0.82375880636139
    assert res.n_throttled == 26747
    assert res.response_p95 == 0.870131095641609


def test_facade_matches_platform_build_in_the_port(monkeypatch):
    cfg = tplat.HarvestConfig(model="fib", duration=1800.0, qps=5.0, seed=0)
    monkeypatch.setattr(tqueues, "_REQ_IDS", itertools.count())
    a = tplat.HarvestRuntime(cfg).run()
    monkeypatch.setattr(tqueues, "_REQ_IDS", itertools.count())
    b = tplat.Platform.build(cfg.to_scenario()).run()
    assert_same_result(a, b)


# --- registry -------------------------------------------------------------------------
def test_registry_has_repros_keys():
    for kind in jplat.registry.KINDS:
        assert set(tplat.available(kind)) == set(jplat.available(kind)), kind
    assert tplat.resolve("executor", "batched-serving") is tex.build_batched_serving
    assert tplat.resolve("executor", "sharded-serving") is tplat.build_sharded_serving
    with pytest.raises(KeyError, match="available"):
        tplat.resolve("executor", "does-not-exist")


def test_sharded_serving_builds_on_cpu_and_registers_its_gauges(fresh_ids):
    """``elastic_storm`` with ``sharded-serving``: the factory's smoke
    replica on the CPU, the gang pool's SIGTERM hook driving real resizes
    of it, and the ``kv_*`` and ``replica_*`` gauges reading the replica."""
    sc = tplat.ScenarioConfig.elastic_storm(duration=600.0)
    sc.platform.executor = "sharded-serving"
    sc.platform.executor_params = {"device": "cpu", "n_new": 4}
    p = tplat.Platform.build(sc)
    ex = p.executor
    assert isinstance(ex, tplat.ElasticServingExecutor)
    rep = ex.replica
    assert rep.n_members == sc.platform.gang_size == 3
    assert {t.device.type for t in tmodel.tree_leaves(rep.params)} == {"cpu"}
    res = p.run()
    assert res.outcome_counts.get("success", 0) > 0
    assert len(rep.migrations) == p.metrics.total("gang_migrations_total") > 0
    assert ex.engine is rep.engine          # re-pointed after every resize
    st = ex.engine.kv_stats()
    for name in tex._KV_GAUGES:
        ((labels, gauge),) = p.metrics.gauges_matching(f"kv_{name}").items()
        assert dict(labels) == {"layout": "dense"}
        assert gauge.read() == st[name]
    want = {"replica_mesh_size": rep.mesh_size, "replica_members": rep.n_members,
            "replica_migrations": len(rep.migrations),
            "replica_migrated_bytes": rep.migrated_bytes}
    for name, value in want.items():
        ((_, gauge),) = p.metrics.gauges_matching(name).items()
        assert gauge.read() == value, name


def test_core_imports_nothing_of_faas_or_platform():
    for path in sorted((SRC / "repro_torch" / "core").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert not n.startswith(("repro_torch.faas", "repro_torch.platform")), \
                    f"{path.name}: import {n}"


# --- executors, float32, temperature 0 -----------------------------------------------
@dataclasses.dataclass
class Req:
    id: int
    fn: str


@pytest.fixture(scope="module")
def qwen():
    jc, tc = configs("qwen2.5-3b")
    jp, tp = params(jc, tc)
    return jc, tc, jp, tp


def _engines(qwen, layout, n_slots=4, max_seq=48, attn="gather"):
    jc, tc, jp, tp = qwen
    if layout == "dense":
        return (JaxContinuousEngine(jc, jp, n_slots=n_slots, max_seq=max_seq),
                ContinuousEngine(tc, tp, n_slots=n_slots, max_seq=max_seq, device="cpu"))
    return (JaxPagedEngine(jc, jp, n_slots=n_slots, max_seq=max_seq, block_size=8),
            PagedContinuousEngine(tc, tp, n_slots=n_slots, max_seq=max_seq, block_size=8,
                                  attn=attn, device="cpu"))


@pytest.mark.parametrize("fn", ["fn-a", "img-resize-3", "tenant", "x-y-z"])
def test_prompts_equal_repros(fn):
    assert tex.tenant_of(fn) == jex.tenant_of(fn)
    for prefix_len in (0, 5):
        assert (tex.prompt_for_fn(fn, 128, 12, prefix_len)
                == jex.prompt_for_fn(fn, 128, 12, prefix_len))
    assert tex.tenant_prefix(fn, 151936, 96) == jex.tenant_prefix(fn, 151936, 96)
    with pytest.raises(ValueError, match="prefix_len"):
        tex.prompt_for_fn(fn, 128, 12, 12)


@pytest.mark.parametrize("layout,attn,prefix_len", [("dense", "gather", 0),
                                                    ("paged", "gather", 6),
                                                    ("paged", "kernel", 6)])
def test_run_batch_streams_equal_repros(qwen, layout, attn, prefix_len):
    je, te = _engines(qwen, layout, attn=attn)
    jx = jex.BatchedServingExecutor(je, prompt_len=12, n_new=6, prefix_len=prefix_len)
    tx = tex.BatchedServingExecutor(te, prompt_len=12, n_new=6, prefix_len=prefix_len)
    for batch in ([Req(0, "svc-1"), Req(1, "svc-2"), Req(2, "other-1")],
                  [Req(3, "svc-3"), Req(4, "other-2"), Req(5, "svc-1"),
                   Req(6, "third"), Req(7, "svc-4"), Req(8, "other-3")]):
        times = tx.run_batch(batch)
        jx.run_batch(batch)
        assert len(times) == len(batch) and all(t > 0 for t in times)
        assert tx.last_results == jx.last_results
        assert all(len(t) == 6 for t in tx.last_results.values())
    if prefix_len:
        assert te.kv_stats()["share_hits"] == je.kv_stats()["share_hits"] > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_drain_then_resubmit_resumes_the_uninterrupted_stream(qwen, layout):
    """Twin of ``test_batched_executor_resume_after_drain``."""
    _, tc, _, tp = qwen
    je, te = _engines(qwen, layout, n_slots=2)
    ex = tex.BatchedServingExecutor(te, prompt_len=10, n_new=8)
    prompt = tex.prompt_for_fn("fn-a", tc.vocab_size, 10)
    ref = ServingEngine(tc, tp, max_seq=48, device="cpu").generate(
        np.asarray([prompt], np.int64), 8)[0].tolist()
    jc, _, jp, _ = qwen
    jref = JaxServingEngine(jc, jp, max_seq=48).generate(
        np.asarray([prompt], np.int32), 8)[0].tolist()
    assert ref == jref

    te.add(GenRequest(id=77, prompt=prompt, max_new=8))
    for _ in range(3):
        te.step()
    assert ex.drain() == 1
    assert len(ex._partials[77]) == 4
    times = ex.run_batch([Req(id=77, fn="fn-a")])
    assert len(times) == 1 and times[0] > 0
    assert ex.last_results[77] == ref
    assert not ex._partials


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_note_preempt_parks_the_elapsed_fraction(qwen, layout):
    """Twin of ``test_batched_executor_note_preempt_resumes_prefix``."""
    _, te = _engines(qwen, layout, n_slots=2)
    ex = tex.BatchedServingExecutor(te, prompt_len=10, n_new=8)
    req = Req(id=5, fn="fn-b")
    ex.run_batch([req])
    ref = ex.last_results[5]
    assert len(ref) == 8

    ex.note_preempt(Req(id=99, fn="x"), 1.0, 2.0)
    ex.note_preempt(req, 0.0, 10.0)
    assert 99 not in ex._partials and 5 not in ex._partials

    ex.note_preempt(req, elapsed=5.0, total=10.0)
    assert ex._partials[5] == ref[:4]
    emitted0 = te.n_emitted
    ex.run_batch([req])
    assert ex.last_results[5] == ref
    assert te.n_emitted - emitted0 == 4
    assert 5 not in ex._partials

    ex.note_preempt(req, 0.01, 10.0)   # re-preemption keeps the banked prefix
    assert ex._partials[5] == ref[:4]


def test_serving_executor_decodes_repros_stream(qwen):
    jc, tc, jp, tp = qwen
    te = ServingEngine(tc, tp, max_seq=48, device="cpu")
    streams = []
    generate = te.generate
    te.generate = lambda *a, **k: streams.append(generate(*a, **k)) or streams[-1]
    ex = tex.ServingExecutor(te, prompt_len=12, n_new=6)
    assert ex(Req(0, "fn-c")) > 0
    prompt = np.asarray([jex.prompt_for_fn("fn-c", jc.vocab_size, 12)], np.int32)
    want = JaxServingEngine(jc, jp, max_seq=48).generate(prompt, 6)
    np.testing.assert_array_equal(streams[0], np.asarray(want))


# --- the factories ----------------------------------------------------------------------
def _scenario(executor, duration=300.0, **executor_params):
    return tplat.ScenarioConfig(
        duration=duration, seed=0, trace=tplat.TraceSection(seed=4),
        workload=tplat.WorkloadSection(qps=0.1, n_functions=8),
        scheduling=tplat.SchedulingSection(model="fib"),
        platform=tplat.PlatformSection(executor=executor,
                                       executor_params=executor_params))


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_batched_factory_builds_on_cpu_and_registers_kv_gauges(kv_layout):
    p = tplat.Platform.build(_scenario("batched-serving", device="cpu",
                                       kv_layout=kv_layout, attn="kernel",
                                       kernel_impls="auto", prefix_len=4))
    eng = p.executor.engine
    assert isinstance(eng, PagedContinuousEngine if kv_layout == "paged"
                      else ContinuousEngine)
    assert eng.device.type == "cpu"
    assert eng.cfg.kernel_impls == (("attention", "kernel"), ("rmsnorm", "kernel"))
    res = p.run()
    assert sum(res.outcome_counts.values()) == res.n_submitted
    assert res.outcome_counts.get("success", 0) > 0
    st = eng.kv_stats()
    gauges = {name: p.metrics.gauges_matching(f"kv_{name}") for name in tex._KV_GAUGES}
    for name, found in gauges.items():
        ((labels, gauge),) = found.items()
        assert dict(labels) == {"layout": kv_layout}
        assert gauge.read() == st[name]
    if kv_layout == "paged":
        assert st["share_hits"] > 0


def test_serving_factory_builds_on_cpu():
    p = tplat.Platform.build(_scenario("serving", device="cpu", n_new=4))
    assert isinstance(p.executor.engine, ServingEngine)
    res = p.run()
    assert res.outcome_counts.get("success", 0) > 0


def test_factories_reject_a_jax_engine(qwen):
    jc, _, jp, _ = qwen
    with pytest.raises(TypeError, match="ContinuousEngine of repro_torch"):
        tex.build_batched_serving(None, engine=JaxContinuousEngine(jc, jp, max_seq=32))
    with pytest.raises(TypeError, match="ServingEngine of repro_torch"):
        tex.build_serving(None, engine=JaxServingEngine(jc, jp, max_seq=32))
    with pytest.raises(ValueError, match="kv_layout"):
        tex.build_batched_serving(None, kv_layout="ring", device="cpu")


def test_factories_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tex.build_batched_serving, tex.build_serving,
                  tplat.build_sharded_serving):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tplat.Platform.build(_scenario("batched-serving"))
    sc = tplat.ScenarioConfig.elastic_storm(duration=600.0)
    sc.platform.executor = "sharded-serving"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tplat.Platform.build(sc)


# --- the platform with real decodes, both packages --------------------------------------
def _recording(base):
    """A subclass of ``base`` that decodes each batch for real, records every
    request's decoded stream and charges the request's nominal seconds, so
    both packages take the same virtual path."""
    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.streams, self.resumed, self.preempts = {}, 0, 0

        def run_batch(self, reqs):
            self.resumed += sum(r.id in self._partials for r in reqs)
            super().run_batch(reqs)
            for rid, toks in self.last_results.items():
                self.streams.setdefault(rid, []).append(toks)
            return [r.exec_time for r in reqs]

        def note_preempt(self, req, elapsed, total):
            self.preempts += 1
            super().note_preempt(req, elapsed, total)
    return Recording


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_platform_with_real_decodes_equals_repro(qwen, layout, fresh_ids):
    """600 s, pilots evicted mid-call (grace 10 s, 60 s calls): requests are
    preempted, parked and resumed alike in both packages."""
    je, te = _engines(qwen, layout, max_seq=32)
    kw = dict(prompt_len=12, n_new=8, prefix_len=4 if layout == "paged" else 0)
    jx = _recording(jex.BatchedServingExecutor)(je, **kw)
    tx = _recording(tex.BatchedServingExecutor)(te, **kw)
    results = []
    for plat, ex in ((jplat, jx), (tplat, tx)):
        sc = plat.ScenarioConfig(
            duration=600.0, seed=0, trace=plat.TraceSection(seed=4),
            workload=plat.WorkloadSection(qps=0.1, n_functions=8, exec_time=60.0,
                                          timeout=900.0),
            scheduling=plat.SchedulingSection(model="fib", grace=10.0),
            platform=plat.PlatformSection(invoker_params={"concurrency": 4}))
        results.append(plat.Platform.build(sc, executor=ex).run())
    assert_same_result(*results)
    assert tx.preempts == jx.preempts > 0
    assert tx.resumed == jx.resumed > 0
    assert tx.streams == jx.streams
    assert all(len(s) == 8 for runs in tx.streams.values() for s in runs)


# --- the twin CLIs -----------------------------------------------------------------------
def _cli(*args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=300)


def test_harvest_serving_cli_on_cpu():
    r = _cli("repro_torch.launch.harvest_serving", "--device", "cpu", "--minutes", "2")
    assert r.returncode == 0, r.stderr
    assert "2 simulated minutes" in r.stdout and "on cpu" in r.stdout
    assert "batched decode" in r.stdout


def test_serving_batching_cli_on_cpu(tmp_path):
    out = tmp_path / "bench.json"
    r = _cli("repro_torch.benchmarks.serving_batching", "--device", "cpu", "--smoke",
             "--out", str(out))
    assert r.returncode == 0, r.stderr
    detail = json.loads(out.read_text())["serving_batching"]
    assert detail["outputs_match"] is True
    assert detail["device"] == {"type": "cpu", "name": "cpu"}
    r = _cli("repro_torch.benchmarks.serving_batching", "--device", "cpu", "--smoke",
             "--out", str(tmp_path / "BENCH_serving_batching.json"))
    assert r.returncode == 2 and "reference" in r.stderr

"""The port's serving engines against ``repro``'s, plus the port's rules.

Temperature-0 token streams at float32 on the qwen2.5-3b smoke config must
equal the JAX ``ContinuousEngine``/``ServingEngine`` streams: batched ==
sequential, drain/resume == uninterrupted, and early EOS (the eos picked by
its first occurrence in the stream). The rules: the port imports no JAX and
no ``repro`` module, an entry point not given ``device="cpu"`` raises
without CUDA, and the CLI serves on the CPU.
"""
import ast
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import configs, params
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.models import model as tmodel
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, PagedContinuousEngine, ServingEngine
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.slot_state import SlotBatchState, graft_slot

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs("qwen2.5-3b", "auto")
    jp, tp = params(jc, tc)
    return jc, tc, jp, tp


def _prompts(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 12))).tolist() for _ in range(n)]


def _serve(engine, prompts, max_new=6, gen_cls=None):
    for i, p in enumerate(prompts):
        engine.add((gen_cls or GenRequest)(id=i, prompt=p, max_new=max_new))
    return {r.id: list(r.generated) for r in engine.run()}


def test_continuous_equals_sequential_and_jax(setup):
    from repro.serving.batching import GenRequest as JaxGenRequest
    jc, tc, jp, tp = setup
    prompts = _prompts(tc.vocab_size)
    port = _serve(ContinuousEngine(tc, tp, n_slots=3, max_seq=32, device="cpu"), prompts)
    ref = _serve(JaxContinuousEngine(jc, jp, n_slots=3, max_seq=32), prompts,
                 gen_cls=JaxGenRequest)
    assert port == ref
    seq = ServingEngine(tc, tp, max_seq=32, device="cpu")
    jseq = JaxServingEngine(jc, jp, max_seq=32)
    for i, p in enumerate(prompts):
        out = seq.generate(np.asarray([p]), 6)
        assert out[0].tolist() == port[i]
        assert out.tolist() == jseq.generate(np.asarray([p], np.int32), 6).tolist()
    assert seq.peak_cache_bytes == jseq.peak_cache_bytes


def test_drain_resume_equals_uninterrupted(setup):
    from repro.serving.batching import GenRequest as JaxGenRequest
    jc, tc, jp, tp = setup
    prompts = _prompts(tc.vocab_size, n=4, seed=1)
    full = _serve(ContinuousEngine(tc, tp, n_slots=2, max_seq=40, device="cpu"),
                  prompts, max_new=8)
    eng = ContinuousEngine(tc, tp, n_slots=2, max_seq=40, device="cpu")
    for i, p in enumerate(prompts):
        eng.add(GenRequest(id=i, prompt=p, max_new=8))
    for _ in range(3):
        eng.step()
    partial = eng.drain()
    assert any(r.generated for r in partial) and not eng.batcher.active()
    done = {r.id: r.generated for r in eng.batcher.finished}
    eng2 = ContinuousEngine(tc, tp, n_slots=2, max_seq=40, device="cpu")
    for r in partial:
        eng2.add(r)
    done.update({r.id: r.generated for r in eng2.run()})
    assert done == full
    assert full == _serve(JaxContinuousEngine(jc, jp, n_slots=2, max_seq=40), prompts,
                          max_new=8, gen_cls=JaxGenRequest)


def test_eos_frees_slot_early_like_jax(setup):
    """The eos is a token at its FIRST occurrence in the greedy stream, so
    the request stops exactly there; a second request then takes the slot."""
    from repro.serving.batching import GenRequest as JaxGenRequest
    jc, tc, jp, tp = setup
    prompt = np.random.default_rng(3).integers(0, tc.vocab_size, size=8).tolist()
    probe = JaxContinuousEngine(jc, jp, n_slots=1, max_seq=48)
    probe.add(JaxGenRequest(id=0, prompt=prompt, max_new=8))
    full = probe.run()[0].generated
    j = next(i for i in range(1, len(full)) if full[i] not in full[:i])
    eos = full[j]
    outs = []
    for eng, cls in ((ContinuousEngine(tc, tp, n_slots=1, max_seq=48, eos_id=eos,
                                       device="cpu"), GenRequest),
                     (JaxContinuousEngine(jc, jp, n_slots=1, max_seq=48, eos_id=eos),
                      JaxGenRequest)):
        eng.add(cls(id=0, prompt=prompt, max_new=8))
        eng.add(cls(id=1, prompt=prompt, max_new=8))
        done = {r.id: list(r.generated) for r in eng.run()}
        assert done[0] == full[:j + 1] and len(done) == 2
        outs.append(done)
    assert outs[0] == outs[1]


def test_graft_zeroes_the_whole_row(setup):
    _, tc, _, _ = setup
    state = SlotBatchState(tc, 3, 16, device="cpu")
    for leaf in tmodel.tree_leaves(state.tree):
        leaf.fill_(7.0)                      # stale state of earlier requests
    pre = tmodel.init_cache(tc, 1, 5, device="cpu")
    for leaf in tmodel.tree_leaves(pre):
        leaf.fill_(1.0)
    graft_slot(state.tree, pre, 1, state.batch_axes)
    k = state.tree["dense"]["k"]             # (L, B, S, KV, Dh)
    assert bool((k[:, 1, :5] == 1).all()) and bool((k[:, 1, 5:] == 0).all())
    assert bool((k[:, 0] == 7).all()) and bool((k[:, 2] == 7).all())
    with pytest.raises(ValueError, match="cannot graft"):
        graft_slot(state.tree, tmodel.init_cache(tc, 1, 17, device="cpu"), 0, state.batch_axes)


def test_kv_stats_and_grown_cache_match_jax(setup):
    jc, tc, jp, tp = setup
    port = ContinuousEngine(tc, tp, n_slots=2, max_seq=32, device="cpu")
    ref = JaxContinuousEngine(jc, jp, n_slots=2, max_seq=32)
    from repro.serving.batching import GenRequest as JaxGenRequest
    port.add(GenRequest(id=0, prompt=[1, 2, 3], max_new=4))
    ref.add(JaxGenRequest(id=0, prompt=[1, 2, 3], max_new=4))
    assert port.kv_stats() == ref.kv_stats()
    seq = ServingEngine(tc, tp, max_seq=64, device="cpu")
    grown = seq._grown_cache(tmodel.init_cache(tc, 1, 5, device="cpu"), 2, 24)
    assert tuple(grown["dense"]["k"].shape) == (tc.n_layers, 2, 24, tc.n_kv_heads, tc.head_dim)
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, size=(2, 12))
    want = JaxServingEngine(jc, jp, max_seq=64).score(toks)
    np.testing.assert_allclose(seq.score(toks), want, atol=5e-5, rtol=5e-4)


# --- the port's rules -------------------------------------------------------------
def test_port_imports_no_jax_and_no_repro():
    """Import every module of the port in a fresh interpreter: neither JAX
    nor any ``repro`` module may come in with them."""
    code = ("import importlib, pkgutil, sys\n"
            "import repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert len(names) > 15, names\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), f"{path}: import {n}"


def test_entry_points_need_cuda_unless_asked_for_cpu(setup, monkeypatch):
    _, tc, _, tp = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.benchmarks import elastic_serving, serving_batching
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.platform.elastic import build_sharded_serving
    from repro_torch.launch import harvest_serving, serve
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.platform.executors import build_batched_serving, build_serving
    tree = tmodel.tree_map(lambda t: t.numpy(), tp)
    calls = [
        lambda: ContinuousEngine(tc, tp),
        lambda: PagedContinuousEngine(tc, tp),
        lambda: PagedContinuousEngine(tc, tp, attn="kernel"),
        lambda: PagedKVCache(tc, n_blocks=4, block_size=4),
        lambda: ServingEngine(tc, tp),
        lambda: tmodel.init_params(tc, torch.Generator()),
        lambda: params_from_numpy(tree, tc),
        lambda: tmodel.init_cache(tc, 1, 8),
        lambda: serve.main(["--requests", "1"]),
        lambda: build_batched_serving(None),
        lambda: build_batched_serving(None, kv_layout="paged"),
        lambda: build_serving(None),
        lambda: harvest_serving.main(["--minutes", "1"]),
        lambda: serving_batching.bench_serving(n_requests=1),
        lambda: elastic_serving.torch_migration_cell(),
        lambda: ElasticReplica(tc, tp, 2),
        lambda: build_sharded_serving(None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    # asked for the CPU, each one works
    ContinuousEngine(tc, tp, device="cpu")
    PagedContinuousEngine(tc, tp, device="cpu")
    PagedKVCache(tc, n_blocks=4, block_size=4, device="cpu")
    params_from_numpy(tree, tc, device="cpu")


def test_serve_cli_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--prompt-len", "8", "--new-tokens", "4", "--batch-slots", "2"],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "served 3 requests, 12 tokens" in r.stdout and "on cpu" in r.stdout


def test_serve_sigterm_drains_and_exits_143(setup):
    _, tc, _, tp = setup
    from repro_torch.launch.serve import _drain_and_exit
    eng = ContinuousEngine(tc, tp, n_slots=1, max_seq=32, device="cpu")
    eng.add(GenRequest(id=0, prompt=[1, 2, 3], max_new=8))
    eng.add(GenRequest(id=1, prompt=[4, 5], max_new=8))
    eng.step()
    with pytest.raises(SystemExit) as exc:
        _drain_and_exit(eng)
    assert exc.value.code == 143 == 128 + signal.SIGTERM
    assert not eng.batcher.active() and not eng.batcher.waiting

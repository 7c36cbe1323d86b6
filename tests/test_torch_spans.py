"""The port's span recorder (``repro_torch.spans``) and its spans on the
serving path.

On the mixtral smoke config (float32, ``auto``: the ``moe_gmm`` twins' plain
paths) the engine's spans form the tree that the benchmark's readers
assume: ``engine.admit`` (request id) holding each MoE layer and the
admission's pick, ``engine.step`` (step number) holding one
``model.decode_step`` with each MoE layer, and one ``engine.pick``. The MoE
spans count the picks and the rows the kernel launches. The ring keeps
the last ``CAPACITY`` records; no span becomes a profiler event; the clock
maps onto the profiler's; and the temperature-0 streams stay JAX's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import configs, params
from repro.serving.batching import GenRequest as JaxGenRequest
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro_torch import spans
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ContinuousEngine, PagedContinuousEngine

ARCH = "mixtral-8x22b"
PROGRAM = ("engine.", "model.")


@pytest.fixture(scope="module")
def mixtral():
    jc, tc = configs(ARCH, "auto", moe_impl="ragged")
    jp, tp = params(jc, tc)
    return jc, tc, jp, tp


def _prompts(vocab, sizes, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in sizes]


def _serve(engine, prompts, max_new, cls, first_id=0):
    for i, p in enumerate(prompts):
        engine.add(cls(id=first_id + i, prompt=p, max_new=max_new))
    return {r.id: list(r.generated) for r in engine.run()}


def _launched(n, k, e):
    """The dropless path's static worst case for ``n`` tokens: every
    expert's rows rounded up to whole tiles."""
    bt = 128 if n * k >= 128 else 8
    return -(-n * k // bt) * bt + e * bt


def test_engine_span_tree_and_moe_rows(mixtral):
    _, tc, _, tp = mixtral
    sizes = [70, 9, 30]       # 140 picks at tile 128; 18 and 60 at tile 8
    engine = ContinuousEngine(tc, tp, n_slots=2, max_seq=96, device="cpu")
    spans.clear()
    _serve(engine, _prompts(tc.vocab_size, sizes), 4, GenRequest, first_id=10)
    recs = spans.records()
    by = {r.seq: r for r in recs}
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    assert spans.dropped() == 0
    assert {r.name for r in recs} == {"engine.admit", "engine.pick", "engine.step",
                                      "model.decode_step", "model.moe"}

    admits = [r for r in recs if r.name == "engine.admit"]
    assert [r.id for r in admits] == [10, 11, 12] and all(r.parent is None for r in admits[:2])
    for a, n in zip(admits, sizes):
        ch = kids[a.seq]
        moe = [c for c in ch if c.name == "model.moe"]
        assert [c.name for c in ch].count("engine.pick") == 1 and len(moe) == tc.n_layers
        for m in moe:
            assert m.counts == {"rows": n * tc.top_k,
                                "rows_launched": _launched(n, tc.top_k, tc.n_experts)}
    # the third request waits for a slot: the step that frees one admits it
    assert by[admits[2].parent].name == "engine.step"

    steps = [r for r in recs if r.name == "engine.step"]
    decoding = [s for s in steps
                if any(c.name == "model.decode_step" for c in kids.get(s.seq, []))]
    assert [s.id for s in decoding] == list(range(engine.n_decode_steps))
    for s in decoding:
        names = [c.name for c in kids[s.seq]]
        assert names.count("model.decode_step") == 1 and names.count("engine.pick") == 1
        assert set(names) <= {"model.decode_step", "engine.pick", "engine.admit"}
        (d,) = [c for c in kids[s.seq] if c.name == "model.decode_step"]
        moe = kids[d.seq]
        assert [m.name for m in moe] == ["model.moe"] * tc.n_layers
        assert all(m.counts == {"rows": 2 * tc.top_k,
                                "rows_launched": _launched(2, tc.top_k, tc.n_experts)}
                   for m in moe)
        for c in kids[s.seq]:
            assert s.start <= c.start <= c.end <= s.end


def test_capacity_form_counts_its_buffer(mixtral):
    _, tc, _, tp = mixtral
    cfg = dataclasses.replace(tc, moe_impl="scatter")
    p = transformer._layer(tp["stack"]["moe"], 0)["moe"]
    x = torch.randn(1, 24, tc.d_model, generator=torch.Generator().manual_seed(0))
    spans.clear()
    tmoe.apply_moe(p, x, cfg, impl="gmm")
    (m,) = spans.records()
    assert m.name == "model.moe"
    assert m.counts == {"rows": 24 * cfg.top_k,
                        "rows_launched": cfg.n_experts * tmoe._capacity(24, cfg)}


@pytest.mark.parametrize("paged", [False, True])
def test_each_decode_step_holds_one_dispatch_and_one_pick(paged):
    jc, tc = configs("qwen2.5-3b", "auto")
    _, tp = params(jc, tc)
    engine = (PagedContinuousEngine(tc, tp, n_slots=2, max_seq=32, attn="kernel", device="cpu")
              if paged else ContinuousEngine(tc, tp, n_slots=2, max_seq=32, device="cpu"))
    spans.clear()
    _serve(engine, _prompts(tc.vocab_size, [5, 7, 6]), 3, GenRequest)
    recs = spans.records()
    for s in (r for r in recs if r.name == "engine.step"):
        names = sorted(r.name for r in recs if r.parent == s.seq)
        assert names in (["engine.pick", "model.decode_step"],
                         ["engine.admit", "engine.pick", "model.decode_step"])


def test_ring_keeps_the_last_capacity_records():
    spans.clear()
    extra = 5
    first = None
    for i in range(spans.CAPACITY + extra):
        with spans.span("x", i) as s:
            if first is None:
                first = s.seq
            spans.count(n=1)
    recs = spans.records()
    assert len(recs) == spans.CAPACITY and spans.dropped() == extra
    assert recs[0].id == extra and recs[0].seq == first + extra and recs[-1].counts == {"n": 1}
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_spans_close_on_error_and_count_needs_an_open_span():
    spans.clear()
    spans.count(rows=3)           # nothing open: nothing to add to
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise ValueError("x")
    inner, outer = spans.records()
    assert (inner.name, inner.parent, outer.name, outer.parent) == (
        "inner", outer.seq, "outer", None)
    with spans.span("after") as a:
        pass
    assert a.parent is None


def test_no_program_span_is_a_profiler_event(mixtral):
    from torch.profiler import ProfilerActivity, profile
    _, tc, _, tp = mixtral
    engine = ContinuousEngine(tc, tp, n_slots=2, max_seq=40, device="cpu")
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(engine, _prompts(tc.vocab_size, [6, 8]), 3, GenRequest)
    names = {e.name for e in prof.events()}
    assert names and not [n for n in names if n.startswith(PROGRAM)]
    assert {r.name for r in spans.records()} >= {"engine.step", "model.moe"}


def test_profiler_ns_maps_inside_the_span():
    from torch.profiler import ProfilerActivity, profile, record_function
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(200):
            with spans.span("outer", i):
                with record_function(f"inner{i}"):
                    torch.ones(4).sum()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    inner = {e.name: e for e in prof.events() if e.name.startswith("inner")}
    recs = spans.records()
    assert len(recs) == len(inner) == 200
    for r in recs:
        tr = inner[f"inner{r.id}"].time_range
        assert spans.profiler_ns(r.start) <= t0 + tr.start * 1000
        assert t0 + tr.end * 1000 <= spans.profiler_ns(r.end)


def test_temperature0_streams_stay_jax(mixtral):
    jc, tc, jp, tp = mixtral
    prompts = _prompts(tc.vocab_size, [5, 11, 8, 4, 9], seed=5)
    want = _serve(JaxContinuousEngine(jc, jp, n_slots=3, max_seq=40), prompts, 7, JaxGenRequest)
    spans.clear()
    got = _serve(ContinuousEngine(tc, tp, n_slots=3, max_seq=40, device="cpu"), prompts, 7,
                 GenRequest)
    assert got == want
    assert sum(r.name == "engine.admit" for r in spans.records()) == len(prompts)

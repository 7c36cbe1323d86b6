"""The port's data pipeline, checkpoint and training launcher against
``repro``'s: pipeline batches bit for bit over seeds, steps and DP ranks;
checkpoints that either package wrote restore in the other (a ``{"params",
"opt"}`` tree at float32, and a bf16 leaf, which the port stores as
float32); the ``repro`` error cases; a restart that continues the loss
curve and a resume that ends with the bits of an unbroken run; the CLIs on
the CPU; and ``device=None`` raising without CUDA.
"""
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, params
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.model import tree_map
from repro_torch.training.optimizer import tree_leaves

pytestmark = pytest.mark.slow


# --- data pipeline -----------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_pipeline_batches_equal_repros(seed):
    jc, tc = jax_get_config("internlm2-1.8b", smoke=True), get_config("internlm2-1.8b", smoke=True)
    for rank, size in ((0, 1), (1, 2), (3, 4)):
        jp = jpipe.DataPipeline(jc, 8, 33, seed=seed, dp_rank=rank, dp_size=size)
        tp = tpipe.DataPipeline(tc, 8, 33, seed=seed, dp_rank=rank, dp_size=size)
        for _ in range(3):
            jb, tb = jp.next_batch(), tp.next_batch()
            assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
            for k in jb:
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])
        assert tp.state_dict() == jp.state_dict() == {"step": 3}
    np.testing.assert_array_equal(tpipe.synth_tokens(seed, 5, 100, 1000),
                                  jpipe.synth_tokens(seed, 5, 100, 1000))


def test_pipeline_state_dict_round_trip():
    cfg = get_config("internlm2-1.8b", smoke=True)
    p = DataPipeline(cfg, 4, 16, seed=2)
    for _ in range(2):
        p.next_batch()
    q = DataPipeline(cfg, 4, 16, seed=2)
    q.load_state_dict(p.state_dict())
    assert q.state.step == 2
    np.testing.assert_array_equal(q.next_batch()["tokens"], p.next_batch()["tokens"])


def test_pipeline_deterministic_and_topology_invariant():
    """The twin of ``test_substrate.py``'s test of the same name."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    b_full = DataPipeline(cfg, global_batch=8, seq_len=32, seed=1).next_batch()
    shards = [DataPipeline(cfg, global_batch=8, seq_len=32, seed=1, dp_rank=r,
                           dp_size=4).next_batch() for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([s["tokens"] for s in shards]),
                                  b_full["tokens"])


def test_pipeline_resume_from_state():
    """The twin of ``test_substrate.py``'s test of the same name."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    p1 = DataPipeline(cfg, 4, 16, seed=2)
    batches = [p1.next_batch() for _ in range(5)]
    p2 = DataPipeline(cfg, 4, 16, seed=2)
    p2.load_state_dict({"step": 3})
    np.testing.assert_array_equal(p2.next_batch()["tokens"], batches[3]["tokens"])


def test_synth_data_is_learnable_markov():
    """The twin of ``test_substrate.py``'s test of the same name."""
    rows = tpipe.synth_sequence_rows(0, np.arange(64), 128, 64, p_markov=0.8)
    frac = float(np.mean((rows[:, :-1] * 31 + 7) % 64 == rows[:, 1:]))
    assert 0.7 < frac < 0.9


# --- checkpoint --------------------------------------------------------------
def test_checkpoint_roundtrip_and_latest():
    """The twin of ``test_substrate.py``'s test of the same name."""
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(tree, d, step=10)
        ckpt.save(tree_map(lambda x: x * 2, tree), d, step=20)
        assert ckpt.latest_step(d) == 20
        restored, man = ckpt.restore(tree, d, device="cpu")
        assert man["step"] == 20
        assert torch.equal(restored["a"], tree["a"] * 2)
        assert restored["b"]["c"].dtype == torch.int32


def test_checkpoint_ignores_uncommitted():
    """The twin of ``test_substrate.py``'s test of the same name."""
    with tempfile.TemporaryDirectory() as d:
        ckpt.save({"a": torch.ones(3)}, d, step=1)
        os.makedirs(os.path.join(d, "step_00000002"))  # partial write, no marker
        assert ckpt.latest_step(d) == 1


def test_checkpoint_async_snapshots_before_returning():
    """The twin of ``test_substrate.py::test_checkpoint_async``, plus: the
    tree may change as soon as ``save`` returns (the optimizer updates it
    in place) and the checkpoint still holds the values at the call."""
    tree = {"a": torch.ones((128, 128))}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(tree, d, step=5, async_save=True)
        tree["a"].mul_(3)
        ckpt.wait_for_saves()
        assert ckpt.latest_step(d) == 5
        restored, _ = ckpt.restore(tree, d, device="cpu")
        assert torch.equal(restored["a"], torch.ones((128, 128)))


def _train_state(arch="internlm2-1.8b"):
    """(jax {"params", "opt"}, torch {"params", "opt"}) with the same values."""
    jc, tc = configs(arch)
    jp, tp = params(jc, tc)
    jopt = {"m": jax.tree.map(lambda p: p * 0.5, jp), "v": jax.tree.map(jnp.square, jp),
            "step": jnp.int32(7)}
    topt = {"m": tree_map(lambda p: p * 0.5, tp), "v": tree_map(torch.square, tp),
            "step": torch.tensor(7, dtype=torch.int32)}
    return {"params": jp, "opt": jopt}, {"params": tp, "opt": topt}


def _assert_same(tree, jtree):
    got, want = tree_leaves(tree), jax.tree.leaves(jtree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_checkpoint_written_by_repro_restores_in_the_port():
    jstate, tstate = _train_state()
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(jstate, d, step=7, extra={"pipeline": {"step": 7}})
        restored, man = ckpt.restore(tstate, d, device="cpu")
    assert man["step"] == 7 and man["extra"] == {"pipeline": {"step": 7}}
    _assert_same(restored, jstate)
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 7


def test_checkpoint_written_by_the_port_restores_in_repro():
    """Same keys, same manifest: ``repro``'s restore reads the port's
    checkpoint into a ``jax.eval_shape`` template."""
    jstate, tstate = _train_state()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(tstate, d, step=7, extra={"pipeline": {"step": 7}})
        template = jax.eval_shape(lambda: jstate)
        restored, man = jckpt.restore(template, d)
        with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
            port_manifest = f.read()
        jckpt.save(jstate, os.path.join(d, "jax"), step=7, extra={"pipeline": {"step": 7}})
        with open(os.path.join(d, "jax", "step_00000007", "manifest.json")) as f:
            jax_manifest = f.read()
    assert port_manifest == jax_manifest
    assert man["step"] == 7 and man["extra"] == {"pipeline": {"step": 7}}
    _assert_same(tstate, restored)


def test_checkpoint_bf16_leaf_round_trips_and_repro_reads_it():
    """A bf16 leaf is stored as float32 with ``"bfloat16"`` in the
    manifest; the port casts it back, and ``repro``'s restore reads it
    into a bf16 template."""
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tree = {"w": w, "n": torch.ones(2)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(tree, d, step=1)
        restored, man = ckpt.restore(tree, d, device="cpu")
        template = {"w": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16),
                    "n": jax.ShapeDtypeStruct((2,), jnp.float32)}
        jrestored, _ = jckpt.restore(template, d)
    assert man["arrays"]["w"]["dtype"] == "bfloat16"
    assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], w)
    assert jrestored["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jrestored["w"], np.float32), w.float().numpy())


def test_a_bf16_leaf_that_repro_wrote_restores_in_neither_package():
    """A reference caveat (ROADMAP §3): ``repro``'s ``save`` writes a bf16
    leaf as numpy's raw ``|V2``, which its own ``restore`` cannot cast
    back, and neither can the port's. The port writes such a leaf as
    float32 (the test above)."""
    tree = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(tree, d, step=1)
        with np.load(os.path.join(d, "step_00000001", "arrays.npz")) as data:
            assert data["w"].dtype == np.dtype("V2")
        with pytest.raises((TypeError, ValueError)):
            jckpt.restore(jax.eval_shape(lambda: tree), d)
        with pytest.raises(TypeError):
            ckpt.restore({"w": torch.ones((2, 3), dtype=torch.bfloat16)}, d, device="cpu")


def test_checkpoint_shape_mismatch_and_missing_key_raise_as_in_repro():
    with tempfile.TemporaryDirectory() as d:
        ckpt.save({"a": torch.ones(3)}, d, step=1)
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore({"a": torch.ones(4)}, d, device="cpu")
        with pytest.raises(KeyError, match="missing"):
            ckpt.restore({"a": torch.ones(3), "b": torch.ones(1)}, d, device="cpu")
        with pytest.raises(ValueError, match="shape"):
            jckpt.restore({"a": jax.ShapeDtypeStruct((4,), jnp.float32)}, d)
        with pytest.raises(KeyError, match="missing"):
            jckpt.restore({"a": jax.ShapeDtypeStruct((3,), jnp.float32),
                           "b": jax.ShapeDtypeStruct((1,), jnp.float32)}, d)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            ckpt.restore({"a": torch.ones(3)}, d, device="cpu")


# --- launcher ----------------------------------------------------------------
def test_train_failure_restart_continues_loss_curve():
    """The twin of ``test_system.py``'s test of the same name."""
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(arch="internlm2-1.8b", smoke=True, steps=12, global_batch=4,
                         seq_len=32, ckpt_dir=d, ckpt_every=6, log_every=3, lr=2e-3)
        _, _, h1 = train(TrainConfig(**{**tc.__dict__, "steps": 6}), device="cpu")
        _, _, h2 = train(tc, device="cpu")  # resumes from step 6
    assert h2[0][0] > 6
    assert h2[-1][1] < h1[0][1] + 0.5


def test_resume_equals_an_unbroken_run_bit_for_bit():
    """Train 6 steps with a checkpoint every 3; drop the last checkpoint
    and train again: the run resumes at step 3 and ends with the bits of
    the unbroken one (params, m, v, step, the logged losses)."""
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(arch="internlm2-1.8b", smoke=True, steps=6, global_batch=4,
                         seq_len=32, n_microbatches=2, ckpt_dir=d, ckpt_every=3, log_every=1)
        p1, o1, h1 = train(tc, device="cpu")
        os.remove(os.path.join(d, "step_00000006", "COMMITTED"))
        assert ckpt.latest_step(d) == 3
        p2, o2, h2 = train(tc, device="cpu")
    assert h2 == h1[3:]
    for a, b in zip(tree_leaves({"p": p1, "o": o1}), tree_leaves({"p": p2, "o": o2})):
        assert torch.equal(a, b)


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": "src"})


def test_train_cli_runs_on_the_cpu():
    proc = _run("repro_torch.launch.train", "--device", "cpu", "--steps", "4",
                "--seq-len", "32", "--global-batch", "4")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step     4 loss" in proc.stdout and "loss " in proc.stdout.splitlines()[-1]


def test_train_lm_runs_a_failure_and_restart():
    proc = _run("repro_torch.launch.train_lm", "--device", "cpu", "--steps", "8")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "resumed from step" in proc.stdout and "across a simulated failure" in proc.stdout


def test_device_none_without_cuda_raises(monkeypatch):
    """``None`` means the card: without CUDA ``train``, ``restore`` and the
    CLIs raise naming ``device="cpu"``."""
    from repro_torch.launch import train as train_cli
    from repro_torch.launch import train_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save({"a": torch.ones(3)}, d, step=1)
        calls = [lambda: train(TrainConfig(steps=1)),
                 lambda: ckpt.restore({"a": torch.ones(3)}, d),
                 lambda: train_cli.main(["--steps", "1"]),
                 lambda: train_lm.main(["--steps", "2"])]
        for call in calls:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()

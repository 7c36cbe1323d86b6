"""The full-sequence path of the port under a tensor-parallel group
(``forward`` and ``loss_fn`` with ``tp``) against ``repro`` on one device,
on the CPU at float32, for all ten archs at smoke size, and the group
resize that moves a replica leaf by leaf.

Ranks are processes of their own over gloo, started by ``spawn_tp`` from a
script that a subprocess runs under a timeout of its own (the pattern of
``test_torch_tp.py``); each group starts once per module, two ranks and
four, while ``repro``'s references are computed here.

- ``forward`` (the whole logits, gathered, and the MoE load-balance loss)
  and ``loss_fn`` (``ce``, ``lb_loss``, ``loss``) of every arch on 2 and 4
  ranks against ``repro``'s one device at 5e-5/5e-4, under both of
  ``repro``'s CE forms (the gather, and ``shard_activations``' masked
  reduction): every smoke config splits over 2 and 4 ranks. The frontends
  are in: hubert's audio frames through its non-causal encoder (its layer-0
  attention at the rank's heads also against ``repro``'s), internvl2's
  vision patches before its text.
- The vocab-parallel cross-entropy (each rank's columns, never gathered)
  against ``log_softmax`` of the gathered logits on the padded vocabulary.
- Replicated KV heads: at 4 ranks qwen2.5-3b's one KV head and
  internvl2's two each sit whole on several ranks (rank ``r`` holds head
  ``r * kv // 4``).
- The resize: zamba2's smoke replica (stacked mamba leaves two deep, the
  shared block, the hybrid cache) shrinks 2 -> 1 and grows 1 -> 2 in each
  KV mode with the unbroken run's streams, ``last_resize``'s bytes equal to
  the counts from the shards, and every whole piece a rank gathers or cuts
  at most one layer of one leaf, so no rank holds a whole tree.
"""
import dataclasses
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

from _torch_parity import F32_TOL, close, configs, params
from test_torch_forward import _batch, _jax
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.distributed.tensor_parallel import _unsplit
from repro_torch.models.model import param_specs, tree_leaves

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = sorted(JAX_ARCH_IDS)
WORLDS = (2, 4)
KV_MODES = ("migrate", "replay", "migrate_int8")

# the ranks' program: ``python tp_forward_ranks.py <world> <inputs.pkl> <out.pkl>``
_RANKS = textwrap.dedent('''
    import dataclasses, itertools, pickle, sys
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.distributed.elastic_serving import migration
    from repro_torch.models import model as M
    from repro_torch.models.attention import attention
    from repro_torch.models.layers import cross_entropy, local_logits, logits_from_hidden
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.serving.batching import GenRequest


    def config(arch, **kw):
        return dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)


    def one_arch(tp, arch, d):
        cfg = config(arch)
        shard = params_from_numpy(d["params"], cfg, "cpu", tp)
        batch = {k: torch.as_tensor(v) for k, v in d["batch"].items()}
        out = {}
        logits, aux = M.forward(shard, batch, cfg, tp)
        out["logits"], out["lb"] = logits.numpy(), float(aux["lb_loss"])
        for sa in (False, True):
            _, m = M.loss_fn(shard, batch, config(arch, shard_activations=sa), tp=tp)
            out[("loss", sa)] = {k: float(v) for k, v in m.items()}
        # the vocab-parallel CE against log_softmax of the gathered logits
        x, _ = M._hidden(shard, batch, cfg, tp)
        head = M._head_weight(shard, cfg)
        labels = batch["labels"]
        loc, whole = local_logits(head, x, tp), logits_from_hidden(head, x, cfg, tp)
        if cfg.is_autoregressive:
            loc, whole, labels = loc[:, :-1], whole[:, :-1], labels[:, 1:]
        out["ce_split"] = float(cross_entropy(loc, labels, cfg, tp))
        logp = torch.log_softmax(whole, dim=-1)
        out["ce_gathered"] = float(-logp.gather(-1, labels[..., None])[..., 0].mean())
        out["head_cols"] = tuple(head.shape)
        local = T.tp_local(cfg, tp)
        out["local"] = (local.n_heads, local.n_kv_heads)
        if "dense" in shard["stack"] and not cfg.use_mla:
            out["wk0"] = shard["stack"]["dense"]["attn"]["wk"][0].numpy()
        if arch == "hubert-xlarge":
            l0 = {k: v[0] for k, v in shard["stack"]["dense"]["attn"].items()}
            x = torch.as_tensor(d["x"])
            pos = torch.arange(x.shape[1]).expand(x.shape[0], x.shape[1])
            out["attention"] = attention(l0, x, pos, local, tp).numpy()
        return out


    def resize_run(tp, d, kv_mode, n0, plan):
        """zamba2's smoke replica on ``n0`` ranks, resized after each
        ``steps`` of ``plan`` ((steps, n), ...); every whole piece that
        ``gather_shards`` hands the migration and every leaf the migration
        cuts recorded by its element count."""
        cfg = config("zamba2-2.7b")
        full = params_from_numpy(d["zamba2"], cfg, "cpu")
        rep = ElasticReplica(cfg, full, n0, n_slots=2, max_seq=32, kv_mode=kv_mode, tp=tp)
        del full
        seen = []
        gather, cut = migration.gather_shards, migration.local_shard

        def gather_rec(local, names, *a, **k):
            whole = gather(local, names, *a, **k)
            seen.append(("gathered", tuple(names), k.get("cache", a[-1] if len(a) > 2 else
                                                      False), whole.numel()))
            return whole

        def cut_rec(leaf, names, *a, **k):
            if leaf.device.type != "meta":
                seen.append(("cut", tuple(names), a[2] if len(a) > 2 else k.get("cache", False),
                             leaf.numel()))
            return cut(leaf, names, *a, **k)

        migration.gather_shards, migration.local_shard = gather_rec, cut_rec
        try:
            out = {"shard_numels": None}
            if tp.rank == 0:
                for i, p in enumerate(d["prompts"]):
                    rep.add(GenRequest(id=i, prompt=list(p), max_new=6))
                out["records"], out["resizes"] = [], []
                for steps, n in plan:
                    for _ in range(steps):
                        rep.step()
                    out["records"].append(dataclasses.asdict(rep.resize(n)))
                    out["resizes"].append(dict(rep.last_resize))
                out["streams"] = {r.id: list(r.generated) for r in rep.run()}
                rep.close()
            else:
                out["resizes"] = []
                rep.follow()
        finally:
            migration.gather_shards, migration.local_shard = gather, cut
        out["seen"] = seen
        out["last_resize"] = rep.last_resize
        return out


    def rank_main(tp, d):
        torch.set_num_threads(1)
        out = {arch: one_arch(tp, arch, d["archs"][arch]) for arch in d["archs"]}
        if tp.size == 2:
            for mode in ("migrate", "replay", "migrate_int8"):
                out[("resize", mode)] = resize_run(tp, d, mode, 2, ((3, 1), (2, 2)))
            out["unbroken"] = resize_run(tp, d, "migrate", 2, ())
        return out


    if __name__ == "__main__":
        world, inputs, output = int(sys.argv[1]), sys.argv[2], sys.argv[3]
        with open(inputs, "rb") as f:
            d = pickle.load(f)
        results = T.spawn_tp(rank_main, world, device="cpu", args=(d,), timeout=170)
        with open(output, "wb") as f:
            pickle.dump(results, f)
''')


@pytest.fixture(scope="module")
def refs_and_inputs():
    """Every arch's ``repro`` parameters (as numpy) and its batch."""
    out = {}
    for arch in ARCHS:
        jc, tc = configs(arch)
        jp, _ = params(jc, tc)
        out[arch] = {"jc": jc, "tc": tc, "jp": jp,
                     "numpy": {"params": jax.tree.map(np.asarray, jp),
                               "batch": _batch(tc, seed=1)}}
    out["hubert-xlarge"]["numpy"]["x"] = np.random.default_rng(26).standard_normal(
        (2, 24, out["hubert-xlarge"]["tc"].d_model), dtype=np.float32)
    return out


def _start(world: int, inputs, tmp: Path):
    """Start ``world`` ranks in the background; returns a function that
    waits for them (180 s at most) and gives each rank's results."""
    script = tmp / "tp_forward_ranks.py"
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


@pytest.fixture(scope="module")
def runs(refs_and_inputs, tmp_path_factory):
    """Both groups of ranks, and ``repro``'s one-device forward and loss of
    every arch (both CE forms) computed while they run."""
    zc = refs_and_inputs["zamba2-2.7b"]["tc"]
    rng = np.random.default_rng(26)
    inputs = {"archs": {a: v["numpy"] for a, v in refs_and_inputs.items()},
              "zamba2": refs_and_inputs["zamba2-2.7b"]["numpy"]["params"],
              "prompts": [rng.integers(0, zc.vocab_size, size=5 + i).tolist()
                          for i in range(2)]}
    waits = {w: _start(w, inputs, tmp_path_factory.mktemp(f"tpf{w}")) for w in WORLDS}
    ref = {}
    for arch, v in refs_and_inputs.items():
        jc, jp = v["jc"], v["jp"]
        batch = _jax(v["numpy"]["batch"])
        logits, aux = jmodel.forward(jp, batch, jc)
        ref[arch] = {"logits": np.asarray(logits), "lb": float(aux["lb_loss"])}
        for sa in (False, True):
            _, m = jmodel.loss_fn(jp, batch, dataclasses.replace(jc, shard_activations=sa))
            ref[arch][("loss", sa)] = {k: float(x) for k, x in m.items()}
        if arch == "hubert-xlarge":
            x = jnp.asarray(v["numpy"]["x"])
            l0 = jax.tree.map(lambda t: t[0], jp["stack"]["dense"]["attn"])
            pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
            ref[arch]["attention"] = np.asarray(jattn.gqa_attention(l0, x, pos, jc))
    return {"repro": ref, **{w: wait() for w, wait in waits.items()}}


def test_every_smoke_config_splits_over_two_and_four_ranks(refs_and_inputs):
    """The module holds every arch at both sizes: none is left out for not
    splitting (``_unsplit`` names nothing)."""
    for arch in ARCHS:
        tc = refs_and_inputs[arch]["tc"]
        assert {w: _unsplit(tc, w) for w in WORLDS} == {2: [], 4: []}, arch


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_repros_one_device(runs, arch, world):
    want = runs["repro"][arch]
    for rank, got in enumerate(runs[world]):
        close(got[arch]["logits"], want["logits"], F32_TOL)
        close(got[arch]["lb"], want["lb"], F32_TOL)


@pytest.mark.parametrize("shard_activations", [False, True], ids=["gather", "masked"])
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_equals_repros_one_device(runs, arch, world, shard_activations):
    """``repro``'s CE form by ``shard_activations`` (a gather, or a masked
    reduction over the vocabulary) against the port's vocab-parallel CE,
    which picks the label's logit on its owning rank by the same form."""
    want = runs["repro"][arch][("loss", shard_activations)]
    for got in runs[world]:
        m = got[arch][("loss", shard_activations)]
        assert sorted(m) == sorted(want) == ["ce", "lb_loss", "loss"]
        for key in want:
            close(m[key], want[key], F32_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_parallel_ce_equals_gathered_log_softmax(runs, refs_and_inputs, world):
    """Each rank's columns of the head (hubert's padded 128 of 64 included,
    masked on the ranks that hold them) give the CE of ``log_softmax`` over
    the gathered, padded vocabulary, on every rank alike."""
    for arch in ARCHS:
        tc = refs_and_inputs[arch]["tc"]
        ces = {(g[arch]["ce_split"], g[arch]["ce_gathered"]) for g in runs[world]}
        assert len(ces) == 1, arch
        (split, gathered), = ces
        close(split, gathered, F32_TOL)
        for got in runs[world]:
            assert got[arch]["head_cols"][-1] == tc.vocab_padded // world
    assert refs_and_inputs["hubert-xlarge"]["tc"].vocab_padded > \
        refs_and_inputs["hubert-xlarge"]["tc"].vocab_size


@pytest.mark.parametrize("world", WORLDS)
def test_hubert_non_causal_attention_at_the_ranks_heads(runs, refs_and_inputs, world):
    tc = refs_and_inputs["hubert-xlarge"]["tc"]
    assert not tc.is_autoregressive
    for got in runs[world]:
        h = got["hubert-xlarge"]
        assert h["local"] == (tc.n_heads // world, tc.n_kv_heads // world)
        close(h["attention"], runs["repro"]["hubert-xlarge"]["attention"], F32_TOL)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-26b"])
def test_replicated_kv_heads_at_four_ranks(runs, refs_and_inputs, arch):
    """Fewer KV heads than ranks: each rank holds one whole KV head, rank
    ``r`` head ``r * kv // 4``, and the logits are ``repro``'s all the
    same (``test_forward_equals_repros_one_device``)."""
    tc = refs_and_inputs[arch]["tc"]
    wk = refs_and_inputs[arch]["numpy"]["params"]["stack"]["dense"]["attn"]["wk"][0]
    assert tc.n_kv_heads < 4
    for rank, got in enumerate(runs[4]):
        assert got[arch]["local"] == (tc.n_heads // 4, 1)
        head = rank * tc.n_kv_heads // 4
        np.testing.assert_array_equal(got[arch]["wk0"],
                                      wk[:, head * tc.head_dim:(head + 1) * tc.head_dim])


# --- the leaf-by-leaf resize ------------------------------------------------------------
def _layer_lead(names, cfg, cache: bool) -> tuple:
    """The layer axes that lead zamba2's leaf at ``names``, counted from the
    config as ``repro``'s ``init_params`` and ``init_cache`` stack a hybrid:
    ``n_layers / attn_every`` groups, then the ``attn_every`` mamba layers
    of a group (its mamba parameters, the cache's ``state`` and ``conv``);
    the groups alone for the shared block's ``k``/``v`` cache; none for the
    shared block's parameters and the leaves outside the stack."""
    assert cfg.family == "hybrid"
    groups = cfg.n_layers // cfg.attn_every
    if cache:
        return (groups, cfg.attn_every) if names[-1] in ("state", "conv") else (groups,)
    if names[0] != "stack":
        return ()
    return (groups, cfg.attn_every) if names[2] == "mamba" else ()


def _layer_numels(cfg, cache: bool):
    """{leaf path: elements of one layer of it} of the whole parameter tree
    (or of the 2-slot, 32-position cache), the layers counted from the
    config; the resize's own count of stacked axes must agree with it."""
    from repro_torch.distributed.elastic_serving.migration import _stacked_axes
    from repro_torch.distributed.sharding import map_with_names
    from repro_torch.models.model import cache_spec, params_meta
    tree = cache_spec(cfg, 2, 32) if cache else params_meta(cfg)
    out = {}

    def one(names, t):
        lead = _layer_lead(names, cfg, cache)
        assert tuple(t.shape[:len(lead)]) == lead, (names, t.shape, lead)
        assert _stacked_axes(names, cfg, cache) == len(lead), names
        out[tuple(names)] = t.numel() // max(int(np.prod(lead)), 1)
    map_with_names(one, tree)
    return out


@pytest.mark.parametrize("kv_mode", KV_MODES)
def test_group_resize_moves_leaf_by_leaf(runs, refs_and_inputs, kv_mode):
    """zamba2 shrinks 2 -> 1 after 3 steps and grows 1 -> 2 after 2 more:
    the streams are the unbroken run's (under ``migrate_int8`` their
    lengths, as the other resize tests hold it), the records' bytes the
    logical counts, ``last_resize`` the bytes of the shards that crossed,
    and no whole piece a rank handles is more than one layer of one leaf
    (a split leaf's gathered piece is exactly one)."""
    tc = refs_and_inputs["zamba2-2.7b"]["tc"]
    r0, r1 = runs[2][0][("resize", kv_mode)], runs[2][1][("resize", kv_mode)]
    unbroken = runs[2][0]["unbroken"]["streams"]
    if kv_mode == "migrate_int8":
        assert {k: len(v) for k, v in r0["streams"].items()} == \
            {k: len(v) for k, v in unbroken.items()}
    else:
        assert r0["streams"] == unbroken
    pd = torch.float32
    whole_params = sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(tc))) * \
        pd.itemsize
    assert [(r["n_before"], r["n_after"]) for r in r0["records"]] == [(2, 1), (1, 2)]
    for rec in r0["records"]:
        assert rec["param_bytes"] == whole_params // 2 and rec["kv_mode"] == kv_mode
    shrink, grow = r0["resizes"]
    assert shrink["shipped_bytes"] == 0 < shrink["gathered_bytes"]
    assert grow["gathered_bytes"] == 0 < grow["shipped_bytes"]
    assert r1["last_resize"] == grow
    # the bytes: the shards a rank of 2 holds of the split leaves (and of
    # the cache when it is moved), the same counts before and after
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.sharding import local_shard, map_with_names, tp_split
    from repro_torch.models.model import cache_spec, params_meta
    two = T.TPGroup(None, 1, 2, torch.device("cpu"), (torch.device("cpu"),) * 2, "gloo")

    def shard_bytes(tree, cache, split_only):
        total = []
        map_with_names(lambda n, t: total.append(
            local_shard(t, n, tc, two, cache).numel() * t.element_size()
            if tp_split(n, tc, 2, cache) or not split_only else 0), tree)
        return sum(total)

    def moved(split_only):
        return shard_bytes(params_meta(tc), False, split_only) + (
            shard_bytes(cache_spec(tc, 2, 32), True, split_only) if kv_mode != "replay" else 0)
    # the shrink gathers rank 1's shards of the split leaves; the grow sends
    # the joiner its shard of every leaf (the whole ones whole)
    assert shrink["gathered_bytes"] == moved(True)
    assert grow["shipped_bytes"] == moved(False) > moved(True)
    # no whole tree: each gathered piece is one layer of its leaf
    layers = {False: _layer_numels(tc, False), True: _layer_numels(tc, True)}
    biggest = max(max(v.values()) for v in layers.values())
    for rank in (r0, r1):
        assert rank["seen"]
        for what, names, cache, numel in rank["seen"]:
            assert numel <= biggest, (what, names, numel)
            if what == "gathered" and tp_split(names, tc, 2, cache):
                assert numel == layers[bool(cache)][names], (names, numel)
    assert biggest < whole_params // pd.itemsize // 8

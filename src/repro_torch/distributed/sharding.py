"""Path-based sharding rules: TP over "model", parameter/optimizer FSDP over
"data", pure DP over "pod" (multi-pod). MoE experts are expert-parallel over
"model" when the expert count divides the axis (deepseek 64/16), else
tensor-parallel inside each expert (mixtral 8 experts on a 16-way axis) —
the port of ``repro.distributed.sharding``.

Every rule degrades gracefully: if a dimension is not divisible by the mesh
axis size, that axis is dropped (replicated) rather than failing to lower.

torch has no GSPMD, so the port brings its own small mesh types in place of
``jax.sharding``'s: :class:`PartitionSpec` (a tuple), :class:`Mesh` (a numpy
object array of ``torch.device`` and its axis names), :class:`AbstractMesh`
(axis sizes, no devices) and :class:`NamedSharding`. The rules and the spec
functions are ``repro``'s line for line; a spec tree here equals ``repro``'s
as tuples.

Placement. A mesh that a :class:`~repro_torch.distributed.tensor_parallel.TPGroup`
covers (``Mesh(..., tp=group)``, one rank a device) places each rank's
shard on that rank's device (:func:`mesh_device`); the ranks run the model
SPMD and meet at explicit collectives. The shard is head-aligned
(:func:`local_shard`, by the leaf's path, :func:`tp_split`): the columns of
``wq``/``bq`` of the rank's query heads, the columns of ``wk``/``wv``/
``bk``/``bv`` of its KV heads, the rows of ``wo`` of its query heads, the
columns of ``w_gate``/``w_up`` and the rows of ``w_down`` of its slice of
``d_ff``, the vocabulary rows of ``tokens`` and columns of ``lm_head``, and
the cache's KV heads; MLA's ``wq``/``w_uk``/``w_uv`` columns and ``wo``
rows of its heads; a routed expert leaf's run of whole experts where the
experts divide over the ranks (``repro``'s ``_EXPERT_RULES_EP``), else its
slice of every expert's ``moe_d_ff`` (``_EXPERT_RULES_TP``); a shared
expert's slice of its width. Norm scales, the router, MLA's ``w_dkv`` and
``w_krope`` and its latent cache stay whole. A Mamba2 leaf is cut by its
SSM heads, piecewise (:func:`tp_segments`): ``in_proj``'s fused
``[z | x | B | C | dt]`` columns become the rank's ``z``, ``x``, B and C
groups and ``dt`` in that order, the conv's ``[x | B | C]`` channels
likewise, ``A_log``/``dt_bias``/``D_skip`` and ``norm_w`` by heads,
``out_proj``'s rows by heads, the cache's ``state`` by heads and its
``conv`` window as the conv.
That is ``repro``'s spec on every leaf where a whole number of heads falls
to each rank. Where there are fewer KV heads than ranks (qwen2.5-3b's one
KV head at smoke size on 2 or 4 ranks, its two at full size on 4), ``repro``
splits the KV head's columns across the ranks and GSPMD regathers them for
the attention; the port replicates the KV head instead (rank ``r`` holds
head ``r * n_kv_heads // size``), as Megatron does. The maths is the same.
The SSM leaves differ from ``repro``'s even cut of the fused axis, which
GSPMD can take at any column and a physical rank cannot: the rank needs
the components of its own heads, and with fewer B/C groups than ranks
(one, for both full configs) it holds the group its heads read whole.
:func:`param_specs` and :func:`cache_specs` stay ``repro``'s, as the
layout GSPMD would take. A mesh over several distinct devices that no
group covers raises: there is nothing to run the shards.

Training also runs on a grid (``data_parallel.Grid``: ``"pod"`` x
``"data"`` x ``"model"`` ranks, :func:`group_mesh` its mesh). A rank's
shard of a parameter is then cut twice: on ``"model"`` by the path as
above, then evenly on the axis where ``param_specs`` puts ``"data"``
(:func:`data_axis`; never the axis ``"model"`` splits). ``"pod"``
replicates every leaf. :func:`local_shard`, :func:`assemble_shards` and
:func:`gather_shards` cut and join both axes; :func:`gather_to_root`
gathers a leaf to rank 0 alone, as a checkpoint's save does.

The sharded-activation path (``cfg.shard_activations``) calls
:func:`maybe_shard` at ``repro``'s sites with ``repro``'s axes. torch has no
GSPMD and so no ambient mesh of its own: ``with mesh:`` on one of the port's
meshes makes it ambient (a ``contextvars`` stack), as ``with mesh:`` does in
JAX. :func:`shard_spec` computes ``repro``'s cleaned constraint axis for
axis; :func:`maybe_shard` computes it and returns its input unchanged: it
constrains nothing, and the tensor-parallel path splits its tensors itself.
"""
from __future__ import annotations

import contextvars
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed

from repro_torch.distributed.tensor_parallel import (ROADMAP_NCCL, _run, all_gather, all_sum,
                                                      device_key, expert_parallel, ssm_span)
from repro_torch.models.model import tree_map


class PartitionSpec(tuple):
    """One entry per dimension: an axis name, a tuple of names, or None.
    As ``jax.sharding.PartitionSpec`` does, an empty tuple becomes None and
    a tuple of one name becomes that name."""

    def __new__(cls, *axes):
        def canon(ax):
            if isinstance(ax, tuple) and len(ax) <= 1:
                return ax[0] if ax else None
            return ax
        return super().__new__(cls, tuple(canon(ax) for ax in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes without devices, as ``jax.sharding.AbstractMesh``:
    enough to compute specs."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} axis sizes for axis names {axis_names}")
        self.axis_sizes = tuple(int(n) for n in axis_sizes)
        self.axis_names = tuple(axis_names)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({dict(zip(self.axis_names, self.axis_sizes))})"

    def __enter__(self) -> "AbstractMesh":
        """Make this mesh the ambient one (``with mesh:``), as
        :func:`maybe_shard` reads it."""
        _AMBIENT.set(_AMBIENT.get() + (self,))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.set(_AMBIENT.get()[:-1])


# the ``with mesh:`` stack; the innermost mesh is the ambient one
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_ambient_mesh",
                                                          default=())


class Mesh(AbstractMesh):
    """``devices``: an array of ``torch.device`` (any nesting), one axis of it
    per name in ``axis_names``. ``tp``: the tensor-parallel group whose
    ranks, one a device, hold the mesh's shards (None: no group)."""

    def __init__(self, devices, axis_names: Sequence[str], tp=None):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.tp = tp
        super().__init__(arr.shape, axis_names)


def mesh_dims(mesh: AbstractMesh) -> Tuple[int, int, int]:
    """The mesh's (pod, data, model) sizes (1 for an axis it lacks)."""
    return _axis(mesh, "pod"), _axis(mesh, "data"), _axis(mesh, "model")


def mesh_device(mesh: AbstractMesh) -> torch.device:
    """The device that holds this process's leaves on ``mesh``: this rank's
    device when an initialised group covers the mesh (one rank a device: a
    ``TPGroup`` a 1-D ``"model"`` mesh, a ``data_parallel.Grid`` the mesh of
    its pod x data x model ranks), else the mesh's one device. A group of
    as many ranks as the mesh has devices but another layout raises
    ``ValueError``; a mesh over several distinct devices that no group
    covers raises ``NotImplementedError``: a process holds one device's
    shards, and without a group nothing runs the others."""
    devices = getattr(mesh, "devices", None)
    if devices is None:
        raise ValueError(f"{mesh} has no devices to place a leaf on")
    tp = getattr(mesh, "tp", None)
    if tp is not None and torch.distributed.is_initialized() and \
            tp.world.size == devices.size:
        if mesh_dims(mesh) != tp.dims:
            raise ValueError(f"a group of (pod, data, model) {tp.dims} does not cover {mesh}")
        return tp.device
    distinct = {device_key(d) for d in devices.flat}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a mesh over {len(distinct)} distinct devices "
            f"({sorted(str(d) for d in devices.flat)}) needs tensor parallelism across "
            f"cards: an initialised TPGroup (repro_torch.distributed.tensor_parallel.init_tp) "
            f"with one rank a device must cover it, and none does ({ROADMAP_NCCL}: NCCL "
            f"with a rank a card); a gang on one card uses a mesh of that card")
    return devices.flat[0]


def group_mesh(tp) -> Mesh:
    """The mesh of every rank of ``tp``, which places each rank's shard on
    its device: the 1-D ``"model"`` mesh of a ``TPGroup``; a grid's world
    laid out as ``repro``'s mesh lays out its devices, ``("data",
    "model")``, or ``("pod", "data", "model")`` with a ``"pod"`` axis."""
    pod, data, model = tp.dims
    devices = np.asarray(list(tp.world.devices), dtype=object)
    if pod == data == 1:
        return Mesh(devices, ("model",), tp=tp)
    if pod == 1:
        return Mesh(devices.reshape(data, model), ("data", "model"), tp=tp)
    return Mesh(devices.reshape(pod, data, model), ("pod", "data", "model"), tp=tp)


class NamedSharding:
    """A leaf's spec over a mesh."""

    def __init__(self, mesh: AbstractMesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"


def _axis(mesh: AbstractMesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.axis_sizes)).get(name, 1)


def ambient_mesh() -> Optional[AbstractMesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    stack = _AMBIENT.get()
    return stack[-1] if stack else None


def ambient_mesh_sizes() -> Optional[Dict[str, int]]:
    """Axis-name -> size of the ambient mesh, or None when no mesh is
    active."""
    mesh = ambient_mesh()
    return None if mesh is None else dict(zip(mesh.axis_names, mesh.axis_sizes))


def shard_spec(shape, *axes, sizes: Dict[str, int]) -> PartitionSpec:
    """``repro``'s cleaned activation constraint for a tensor of ``shape``
    over a mesh of axis ``sizes``: axes unknown to the mesh or larger than
    the dimension are dropped (None); dimensions past ``axes`` get none."""
    clean = []
    for dim, ax in zip(shape, axes):
        cand = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        keep = tuple(a for a in cand if a in sizes)
        n = int(np.prod([sizes[a] for a in keep])) if keep else 1
        if not keep or dim < n:
            clean.append(None)
        else:
            clean.append(keep if len(keep) > 1 else keep[0])
    return P(*clean)


def maybe_shard(x, *axes):
    """Best-effort activation sharding constraint against the ambient mesh,
    as ``repro``'s: with no ambient mesh this is the identity, so model code
    calls it unconditionally. Under a mesh it computes the cleaned spec
    (:func:`shard_spec`) and returns ``x`` unchanged: a constraint moves no
    tensor here (the tensor-parallel path splits its own), and a mesh over
    several distinct devices that no group covers raises
    (:func:`mesh_device`). A mesh without devices (an :class:`AbstractMesh`,
    as the dry run uses) only computes the spec."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    if getattr(mesh, "devices", None) is not None:
        mesh_device(mesh)
    shard_spec(x.shape, *axes, sizes=dict(zip(mesh.axis_names, mesh.axis_sizes)))
    return x


def _fit(spec: Tuple[Optional[str], ...], shape, mesh: AbstractMesh):
    """Drop axes the mesh does not have (a 1-D serving gang mesh carries only
    "model") and axes that do not divide the dimension; prepend None for
    extras."""
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in mesh.axis_names)
        n = int(np.prod([_axis(mesh, a) for a in axes]))
        if not axes or dim % n != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


# trailing-dims rules per parameter name (see module docstring)
_RULES: Dict[str, Tuple] = {
    "tokens": ("model", "data"),
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "wo": ("model", "data"),
    "w_gate": ("data", "model"), "w_up": ("data", "model"), "w_down": ("model", "data"),
    "router": ("data", None),
    "w_dkv": ("data", None), "w_krope": ("data", None),
    "w_uk": (None, "model"), "w_uv": (None, "model"),
    "in_proj": ("data", "model"),
    "conv_w": ("model", None), "conv_b": ("model",),
    "A_log": ("model",), "dt_bias": ("model",), "D_skip": ("model",),
    "norm_w": ("model",),
    "out_proj": ("model", "data"),
    "lm_head": ("data", "model"),
    "w": (None,), "b": (None,),  # norm scales/biases
}

_EXPERT_RULES_EP = {  # experts sharded over "model" (E % axis == 0)
    "w_gate": ("model", "data", None), "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}
_EXPERT_RULES_TP = {  # experts replicated, FFN dim tensor-parallel
    "w_gate": (None, "data", "model"), "w_up": (None, "data", "model"),
    "w_down": (None, "model", "data"),
}


def map_with_names(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested dicts; ``path`` is the tuple of keys
    (``repro``'s ``_path_names`` of a ``tree_map_with_path`` path)."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params_shape: Any, cfg, mesh: AbstractMesh) -> Any:
    """PartitionSpec tree matching a params tree (tensors, ``meta`` tensors,
    or anything with a ``shape``)."""
    return map_with_names(lambda names, leaf: _leaf_spec(names, tuple(leaf.shape), cfg, mesh),
                          params_shape)


def _leaf_spec(names: Sequence[str], shape, cfg, mesh: AbstractMesh) -> PartitionSpec:
    """``param_specs``' spec of the one leaf at ``names`` of ``shape``."""
    expert_parallel = cfg.n_experts > 0 and cfg.n_experts % _axis(mesh, "model") == 0
    expert_rules = _EXPERT_RULES_EP if expert_parallel else _EXPERT_RULES_TP
    key = names[-1]
    if "moe" in names and "shared" not in names and key in expert_rules:
        return _fit(expert_rules[key], shape, mesh)
    rule = _RULES.get(key)
    if rule is None:
        return P()
    return _fit(rule, shape, mesh)


def param_shardings(params_shape: Any, cfg, mesh: AbstractMesh) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), param_specs(params_shape, cfg, mesh))


# --- activations / batch ---------------------------------------------------------
def batch_axes(mesh: AbstractMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if _axis(mesh, a) > 1)


def batch_spec(global_batch: int, mesh: AbstractMesh, extra_dims: int = 1) -> P:
    axes = batch_axes(mesh)
    n = int(np.prod([_axis(mesh, a) for a in axes]))
    # no shardable batch axes (e.g. 1x1 mesh) must yield None, not P(())
    lead = axes if (axes and global_batch % n == 0) else None
    return P(lead, *([None] * extra_dims))


def input_shardings(batch_tree: Any, mesh: AbstractMesh) -> Any:
    """Shard every input on its leading (batch) dim where divisible."""
    def spec(leaf):
        return NamedSharding(mesh, batch_spec(leaf.shape[0], mesh,
                                              extra_dims=len(leaf.shape) - 1))
    return tree_map(spec, batch_tree)


def cache_specs(cache_shape: Any, cfg, mesh: AbstractMesh,
                global_batch: int, seq_shard: bool = False) -> Any:
    """Decode-cache shardings: batch over (pod,data) when divisible; for the
    attention caches either the trailing feature dim over "model" (baseline)
    or — with ``seq_shard``, the flash-decode layout — the SEQ dim over
    "model" so attention reads its cache shard locally and only tiny softmax
    stats cross the wire."""
    baxes = batch_axes(mesh)
    n = int(np.prod([_axis(mesh, a) for a in baxes]))
    b_ax = baxes if (n > 0 and global_batch % n == 0) else None
    m = _axis(mesh, "model")

    def spec(names, leaf):
        shape = tuple(leaf.shape)
        # leading dims are scan stacks until the batch dim (== global_batch)
        try:
            b_idx = shape.index(global_batch)
        except ValueError:
            b_idx = 1
        out = [None] * len(shape)
        out[b_idx] = b_ax
        key = names[-1]
        if key in ("k", "v", "c"):
            # k/v: (..., B, S, KV, dh); c: (..., B, S, r+rope)
            if seq_shard and shape[b_idx + 1] % m == 0:
                out[b_idx + 1] = "model"
            elif shape[-1] % m == 0:
                out[-1] = "model"
        elif key == "state":  # (..., B, H, P, N): shard heads over model
            h_idx = b_idx + 1
            out[h_idx] = "model" if shape[h_idx] % m == 0 else None
        elif key == "conv":  # (..., B, W, C): shard channels over model
            out[-1] = "model" if shape[-1] % m == 0 else None
        return P(*out)

    return map_with_names(spec, cache_shape)


def cache_shardings(cache_shape: Any, cfg, mesh: AbstractMesh,
                    global_batch: int, seq_shard: bool = False) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s),
                cache_specs(cache_shape, cfg, mesh, global_batch, seq_shard))


# --- the head-aligned shards of the tensor-parallel path ---------------------------------
# leaf name -> (what splits, axis): q / kv heads in columns or rows of head_dim,
# d_ff, the padded vocabulary; the cache's KV heads. Every other leaf is whole.
_TP_SPLITS: Dict[str, Tuple[str, int]] = {
    "wq": ("q", -1), "bq": ("q", -1), "wo": ("q", -2),
    "wk": ("kv", -1), "bk": ("kv", -1), "wv": ("kv", -1), "bv": ("kv", -1),
    "w_gate": ("ff", -1), "w_up": ("ff", -1), "w_down": ("ff", -2),
    "tokens": ("vocab", -2), "lm_head": ("vocab", -1),
    # Mamba2, by SSM heads: in_proj's [z | x | B | C | dt] columns and the
    # conv's [x | B | C] channels piecewise, the per-head scalars, the
    # gated norm's and out_proj's heads x headdim
    "in_proj": ("ssm_in", -1), "conv_w": ("ssm_conv", -2), "conv_b": ("ssm_conv", -1),
    "A_log": ("ssm_heads", -1), "dt_bias": ("ssm_heads", -1), "D_skip": ("ssm_heads", -1),
    "norm_w": ("ssm_inner", -1), "out_proj": ("ssm_inner", -2),
}
# MLA's heads: the query's heads x (nope + rope) columns, the up-projections'
# heads x nope / heads x v_head columns, wo's heads x v_head rows. w_dkv,
# w_krope and the latent cache "c" stay whole on every rank.
_TP_MLA_SPLITS: Dict[str, Tuple[str, int]] = {
    "wq": ("mla_q", -1), "w_uk": ("mla_uk", -1), "w_uv": ("mla_uv", -1), "wo": ("mla_o", -2)}
# the feed-forward leaves of a routed or shared expert: the axis of moe_d_ff
_TP_EXPERT_FF_AXIS: Dict[str, int] = {"w_gate": -1, "w_up": -1, "w_down": -2}
# the cache: KV heads; the SSM state (..., B, H, P, N) by heads, the conv
# window (..., B, W - 1, conv_dim) as the conv's channels
_TP_CACHE_SPLITS: Dict[str, Tuple[str, int]] = {
    "k": ("kv_heads", -2), "v": ("kv_heads", -2),
    "state": ("ssm_heads", -3), "conv": ("ssm_conv", -1)}


def tp_split(names: Sequence[str], cfg, size: int,
             cache: bool = False) -> Optional[Tuple[str, int]]:
    """(what splits, axis) of the leaf at ``names`` of the global ``cfg``
    over ``size`` ranks, or None for a leaf every rank holds whole. The
    path decides, as ``repro``'s ``param_specs``: a leaf under ``moe`` and
    not under ``shared`` is a routed expert's ``(E, D, F)`` / ``(E, F, D)``,
    cut into whole experts on axis -3 (``"experts"``, expert-parallel, ``E %
    size == 0``) or else on its ``moe_d_ff`` axis (``"expert_ff"``); a
    shared expert's leaf is cut on its ``moe_d_ff x n_shared_experts``
    axis (``"shared_ff"``); MLA's ``wq``, ``w_uk``, ``w_uv`` and ``wo``
    by heads; a Mamba2 leaf by SSM heads (``"ssm_*"``, piecewise where
    the axis fuses components, :func:`tp_segments`). The router, the
    norms, ``w_dkv``, ``w_krope`` and MLA's latent cache stay whole."""
    key = names[-1]
    if cache:
        return _TP_CACHE_SPLITS.get(key)
    if "moe" in names and key in _TP_EXPERT_FF_AXIS:
        if "shared" in names:
            return "shared_ff", _TP_EXPERT_FF_AXIS[key]
        if expert_parallel(cfg, size):
            return "experts", -3
        return "expert_ff", _TP_EXPERT_FF_AXIS[key]
    if cfg.use_mla and key in _TP_MLA_SPLITS:
        return _TP_MLA_SPLITS[key]
    return _TP_SPLITS.get(key)


def tp_span(kind: str, cfg, rank: int, size: int) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s slice of ``size`` along the split
    axis of a one-piece ``kind`` of the global ``cfg``: whole KV heads
    (each rank its own, or with fewer KV heads than ranks head ``rank *
    n_kv_heads // size``), else an even slice of the axis (whole query,
    MLA or SSM heads, whole experts, a share of ``d_ff``, of ``moe_d_ff``,
    of the shared width or of the padded vocabulary). ``"kv"`` counts
    columns (heads x head_dim), ``"kv_heads"`` heads."""
    if kind in ("kv", "kv_heads"):
        kv = cfg.n_kv_heads
        first, n = (rank * (kv // size), kv // size) if kv >= size else (rank * kv // size, 1)
        unit = cfg.head_dim if kind == "kv" else 1
        return first * unit, (first + n) * unit
    total = _tp_global_dim(kind, cfg)
    return rank * total // size, (rank + 1) * total // size


def tp_segments(kind: str, cfg, rank: int, size: int) -> List[Tuple[int, int]]:
    """Rank ``rank``'s share of the split axis of a ``kind`` leaf, as the
    [start, stop) segments of the global axis it holds, in the order the
    rank lays them out. One segment (:func:`tp_span`) but for the fused
    Mamba2 axes: ``"ssm_in"`` (``in_proj``'s columns) is ``z`` of the
    rank's heads, ``x`` of its heads, B of its groups, C of its groups and
    ``dt`` of its heads; ``"ssm_conv"`` (the conv's channels) ``x``, B, C.
    The rank's columns keep the ``[z | x | B | C | dt]`` order at local
    widths, so a rank splits its projection as the whole model does."""
    if kind not in ("ssm_in", "ssm_conv"):
        return [tp_span(kind, cfg, rank, size)]
    loc = ssm_span(cfg, rank, size)
    p, n = cfg.ssm_headdim, cfg.ssm_state
    di, gn = cfg.d_inner, cfg.ssm_ngroups * n
    heads = (loc.first_head * p, loc.first_head * p + loc.d_inner)
    g0, g1 = loc.first_group * n, (loc.first_group + loc.n_groups) * n
    x0 = di if kind == "ssm_in" else 0   # where x starts: after z in in_proj
    xbc = [(x0 + heads[0], x0 + heads[1]), (x0 + di + g0, x0 + di + g1),
           (x0 + di + gn + g0, x0 + di + gn + g1)]
    if kind == "ssm_conv":
        return xbc
    dt0 = 2 * di + 2 * gn + loc.first_head
    return [heads, *xbc, (dt0, dt0 + loc.n_heads)]


def _tp_global_dim(kind: str, cfg) -> int:
    h = cfg.n_heads
    return {"q": h * cfg.head_dim, "kv": cfg.n_kv_heads * cfg.head_dim,
            "kv_heads": cfg.n_kv_heads, "ff": cfg.d_ff, "vocab": cfg.vocab_padded,
            "mla_q": h * (cfg.qk_nope_dim + cfg.qk_rope_dim), "mla_uk": h * cfg.qk_nope_dim,
            "mla_uv": h * cfg.v_head_dim, "mla_o": h * cfg.v_head_dim,
            "experts": cfg.n_experts, "expert_ff": cfg.moe_d_ff,
            "shared_ff": cfg.moe_d_ff * cfg.n_shared_experts,
            "ssm_in": 2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.n_ssm_heads,
            "ssm_conv": cfg.conv_dim, "ssm_heads": cfg.n_ssm_heads,
            "ssm_inner": cfg.d_inner}[kind]


@functools.lru_cache(maxsize=64)
def _data_axes(cfg, dims: Tuple[int, int, int]) -> Dict[Tuple[str, ...], Optional[int]]:
    """{parameter path: the axis, from the end, that ``param_specs`` puts
    ``"data"`` on over a mesh of ``dims`` (pod, data, model), or None}."""
    from repro_torch.models.model import param_specs as model_param_specs
    mesh = AbstractMesh(dims, ("pod", "data", "model"))
    out = {}

    def one(names, spec):
        placed = _leaf_spec(names, spec.shape, cfg, mesh)
        out[tuple(names)] = next((i - len(placed) for i, ax in enumerate(placed)
                                  if ax == "data"), None)
    map_with_names(one, model_param_specs(cfg))
    return out


def data_axis(names: Sequence[str], cfg, dims: Tuple[int, int, int]) -> Optional[int]:
    """The axis, counted from the end (so a stacked leaf's layer keeps it),
    that the ``"data"`` axis of a grid of ``dims`` (pod, data, model) cuts
    on the leaf at ``names`` of the global ``cfg``, as ``repro``'s
    ``param_specs`` places ``"data"`` on the whole leaf (``_fit`` leaves it
    whole where the dimension does not divide); None for a leaf ``"data"``
    replicates, and for no ``"data"`` axis. ``names`` is a parameter's path
    or ends in one (an optimizer moment's, a checkpoint key's)."""
    if dims[1] == 1:
        return None
    axes = _data_axes(cfg, tuple(dims))
    for i in range(len(names)):
        if tuple(names[i:]) in axes:
            return axes[tuple(names[i:])]
    return None


def _model_shard(leaf: torch.Tensor, names: Sequence[str], cfg, size: int, rank: int,
                 cache: bool = False, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rank ``rank``'s share of ``size`` of ``leaf`` on the ``"model"``
    axis (see :func:`local_shard`)."""
    split = tp_split(names, cfg, size, cache) if size > 1 else None
    if split is None:
        return leaf if dtype is None else leaf.to(dtype)
    kind, axis = split
    segments = tp_segments(kind, cfg, rank, size)
    shape = list(leaf.shape)
    shape[axis] = sum(stop - start for start, stop in segments)
    out = torch.empty(shape, dtype=dtype or leaf.dtype, device=leaf.device)
    at = 0
    for start, stop in segments:
        out.narrow(axis, at, stop - start).copy_(leaf.narrow(axis, start, stop - start))
        at += stop - start
    return out


def local_shard(leaf: torch.Tensor, names: Sequence[str], cfg, tp, cache: bool = False,
                rank: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                data_rank: Optional[int] = None) -> torch.Tensor:
    """Rank ``rank``'s (default: ``tp.rank``'s) share of the whole ``leaf``
    at ``names`` of the global ``cfg`` (a cache leaf with ``cache``; see
    :func:`tp_split`): its segments of the split axis side by side
    (:func:`tp_segments`), as a tensor of its own so the whole leaf can be
    freed; the leaf itself for a whole leaf, no group or a group of one.
    ``dtype`` casts the share (the whole leaf under a whole leaf, no group
    or a group of one), read from the leaf in place, so no whole copy at
    ``dtype`` is made.

    Under a grid (``data_parallel.Grid``) the ``"model"`` cut is followed by
    the ``"data"`` cut of a parameter leaf: the ``data_rank``'s (default:
    ``tp.data_rank``'s) even slice of :func:`data_axis` (a copy of its own
    too). ``"pod"`` replicates every leaf."""
    size = 1 if tp is None else tp.size
    r = 0 if size == 1 else (tp.rank if rank is None else rank)
    axis = None if cache or tp is None else data_axis(names, cfg, tp.dims)
    if axis is None:
        return _model_shard(leaf, names, cfg, size, r, cache, dtype)
    # "data" never cuts the axis "model" splits: the data slice first, a view
    n = leaf.shape[axis] // tp.data_size
    piece = leaf.narrow(axis, (tp.data_rank if data_rank is None else data_rank) * n, n)
    if size > 1 and tp_split(names, cfg, size) is not None:
        return _model_shard(piece, names, cfg, size, r, dtype=dtype)   # a copy
    return piece.to(dtype or leaf.dtype, memory_format=torch.contiguous_format, copy=True)


def assemble_shards(parts: Sequence[torch.Tensor], names: Sequence[str], cfg,
                    cache: bool = False, dims: Optional[Tuple[int, int, int]] = None
                    ) -> torch.Tensor:
    """The whole leaf from every rank's :func:`local_shard` of it, by rank
    (``len(parts)`` ranks of the ``"model"`` axis; under a grid of ``dims``
    (pod, data, model) every rank's by world rank, of which pod 0's are
    read): each data slice assembled over ``"model"``, then the slices side
    by side on :func:`data_axis`. A segment that several ranks hold (a
    replicated KV head, or B/C group) is written once, from the first of
    them."""
    pod, data, model = dims or (1, 1, len(parts))
    if len(parts) != pod * data * model:
        raise ValueError(f"{len(parts)} parts for a grid of {(pod, data, model)}")
    axis = None if cache else data_axis(names, cfg, (pod, data, model))
    slices = [_assemble_model(parts[d * model:(d + 1) * model], names, cfg, cache)
              for d in range(data if axis is not None else 1)]
    return slices[0] if len(slices) == 1 else torch.cat(slices, dim=axis)


def _assemble_model(parts, names, cfg, cache: bool) -> torch.Tensor:
    size = len(parts)
    split = tp_split(names, cfg, size, cache) if size > 1 else None
    if split is None:
        return parts[0]
    kind, axis = split
    shape = list(parts[0].shape)
    shape[axis] = _tp_global_dim(kind, cfg)
    whole = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device)
    written = set()
    for r, part in enumerate(parts):
        at = 0
        for start, stop in tp_segments(kind, cfg, r, size):
            if (start, stop) not in written:
                whole.narrow(axis, start, stop - start).copy_(part.narrow(axis, at, stop - start))
                written.add((start, stop))
            at += stop - start
    return whole


def gather_shards(local: torch.Tensor, names: Sequence[str], cfg, tp,
                  cache: bool = False) -> torch.Tensor:
    """The whole leaf from every rank's :func:`local_shard` of it (a
    collective over ``tp``: every rank calls it and every rank gets the
    whole leaf, :func:`assemble_shards` of the gathered parts; under a grid
    over ``"model"``, then over ``"data"``); ``local`` itself for a whole
    leaf, no group or a group of one."""
    size = 1 if tp is None else tp.size
    if size > 1 and tp_split(names, cfg, size, cache) is not None:
        local = _assemble_model(all_gather(local, tp), names, cfg, cache)
    axis = None if cache or tp is None else data_axis(names, cfg, tp.dims)
    if axis is None:
        return local
    return torch.cat(all_gather(local, tp.data), dim=axis)


def gather_to_root(local: torch.Tensor, names: Sequence[str], cfg, tp,
                   cache: bool = False) -> Optional[torch.Tensor]:
    """The whole leaf, on the host of world rank 0 alone (None on every
    other rank), from every rank's :func:`local_shard` of it: a checkpoint's
    gather. Pod 0's ranks take part (every ``"pod"`` replica is the same):
    the data slices go to data rank 0 of their ``"model"`` rank (a gather
    over ``"data"``), then those to rank 0 (a gather over ``"model"``), who
    assembles them (:func:`assemble_shards`). Over gloo a part moves to the
    host before it is sent, since gloo carries a CUDA tensor through host
    memory in any case; over NCCL it is sent from the card. For no group
    or a group of one, ``local`` on the host."""
    if tp is None or tp.world.size == 1:
        return local.to("cpu")
    if tp.pod_rank != 0:
        return None
    axis = None if cache else data_axis(names, cfg, tp.dims)
    if axis is not None:
        parts = _gather_root(local, tp.data)
        if parts is None:
            return None
        local = torch.cat(parts, dim=axis)
    elif tp.data_rank != 0:
        return None
    if tp.size > 1 and tp_split(names, cfg, tp.size, cache) is not None:
        parts = _gather_root(local, tp)
        if parts is None:
            return None
        local = _assemble_model(parts, names, cfg, cache)
    elif tp.rank != 0:
        return None
    return local.to("cpu")


def _gather_root(x: torch.Tensor, group) -> Optional[list]:
    """Every rank's ``x`` by rank on the group's rank 0 (None elsewhere)."""
    if group.backend != "nccl":
        x = x.to("cpu")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)] if group.rank == 0 else None
    _run(torch.distributed.gather, x, x, parts, dst=group.global_rank(0), group=group.group,
         axis=group.axis)
    return parts


def shared_segments(names: Sequence[str], cfg, size: int, rank: int,
                    cache: bool = False) -> Optional[Tuple[int, List[Tuple[int, int, int, Tuple]]]]:
    """(axis, [(local start, global start, length, the ranks that hold
    it)]) for each segment rank ``rank`` holds of the leaf at ``names`` over
    ``size`` ranks (:func:`tp_segments`, in its local order), or None for a
    leaf every rank holds whole. A segment several ranks hold (a KV head
    replicated because there are fewer KV heads than ranks, a Mamba2 B/C
    group and its conv channels that several ranks' heads read) lists them
    all."""
    split = tp_split(names, cfg, size, cache) if size > 1 else None
    if split is None:
        return None
    kind, axis = split
    every = [tp_segments(kind, cfg, r, size) for r in range(size)]
    out, at = [], 0
    for start, stop in every[rank]:
        out.append((at, start, stop - start,
                    tuple(r for r in range(size) if (start, stop) in every[r])))
        at += stop - start
    return axis, out


def sum_shared(local: torch.Tensor, names: Sequence[str], cfg, tp) -> torch.Tensor:
    """A gradient of the leaf at ``names`` (this rank's shard of it) with
    each segment that several ranks hold summed over exactly those ranks
    (a collective over ``tp`` when the leaf has such a segment; every rank
    calls it): each rank's gradient of a copy is only its own heads' part.
    Segments one rank holds, and leaves without a shared segment, stay as
    they are; ``local`` itself for no group or a group of one. Under a grid
    the sums run over the ``"model"`` group, whose ranks hold one data
    slice (``"data"`` never cuts the axis ``"model"`` splits)."""
    size = 1 if tp is None else tp.size
    segs = shared_segments(names, cfg, size, 0 if tp is None else tp.rank)
    if segs is None or all(len(held) == 1 for r in range(size)
                           for *_, held in shared_segments(names, cfg, size, r)[1]):
        return local
    axis, mine = segs
    shape = list(local.shape)
    shape[axis] = _tp_global_dim(tp_split(names, cfg, size)[0], cfg)
    whole = torch.zeros(shape, dtype=local.dtype, device=local.device)
    for at, start, n, _ in mine:
        whole.narrow(axis, start, n).copy_(local.narrow(axis, at, n))
    with torch.no_grad():
        whole = all_sum(whole, tp)
    return _model_shard(whole, names, cfg, size, tp.rank)

"""Physical tensor parallelism over a ``torch.distributed`` group.

``repro`` spreads a serving replica over the devices of a 1-D ``"model"``
mesh and lets GSPMD place the shards and insert the collectives. torch has
no GSPMD, so the port runs the same program on every rank of a process
group (SPMD): each rank holds only its shard of every weight and of the KV
cache, and the model code meets at two explicit collectives, a sum over the
group after each row-parallel product and a gather of the vocabulary's
columns after the head. This module is that plumbing:

- :class:`TPGroup`: a process group, this rank, the group's size and this
  rank's device, with any set of the world's ranks as a group of its own
  (:meth:`TPGroup.group_of`: an elastic gang is the first ``n`` ranks of a
  fixed world, a grid's ``"data"`` group a strided set of them); a
  ``TPGroup`` is a grid of one ``"model"`` axis (``data_parallel.Grid``
  adds the ``"data"`` and ``"pod"`` axes of training);
- :func:`init_tp`, :func:`spawn_tp`: start the ranks (``spawn``, a
  ``file://`` store) and join them;
- :func:`backend_for`: ``"nccl"`` when every rank has a card of its own,
  ``"gloo"`` for ranks that share a card or run on the CPU. This is a rule,
  not a fallback: NCCL refuses two ranks on one card, and gloo's
  collectives take CUDA tensors through host memory;
- :func:`tp_local`: the config one rank runs, at its local head and
  feed-forward counts (every family: dense, MoE with GQA or MLA, SSM,
  hybrid, and the audio and vision frontends); :func:`expert_parallel`
  and :func:`expert_span`, which experts a rank holds; :func:`ssm_local`,
  the rank's Mamba2 widths, which the config cannot state (they derive
  from ``d_model``);
- the collectives :func:`all_sum` (with :func:`row_parallel`, the product
  it follows), :func:`copy_in`, :func:`gather_last`, :func:`all_max` and
  :func:`broadcast_`, each the identity for no group or a group of one,
  and :func:`broadcast_object` for the replica's commands.

Autograd passes through the collectives as through Megatron's conjugate
pair. :func:`all_sum` is the "reduce" (forward the sum over the group,
backward the identity): it follows partial sums, whose result every rank
then uses alike. :func:`copy_in` is the "copy" (forward the identity,
backward a float32 sum over the group): it goes where a tensor every rank
holds alike enters work split over the ranks, so the gradient that flows
back is the sum of every rank's part. :func:`gather_last`'s backward is
the rank's slice. Serving calls the same functions with grad mode off:
they make the same one collective each and give the same bits. A backward
collective counts in ``STATS`` too, and in ``STATS["backward_*"]`` apart;
each is counted again under its group's axis (``STATS["data_bytes"]``,
``STATS["backward_model_calls"]``, ...).

The default process group is always gloo: it carries the small control
messages (the replica's commands, each rank's device). The data group is
the default group under gloo, or an NCCL group over the same ranks.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

# where ROADMAP.md queues what the port does not run yet: NCCL with more
# than one rank
ROADMAP_NCCL = "ROADMAP.md, section 1, item 3"

# the axes a group's collectives count under: a grid's "model", "data" and
# "pod" groups, "batch" for its (pod, data) plane (the loss's and the MoE
# statistics' sums) and "world" for all of its ranks
AXES = ("model", "data", "pod", "batch", "world")
# what the collectives moved since the last reset_stats(): calls, bytes this
# rank sent into them, and their host seconds (see time_collectives); the
# backward_ keys count again those that autograd's backward ran, and the
# <axis>_ keys (backward_<axis>_) count each again under its group's axis
_ZERO = {f"{pre}{axis}{what}": 0.0 if what == "seconds" else 0
         for pre in ("", "backward_") for axis in ("",) + tuple(f"{a}_" for a in AXES)
         for what in ("calls", "bytes", "seconds")}
STATS: Dict[str, float] = dict(_ZERO)
_SYNC = [False]


def reset_stats() -> None:
    STATS.update(_ZERO)


def time_collectives(on: bool) -> None:
    """With ``on``, every collective on a CUDA tensor synchronises the card
    before its clock starts and after it ends, so ``STATS["seconds"]`` holds
    the collectives alone and not the kernels queued before them. That
    costs two synchronisations a collective; off (the default) the seconds
    are host time around each call."""
    _SYNC[0] = bool(on)


@dataclasses.dataclass(eq=False)
class TPGroup:
    """``group`` is the data process group (None for a group of one),
    ``rank`` this rank's place in it, ``devices`` every rank's device by
    rank, ``backend`` the data group's backend, ``axis`` the axis its
    collectives count under in ``STATS``, ``ranks`` its ranks' places in the
    world by rank (empty: the world's first ``size`` ranks).

    A ``TPGroup`` is also a grid of one ``"model"`` axis: its ``pod_size``
    and ``data_size`` are 1, its ``data``, ``pod`` and ``batch`` groups
    None and its ``world`` itself (``data_parallel.Grid`` is the grid of
    all three axes)."""
    group: Any
    rank: int
    size: int
    device: torch.device
    devices: tuple
    backend: str
    _subgroups: Dict[Any, Optional["TPGroup"]] = dataclasses.field(default_factory=dict,
                                                                   repr=False)
    axis: str = "model"
    ranks: Tuple[int, ...] = ()

    pod_size = data_size = 1
    pod_rank = data_rank = 0
    data = pod = batch = None

    @property
    def world(self) -> "TPGroup":
        """Every rank of the grid: for a group of the ``"model"`` axis alone,
        itself."""
        return self

    @property
    def dims(self) -> Tuple[int, int, int]:
        """The grid's sizes (pod, data, model)."""
        return self.pod_size, self.data_size, self.size

    def global_rank(self, rank: int) -> int:
        """The world rank of this group's rank ``rank``."""
        return self.ranks[rank] if self.ranks else rank

    def subgroup(self, n: int) -> Optional["TPGroup"]:
        """The first ``n`` ranks as a group of their own, or None on a rank
        outside it. Every rank of this group calls it with the same ``n`` in
        the same order (``new_group`` is collective); each size is made
        once."""
        if not 1 <= n <= self.size:
            raise ValueError(f"a subgroup of {n} ranks of a group of {self.size}")
        if n == self.size:
            return self
        return self.group_of(range(n))

    def group_of(self, ranks: Sequence[int], axis: str = "model") -> Optional["TPGroup"]:
        """The ranks ``ranks`` of this group (the world: a group whose ranks
        are the world's first ``size``) as a group of their own, by their
        order in ``ranks``, or None on a rank outside it; its collectives
        count under ``axis``. Every rank of this group calls it with the
        same ranks in the same order (``new_group`` is collective, members
        or not); each set is made once."""
        ranks = tuple(int(r) for r in ranks)
        if self.ranks and self.ranks != tuple(range(self.size)):
            raise ValueError("group_of makes groups of the world's ranks: call it on the world")
        if not ranks or len(set(ranks)) != len(ranks) or not all(0 <= r < self.size
                                                                 for r in ranks):
            raise ValueError(f"ranks {ranks} of a group of {self.size}")
        key = (ranks, axis)
        if key not in self._subgroups:
            group = None
            if len(ranks) > 1:
                group = dist.new_group(list(ranks), backend=self.backend)
            self._subgroups[key] = (
                TPGroup(group, ranks.index(self.rank), len(ranks), self.device,
                        tuple(self.devices[r] for r in ranks), self.backend, axis=axis,
                        ranks=ranks) if self.rank in ranks else None)
        return self._subgroups[key]


def device_key(d: torch.device) -> tuple:
    """``d`` as (type, index); a bare ``cuda`` is the current card, so
    ``cuda`` and ``cuda:0`` on card 0 are one device."""
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return d.type, torch.cuda.current_device()
    return d.type, d.index


def backend_for(devices: Sequence[DeviceLike]) -> str:
    """``"nccl"`` when every rank has a CUDA card of its own, else
    ``"gloo"`` (ranks that share a card, or run on the CPU)."""
    devs = [torch.device(d) for d in devices]
    own_cards = len({device_key(d) for d in devs}) == len(devs)
    return "nccl" if devs and own_cards and all(d.type == "cuda" for d in devs) else "gloo"


def init_tp(world_size: int, rank: int, init_method: str,
            device: DeviceLike = None) -> TPGroup:
    """Join a group of ``world_size`` ranks at ``init_method`` (``file://``
    or ``tcp://``) and return its :class:`TPGroup`. ``device=None`` is this
    rank's card, ``cuda:{rank % cards}``, raising without CUDA (pass
    ``device="cpu"``). The default group is gloo; the data group follows
    :func:`backend_for` over every rank's device."""
    if device is None:
        resolve_device(None)
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init_method, world_size=world_size, rank=rank)
    devices: List[Any] = [None] * world_size
    dist.all_gather_object(devices, str(dev))
    devices = tuple(torch.device(d) for d in devices)
    backend = backend_for(devices)
    group = None
    if world_size > 1 or backend == "nccl":
        group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="nccl")
    return TPGroup(group, rank, world_size, dev, devices, backend)


def tp_size(tp: Optional[TPGroup]) -> int:
    return 1 if tp is None else tp.size


def dp_size(tp: Optional[TPGroup]) -> int:
    """The ranks of a grid's ``(pod, data)`` plane: how many ways the batch
    splits (1 for no group or a ``TPGroup``)."""
    return 1 if tp is None else tp.pod_size * tp.data_size


def tp_local(cfg: ModelConfig, tp: Optional[TPGroup]) -> ModelConfig:
    """The config one rank of ``tp`` runs: ``n_heads / size`` query heads,
    ``max(1, n_kv_heads / size)`` KV heads (with fewer KV heads than ranks
    each KV head is replicated, as Megatron does: rank ``r`` holds head
    ``r * n_kv_heads // size``), ``d_ff / size`` (a dense layer, such as
    deepseek's layer 0). A MoE config keeps the GLOBAL ``n_experts`` and
    ``top_k``, because every rank routes every token over all experts;
    under in-expert parallelism (``E % size != 0``) ``moe_d_ff`` is the
    rank's share of each expert's width, and under expert parallelism it
    stays whole (the rank's experts are :func:`expert_span`). MLA keeps its
    latent width (``kv_lora_rank``, ``qk_rope_dim``): the latent cache is
    whole on every rank. The vocabulary stays whole in the config: the
    embedding and the head split it themselves. The SSM and hybrid
    families keep their SSM fields: the rank's Mamba2 widths derive from
    ``d_model`` and come from :func:`ssm_local`. The frontends (hubert's
    audio encoder, internvl2's vision-language model) split as the dense
    family: their frames and patches enter whole on every rank. ``cfg``
    itself for no group or a group of one; ``ValueError`` naming what does
    not divide for a config that does not split over ``size``."""
    n = tp_size(tp)
    if n == 1:
        return cfg
    bad = _unsplit(cfg, n)
    if bad:
        raise ValueError(f"{cfg.arch_id}: {', '.join(bad)} do not split over {n} ranks")
    moe_d_ff = cfg.moe_d_ff if expert_parallel(cfg, n) else cfg.moe_d_ff // n
    kv = cfg.n_kv_heads
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // n,
                               n_kv_heads=max(1, kv // n) if kv else 0, d_ff=cfg.d_ff // n,
                               moe_d_ff=moe_d_ff)


@dataclasses.dataclass(frozen=True)
class SSMLocal:
    """One rank's Mamba2 widths: ``n_heads`` SSM heads from ``first_head``
    on (``d_inner = n_heads * ssm_headdim`` channels of ``x``, ``z`` and
    the gated norm), the ``n_groups`` B/C groups from ``first_group`` on
    that those heads read, and ``conv_dim``, the channels of its depthwise
    conv (its ``x``, then its B and C groups)."""
    d_inner: int
    n_heads: int
    n_groups: int
    conv_dim: int
    first_head: int
    first_group: int


def ssm_local(cfg: ModelConfig, tp: Optional[TPGroup] = None) -> SSMLocal:
    """This rank's Mamba2 widths under ``tp`` (:func:`ssm_span`); the
    config's own widths for no group or a group of one. ``cfg`` may be the
    global config or :func:`tp_local`'s, which keeps the SSM fields."""
    n = tp_size(tp)
    return ssm_span(cfg, 0 if n == 1 else tp.rank, n)


def ssm_span(cfg: ModelConfig, rank: int, size: int) -> SSMLocal:
    """The Mamba2 widths of rank ``rank`` of ``size``: a contiguous run of
    ``n_ssm_heads / size`` heads, and the groups they read (heads ``[h0,
    h1)`` read groups ``h0 // (H/G)`` to ``(h1 - 1) // (H/G)``: ``G /
    size`` of them where ``size`` divides ``G``, else the one group the
    rank's heads share, whole on every rank that reads it)."""
    h, g, p = cfg.n_ssm_heads, cfg.ssm_ngroups, cfg.ssm_headdim
    h0, h1 = rank * h // size, (rank + 1) * h // size
    per_group = max(h // g, 1)
    g0, g1 = h0 // per_group, (h1 - 1) // per_group + 1
    di = (h1 - h0) * p
    return SSMLocal(d_inner=di, n_heads=h1 - h0, n_groups=g1 - g0,
                    conv_dim=di + 2 * (g1 - g0) * cfg.ssm_state, first_head=h0,
                    first_group=g0)


def expert_parallel(cfg: ModelConfig, size: int) -> bool:
    """Whether ``size`` ranks hold whole experts, ``E / size`` each
    (``E % size == 0``, ``repro``'s ``_EXPERT_RULES_EP``), rather than a
    slice of every expert's ``moe_d_ff`` (``_EXPERT_RULES_TP``)."""
    return cfg.n_experts > 0 and cfg.n_experts % size == 0


def expert_span(cfg: ModelConfig, tp: Optional[TPGroup]) -> Tuple[int, int]:
    """[first, stop) of the experts this rank holds: a contiguous run of
    ``E / size`` under expert parallelism, every expert otherwise."""
    n = tp_size(tp)
    if n == 1 or not expert_parallel(cfg, n):
        return 0, cfg.n_experts
    per = cfg.n_experts // n
    return tp.rank * per, (tp.rank + 1) * per


def _unsplit(cfg: ModelConfig, n: int) -> List[str]:
    """What of ``cfg`` does not divide over ``n`` ranks. The padded
    vocabulary is the token embedding's rows and the head's columns alike
    (hubert, with no token embedding, still splits its head's columns)."""
    kv = cfg.n_kv_heads
    checks = [(f"n_heads {cfg.n_heads}", cfg.n_heads % n == 0),
              (f"n_kv_heads {kv}", kv % n == 0 or n % kv == 0),
              (f"d_ff {cfg.d_ff}", cfg.d_ff % n == 0),
              (f"vocab_padded {cfg.vocab_padded} (the embedding's rows, the head's columns)",
               cfg.vocab_padded % n == 0)]
    if cfg.n_experts:
        checks.append((f"n_experts {cfg.n_experts} (or else moe_d_ff {cfg.moe_d_ff})",
                       cfg.n_experts % n == 0 or cfg.moe_d_ff % n == 0))
        shared = cfg.moe_d_ff * cfg.n_shared_experts
        checks.append((f"shared width {shared}", shared % n == 0))
    if cfg.family in ("ssm", "hybrid"):
        g = cfg.ssm_ngroups
        checks += [(f"n_ssm_heads {cfg.n_ssm_heads}", cfg.n_ssm_heads % n == 0),
                   (f"ssm_ngroups {g}", g % n == 0 or n % g == 0)]
    return [what for what, ok in checks if not ok]


def gang_ranks(cfg: ModelConfig, n_members: int, tp: TPGroup) -> int:
    """How many ranks of ``tp`` a gang of ``n_members`` spans: the most, up
    to ``min(n_members, tp.size)``, that ``cfg`` splits over. A gang the
    heads (or the experts) do not divide (3 members of a 4-head model)
    leaves its last members idle, as ``repro``'s rules drop an axis that
    does not divide."""
    return max(k for k in range(1, min(max(int(n_members), 1), tp.size) + 1)
               if not _unsplit(cfg, k))


# --- collectives ------------------------------------------------------------------------
def _run(fn, t: torch.Tensor, *args, backward: bool = False, axis: str = "model",
         **kw) -> None:
    """``fn(*args, **kw)``, a collective of ``t``'s bytes over a group of
    ``axis``, counted in ``STATS``."""
    sync = _SYNC[0] and t.is_cuda
    if sync:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn(*args, **kw)
    if sync:
        torch.cuda.synchronize(t.device)
    took, moved = time.perf_counter() - t0, t.numel() * t.element_size()
    for pre in ("", "backward_") if backward else ("",):
        for key in (pre, f"{pre}{axis}_"):
            STATS[key + "seconds"] += took
            STATS[key + "calls"] += 1
            STATS[key + "bytes"] += moved


def _all_reduce(x: torch.Tensor, tp: TPGroup, op=dist.ReduceOp.SUM,
                backward: bool = False) -> torch.Tensor:
    """``x`` (contiguous, written in place) reduced over the group."""
    _run(dist.all_reduce, x, x, op=op, group=tp.group, backward=backward, axis=tp.axis)
    return x


class _Reduce(torch.autograd.Function):
    """Megatron's "reduce": forward the sum over the group, backward the
    identity (every rank's output is used alike, so the gradient each rank
    holds is already the whole one)."""

    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.contiguous().clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Megatron's "copy": forward the identity, backward the float32 sum of
    every rank's gradient over the group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.to(torch.float32, copy=True).contiguous(), ctx.tp,
                           backward=True).to(g.dtype), None


class _GatherLast(torch.autograd.Function):
    """Every rank's ``x`` side by side on the last dim; backward the rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return torch.cat(all_gather(x, tp), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.tp.rank * ctx.width, ctx.width).contiguous(), None


def all_sum(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """The sum of ``x`` over the group (after a row-parallel product): the
    "reduce", whose backward is the identity; ``x`` itself for no group or
    a group of one."""
    if tp_size(tp) == 1:
        return x
    return _Reduce.apply(x, tp)


def copy_in(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``x`` (the same on every rank) where it enters work split over the
    group: the "copy", whose backward sums the ranks' gradients at float32.
    ``x`` itself for no group or a group of one."""
    if tp_size(tp) == 1:
        return x
    return _Copy.apply(x, tp)


def all_max(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """The element-wise maximum of ``x`` over the group, with no gradient
    (a detached copy); ``x`` detached for no group or a group of one."""
    x = x.detach()
    if tp_size(tp) == 1:
        return x
    return _all_reduce(x.contiguous().clone(), tp, dist.ReduceOp.MAX)


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``x @ w`` for a row-parallel ``w`` (this rank's rows, ``x`` this
    rank's columns), summed over the group. Below float32 each rank's
    partial product leaves its GEMM at float32 (its accumulator, not
    rounded to ``x``'s dtype), the sum runs at float32 and is rounded once,
    as the one-device GEMM rounds its accumulator once: a rounding of each
    partial would add one rounding error per product and layer. ``x @ w``
    for no group or a group of one."""
    if tp_size(tp) == 1:
        return x @ w
    return all_sum(partial_f32(x, w), tp).to(x.dtype)


def partial_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` left at float32: below float32 the GEMM's accumulator is
    not rounded to ``x``'s dtype (the partial product a rank sums over the
    group)."""
    if x.dtype == torch.float32:
        return x @ w
    flat = x.reshape(-1, x.shape[-1])
    part = (torch.mm(flat, w, out_dtype=torch.float32) if flat.is_cuda
            else flat.float() @ w.float())
    return part.reshape(*x.shape[:-1], w.shape[-1])


def gather_last(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """Every rank's ``x`` side by side on the last dim, by rank (the
    vocab-parallel logits); its backward is the rank's slice. ``x`` itself
    for no group or a group of one."""
    if tp_size(tp) == 1:
        return x
    return _GatherLast.apply(x, tp)


def all_gather(x: torch.Tensor, tp: Optional[TPGroup]) -> List[torch.Tensor]:
    """Every rank's ``x`` (all of one shape), by rank."""
    if tp_size(tp) == 1:
        return [x]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    _run(dist.all_gather, x, parts, x, group=tp.group, axis=tp.axis)
    return parts


def broadcast_(x: torch.Tensor, tp: Optional[TPGroup], src: int = 0) -> torch.Tensor:
    """``x`` of rank ``src`` into ``x`` on every rank of the group, in
    place (``x`` contiguous); ``x`` itself for no group or a group of
    one."""
    if tp_size(tp) == 1:
        return x
    _run(dist.broadcast, x, x, src=tp.global_rank(src), group=tp.group, axis=tp.axis)
    return x


def broadcast_object(obj: Any = None, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank of the default (gloo) group,
    pickled: the replica's commands and the decode state a joining rank
    adopts."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# --- starting ranks -------------------------------------------------------------------------
def _rank_main(fn, rank: int, world_size: int, init_method: str, device, args, out: str):
    try:
        tp = init_tp(world_size, rank, init_method, device)
        try:
            result = fn(tp, *args)
        finally:
            dist.destroy_process_group()
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise SystemExit(1)


def spawn_tp(fn: Callable, world_size: int, device: DeviceLike = None, args: tuple = (),
             timeout: Optional[float] = None) -> list:
    """Run ``fn(tp, *args)`` on ``world_size`` new processes (the ``spawn``
    start method, which CUDA needs), each joined to one group through a
    ``file://`` store in a temporary directory, and return each rank's
    result by rank. ``fn`` and ``args`` must pickle (``fn`` defined at a
    module's top level). A rank that raises, or ``timeout`` seconds passing
    before every rank ends, stops every rank and raises ``RuntimeError``
    with the rank's traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_tp_") as tmp:
        init, out = f"file://{os.path.join(tmp, 'store')}", os.path.join(tmp, "result")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init, device, args, out))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r in range(world_size):
            try:
                with open(f"{out}.{r}", "rb") as f:
                    status, value = pickle.load(f)
            except FileNotFoundError:
                status, value = "error", f"rank {r} ended with exit code {procs[r].exitcode}"
            (results if status == "ok" else errors).append(value)
        if errors:
            late = "" if deadline is None or time.monotonic() <= deadline else \
                f" (stopped after {timeout} s)"
            raise RuntimeError(f"spawn_tp: {len(errors)} of {world_size} ranks failed{late}:\n"
                               + "\n".join(errors))
        return results

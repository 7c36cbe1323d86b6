"""Dependency-free checkpointing with restore onto any device — the port of
``repro.checkpoint.checkpoint``.

Layout, as ``repro`` writes it: ``<dir>/step_<N>/manifest.json`` +
``arrays.npz`` + ``COMMITTED``. Arrays are keyed by their tree path joined
with ``/`` (``params/embed/tokens``, ``opt/m/...``, ``opt/step``), in
``jax.tree`` order (sorted keys), so a checkpoint written by either package
restores in the other. Saves can run asynchronously on a background thread
after a snapshot to host memory.

bfloat16 leaves: numpy has no bfloat16 without ``ml_dtypes``, so such a
leaf is stored as float32 (lossless) and its manifest entry keeps
``"bfloat16"``; :func:`restore` casts it back to the template's dtype.

``restore`` places leaves on one ``device``, or with ``shardings`` (a tree
of :class:`repro_torch.distributed.sharding.NamedSharding` shaped like the
template, as ``repro``'s) each on its sharding's mesh device: that is how a
checkpoint moves between mesh shapes (elastic restore,
``distributed.elastic.reshard_restore``).

Under a tensor-parallel group (``distributed.tensor_parallel``) or a grid
(``distributed.data_parallel``) a save still writes the WHOLE arrays, in
the same format: each leaf in turn is gathered from its shards to rank 0's
host alone (``sharding.gather_to_root``: over ``"data"``, then over
``"model"``; pod 0's ranks take part), and rank 0 writes; so either
package restores it. A restore onto a mesh that a group or a grid covers
reads each whole array on the host and places only this rank's
``local_shard`` of it on the rank's device, leaf by leaf.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """{"a/b/c": leaf} over nested dicts, in sorted-key order."""
    if isinstance(tree, dict):
        flat: Dict[str, Any] = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], prefix + (str(k),)))
        return flat
    return {"/".join(prefix): tree}


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that nothing else writes: ``.cpu()`` of a CPU
    tensor is the tensor itself, which an in-place optimizer step would
    then change under a background write."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)  # a new tensor on any device
    return t.to("cpu", copy=True).numpy()


def save(tree: Any, directory: str, step: int, extra: Optional[Dict] = None,
         async_save: bool = False, tp=None, cfg=None) -> str:
    """Write a checkpoint of a tree of tensors; returns its path. With
    ``async_save``, snapshot to host first and write on a daemon thread
    (:func:`wait_for_saves` joins it): the tree may change as soon as this
    returns.

    Under a tensor-parallel group or a grid ``tp`` every rank calls it with
    its shards of a tree whose leaves are named as the parameters of the
    global model config ``cfg`` (a parameter tree, or ``{"params": ...,
    "opt": {"m": ..., "v": ..., "step": ...}}``, whose leaves split as the
    parameters they shadow): each leaf in turn is gathered whole to rank
    0's host alone (``sharding.gather_to_root``), and only rank 0 writes
    (the other ranks return the path without writing)."""
    path = os.path.join(directory, f"step_{step:08d}")
    leaves = _flatten(tree)
    if any(t.is_cuda for t in leaves.values()):
        torch.cuda.synchronize()
    if tp is None or tp.world.size == 1:
        flat = {k: _host_array(t) for k, t in leaves.items()}  # host snapshot
        shapes = {k: t.shape for k, t in leaves.items()}
    else:
        from repro_torch.distributed.sharding import gather_to_root
        flat, shapes = {}, {}
        for k, t in leaves.items():
            whole = gather_to_root(t, k.split("/"), cfg, tp)
            if whole is not None:
                shapes[k] = whole.shape
                flat[k] = _host_array(whole)
            del whole
        if tp.world.rank != 0:
            return path
    os.makedirs(path, exist_ok=True)
    manifest = {
        "step": step,
        "extra": extra or {},
        "arrays": {k: {"shape": list(shapes[k]), "dtype": str(t.dtype).removeprefix("torch.")}
                   for k, t in leaves.items()},
    }

    def _write():
        np.savez(os.path.join(path, "arrays.npz"), **flat)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        # completion marker (restart safety: a partial write is ignored)
        open(os.path.join(path, "COMMITTED"), "w").close()

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _PENDING.append((path, t))
    else:
        _write()
    return path


_PENDING = []


def wait_for_saves():
    while _PENDING:
        _, t = _PENDING.pop()
        t.join()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(directory, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(template: Any, directory: str, step: Optional[int] = None,
            device: DeviceLike = None, shardings: Optional[Any] = None, cfg=None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template`` (nested dicts of tensors,
    ``meta`` ones too: only shapes and dtypes are read) on ``device``
    (``None``: the card), or, given ``shardings`` (the same tree of
    ``NamedSharding``), each leaf on its sharding's device, and ``device``
    is not read. Returns (tree, manifest). Raises ``FileNotFoundError``
    without a committed step, ``KeyError`` for a missing array and
    ``ValueError`` for a shape other than the template's, as ``repro``
    does; a sharding over several distinct devices that no group covers
    raises ``NotImplementedError``.

    A sharding over a mesh that an initialised tensor-parallel group or
    grid covers (``Mesh(..., tp=group)``, ``sharding.group_mesh``) gives
    this rank its ``local_shard`` of each leaf (the template holds the
    whole shapes; ``cfg`` is the global model config whose parameters name
    the leaves): each whole array is read and cut on the host, and only the
    rank's shard goes to its device."""
    shard_of = _flatten(shardings) if shardings is not None else None
    dev = resolve_device(device) if shardings is None else None
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(template)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = [k for k in flat if k not in data]
        if missing:
            raise KeyError(f"checkpoint missing arrays: {missing[:5]}...")
        out = {}
        for key, leaf in flat.items():
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != template {tuple(leaf.shape)}")
            target = dev if shard_of is None else shard_of[key].device
            host = torch.from_numpy(arr)
            tp = None if shard_of is None else getattr(shard_of[key].mesh, "tp", None)
            if tp is not None and tp.world.size > 1:
                if cfg is None:
                    raise ValueError(f"{key}: restoring onto a group's mesh needs the model "
                                     f"config that names the leaves (cfg=)")
                from repro_torch.distributed.sharding import local_shard
                host = local_shard(host, key.split("/"), cfg, tp)
            out[key] = host.to(device=target, dtype=leaf.dtype)
            del host, arr
    return _unflatten(template, out), manifest


def _unflatten(template: Any, flat: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),)) for k, v in template.items()}
    return flat["/".join(prefix)]

"""Bridge from ``repro``'s parameter tree, as numpy arrays, to the port's.

A caller that holds JAX parameters converts them to numpy first
(``jax.tree.map(np.asarray, params)``); this module never sees JAX. The
tree keeps its nested keys and the stacked layer axis, and every key and
shape is checked against :func:`repro_torch.models.model.param_specs`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.tensor_parallel import tp_local
from repro_torch.models.model import ParamSpec, param_specs


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None, tp=None) -> Dict[str, Any]:
    """numpy parameter tree -> tensors at ``cfg.param_dtype`` on ``device``;
    under a tensor-parallel group ``tp`` only this rank's shard of each
    leaf (:func:`repro_torch.distributed.sharding.local_shard`) is copied.
    Raises ``ValueError`` on a missing or extra key or a wrong shape."""
    from repro_torch.distributed.sharding import local_shard  # it imports the models
    dev = resolve_device(device)
    pd = cfg.param_torch_dtype
    tp_local(cfg, tp)   # an architecture tensor parallelism does not cover raises

    def walk(spec, node, path):
        where = "/".join(path) or "<root>"
        if isinstance(spec, ParamSpec):
            arr = np.asarray(node)
            if arr.shape != spec.shape:
                raise ValueError(f"{where}: shape {arr.shape}, expected {spec.shape}")
            if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it
                arr = arr.astype(np.float32)
            leaf = local_shard(torch.from_numpy(np.array(arr, order="C")), path, cfg, tp)
            return leaf.to(device=dev, dtype=pd)
        if not isinstance(node, Mapping) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
            raise ValueError(f"{where}: keys {got}, expected {sorted(spec)}")
        return {k: walk(spec[k], node[k], path + (k,)) for k in spec}

    return walk(param_specs(cfg), tree, ())

"""The model's weights, made from the seed on the device in the type they
are served in.

The tree has the port's keys and stacked shapes (``param_specs``), which is
the layout its engine loads; the values are the benchmark's own: one
``randn`` a stacked leaf on a generator on the device, clipped at two
standard deviations and scaled as the spec says, norms at one. Both the
port and the reference are handed this one tree.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def make_weights(cfg, seed: int, device: torch.device) -> Dict[str, Any]:
    from repro_torch.models.model import param_specs
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = cfg.param_torch_dtype

    def make(spec):
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "full":
            return torch.full(spec.shape, spec.value, dtype=dtype, device=device)
        t = torch.randn(spec.shape, dtype=dtype, device=device, generator=gen)
        return t.clamp_(-2.0, 2.0).mul_(spec.scale)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return make(node)
    return walk(param_specs(cfg))


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()

"""Slot-state protocol for continuous batching — the port of
``repro.serving.slot_state``.

The engine keeps ONE tree of device tensors holding the decode state of
every batch slot: per-layer K/V for GQA attention, the SSM recurrent state
and conv window (``{"state", "conv"}``) for mamba2, both for zamba2's
hybrid groups. Each leaf has exactly one batch axis, found by diffing the
model's ``cache_spec`` at two batch sizes.
Admission produces a batch-1 state (prefill) that is grafted into one slot's
row of the live state: the whole row is zeroed first, so no stale state from
the row's previous occupant survives.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import model as model_mod


def find_batch_axes(cfg: ModelConfig, max_seq: int) -> Dict[str, Any]:
    """Per-leaf batch-axis index of the decode-state tree."""
    def axis(a, b):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diff) != 1:
            raise ValueError(f"cache leaf {tuple(a.shape)} vs {tuple(b.shape)}: "
                             f"expected exactly one batch axis")
        return diff[0]
    return model_mod.tree_map(axis, model_mod.cache_spec(cfg, 1, max_seq),
                              model_mod.cache_spec(cfg, 2, max_seq))


def graft_slot(live, pre, slot: int, batch_axes):
    """Write a batch-1 state tree into batch row ``slot`` of ``live``, in
    place (saves a copy of the whole live state per admission). The row is
    zeroed, then the batch-1 state is written at the start of every
    non-batch axis (the right-padding of ``repro``'s graft). Returns
    ``live``."""
    def one(z, c, ax):
        if c.shape[ax] != 1 or c.ndim != z.ndim or any(
                cs > zs for i, (cs, zs) in enumerate(zip(c.shape, z.shape)) if i != ax):
            raise ValueError(f"cannot graft {tuple(c.shape)} into row {slot} of "
                             f"{tuple(z.shape)} (batch axis {ax})")
        row = z.narrow(ax, slot, 1)
        row.zero_()
        row[tuple(slice(0, n) for n in c.shape)] = c.to(z.dtype)
        return z
    return model_mod.tree_map(one, live, pre, batch_axes)


class SlotBatchState:
    """The live decode state of ``n_slots`` concurrent requests (under a
    tensor-parallel group ``tp``, the rank's KV heads)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_seq: int,
                 device: DeviceLike = None, tp=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.tree = model_mod.init_cache(cfg, n_slots, max_seq, device, tp)
        self.batch_axes = find_batch_axes(cfg, max_seq)

    def graft(self, pre: Any, slot: int) -> None:
        """Install a batch-1 prefill state into ``slot``'s batch row."""
        graft_slot(self.tree, pre, slot, self.batch_axes)

    @property
    def nbytes(self) -> int:
        return model_mod.nbytes(self.tree)


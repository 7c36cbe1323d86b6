"""The yardstick's arithmetic: the card's peaks, the work of each
``moe_gmm`` launch and its bound, and the model FLOPs of the served tokens.

Peaks: NVIDIA's data sheet for one H100 SXM (80 GB HBM3) at its 700 W limit,
dense rates, as the port's ``launch/roofline.py`` states them: 989e12
FLOP/s in bf16 on the tensor cores, 3.35e12 B/s of HBM.

A ``moe_gmm`` launch's work is counted from its inputs, as the port's
``chip_smoke.gmm_bound`` counts it, but only what these inputs need: the
rows that carry a token (the padding rows of each expert's last tile carry
none) and the experts that received rows. Bytes: those rows read and their
outputs written once, each used expert's ``(D, F)`` weights read once, the
tile map read. FLOPs: ``2 * rows * D * F``. The bound is the larger of
FLOPs over the FLOP peak and bytes over the byte peak.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the kernel names of the port's moe_gmm as the profiler shows them (bf16
# narrow and wide row tiles, and the float32 kernel)
MOE_GMM_KERNELS = ("moe_gmm_kernel", "gmm_narrow_kernel", "gmm_wgmma_kernel")


def gmm_work(rows: int, used: int, d: int, f: int, elt: int, tiles: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``rows`` real rows and ``used``
    experts with rows."""
    flops = 2.0 * rows * d * f
    nbytes = float(elt * (rows * d + used * d * f + rows * f) + 4 * tiles)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)


class GmmRecorder:
    """Records every ``moe_gmm`` launch of the dropless MoE path while
    installed: it wraps ``repro_torch.kernels.ops.pad_group_sizes`` (called
    once a MoE layer with the expert group sizes, on the device) and
    ``ops.moe_gmm_op`` (its three launches). The group sizes stay on the
    device until :meth:`work` reads them all at once."""

    def __init__(self):
        self.launches: List[Tuple[int, int, int, int, torch.Tensor]] = []
        self._sizes: Optional[torch.Tensor] = None
        self._pending = 0
        self._orig = None
        self.fault: Optional[str] = None

    def install(self) -> None:
        from repro_torch.kernels import ops
        self._orig = (ops.pad_group_sizes, ops.moe_gmm_op)
        pad, gmm = self._orig

        def pad_group_sizes(group_sizes, block_t):
            self._sizes = group_sizes.detach().clone()
            self._pending = 3
            return pad(group_sizes, block_t)

        def moe_gmm_op(lhs, rhs, tile_expert, *, block_t=128):
            if self._pending == 0 and self.fault is None:
                self.fault = "a moe_gmm launch without the group sizes of its layer"
            else:
                self._pending -= 1
                self.launches.append((lhs.shape[1], rhs.shape[2], lhs.element_size(),
                                      lhs.shape[0] // block_t, self._sizes))
            return gmm(lhs, rhs, tile_expert, block_t=block_t)

        ops.pad_group_sizes, ops.moe_gmm_op = pad_group_sizes, moe_gmm_op

    def uninstall(self) -> None:
        from repro_torch.kernels import ops
        if self._orig is not None:
            ops.pad_group_sizes, ops.moe_gmm_op = self._orig
            self._orig = None

    def work(self) -> Tuple[float, float, float]:
        """(FLOPs, bytes, bound seconds) summed over the recorded launches."""
        if not self.launches:
            return 0.0, 0.0, 0.0
        sizes = torch.stack([s for *_, s in self.launches]).cpu()
        rows = sizes.sum(dim=1).tolist()
        used = (sizes > 0).sum(dim=1).tolist()
        flops = nbytes = bound = 0.0
        for (d, f, elt, tiles, _), r, u in zip(self.launches, rows, used):
            fl, by = gmm_work(int(r), int(u), d, f, elt, tiles)
            flops, nbytes, bound = flops + fl, nbytes + by, bound + bound_s(fl, by)
        return flops, nbytes, bound


def layer_kinds(cfg) -> List[str]:
    """``"dense"`` or ``"moe"`` for each layer, in order."""
    if cfg.family != "moe":
        return ["dense"] * cfg.n_layers
    return ["dense"] * cfg.first_dense_layers + ["moe"] * (cfg.n_layers - cfg.first_dense_layers)


def token_matmul_params(cfg) -> int:
    """Weights one token multiplies through: every layer's attention
    projections and its MLP, or its router, ``top_k`` routed experts and
    the shared experts (the model's active parameters, the embedding
    lookup left out)."""
    d = cfg.d_model
    if cfg.use_mla:
        h, r = cfg.n_heads, cfg.kv_lora_rank
        attn = (d * cfg.q_dim + d * (r + cfg.qk_rope_dim)
                + r * h * (cfg.qk_nope_dim + cfg.v_head_dim) + h * cfg.v_head_dim * d)
    else:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    total = 0
    for kind in layer_kinds(cfg):
        if kind == "dense":
            total += attn + 3 * d * cfg.d_ff
        else:
            experts = 3 * d * cfg.moe_d_ff * (cfg.top_k + cfg.n_shared_experts)
            total += attn + d * cfg.n_experts + experts
    return total


def attention_flops_per_key(cfg) -> int:
    """FLOPs of one query against one key over all heads and layers:
    ``q . k`` and ``p . v``, 2 FLOPs a multiply-add (MLA at its
    decompressed widths)."""
    if cfg.use_mla:
        per = 2 * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim)
    else:
        per = 2 * cfg.n_heads * 2 * cfg.head_dim
    return per * cfg.n_layers


def keys_attended(position: int, window: Optional[int]) -> int:
    """Keys the query at ``position`` (from 0) attends under a causal mask."""
    n = position + 1
    return n if window is None else min(n, window)


class ModelFlops:
    """Model FLOPs of the tokens served: a prefill of ``n`` tokens passes
    each through every layer and attends causally, and its last position
    through the head; a decode token at ``position`` passes every layer,
    attends ``position + 1`` keys and passes the head."""

    def __init__(self, cfg):
        self.per_token = 2 * token_matmul_params(cfg)
        self.per_key = attention_flops_per_key(cfg)
        self.head = 2 * cfg.d_model * cfg.vocab_size
        self.window = cfg.sliding_window
        self.total = 0.0

    def prefill(self, n: int) -> None:
        if self.window is None or self.window >= n:
            keys = n * (n + 1) // 2
        else:
            keys = sum(keys_attended(p, self.window) for p in range(n))
        self.total += self.per_token * n + self.per_key * keys + self.head

    def decode(self, positions: List[int]) -> None:
        keys = sum(keys_attended(p, self.window) for p in positions)
        self.total += (self.per_token + self.head) * len(positions) + self.per_key * keys

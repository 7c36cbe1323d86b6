"""Roofline terms of a dry-run cell on the NVIDIA H100 — the port of
``repro.launch.roofline``:

  compute    = FLOPs / (chips x PEAK_FLOPS)
  memory     = bytes / (chips x HBM_BW)
  collective = collective bytes / (chips x LINK_BW)

The constants are the data sheet's for one NVIDIA H100 80GB HBM3 (SXM5) at
its 700 W power limit, in place of ``repro``'s TPU figures: 989e12 FLOP/s
dense bf16 on the tensor cores, 3.35e12 B/s of HBM3, and 450e9 B/s of
NVLink 4 one way (all 18 links). ``chip_smoke.py`` takes its peaks from
here. A card set below 700 W runs slower under load.

``repro``'s ``collective_bytes`` parses the collectives of XLA's
partitioned HLO text; the port has no GSPMD and produces no HLO, so it has
no twin here, and a port dry-run record's collective bytes are empty
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12      # bf16 dense tensor cores per card
PEAK_FLOPS_F32 = 67e12   # fp32 on the CUDA cores per card
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # bytes/s one way, NVLink 4 (18 links)


@dataclasses.dataclass
class RooflineTerms:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    chips: int
    coll_breakdown: Dict[str, int] = dataclasses.field(default_factory=dict)
    model_flops: float = 0.0          # analytic useful FLOPs (global)

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global) — remat/redundancy waste."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (max of the 3 terms):
        the score a perfect overlap schedule would reach."""
        t_use = self.model_flops / (self.chips * PEAK_FLOPS)
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_use / t_step if t_step else 0.0

    def row(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_breakdown": self.coll_breakdown,
        }


def analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful-model FLOPs for the whole step (global, not per-device).

    train  : 6 N_active D  +  12 L_attn B S^2 H dh   (fwd+bwd, causal halves S^2)
    prefill: 2 N_active D  +   2 L_attn B S^2 H dh
    decode : 2 N_active B  +   4 L_attn B S_ctx H dh (one token vs full cache)
    SSM layers contribute their state-update term instead of attention.
    """
    n_active = cfg.param_count(active_only=True)
    b, s = shape.global_batch, shape.seq_len
    l_attn = cfg.n_attn_layers
    hdh = (cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla
           else cfg.n_heads * cfg.head_dim)
    s_attn = min(s, cfg.sliding_window) if cfg.sliding_window else s
    # SSM state math: per token per layer ~ 6 * H * P * N (update + output)
    ssm_term_per_tok = 6 * cfg.n_ssm_heads * cfg.ssm_headdim * cfg.ssm_state \
        if cfg.n_ssm_layers else 0
    if shape.kind == "train":
        d_tokens = b * s
        return (6.0 * n_active * d_tokens
                + 3 * 2.0 * l_attn * b * s * s_attn * hdh  # fwd+bwd QK^T & AV
                + 3.0 * cfg.n_ssm_layers * d_tokens * ssm_term_per_tok)
    if shape.kind == "prefill":
        d_tokens = b * s
        return (2.0 * n_active * d_tokens
                + 2.0 * l_attn * b * s * s_attn * hdh
                + cfg.n_ssm_layers * d_tokens * ssm_term_per_tok)
    # decode: one new token against an S-token cache
    if cfg.use_mla:
        per_layer_attn = 2 * 2.0 * b * s * (cfg.kv_lora_rank + cfg.qk_rope_dim) * cfg.n_heads
    else:
        per_layer_attn = 2 * 2.0 * b * s_attn * hdh
    return (2.0 * n_active * b
            + l_attn * per_layer_attn
            + cfg.n_ssm_layers * b * ssm_term_per_tok)


def build_terms(flops_per_dev: float, bytes_per_dev: float,
                coll: Dict[str, int], chips: int,
                cfg: ModelConfig, shape: ShapeConfig) -> RooflineTerms:
    return RooflineTerms(
        flops_per_dev=flops_per_dev,
        bytes_per_dev=bytes_per_dev,
        coll_bytes_per_dev=float(sum(coll.values())),
        chips=chips,
        coll_breakdown=coll,
        model_flops=analytic_model_flops(cfg, shape),
    )

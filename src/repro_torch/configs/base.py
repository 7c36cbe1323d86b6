"""Model/config schema: the port's own copy of ``repro.configs.base``.

The fields, their defaults, the kernel-dispatch policy, the analytic
``param_count``, the four input shapes and the dry-run skip matrix
(``cell_is_runnable``) are the same as in ``repro`` (the tests hold them
equal), so a configuration means the same thing on both sides. Dtypes stay strings here; the port maps
them to torch dtypes with :func:`torch_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# Dispatch sites that can swap a reference path for a hand-written kernel.
KERNEL_SITES: Tuple[str, ...] = ("attention", "ssm", "moe", "rmsnorm")
KERNEL_IMPL_CHOICES: Tuple[str, ...] = ("reference", "kernel")

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """Map a config dtype string to a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r}; allowed: {tuple(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm

    # trunk
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab_size: int = 256
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP, hubert)
    encoder_only: bool = False
    sliding_window: Optional[int] = None  # SWA width; None = full attn

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_impl: str = "scatter"
    capacity_factor: float = 1.25
    moe_dispatch_constraints: bool = False

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    ssm_expand: int = 2
    d_conv: int = 4

    # hybrid (zamba2)
    attn_every: int = 0

    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_seq: int = 0

    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"

    remat: str = "none"
    unroll: bool = False
    shard_activations: bool = False
    attn_impl: str = "einsum"
    # per-site dispatch policy: site -> reference | kernel, normalized to a
    # sorted tuple of pairs so the config stays hashable.
    kernel_impls: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        impls = self.kernel_impls
        if isinstance(impls, Mapping):
            impls = tuple(sorted(impls.items()))
        else:
            impls = tuple(sorted(tuple(p) for p in impls))
        for site, impl in impls:
            if site not in KERNEL_SITES:
                raise ValueError(
                    f"kernel_impls: unknown site {site!r}; allowed sites: "
                    f"{KERNEL_SITES}")
            if impl not in KERNEL_IMPL_CHOICES:
                raise ValueError(
                    f"kernel_impls[{site!r}]: unknown impl {impl!r}; allowed "
                    f"impls: {KERNEL_IMPL_CHOICES}")
            if impl == "kernel" and site not in supported_kernel_sites(self):
                raise ValueError(
                    f"kernel_impls[{site!r}]=kernel is unsupported for arch "
                    f"{self.arch_id!r} (family={self.family!r}); supported "
                    f"kernel sites: {tuple(sorted(supported_kernel_sites(self)))}")
        object.__setattr__(self, "kernel_impls", impls)

    # --- derived -----------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        # mamba2 convolves [x, B, C] jointly
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_cache_head_dim(self) -> int:
        if self.use_mla:
            return self.kv_lora_rank + self.qk_rope_dim
        return self.head_dim

    @property
    def n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.n_layers // max(self.attn_every, 1)
        return self.n_layers

    @property
    def n_ssm_layers(self) -> int:
        return self.n_layers if self.family in ("ssm", "hybrid") else 0

    @property
    def is_autoregressive(self) -> bool:
        return not self.encoder_only

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid/sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    # --- parameter count (for roofline MODEL_FLOPS) ------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; active_only counts top-k experts only."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        n = 0
        # embeddings (+ untied head)
        if self.frontend != "audio":
            n += v * d
        if not self.tie_embeddings:
            n += d * v if self.is_autoregressive else d * self.vocab_padded
        per_attn = 0
        if self.use_mla:
            per_attn += d * self.q_dim  # wq
            per_attn += d * (self.kv_lora_rank + self.qk_rope_dim)  # down
            per_attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            per_attn += self.n_heads * self.v_head_dim * d  # wo
        else:
            hd, kv = self.head_dim, self.n_kv_heads
            per_attn += d * self.n_heads * hd + 2 * d * kv * hd + self.n_heads * hd * d
        per_dense_ffn = 3 * d * f if self.act == "silu" else 2 * d * f
        per_moe_ffn = 0
        if self.n_experts:
            e = self.top_k if active_only else self.n_experts
            per_moe_ffn = 3 * d * self.moe_d_ff * e + d * self.n_experts
            per_moe_ffn += 3 * d * self.moe_d_ff * self.n_shared_experts
        per_ssm = 0
        if self.ssm_state:
            di, cd = self.d_inner, self.conv_dim
            per_ssm = d * (2 * di + 2 * self.ssm_ngroups * self.ssm_state + self.n_ssm_heads)
            per_ssm += cd * self.d_conv + di * d + 3 * self.n_ssm_heads + di
        if self.family in ("dense", "vlm", "audio"):
            n += self.n_layers * (per_attn + per_dense_ffn)
        elif self.family == "moe":
            n += self.first_dense_layers * (per_attn + per_dense_ffn)
            n += (self.n_layers - self.first_dense_layers) * (per_attn + per_moe_ffn)
        elif self.family == "ssm":
            n += self.n_layers * per_ssm
        elif self.family == "hybrid":
            n += self.n_layers * per_ssm
            n += per_attn + per_dense_ffn  # ONE shared block
        n += 2 * self.n_layers * d + d  # norms (approximate)
        return n


# ---------------------------------------------------------------------------
# Kernel-dispatch policy helpers
# ---------------------------------------------------------------------------
def supported_kernel_sites(cfg: ModelConfig) -> frozenset:
    """Sites where this arch can legally run a kernel (MLA has no flash
    twin; gelu archs use LayerNorm, not RMSNorm)."""
    sites = set()
    if cfg.n_attn_layers > 0 and not cfg.use_mla:
        sites.add("attention")
    if cfg.n_ssm_layers > 0:
        sites.add("ssm")
    if cfg.n_experts > 0:
        sites.add("moe")
    if cfg.act != "gelu":
        sites.add("rmsnorm")
    return frozenset(sites)


def kernel_impl(cfg: ModelConfig, site: str) -> str:
    """Resolved impl for a dispatch site: 'reference' unless opted in."""
    if site not in KERNEL_SITES:
        raise ValueError(
            f"unknown kernel site {site!r}; allowed sites: {KERNEL_SITES}")
    return dict(cfg.kernel_impls).get(site, "reference")


def with_kernel_impls(
    cfg: ModelConfig,
    impls: Union[str, Mapping[str, str]] = "auto",
) -> ModelConfig:
    """Copy of ``cfg`` with a kernel-dispatch policy: ``"auto"`` opts every
    supported site in, ``"reference"`` clears the policy, a mapping is
    validated by ``__post_init__``."""
    if impls == "auto":
        mapping: Dict[str, str] = {
            s: "kernel" for s in supported_kernel_sites(cfg)}
    elif impls == "reference":
        mapping = {}
    elif isinstance(impls, str):
        raise ValueError(
            f"with_kernel_impls: unknown policy {impls!r}; allowed: 'auto', "
            f"'reference', or a mapping site->impl over sites {KERNEL_SITES}")
    else:
        mapping = dict(impls)
    return dataclasses.replace(cfg, kernel_impls=tuple(sorted(mapping.items())))


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (LM-family): every arch gets all four.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable dry-run cell, else the skip reason.

    Skips are mandated by the assignment: encoder-only archs have no decode
    step; long_500k needs a sub-quadratic attention path.
    """
    if shape.kind == "decode" and not cfg.is_autoregressive:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: no sub-quadratic path at 500k"
    return True, ""

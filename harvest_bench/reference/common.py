"""Building blocks of the plain references, at float32 with TF32 off.

Every product with a weight goes through a precision object: :class:`Exact`
multiplies at float32; :class:`Fp8`, the control of a bfloat16
configuration, rounds the weight to float8 e4m3 with a scale a column and
the activation with a scale a row before it multiplies (what a serving path
that drops below bfloat16 would do); :class:`Bf16` is the control of a
float32 one. The router, the norms, rotary embeddings and the attention scores stay
at float32 in both.

The weights come as the tree the benchmark made (stacked layers first):
each layer is read as views and cast to float32 one leaf, or one expert, at
a time, so the reference fits beside the served weights.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")
FP8_MAX = 448.0   # the largest finite float8 e4m3fn


def no_tf32() -> None:
    """Float32 products at float32: TF32 would round their inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Exact:
    name = "float32"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.float()


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim`` (the
    largest magnitude maps to the largest finite value), back at float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Fp8:
    name = "float8_e4m3"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return fp8_round(x, -1) @ fp8_round(w.float(), 0)


class Bf16:
    """The control of a float32 configuration (the CPU rehearsal's): both
    factors rounded to bfloat16."""
    name = "bfloat16"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention temperature for a context stretched by ``factor``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_frequencies(d: int, theta: float, scaling: Optional[Dict] = None,
                     device=None):
    """(inverse frequencies (D/2,), amplitude of cos and sin) of a rotary
    embedding over ``d`` dims. With ``scaling`` of type ``yarn`` (the
    published DeepSeek-V2 ``rope_scaling``), the frequencies that turn
    fewer than ``beta_slow`` times over ``original_max_position_embeddings``
    are divided by ``factor``, those that turn more than ``beta_fast`` times
    are kept, and a linear ramp blends the dims between."""
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    if not scaling:
        return inv, 1.0
    kind = scaling.get("type", scaling.get("rope_type"))
    if kind != "yarn":
        raise ValueError(f"the reference has no rope scaling of type {kind!r}")
    factor, orig = scaling["factor"], scaling["original_max_position_embeddings"]

    def dim_of(turns: float) -> float:
        return d * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(dim_of(scaling["beta_fast"])), 0)
    high = min(math.ceil(dim_of(scaling["beta_slow"])), d - 1)
    if high == low:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv = inv / factor * ramp + inv * (1 - ramp)
    amp = yarn_mscale(factor, scaling["mscale"]) / yarn_mscale(factor, scaling["mscale_all_dim"])
    return inv, amp


def rope(x: torch.Tensor, theta: float, scaling: Optional[Dict] = None) -> torch.Tensor:
    """Rotary embedding of ``x`` (S, H, D) at positions 0..S-1, the two
    halves of the head rotated as pairs (``x[i]`` with ``x[i + D/2]``),
    its frequencies scaled by ``scaling`` (:func:`rope_frequencies`)."""
    s, _, d = x.shape
    inv, amp = rope_frequencies(d, theta, scaling, x.device)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    if amp != 1.0:
        cos, sin = cos * amp, sin * amp
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     window: Optional[int] = None, block: int = 512) -> torch.Tensor:
    """Softmax attention of q (S, H, Dk) over k (S, H, Dk), v (S, H, Dv),
    each query over the keys at or before it (and, with ``window``, the
    last ``window`` of them); queries in blocks so the scores fit.
    Returns (S, H * Dv)."""
    s, h, _ = q.shape
    pos = torch.arange(s, device=q.device)
    out = []
    for lo in range(0, s, block):
        qb = q[lo:lo + block]
        scores = torch.einsum("qhd,khd->hqk", qb, k) * scale
        qp = pos[lo:lo + block, None]
        allow = pos[None, :] <= qp
        if window is not None:
            allow = allow & (pos[None, :] > qp - window)
        scores = scores.masked_fill(~allow[None], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", w, v).reshape(qb.shape[0], -1))
    return torch.cat(out)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, prec) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, renormalize: bool):
    """(weights (S, k), experts (S, k)): the softmax over every expert's
    router logit at float32, the ``top_k`` largest (the lower expert first
    on a tie), renormalised to sum to one when ``renormalize``."""
    probs = torch.softmax(x @ router.float(), dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx


def routed_experts(x: torch.Tensor, p: Dict[str, torch.Tensor], top_k: int,
                   renormalize: bool, prec) -> torch.Tensor:
    """Every token through its ``top_k`` experts, weighted and summed: one
    expert at a time over the tokens routed to it."""
    weights, idx = route(x, p["router"], top_k, renormalize)
    y = torch.zeros_like(x)
    for e in range(p["w_gate"].shape[0]):
        hit = idx == e                       # (S, k)
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        gate = (weights * hit).sum(dim=-1)[rows]
        out = swiglu(x[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e], prec)
        y.index_add_(0, rows, out * gate[:, None])
    return y


def layer(stack: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def decoder_logits(weights: Dict, hp: Dict, seqs: List[List[int]], n_last: List[int],
                   prec, attention: Callable, ffn: Callable,
                   segments: List[str]) -> List[torch.Tensor]:
    """Pre-norm decoder: embedding, then every layer of ``segments`` in
    order (``x + attention(p, norm1(x))`` on each sequence alone, then
    ``x + ffn(p, norm2(x))`` on the sequences' rows together, since the FFN
    treats rows one by one), the final norm and the head on each
    sequence's last ``n_last`` positions. Each ``fn(p, y, hp, prec)`` maps
    a layer's normed rows to its output. Returns (n_last, vocab_size)
    float32 logits a sequence."""
    table = weights["embed"]["tokens"]
    dev = table.device
    eps = hp["rms_norm_eps"]
    xs = [table[torch.as_tensor(s, device=dev)].float() for s in seqs]
    lens = [len(s) for s in seqs]
    for seg in segments:
        stack = weights["stack"][seg]
        for i in range(next(iter(_leaves(stack))).shape[0]):
            p = layer(stack, i)
            x = torch.cat([x + attention(p, rms_norm(x, p["ln1"]["w"], eps), hp, prec)
                           for x in xs])
            x = x + ffn(p, rms_norm(x, p["ln2"]["w"], eps), hp, prec)
            xs = list(torch.split(x, lens))
    out = []
    for x, n in zip(xs, n_last):
        h = rms_norm(x[-n:], weights["final_norm"]["w"], eps)
        out.append(prec.mm(h, weights["lm_head"])[:, :hp["vocab_size"]])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree

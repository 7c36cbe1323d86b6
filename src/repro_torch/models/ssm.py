"""Mamba2 (SSD — state-space duality) block — the port of ``repro.models.ssm``.

The chunked algorithm follows the Mamba2 paper: a within-chunk quadratic
("attention-like") term plus a cross-chunk linear state recurrence.
Full-sequence prefill from the zero state dispatches to the ``ssd`` kernel
under ``kernel_impls['ssm'] == 'kernel'``; a prefill that resumes from a
state, and every decode step, run the reference scan here, as in ``repro``.

Under a tensor-parallel group ``tp`` (``distributed.tensor_parallel``) each
rank holds the channels of its SSM heads (``sharding.local_shard``): its
``in_proj`` columns keep the ``[z | x | B | C | dt]`` order at the rank's
widths (``tensor_parallel.ssm_local``), so the conv, ``dt``, ``A``, the
scan and ``D_skip`` run on its heads alone; the gated norm sums its rows'
squares over the group and ``out_proj`` is row-parallel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, kernel_impl
from repro_torch.distributed.tensor_parallel import SSMLocal, copy_in, row_parallel, ssm_local
from repro_torch.models.layers import gated_rms_norm

NEG_INF = -1e9


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in x's dtype. x: (B,S,C); w: (C,W); b: (C,).
    Returns a contiguous (B,S,C)."""
    c, width = w.shape
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))                   # (B,C,S+W-1)
    out = F.conv1d(xp, w.to(x.dtype)[:, None, :], groups=c)          # (B,C,S)
    return out.transpose(1, 2).contiguous() + b.to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j<k<=i} a[k], NEG_INF
    above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, torch.full_like(diff, NEG_INF))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """SSD scan, the reference path. x: (B,S,H,P); dt: (B,S,H) positive step
    sizes; a: (H,) negative; b_mat, c_mat: (B,S,G,N); S % chunk == 0.
    Returns (y (B,S,H,P), final_state (B,H,P,N)), all math in fp32."""
    bsz, s, h, pdim = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunked: S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    f32 = torch.float32
    x, dt = x.to(f32), dt.to(f32)
    rep = h // g
    bh = b_mat.to(f32).repeat_interleave(rep, dim=2)                 # (B,S,H,N)
    ch = c_mat.to(f32).repeat_interleave(rep, dim=2)
    da = dt * a.to(f32)[None, None, :]                               # (B,S,H)

    def to_chunks(t):
        return t.reshape((bsz, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc, dac, bc, cc = map(to_chunks, (x, dt, da, bh, ch))
    x_dt = xc * dtc[..., None]                                       # (B,C,Q,H,P)
    da_h = dac.movedim(-1, 1)                                        # (B,H,C,Q)
    da_cs = torch.cumsum(da_h, dim=-1)
    # 1) within-chunk (quadratic) term
    ell = torch.exp(_segsum(da_h))                                   # (B,H,C,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bhcqk", cc, bc) * ell
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", scores, x_dt)
    # 2) per-chunk final states
    decay = torch.exp(da_cs[..., -1:] - da_cs)                       # (B,H,C,Q)
    states = torch.einsum("bckhn,bhck,bckhp->bchpn", bc, decay, x_dt)
    # 3) cross-chunk recurrence over states, emitting the state entering each chunk
    chunk_decay = torch.exp(da_cs[..., -1])                          # (B,H,C)
    carry = (torch.zeros((bsz, h, pdim, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                           # (B,C,H,P,N)
    # 4) contribution of the entering state to each chunk position
    state_decay = torch.exp(da_cs)                                   # (B,H,C,Q)
    y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(bsz, s, h, pdim)
    return y, carry


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor):
    """Single-token recurrence. state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    b_mat/c_mat: (B,G,N). Returns (y (B,H,P), new_state), both fp32."""
    f32 = torch.float32
    rep = x.shape[1] // b_mat.shape[1]
    bh = b_mat.to(f32).repeat_interleave(rep, dim=1)                 # (B,H,N)
    ch = c_mat.to(f32).repeat_interleave(rep, dim=1)
    da = torch.exp(dt.to(f32) * a.to(f32)[None, :])                  # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt.to(f32), bh, x.to(f32))
    new_state = state.to(f32) * da[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", ch, new_state)
    return y, new_state


def _split_in_proj(zxbcdt: torch.Tensor, loc: SSMLocal, cfg: ModelConfig):
    """(z, xBC, dt) of a rank's projection (the whole one without a
    group), at the widths ``loc``."""
    di, gn = loc.d_inner, loc.n_groups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt


def mamba_block(p, u: torch.Tensor, cfg: ModelConfig,
                initial_state: Optional[torch.Tensor] = None, tp=None):
    """Full-sequence Mamba2 block. u: (B,S,D) -> (y, final_state, conv_tail);
    under ``tp`` the rank's heads of the state and channels of the tail,
    and the whole y.

    Sequences that are not a multiple of ``ssm_chunk`` are zero-padded;
    padded positions get dt=0 so they neither emit output nor advance the
    state. ``conv_tail`` is the last ``d_conv - 1`` raw xBC rows (fewer for a
    shorter prompt), taken before the conv and before the padding, for the
    serving handoff."""
    bsz, s, _ = u.shape
    dtc = u.dtype
    loc = ssm_local(cfg, tp)
    zxbcdt = copy_in(u, tp) @ p["in_proj"].to(dtc)
    z, xbc, dt_raw = _split_in_proj(zxbcdt, loc, cfg)
    conv_tail = xbc[:, -(cfg.d_conv - 1):, :].clone()
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    di, gn = loc.d_inner, loc.n_groups * cfg.ssm_state
    x = xbc[..., :di].reshape(bsz, s, loc.n_heads, cfg.ssm_headdim)
    b_mat = xbc[..., di:di + gn].reshape(bsz, s, loc.n_groups, cfg.ssm_state)
    c_mat = xbc[..., di + gn:].reshape(bsz, s, loc.n_groups, cfg.ssm_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    pad = (-s) % cfg.ssm_chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))  # dt=0 => identity step
    if kernel_impl(cfg, "ssm") == "kernel" and initial_state is None:
        # the ssd kernel always starts from the zero state; resumed prefills
        # (initial_state set) keep the reference scan
        from repro_torch.kernels.ops import ssd_op
        y, final_state = ssd_op(x, dt, a, b_mat, c_mat, chunk=cfg.ssm_chunk)
    else:
        y, final_state = ssd_chunked(x, dt, a, b_mat, c_mat, cfg.ssm_chunk, initial_state)
    y = y + x.float() * p["D_skip"].float()[None, None, :, None]
    if pad:
        y = y[:, :s]
    y = y.reshape(bsz, s, di).to(dtc)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps, cfg, tp)
    return row_parallel(y, p["out_proj"].to(dtc), tp), final_state, conv_tail


def mamba_decode(p, u: torch.Tensor, ssm_state: torch.Tensor, conv_state: torch.Tensor,
                 cfg: ModelConfig, tp=None):
    """One-token decode. u: (B,1,D); ssm_state: (B,H,P,N); conv_state:
    (B, d_conv-1, conv_dim) previous raw xBC inputs (under ``tp`` the
    rank's heads and channels). Returns (y (B,1,D), new_ssm_state,
    new_conv_state); the inputs are not modified."""
    bsz = u.shape[0]
    dtc = u.dtype
    loc = ssm_local(cfg, tp)
    zxbcdt = u @ p["in_proj"].to(dtc)
    z, xbc_new, dt_raw = _split_in_proj(zxbcdt, loc, cfg)
    window = torch.cat([conv_state, xbc_new], dim=1)                 # (B, d_conv, C)
    new_conv_state = window[:, 1:, :]
    conv_out = (torch.einsum("bwc,cw->bc", window.float(), p["conv_w"].float())
                + p["conv_b"].float())
    xbc = F.silu(conv_out)[:, None, :].to(dtc)                       # (B,1,C)
    di, gn = loc.d_inner, loc.n_groups * cfg.ssm_state
    x = xbc[:, 0, :di].reshape(bsz, loc.n_heads, cfg.ssm_headdim)
    b_mat = xbc[:, 0, di:di + gn].reshape(bsz, loc.n_groups, cfg.ssm_state)
    c_mat = xbc[:, 0, di + gn:].reshape(bsz, loc.n_groups, cfg.ssm_state)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y, new_state = ssd_decode_step(ssm_state, x, dt, a, b_mat, c_mat)
    y = y + x.float() * p["D_skip"].float()[None, :, None]
    y = y.reshape(bsz, 1, di).to(dtc)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps, cfg, tp)
    return row_parallel(y, p["out_proj"].to(dtc), tp), new_state, new_conv_state

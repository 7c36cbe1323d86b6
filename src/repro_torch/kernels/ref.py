"""Plain PyTorch versions of the port's kernels.

Each is the specification its CUDA kernel must match, with the same semantics
as ``repro/kernels/ref.py`` (finite ``NEG_INF`` masks included). A kernel
wrapper uses these for tensors on the CPU; on the card they are what
``chip_smoke.py`` holds each kernel against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,). fp32 math, result in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y): s = x + h in x's dtype (``torch.add``'s rounding), y =
    :func:`rmsnorm_ref` of s."""
    s = x + h
    return s, rmsnorm_ref(s, w, eps)


def gated_rmsnorm_ref(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """:func:`rmsnorm_ref` of x * silu(z), silu(z) and the product each
    rounded to x's dtype, as ``models/layers.py``'s ``gated_rms_norm``
    composes them."""
    return rmsnorm_ref(x * F.silu(z.to(x.dtype)), w, eps)


def gated_rmsnorm_ssq_ref(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pass A of the gated norm split over ranks: each row's fp32 sum of
    squares of x * silu(z), rounded as :func:`gated_rmsnorm_ref` rounds it;
    shape ``x.shape[:-1]``."""
    return (x * F.silu(z.to(x.dtype))).float().square().sum(dim=-1)


def gated_rmsnorm_scale_ref(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                            ssq: torch.Tensor, d: int, eps: float = 1e-5) -> torch.Tensor:
    """Pass B: x * silu(z) (rounded as pass A rounds it) times
    rsqrt(ssq / d + eps) times w, fp32 math, result in x's dtype; ``ssq``
    the rows' sums over every rank, ``d`` the row's width over them."""
    g = (x * F.silu(z.to(x.dtype))).float()
    return ((g * torch.rsqrt(ssq.float() / d + eps)[..., None]) * w.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KV,Sk,D) with H % KV == 0. Returns (B,H,Sq,D)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kv, g, sq, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention_tiles_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, window: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The bf16 flash kernel's own partition: q tiles of 64 rows, each
    taking the 64-key tiles (zero-padded past Sk) from the first tile its
    window allows to the last tile causality allows, the even ones and the
    odd ones (counted from that first tile) in two fp32 online softmaxes
    (m, l, acc) that are merged at the end; l sums the fp32 P, and P is
    rounded to q's dtype before P V. Returns acc / max(l, 1e-30) in q's
    dtype. Shapes as :func:`flash_attention_ref`."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    tile = 64
    qf = q.float().reshape(b, kv, g, sq, d)
    pad = (-sk) % tile
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    out = torch.empty_like(qf)
    for q0 in range(0, sq, tile):
        rows = torch.arange(q0, min(q0 + tile, sq), device=q.device)[:, None]
        lo = max(0, q0 - window + 1) if window is not None else 0
        hi = min(sk - 1, q0 + tile - 1) if causal else sk - 1
        halves = []
        for parity in (0, 1):
            m = torch.full((b, kv, g, rows.shape[0]), NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, kv, g, rows.shape[0], d), device=q.device)
            for k0 in range((lo // tile + parity) * tile, hi + 1, 2 * tile):
                keys = torch.arange(k0, k0 + tile, device=q.device)[None, :]
                s = torch.einsum("bkgqd,bksd->bkgqs", qf[:, :, :, q0:q0 + tile],
                                 kf[:, :, k0:k0 + tile]) * scale
                mask = keys < sk
                if causal:
                    mask = mask & (keys <= rows)
                if window is not None:
                    mask = mask & (keys > rows - window)
                s = s.masked_fill(~mask, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgqs,bksd->bkgqd", p.to(q.dtype).float(), vf[:, :, k0:k0 + tile])
                m = m_new
            halves.append((m, l, acc))
        (m0, l0, acc0), (m1, l1, acc1) = halves
        m = torch.maximum(m0, m1)
        a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
        l = l0 * a0 + l1 * a1
        acc = acc0 * a0[..., None] + acc1 * a1[..., None]
        out[:, :, :, q0:q0 + tile] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                        block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Decode-time attention over a block-paged KV pool.

    q: (B,H,D), one query token per sequence, H % KV == 0; k_pool/v_pool:
    (NB,BS,KV,D); block_tables: (B,MAXB) integer (padding entries may point
    at any block, they are masked); context_lens: (B,) integer, the valid
    positions per sequence including the token that produced q. Returns
    (B,H,D) in q's dtype. A row with length 0 gets the uniform average of
    its masked positions (the kernel gives zeros there).
    """
    b, h, d = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    maxb = block_tables.shape[1]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    tables = block_tables.to(device=k_pool.device, dtype=torch.int64)
    lens = context_lens.to(device=q.device, dtype=torch.int64)
    k = k_pool[tables].reshape(b, maxb * bs, kv, d)
    v = v_pool[tables].reshape(b, maxb * bs, kv, d)
    qg = q.reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    valid = torch.arange(maxb * bs, device=q.device)[None, :] < lens[:, None]  # (B,S)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                              block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                              blocks_per_split: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The paged kernel's own partition: each row's table cut into splits of
    ``blocks_per_split`` blocks, each split's fp32 partial ``(m, l, acc)``
    over its valid positions (a split past the row's length is the empty
    partial ``m = NEG_INF, l = 0``), then the splits that hold positions
    merged in split order into ``acc / max(l, 1e-30)``.

    Shapes as :func:`paged_attention_ref`; at most MAXB * BS positions of a
    row count. A row of length 0 gives zeros, as the kernel does."""
    b, h, d = q.shape
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    maxb = block_tables.shape[1]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    span = blocks_per_split * bs
    n_splits = max(1, -(-maxb // blocks_per_split))
    tables = block_tables.to(device=k_pool.device, dtype=torch.int64)
    lens = context_lens.to(device=q.device, dtype=torch.int64).clamp(0, maxb * bs)
    pad = n_splits * span - maxb * bs
    k = torch.nn.functional.pad(k_pool[tables].reshape(b, maxb * bs, kv, d).float(),
                                (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v_pool[tables].reshape(b, maxb * bs, kv, d).float(),
                                (0, 0, 0, 0, 0, pad))
    scores = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, kv, g, d).float(), k) * scale
    valid = torch.arange(n_splits * span, device=q.device)[None, :] < lens[:, None]
    valid = valid.reshape(b, 1, 1, n_splits, span)
    scores = scores.reshape(b, kv, g, n_splits, span).masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1)                                          # (B,KV,G,NS)
    p = torch.exp(scores - m[..., None]) * valid
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgns,bnskd->bkgnd", p, v.reshape(b, n_splits, span, kv, d))
    # the combine: the splits that hold positions, in order
    used = (torch.arange(n_splits, device=q.device) * span)[None, :] < lens[:, None]
    m_all = m.masked_fill(~used[:, None, None, :], NEG_INF).amax(dim=-1)
    den = torch.zeros_like(m_all)
    num = torch.zeros_like(acc[..., 0, :])
    for s in range(n_splits):
        w = torch.exp(m[..., s] - m_all) * used[:, None, None, s]
        den = den + l[..., s] * w
        num = num + acc[..., s, :] * w[..., None]
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def _rows_times_experts(lhs: torch.Tensor, rhs: torch.Tensor,
                        row_expert: torch.Tensor) -> torch.Tensor:
    """Row t of ``lhs`` times ``rhs[row_expert[t]]`` in fp32, in lhs's
    dtype: one product per expert over its rows (no (T, D, F) gather)."""
    out = torch.zeros((lhs.shape[0], rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for e in range(rhs.shape[0]):
        rows = (row_expert == e).nonzero().squeeze(1)
        out[rows] = lhs[rows].float() @ rhs[e].float()
    return out.to(lhs.dtype)


def moe_gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul. lhs: (T,D) rows sorted by group; rhs: (E,D,F);
    group_sizes: (E,) integer summing to <= T; tail rows belong to the last
    group. Returns (T,F) in lhs's dtype where row t uses rhs[g(t)], fp32 math."""
    t = lhs.shape[0]
    ends = torch.cumsum(group_sizes.to(device=lhs.device, dtype=torch.int64), 0)
    row_group = torch.searchsorted(ends, torch.arange(t, device=lhs.device), right=True)
    return _rows_times_experts(lhs, rhs, row_group.clamp(max=rhs.shape[0] - 1))


def moe_gmm_tiles_ref(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor,
                      block_t: int) -> torch.Tensor:
    """The ``moe_gmm`` kernel's own signature. lhs: (T,D) with T % block_t
    == 0; rhs: (E,D,F); tile_expert: (T/block_t,) integer. Row tile i
    (rows ``i*block_t`` to ``(i+1)*block_t``) times ``rhs[tile_expert[i]]``
    in fp32, returned in lhs's dtype. Expert ids are clamped to [0, E-1],
    as the kernel (and a clamped TPU index map) does."""
    row_expert = tile_expert.to(device=lhs.device, dtype=torch.int64).repeat_interleave(block_t)
    return _rows_times_experts(lhs, rhs, row_expert.clamp(0, rhs.shape[0] - 1))


def moe_gmm_schedule_ref(lhs: torch.Tensor, rhs: torch.Tensor, tile_expert: torch.Tensor,
                         block_t: int, *, tile_rows: int) -> torch.Tensor:
    """The bf16 ``moe_gmm`` kernel's own partition, in fp32. Row tiles of
    ``tile_rows``: for 8, fixed tiles from row 0, each taking one product
    per run of equal (clamped) expert among its rows; for more, each run of
    equal expert cut into tiles from its own first row. Each product covers
    all of D; returned in lhs's dtype. Same contract as
    :func:`moe_gmm_tiles_ref`."""
    t = lhs.shape[0]
    f = rhs.shape[2]
    row_expert = tile_expert.to(device=lhs.device, dtype=torch.int64).repeat_interleave(
        block_t).clamp(0, rhs.shape[0] - 1).tolist()
    runs, r0 = [], 0          # maximal runs of equal expert: (first row, end, expert)
    for r in range(1, t + 1):
        if r == t or row_expert[r] != row_expert[r0]:
            runs.append((r0, r, row_expert[r0]))
            r0 = r
    if tile_rows == 8:        # fixed tiles, runs cut at the tile edges
        pieces = [(max(lo, m0), min(hi, m0 + 8), ex) for m0 in range(0, t, 8)
                  for lo, hi, ex in runs if lo < m0 + 8 and hi > m0]
    else:                     # tiles cut per run
        pieces = [(m0, min(m0 + tile_rows, hi), ex) for lo, hi, ex in runs
                  for m0 in range(lo, hi, tile_rows)]
    lf, rf = lhs.float(), rhs.float()
    out = torch.zeros((t, f), dtype=torch.float32, device=lhs.device)
    for lo, hi, ex in pieces:
        out[lo:hi] = lf[lo:hi] @ rf[ex]
    return out.to(lhs.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
            c_mat: torch.Tensor):
    """The sequential SSD recurrence, one position at a time (the slow but
    obvious oracle of ``repro.kernels.ref.ssd_ref``).

    x: (B,S,H,P); dt: (B,S,H); a: (H,); b_mat/c_mat: (B,S,G,N), H % G == 0.
    Returns (y (B,S,H,P) fp32, final_state (B,H,P,N) fp32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    rep = h // b_mat.shape[2]
    bh = b_mat.float().repeat_interleave(rep, dim=2)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    xf, dtf, af = x.float(), dt.float(), a.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * af[None, :])
        state = state * da[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], bh[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], state))
    return torch.stack(ys, dim=1), state


def check_ssd_shapes(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int) -> None:
    """Raise ``ValueError`` unless the shapes meet the ``ssd`` contract."""
    if x.ndim != 4 or b_mat.ndim != 4:
        raise ValueError(f"ssd: x {tuple(x.shape)} and b_mat {tuple(b_mat.shape)} must "
                         f"be (B,S,H,P) and (B,S,G,N)")
    bsz, s, h, _ = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd: S={s} is not a multiple of chunk={chunk}")
    if g < 1 or h % g:
        raise ValueError(f"ssd: H={h} is not a multiple of G={g}")
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b_mat.shape) != (bsz, s, g, n) or c_mat.shape != b_mat.shape):
        raise ValueError(f"ssd: dt {tuple(dt.shape)}, a {tuple(a.shape)}, b_mat "
                         f"{tuple(b_mat.shape)}, c_mat {tuple(c_mat.shape)} do not "
                         f"match x {tuple(x.shape)}")


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                  c_mat: torch.Tensor, chunk: int):
    """The ``ssd`` kernel's own arithmetic: the chunks in order with a
    carried (P, N) state from zero, each chunk as ``_ssd_kernel`` computes
    it (a per-chunk cumsum of dt*a, the ``exp(where(tri, cs_i - cs_j,
    -1e9))`` decay, the off-chunk term from the entering state, then the
    state update), for every (batch, head) at once.

    x: (B,S,H,P); dt: (B,S,H); a: (H,); b_mat/c_mat: (B,S,G,N); head h reads
    group h // (H/G). S % chunk == 0 and H % G == 0, else ``ValueError``.
    Returns (y (B,S,H,P) fp32, final_state (B,H,P,N) fp32)."""
    check_ssd_shapes(x, dt, a, b_mat, c_mat, chunk)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    rep = h // b_mat.shape[2]
    xf = x.float().permute(0, 2, 1, 3)                                    # (B,H,S,P)
    dtf = dt.float().permute(0, 2, 1)                                     # (B,H,S)
    bh = b_mat.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)  # (B,H,S,N)
    ch = c_mat.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    da = dtf * a.float()[None, :, None]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, bc, cc = xf[:, :, sl], dtf[:, :, sl], bh[:, :, sl], ch[:, :, sl]
        cs = torch.cumsum(da[:, :, sl], dim=-1)                           # (B,H,Q)
        seg = cs[..., :, None] - cs[..., None, :]
        ell = torch.exp(torch.where(tri, seg, torch.full_like(seg, NEG_INF)))
        xdt = xc * dtc[..., None]                                         # (B,H,Q,P)
        y = ((cc @ bc.transpose(-1, -2)) * ell) @ xdt                     # within-chunk
        y = y + torch.exp(cs)[..., None] * (cc @ state.transpose(-1, -2))  # entering state
        decay = torch.exp(cs[..., -1:] - cs)
        state = (state * torch.exp(cs[..., -1])[..., None, None]
                 + (xdt * decay[..., None]).transpose(-1, -2) @ bc)
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).contiguous(), state


def ssd_passes_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, chunk: int):
    """The bf16 ``ssd`` kernel's decomposition, in fp32: (a) every chunk's
    own contribution ``(xdt * exp(cs_last - cs))^T B`` at once, (b) the
    states entering the chunks, ``state_c = state_{c-1} exp(cs_last_{c-1})
    + contrib_{c-1}`` from zero, the last one the final state, (c) every
    chunk's y at once from its entering state. Same contract as
    :func:`ssd_chunk_ref`."""
    check_ssd_shapes(x, dt, a, b_mat, c_mat, chunk)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    rep = h // b_mat.shape[2]
    nc = s // chunk

    def chunks(t):  # (B,S,H,...) -> (B,H,nc,Q,...)
        t = t.float()
        if t.ndim == 3:
            return t.permute(0, 2, 1).reshape(bsz, h, nc, chunk)
        return t.permute(0, 2, 1, 3).reshape(bsz, h, nc, chunk, t.shape[-1])

    xc, dtc = chunks(x), chunks(dt)
    bc = chunks(b_mat.repeat_interleave(rep, dim=2))
    cc = chunks(c_mat.repeat_interleave(rep, dim=2))
    cs = torch.cumsum(dtc * a.float()[None, :, None, None], dim=-1)   # (B,H,nc,Q)
    # (a) chunk state
    w = dtc * torch.exp(cs[..., -1:] - cs)
    contrib = (xc * w[..., None]).transpose(-1, -2) @ bc               # (B,H,nc,P,N)
    # (b) state passing
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cs[:, :, c, -1])[..., None, None] + contrib[:, :, c]
    entering = torch.stack(entering, dim=2)                            # (B,H,nc,P,N)
    # (c) chunk scan
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    seg = cs[..., :, None] - cs[..., None, :]
    ell = torch.exp(torch.where(tri, seg, torch.full_like(seg, NEG_INF)))
    scores = (cc @ bc.transpose(-1, -2)) * ell * dtc[..., None, :]
    y = scores @ xc + torch.exp(cs)[..., None] * (cc @ entering.transpose(-1, -2))
    y = y.reshape(bsz, h, s, p).permute(0, 2, 1, 3).contiguous()
    return y, state

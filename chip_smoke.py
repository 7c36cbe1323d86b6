#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's five CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (flash and paged attention also at head_dim 8 and
   160) and times kernel, plain version and a library yardstick (CUDA
   events); the rmsnorm kernel's three forms (plain, residual add, Mamba2
   gate) at rows 1 to 777 of every width the configs norm, the residual
   form's outputs bit for bit against ``torch.add`` and the plain kernel,
   the bf16 gated form against the plain kernel on ``x * F.silu(z)`` in
   bf16 ulps, the fused forms timed beside the several PyTorch calls they
   replace, and each form's host time a call beside theirs; the
   paged-attention and grouped-matmul kernels (the latter also at the
   ``w_down`` shapes) must give the same bits when called again; the bf16
   flash kernel is also held against the plain mirror of its own tiles
   (``ref.flash_attention_tiles_ref``) at a tighter limit; the redesigned
   kernels' times print beside their previous design's;
4. serves 8 requests of full-width qwen2.5-3b (random weights from
   ``--seed``) through ``ContinuousEngine`` under ``kernel_impls="auto"``,
   checks the kernels' launch counts (rmsnorm's also by form) and every
   request's length, profiles a decode step and one 512-token admission,
   and holds one float32 prefill under ``auto`` against ``reference``;
5. serves 8 requests that share a 488-token tenant prefix through
   ``PagedContinuousEngine(attn="kernel")`` on the same weights (prefix
   fork with copy-on-write, drain and parked resume), checks the launch
   counts of all three kernels, the sharing counters and the block pool,
   and holds float32 paged decode through the kernel against the gather
   path for 8 teacher-forced waves;
6. frees those weights and serves 8 requests of full-width mixtral-8x22b
   cut to 4 of its 56 layers (bf16 weights from ``--seed``) through
   ``ContinuousEngine`` under ``kernel_impls="auto"``, checks the launch
   counts of the grouped-matmul, flash and rmsnorm kernels and every
   request's length, and holds one float32 1-layer prefill under ``auto``
   against ``reference``;
7. frees those weights and serves 8 requests each of full-width,
   full-depth mamba2-2.7b and zamba2-2.7b (fp32 weights from ``--seed``
   plus the bf16 copy) through ``ContinuousEngine`` under
   ``kernel_impls="auto"``, with a drain after 4 steps and a resume,
   checks the exact launch counts of ssd, rmsnorm and flash and every
   request's length, profiles a decode step and one admission, and holds a
   float32 prefill and decode step of one mamba2 layer (one zamba2 group)
   under ``auto`` against ``reference``;
8. prints a ``{"kernels": [...]}`` line (the rmsnorm kernel once for each
   form) and, last, the ``{"ok": true, ...}`` line.

Any failed check raises, so the exit code is not 0. Without CUDA it exits
with code 2 before printing any result. It imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 tensor / fp32 CUDA cores

# tests/test_kernels.py tolerances: (atol, rtol)
TOL = {torch.float32: (5e-5, 5e-4), torch.bfloat16: (5e-2, 5e-2)}
# the bf16 flash kernel against the plain mirror of its own tiles
# (ref.flash_attention_tiles_ref: the same 64 x 64 tiles, halves and merge,
# P rounded to bf16 before P V): only the order of fp32 sums differs, which
# flips a rounding to bf16 (of P or of the output) now and then; rtol 2^-7
# is one bf16 ulp of the output, atol covers a flipped P (PERF.md sets it
# against sound and planted-fault readings)
TILES_TOL = (1e-2, 2 ** -7)
# tests/test_kernels.py's ssd tolerance at float32: kernel and plain version
# sum Q*N products of order 10 in another order (both compute in fp32 from
# the same inputs, bf16 ones included)
SSD_TOL = (2e-3, 1e-3)
# float32 prefill logits, auto (kernels) vs reference, full width: both sides
# sum in another order (FMA flash kernel vs materialised softmax, block
# reduction vs torch's mean), compounded over 36 residual layers; expected
# about 1e-5 on logits of order 1, the limit is 100x that, and a wrong mask
# or head map moves logits by order 0.1.
SLICE_TOL = (1e-3, 1e-3)
# device ms per call of the previous design of each redesigned kernel, as
# this script read them on an H100 80GB HBM3 at 700 W (PERF.md's kernel
# table): paged attention and the grouped matmul before their split-KV and
# tensor-core designs; flash attention (fp32 FMAs) and ssd (one CTA per
# (batch, head), fp32 FMAs) before their tensor-core designs
PREVIOUS_MS = {"paged_attention": 0.52284, "moe_gmm decode": 1.65361,
               "moe_gmm prefill": 10.13531, "flash_attention": 0.17507,
               "flash_attention head_dim 80": 0.21983, "ssd mamba2": 0.54182,
               "ssd zamba2": 0.36733, "rmsnorm": 0.00192, "rmsnorm prefill": 0.00335}
# the rmsnorm kernel's forms by the name of their wrapper (kernels/rmsnorm.py)
RMS_FORMS = {"rmsnorm": "plain", "add_rmsnorm": "residual", "gated_rmsnorm": "gated"}
# the form as rmsnorm_kernel's template argument (csrc/rmsnorm.cu's Form)
RMS_FORM_OF_ARG = {"0": "plain", "1": "residual", "2": "gated"}
# the widths the configs norm: qwen2.5-3b, mamba2/zamba2 d_model, their gated
# d_inner, mixtral-8x22b; and an odd width (the element-wise path)
RMS_WIDTHS = (2048, 2560, 5120, 6144, 777)
# mamba2-2.7b's in_proj row [z, xBC, dt] is 2 * 5120 + 2 * 128 + 80 wide: the
# row stride of the gated norm's z
MAMBA2_ZXBCDT = 10576
# the gated form rounds silu(z) to bf16 before the product, as `x * F.silu(z)`
# does; its silu takes the fast exp and divide, which may flip that rounding
# now and then, so it is not held bit for bit against the plain kernel on the
# composition. Limits on y, in bf16 ulps at the reference and as the share of
# elements that differ: on an H100 a sound kernel reads 0 and 0, one that
# skips the rounding 3 ulps and over a quarter of the elements (PERF.md)
GATE_ULPS, GATE_DIFF_SHARE = 1, 1e-3


def cuda_ms(fn, iters: int = 50, reps: int = 5, graph: bool = True) -> tuple:
    """Mean time of one call of ``fn`` in ms, as (device, eager).

    device: ``iters`` calls captured in one CUDA graph, replayed ``reps``
    times between CUDA events, so host launch overhead is out of the number.
    eager: ``iters`` back-to-back calls from Python between CUDA events; for
    a small kernel this is the host's launch rate, not the kernel. With
    ``graph=False`` (a function that waits for the device inside, so no
    graph can hold it) both numbers are the eager one."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    device = None
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture stream
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            for _ in range(iters):
                fn()
        cuda_graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            cuda_graph.replay()
        end.record()
        torch.cuda.synchronize()
        device = start.elapsed_time(end) / (reps * iters)
    else:
        fn()  # warm up
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    return (eager if device is None else device), eager


def time_three(kernel, plain, library, plain_graph: bool = True) -> dict:
    """Device and eager times of the kernel, its plain version and the
    library yardstick (None where there is none)."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        graph = plain_graph or key != "plain_ms"
        out[key], out["eager_" + key] = cuda_ms(fn, graph=graph) if fn is not None else (None, None)
    return out


def _fmt(v) -> str:
    return "n/a" if v is None else f"{v:.5f}"


def report(name: str, t: dict) -> None:
    fmt = _fmt
    prior = (f"; previous design {PREVIOUS_MS[name]:.5f} ms" if name in PREVIOUS_MS
             else "")
    fused = (f"; several library calls ({t['library_calls']}) {fmt(t['library_calls_ms'])} "
             f"ms, unfused ({t['unfused']}) {fmt(t['unfused_ms'])} ms"
             if "library_calls_ms" in t else "")
    print(f"time {name} {t['shape']}: device (CUDA graph) kernel {fmt(t['ms'])} ms, "
          f"plain {fmt(t['plain_ms'])} ms, library {fmt(t['library_ms'])} ms; eager "
          f"kernel {fmt(t['eager_ms'])} ms, plain {fmt(t['eager_plain_ms'])} ms, library "
          f"{fmt(t['eager_library_ms'])} ms; bound {t['bound_ms']:.6f} ms ({t['bound_by']})"
          f"{fused}{prior}")
    if "host_us" in t:
        others = ", ".join(f"{label} {fmt(t[key])}" for key, label in (
            ("library_host_us", "the library call"),
            ("unfused_host_us", f"the unfused calls ({t.get('unfused')})")) if key in t)
        print(f"host {name}: the wrapper {fmt(t['host_us'])} us a call, {others} (host clock, "
              f"2000 calls back to back)")


def check_repeat(name: str, fn) -> None:
    """Two calls give the same bits (no float atomics in the kernels)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{name}: a repeated call gave other bits")
    print(f"check {name}: a repeated call gives the same bits")


def check_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} elements differ in their bits")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond atol={atol} "
                             f"rtol={rtol}; max abs err {err.max().item():.3e}")
    return err.max().item()


def limit_share(got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """The largest |got - want| / (atol + rtol |want|): 1.0 is at the limit."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def rmsnorm_bound(rows: int, d: int, dtype: torch.dtype, form: str):
    """(bound ms, 'bytes' | 'operations') of one call of an rmsnorm form:
    its inputs (x; h, or the d columns of z it needs; w) read once and its
    outputs (y; s) written once; fp32 operations per element: square-add,
    scale and weight, plus the add, or silu (negate, exp, add, divide) and
    the product."""
    elt = torch.empty((), dtype=dtype).element_size()
    moved = {"plain": 2, "residual": 4, "gated": 3}[form]
    ops = {"plain": 4, "residual": 5, "gated": 9}[form] * rows * d
    t_bytes = (moved * rows * d * elt + d * 4) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in units of bf16's spacing at want (8 significant bits)."""
    want = want.float()
    spacing = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    return (got.float() - want).abs() / spacing


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds a call of ``fn``: ``n`` back-to-back calls on the
    host clock from a drained device. A small kernel's device time is below
    its launch's host time, so the queue never backs up and this is what a
    call costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def expected_norm_forms(cfg, passes: int) -> dict:
    """The rmsnorm kernel's launches by form over ``passes`` forward passes
    (prefills, decode steps, paged waves), from the model code: per pass one
    plain (the stack's first norm follows the embedding and no add), one
    gated for each Mamba2 mixer, and the residual form for every other norm
    (each follows a residual add; the final norm too)."""
    gated = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    total = 2 * cfg.n_layers + 1 + (2 * cfg.n_attn_layers if cfg.family == "hybrid" else 0)
    return {"plain": passes, "residual": (total - 1 - gated) * passes,
            "gated": gated * passes}


def check_norm_forms(tag: str, cfg, passes: int, counts: dict, forms: dict) -> dict:
    """Assert this path's rmsnorm launches by form (read beside ``counts``);
    returns ``counts`` with them under ``rmsnorm_forms``."""
    expect = expected_norm_forms(cfg, passes)
    print(f"{tag}: rmsnorm launches by form {forms}, expected {expect}")
    if forms != expect:
        raise AssertionError(f"{tag}: rmsnorm forms {forms} != expected {expect}")
    return dict(counts, rmsnorm_forms=forms)


def flash_bound(b, h, kv, s, d, dtype, causal=True, window=None):
    """(bound ms, 'bytes' | 'operations') for attention over this run's mask."""
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= k <= q
    if window is not None:
        mask &= k > q - window
    pairs = int(mask.sum())
    flops = 4 * b * h * d * pairs                  # QK^T and PV, 2 flops a MAC
    elt = torch.empty((), dtype=dtype).element_size()
    bytes_ = (2 * b * h * s * d + 2 * b * kv * s * d) * elt
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def paged_bound(lens, h, kv, d, bs, dtype):
    """(bound ms, 'bytes' | 'operations') for paged decode attention over
    these lengths: the K/V positions the rows need, q, out, the table
    entries and lengths read."""
    elt = torch.empty((), dtype=dtype).element_size()
    n = int(sum(lens))
    blocks = sum(-(-int(n_) // bs) for n_ in lens)
    bytes_ = 2 * n * kv * d * elt + 2 * len(lens) * h * d * elt + 4 * (blocks + len(lens))
    flops = 4 * h * d * n                          # q.k and p.v, 2 flops a MAC
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gmm_bound(lhs, rhs, te):
    """(bound ms, 'bytes' | 'operations') for one grouped matmul on these
    inputs: lhs, the rhs experts the tiles use and out moved once, te read;
    2*T*D*F operations."""
    t, d = lhs.shape
    f = rhs.shape[2]
    elt = lhs.element_size()
    used = int(torch.unique(te).numel())
    bytes_ = t * d * elt + used * d * f * elt + t * f * elt + te.numel() * 4
    flops = 2 * t * d * f
    t_ops, t_bytes = flops / PEAK_FLOPS[lhs.dtype], bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def moe_kernel_phase(gen: torch.Generator) -> dict:
    """moe_gmm against its plain version at the main path's decode-wave and
    prefill shapes (full-width mixtral, bf16) and at small float32 cases,
    then timed at both main shapes beside torch.bmm over the capacity buffer."""
    from repro_torch.kernels.moe_gmm import row_tile
    from repro_torch.kernels.ops import moe_gmm_op, pad_group_sizes
    from repro_torch.kernels.ref import moe_gmm_ref, moe_gmm_tiles_ref

    dev = "cuda"
    res = {"err": 0.0}

    def case(t, d, f, e, bt, dtype, scale=1.0):
        lhs = torch.randn(t, d, device=dev, generator=gen).to(dtype)
        rhs = (torch.randn(e, d, f, device=dev, generator=gen) * scale).to(dtype)
        te = torch.arange(e, device=dev, dtype=torch.int32).repeat_interleave(t // bt // e)
        return lhs, rhs, te

    # (T, D, F, E, block_t, dtype, label): the capacity buffers of the main
    # path (cap 8 at the 4-slot decode wave, cap 160 at a 512-token prefill;
    # block_t = gcd(cap, 128)), w_gate/w_up and w_down shapes, then small
    # float32 cases
    d_model, d_ff, e_full = 6144, 16384, 8
    cases = [(64, d_model, d_ff, e_full, 8, torch.bfloat16, "decode w_gate/w_up"),
             (64, d_ff, d_model, e_full, 8, torch.bfloat16, "decode w_down"),
             (1280, d_model, d_ff, e_full, 32, torch.bfloat16, "prefill w_gate/w_up"),
             (1280, d_ff, d_model, e_full, 32, torch.bfloat16, "prefill w_down"),
             (256, 64, 96, 4, 32, torch.float32, "F not a multiple of the tile"),
             (64, 64, 96, 8, 8, torch.float32, "block_t 8"),
             (128, 32, 200, 2, 64, torch.float32, "E 2"),
             (39, 40, 52, 3, 13, torch.float32, "block_t 13, odd D and F")]
    for t, d, f, e, bt, dtype, label in cases:
        lhs, rhs, te = case(t, d, f, e, bt, dtype, scale=d ** -0.5)
        name = f"moe_gmm {label} lhs ({t},{d}) rhs ({e},{d},{f}) block_t {bt} {dtype}"
        err = check_close(name, moe_gmm_op(lhs, rhs, te, block_t=bt),
                          moe_gmm_tiles_ref(lhs, rhs, te, bt), TOL[dtype])
        torch.cuda.synchronize()
        print(f"check {name}: max abs err {err:.3e}")
        res["err"] = max(res["err"], err)
    # ragged groups padded by pad_group_sizes (an empty group, zero rows)
    sizes = torch.tensor([5, 0, 17, 8], dtype=torch.int32, device=dev)
    padded, offs = pad_group_sizes(sizes, 8)
    t = int(offs[-1])
    lhs = torch.zeros(t, 64, device=dev)
    for n, o in zip(sizes.tolist(), offs[:-1].tolist()):
        lhs[o:o + n] = torch.randn(n, 64, device=dev, generator=gen)
    rhs = torch.randn(4, 64, 96, device=dev, generator=gen)
    te = (torch.searchsorted(offs, torch.arange(t // 8, device=dev, dtype=torch.int32) * 8,
                             right=True) - 1).clamp(0, 3)
    err = check_close("moe_gmm ragged groups", moe_gmm_op(lhs, rhs, te, block_t=8),
                      moe_gmm_ref(lhs, rhs, padded), TOL[torch.float32])
    torch.cuda.synchronize()
    print(f"check moe_gmm ragged groups {sizes.tolist()} padded to {padded.tolist()}, "
          f"block_t 8, float32: max abs err {err:.3e}")
    res["err"] = max(res["err"], err)

    # timing at the main path's shapes, bf16: w_gate/w_up (D 6144 -> F 16384)
    # and w_down (16384 -> 6144)
    for t, d, f, bt, label in ((64, d_model, d_ff, 8, "decode"),
                               (1280, d_model, d_ff, 32, "prefill"),
                               (64, d_ff, d_model, 8, "decode w_down"),
                               (1280, d_ff, d_model, 32, "prefill w_down")):
        lhs, rhs, te = case(t, d, f, e_full, bt, torch.bfloat16, scale=d ** -0.5)
        buf = lhs.view(e_full, t // e_full, d)
        check_close(f"moe_gmm {label} library yardstick (torch.bmm) vs plain",
                    torch.bmm(buf, rhs).reshape(t, f), moe_gmm_tiles_ref(lhs, rhs, te, bt),
                    TOL[torch.bfloat16])
        check_repeat(f"moe_gmm {label}", lambda: moe_gmm_op(lhs, rhs, te, block_t=bt))
        bound, by = gmm_bound(lhs, rhs, te)
        tm = time_three(lambda: moe_gmm_op(lhs, rhs, te, block_t=bt),
                        lambda: moe_gmm_tiles_ref(lhs, rhs, te, bt),
                        lambda: torch.bmm(buf, rhs), plain_graph=False)
        tm.update(bound_ms=bound, bound_by=by,
                  shape=f"{label}: lhs ({t},{d}) rhs ({e_full},{d},{f}) "
                        f"block_t {bt} bf16, {row_tile(t, e_full)}-row tiles; plain timed "
                        f"eager (it waits for the device); library: torch.bmm over the "
                        f"(E, C, D) capacity buffer")
        report(f"moe_gmm {label}", tm)
        res[label] = tm
        del lhs, rhs, buf
    res.update(res["decode"])  # the decode wave carries most of the launches
    return res


def ssd_bound(x, dt, a, bm, cm, chunk):
    """(bound ms, 'bytes' | 'operations') for one SSD scan on these inputs:
    x, dt, a, B, C read once, y and the final state (fp32) written once; the
    products over each chunk's causal pairs (scores C.B^T and scores.xdt),
    the entering state's term and the state update."""
    b, s, h, p = x.shape
    n = bm.shape[3]
    elt = x.element_size()
    bytes_ = ((x.numel() + bm.numel() + cm.numel()) * elt + (dt.numel() + a.numel()) * 4
              + (b * s * h * p + b * h * p * n) * 4)
    pairs = chunk * (chunk + 1) // 2
    flops = (s // chunk) * b * h * (2 * pairs * n + 2 * pairs * p + 4 * chunk * p * n)
    t_ops, t_bytes = flops / PEAK_FLOPS[x.dtype], bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssd_kernel_phase(gen: torch.Generator) -> dict:
    """ssd against its plain version (ssd_chunk_ref) at mamba2's and zamba2's
    512-token prefill shapes (bf16 x/B/C, fp32 dt) and at small float32
    cases (tests/test_kernels.py's shapes, chunk invariance, S of one chunk),
    against the sequential recurrence on the small cases, then timed at both
    prefill shapes. No single PyTorch call computes the SSD scan, so there
    is no library yardstick."""
    from repro_torch.kernels.ops import ssd_op
    from repro_torch.kernels.ref import ssd_chunk_ref, ssd_ref

    dev = "cuda"
    res = {"err": 0.0}

    def case(b, s, h, p, g, n, dtype):
        """tests/test_kernels.py's construction: x, B, C standard normal,
        dt = softplus(N(0,1)), a = -exp(0.3 N(0,1))."""
        x = torch.randn(b, s, h, p, device=dev, generator=gen).to(dtype)
        dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=dev, generator=gen))
        a = -torch.exp(torch.randn(h, device=dev, generator=gen) * 0.3)
        bm = torch.randn(b, s, g, n, device=dev, generator=gen).to(dtype)
        cm = torch.randn(b, s, g, n, device=dev, generator=gen).to(dtype)
        return x, dt, a, bm, cm

    def check(label, inputs, chunk, oracle=False):
        name = (f"ssd {label} x {tuple(inputs[0].shape)} B {tuple(inputs[3].shape)} "
                f"chunk {chunk} {inputs[0].dtype}")
        y, fin = ssd_op(*inputs, chunk=chunk)
        want = ssd_chunk_ref(*inputs, chunk)
        err = max(check_close(name + " y", y, want[0], SSD_TOL),
                  check_close(name + " final state", fin, want[1], SSD_TOL))
        share = max(limit_share(y, want[0], SSD_TOL), limit_share(fin, want[1], SSD_TOL))
        if oracle:  # the sequential recurrence, a different order of sums
            seq = ssd_ref(*inputs)
            err = max(err, check_close(name + " y vs ssd_ref", y, seq[0], SSD_TOL),
                      check_close(name + " state vs ssd_ref", fin, seq[1], SSD_TOL))
        torch.cuda.synchronize()
        print(f"check {name}: max abs err {err:.3e}, {share:.3f} of the limit against "
              f"ssd_chunk_ref (atol={SSD_TOL[0]} rtol={SSD_TOL[1]})"
              f"{'; also against ssd_ref' if oracle else ''}")
        res["err"] = max(res["err"], err)
        return y

    mamba2 = (1, 512, 80, 64, 1, 128)   # x (1, 512, 80, 64), B/C (1, 512, 1, 128)
    zamba2 = (1, 512, 80, 64, 1, 64)
    for label, shape in (("mamba2 prefill", mamba2), ("zamba2 prefill", zamba2)):
        check(label, case(*shape, torch.bfloat16), 256)
    for b, s, h, p, g, n, chunk in ((2, 64, 4, 16, 2, 8, 16), (1, 128, 8, 64, 1, 32, 32),
                                    (2, 96, 2, 8, 2, 16, 32), (1, 256, 4, 64, 1, 64, 128)):
        check("small", case(b, s, h, p, g, n, torch.float32), chunk, oracle=True)
    check("S of one chunk", case(1, 256, 4, 64, 1, 128, torch.float32), 256, oracle=True)
    inputs = case(1, 128, 2, 16, 1, 8, torch.float32)
    ys = [check("chunk invariance", inputs, c, oracle=True) for c in (16, 32, 64, 128)]
    for y in ys[1:]:
        err = check_close("ssd chunk invariance", y, ys[0], (1e-4, 1e-3))
        res["err"] = max(res["err"], err)
    print(f"check ssd chunk invariance over 16/32/64/128: y within atol=1e-4 rtol=1e-3")

    for label, shape in (("zamba2", zamba2), ("mamba2", mamba2)):  # the kernels line: mamba2
        inputs = case(*shape, torch.bfloat16)
        bound, by = ssd_bound(*inputs, 256)
        t = time_three(lambda: ssd_op(*inputs, chunk=256),
                       lambda: ssd_chunk_ref(*inputs, 256), None)
        t.update(bound_ms=bound, bound_by=by,
                 shape=f"{label} prefill: x {tuple(inputs[0].shape)} bf16, dt fp32, B/C "
                       f"{tuple(inputs[3].shape)} bf16, chunk 256; library: none (no PyTorch "
                       f"call computes the SSD scan)")
        report(f"ssd {label}", t)
        res[label] = t
    res.update(res["mamba2"])
    return res


def paged_case(gen, b, h, kv, d, bs, maxb, lens, dtype):
    """Pools, q, block tables that are a random permutation avoiding the
    null block 0, and the given lengths, on the card."""
    dev = "cuda"
    nb = b * maxb + 1
    k_pool = torch.randn(nb, bs, kv, d, device=dev, generator=gen).to(dtype)
    v_pool = torch.randn(nb, bs, kv, d, device=dev, generator=gen).to(dtype)
    q = torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
    perm = torch.randperm(nb - 1, device=dev, generator=gen)[:b * maxb] + 1
    tables = perm.reshape(b, maxb).to(torch.int32)
    return q, k_pool, v_pool, tables, torch.tensor(lens, dtype=torch.int32, device=dev)


def paged_kernel_phase(gen: torch.Generator) -> dict:
    from repro_torch.kernels.ops import paged_attention_op
    from repro_torch.kernels.paged_attention import blocks_per_split
    from repro_torch.kernels.ref import paged_attention_ref

    res = {"err": 0.0}
    main = (8, 16, 2, 128, 16, 40, [1, 15, 16, 17, 255, 256, 511, 640])
    cases = [main + (dt,) for dt in (torch.float32, torch.bfloat16)]
    cases += [c + (dt,) for c in ((4, 4, 1, 16, 16, 4, [1, 16, 17, 64]),
                                  (2, 4, 4, 32, 8, 3, [5, 24]),
                                  (3, 8, 2, 64, 16, 2, [2, 31, 32]),
                                  (2, 6, 3, 32, 4, 5, [3, 13]),
                                  (3, 4, 2, 8, 16, 4, [1, 33, 64]),         # head_dim 8
                                  (4, 32, 8, 160, 16, 8, [5, 16, 100, 128]))  # head_dim 160
              for dt in (torch.float32, torch.bfloat16)]
    for b, h, kv, d, bs, maxb, lens, dtype in cases:
        q, k_pool, v_pool, tables, ln = paged_case(gen, b, h, kv, d, bs, maxb, lens, dtype)
        name = f"paged (b={b},h={h},kv={kv},d={d},bs={bs},maxb={maxb}) lens={lens} {dtype}"
        err = check_close(name, paged_attention_op(q, k_pool, v_pool, tables, ln),
                          paged_attention_ref(q, k_pool, v_pool, tables, ln), TOL[dtype])
        torch.cuda.synchronize()
        print(f"check {name}: max abs err {err:.3e}")
        res["err"] = max(res["err"], err)
    # inactive slots: all-null tables, length 1 -> finite; length 0 -> zeros
    q, k_pool, v_pool, tables, _ = paged_case(gen, 4, 16, 2, 128, 16, 4, [1] * 4,
                                              torch.bfloat16)
    null = paged_attention_op(q, k_pool, v_pool, torch.zeros_like(tables),
                              torch.ones(4, dtype=torch.int32, device="cuda"))
    zero_lens = torch.tensor([0, 5, 0, 64], dtype=torch.int32, device="cuda")
    out = paged_attention_op(q, k_pool, v_pool, tables, zero_lens)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(null).all()):
        raise AssertionError("paged: null rows are not finite")
    if not (bool((out[0] == 0).all()) and bool((out[2] == 0).all())):
        raise AssertionError("paged: rows of length 0 are not zeros")
    check_close("paged rows next to the empty ones", out[1::2],
                paged_attention_ref(q[1::2], k_pool, v_pool, tables[1::2], zero_lens[1::2]),
                TOL[torch.bfloat16])
    print("check paged null rows (table all null block, length 1): finite; "
          "rows of length 0: zeros")

    # timing at the main path's decode wave (8 slots), bf16
    b, h, kv, d, bs, maxb, lens = main
    q, k_pool, v_pool, tables, ln = paged_case(gen, b, h, kv, d, bs, maxb, lens,
                                               torch.bfloat16)
    # library yardstick: SDPA over K/V gathered to dense and repeated per
    # group beforehand (the gather is not timed), with the length mask
    s = maxb * bs
    k_dense = k_pool[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
    v_dense = v_pool[tables.long()].reshape(b, s, kv, d).transpose(1, 2)
    k_dense = k_dense.repeat_interleave(h // kv, dim=1)
    v_dense = v_dense.repeat_interleave(h // kv, dim=1)
    mask = (torch.arange(s, device="cuda")[None, :] < ln[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(q4, k_dense, v_dense,
                                                                attn_mask=mask)
    check_close("paged library yardstick (SDPA) vs plain", library()[:, :, 0],
                paged_attention_ref(q, k_pool, v_pool, tables, ln), TOL[torch.bfloat16])
    check_repeat("paged_attention decode wave",
                 lambda: paged_attention_op(q, k_pool, v_pool, tables, ln))
    bound, by = paged_bound(lens, h, kv, d, bs, torch.bfloat16)
    t = time_three(lambda: paged_attention_op(q, k_pool, v_pool, tables, ln),
                   lambda: paged_attention_ref(q, k_pool, v_pool, tables, ln), library)
    t.update(bound_ms=bound, bound_by=by,
             shape=f"q ({b},{h},{d}) kv {kv} bs {bs} maxb {maxb} lens {lens} bf16, "
                   f"{blocks_per_split(b, kv, bs, maxb)} blocks a split; library: "
                   f"SDPA over K/V gathered to dense (untimed) and repeated per group, "
                   f"length mask")
    report("paged_attention", t)
    res.update(t)
    return res


def rmsnorm_kernel_phase(gen: torch.Generator) -> dict:
    """The rmsnorm kernel's three forms against their plain versions at rows
    1, 4, 8, 512 and 777 of every width the configs norm (and an odd one),
    in both dtypes, z at the row stride of a Mamba2 in_proj row; the
    residual form's s against torch.add and its y against the plain kernel
    on s, bit for bit; the bf16 gated form against the plain kernel on
    ``x * F.silu(z)`` within GATE_ULPS and GATE_DIFF_SHARE; the element-wise
    path (misaligned views) against the 16-byte path, bit for bit; then each
    form timed at the decode wave and at a prefill, and each wrapper's host
    time a call beside the calls it replaces."""
    from repro_torch.kernels.ops import add_rmsnorm_op, gated_rmsnorm_op, rmsnorm_op
    from repro_torch.kernels.ref import add_rmsnorm_ref, gated_rmsnorm_ref, rmsnorm_ref

    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32
    F = torch.nn.functional
    res = {name: {"err": 0.0} for name in RMS_FORMS}
    gate_ulps, gate_share = 0.0, 0.0  # the gated form's rounding, bf16

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def z_slice(rows, d, dtype, stride=None, offset=0):
        """z as Mamba2 slices it: the first d columns of a wider row
        (``offset`` elements in: a base and stride off 16 bytes)."""
        stride = stride or 2 * d + 336
        return rand(rows, stride + offset, dtype=dtype)[:, offset:offset + d]

    for d in RMS_WIDTHS:
        w = rand(d)
        for dtype in (f32, bf16):
            errs = dict.fromkeys(RMS_FORMS, 0.0)
            for rows in (1, 4, 8, 512, 777):
                x, h, z = rand(rows, d, dtype=dtype), rand(rows, d, dtype=dtype), \
                    z_slice(rows, d, dtype)
                label = f"rows={rows} d={d} {dtype}"
                errs["rmsnorm"] = max(errs["rmsnorm"], check_close(
                    f"rmsnorm {label}", rmsnorm_op(x, w), rmsnorm_ref(x, w), TOL[dtype]))
                s, y = add_rmsnorm_op(x, h, w)
                check_bits(f"add_rmsnorm {label}: s against torch.add", s, torch.add(x, h))
                check_bits(f"add_rmsnorm {label}: y against the plain kernel on s", y,
                           rmsnorm_op(s, w))
                errs["add_rmsnorm"] = max(errs["add_rmsnorm"], check_close(
                    f"add_rmsnorm {label}", y, add_rmsnorm_ref(x, h, w)[1], TOL[dtype]))
                yg = gated_rmsnorm_op(x, z, w)
                errs["gated_rmsnorm"] = max(errs["gated_rmsnorm"], check_close(
                    f"gated_rmsnorm {label}", yg, gated_rmsnorm_ref(x, z, w), TOL[dtype]))
                if dtype == bf16:
                    ulps = bf16_ulps(yg, rmsnorm_op(x * F.silu(z), w))
                    share = (ulps > 0).float().mean().item()
                    if ulps.max().item() > GATE_ULPS or share > GATE_DIFF_SHARE:
                        raise AssertionError(
                            f"gated_rmsnorm {label} against the plain kernel on x * F.silu(z): "
                            f"{ulps.max().item():.0f} bf16 ulps at most, {share:.3e} of the "
                            f"elements differ (limits {GATE_ULPS}, {GATE_DIFF_SHARE})")
                    gate_ulps, gate_share = max(gate_ulps, ulps.max().item()), max(gate_share,
                                                                                   share)
            torch.cuda.synchronize()
            print(f"check rmsnorm forms d={d} {dtype}, rows 1/4/8/512/777: "
                  f"max abs err plain {errs['rmsnorm']:.3e}, residual "
                  f"{errs['add_rmsnorm']:.3e} (s = torch.add and y = the plain kernel on s, "
                  f"bit for bit), gated {errs['gated_rmsnorm']:.3e} (z at row stride "
                  f"{2 * d + 336}) (atol={TOL[dtype][0]} rtol={TOL[dtype][1]})")
            for name in RMS_FORMS:
                res[name]["err"] = max(res[name]["err"], errs[name])
    print(f"check gated_rmsnorm bf16 against the plain kernel on x * F.silu(z) (silu rounded "
          f"to bf16 before the product): at most {gate_ulps:.0f} bf16 ulps, at most "
          f"{gate_share:.3e} of a case's elements differ (limits {GATE_ULPS}, "
          f"{GATE_DIFF_SHARE})")
    for dtype in (f32, bf16):  # the element-wise path gives the 16-byte path's bits
        d, rows = 5120, 502
        w, x = rand(d), rand(rows, d, dtype=dtype)
        z = z_slice(rows, d, dtype, stride=MAMBA2_ZXBCDT - 1, offset=1)
        check_bits(f"gated_rmsnorm misaligned z {dtype}", gated_rmsnorm_op(x, z, w),
                   gated_rmsnorm_op(x, z.contiguous(), w))
        xm, hm = (z_slice(rows, d, dtype, stride=d + 1, offset=1) for _ in range(2))
        for got, want in zip(add_rmsnorm_op(xm, hm, w),
                             add_rmsnorm_op(xm.contiguous(), hm.contiguous(), w)):
            check_bits(f"add_rmsnorm misaligned x and h {dtype}", got, want)
        torch.cuda.synchronize()
    print("check rmsnorm element-wise path (views one element into a wider row, base and "
          "stride off 16 bytes) gives the 16-byte path's bits: gated and residual, "
          "(502, 5120), both dtypes")

    # timing: each form at the decode wave and at a prefill, bf16
    has_rms = hasattr(torch.nn.functional, "rms_norm")
    for rows, tag in ((512, " prefill"), (4, "")):  # the kernels line: the decode wave
        d = 2048
        w, x, h = rand(d), rand(rows, d, dtype=bf16), rand(rows, d, dtype=bf16)
        w_lib = w.to(bf16)
        lib = (lambda: F.rms_norm(x, (d,), w_lib, 1e-5)) if has_rms else None
        t = time_three(lambda: rmsnorm_op(x, w), lambda: rmsnorm_ref(x, w), lib)
        bound, by = rmsnorm_bound(rows, d, bf16, "plain")
        t.update(bound_ms=bound, bound_by=by, shape=f"x ({rows}, {d}) bf16, w fp32; library: "
                 f"F.rms_norm, w in bf16")
        if not tag:  # what a call costs the host, at the decode wave
            t.update(host_us=host_us(lambda: rmsnorm_op(x, w)),
                     library_host_us=host_us(lib) if has_rms else None)
        report("rmsnorm" + tag, t)
        res["rmsnorm"]["prefill" if tag else "decode"] = t
        t = time_three(lambda: add_rmsnorm_op(x, h, w), lambda: add_rmsnorm_ref(x, h, w), None)
        bound, by = rmsnorm_bound(rows, d, bf16, "residual")
        t.update(bound_ms=bound, bound_by=by,
                 shape=f"x, h ({rows}, {d}) bf16, w fp32; library: none (no one PyTorch call)",
                 library_calls="torch.add, F.rms_norm", unfused="torch.add, the plain kernel",
                 library_calls_ms=cuda_ms(lambda: F.rms_norm(torch.add(x, h), (d,), w_lib, 1e-5))[0]
                 if has_rms else None,
                 unfused_ms=cuda_ms(lambda: rmsnorm_op(torch.add(x, h), w))[0])
        if not tag:
            t.update(host_us=host_us(lambda: add_rmsnorm_op(x, h, w)),
                     unfused_host_us=host_us(lambda: rmsnorm_op(torch.add(x, h), w)))
        report("add_rmsnorm" + tag, t)
        res["add_rmsnorm"]["prefill" if tag else "decode"] = t
    for rows, tag in ((502, " prefill"), (4, "")):
        d = 5120
        w, x = rand(d), rand(rows, d, dtype=bf16)
        z = z_slice(rows, d, bf16, stride=MAMBA2_ZXBCDT)
        w_lib = w.to(bf16)
        t = time_three(lambda: gated_rmsnorm_op(x, z, w), lambda: gated_rmsnorm_ref(x, z, w),
                       None)
        bound, by = rmsnorm_bound(rows, d, bf16, "gated")
        t.update(bound_ms=bound, bound_by=by,
                 shape=f"x ({rows}, {d}) bf16, z its columns of a ({rows}, {MAMBA2_ZXBCDT}) "
                       f"in_proj row (mamba2-2.7b), w fp32; library: none (no one PyTorch call)",
                 library_calls="F.silu, mul, F.rms_norm", unfused="F.silu, mul, the plain kernel",
                 library_calls_ms=cuda_ms(lambda: F.rms_norm(x * F.silu(z), (d,), w_lib, 1e-5))[0]
                 if has_rms else None,
                 unfused_ms=cuda_ms(lambda: rmsnorm_op(x * F.silu(z), w))[0])
        if not tag:
            t.update(host_us=host_us(lambda: gated_rmsnorm_op(x, z, w)),
                     unfused_host_us=host_us(lambda: rmsnorm_op(x * F.silu(z), w)))
        report("gated_rmsnorm" + tag, t)
        res["gated_rmsnorm"]["prefill" if tag else "decode"] = t
    for name in RMS_FORMS:  # the kernels line carries the decode wave's numbers
        res[name].update(res[name]["decode"])
    return res


def flash_kernel_phase(gen: torch.Generator) -> dict:
    from repro_torch.kernels.ops import flash_attention_op
    from repro_torch.kernels.ref import flash_attention_ref, flash_attention_tiles_ref

    dev = "cuda"
    results = {"flash_attention": {"err": 0.0}}

    # --- flash attention: (B,S,H,D) projections read as (B,H,S,D) views
    def qkv(b, h, kv, s, dd, dtype):
        q = torch.randn(b, s, h, dd, device=dev, generator=gen).to(dtype).transpose(1, 2)
        k = torch.randn(b, s, kv, dd, device=dev, generator=gen).to(dtype).transpose(1, 2)
        v = torch.randn(b, s, kv, dd, device=dev, generator=gen).to(dtype).transpose(1, 2)
        return q, k, v

    cases = [(1, 16, 2, s, 128, True, None, dt) for s in (512, 1000)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(1, 16, 2, 1000, 128, True, 256, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 4, 1, 100, 16, True, None, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(1, 4, 4, 128, 64, False, None, torch.float32)]
    # zamba2-2.7b's shared attention at its prefill: 32 heads of head_dim 80
    cases += [(1, 32, 32, 512, 80, True, None, dt) for dt in (torch.float32, torch.bfloat16)]
    # head_dim 8 (internvl2-26b's smoke) and 160 (stablelm-12b, 32/8 heads)
    cases += [(1, 4, 2, 200, 8, True, None, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(1, 32, 8, 300, 160, True, None, dt) for dt in (torch.float32, torch.bfloat16)]
    # mixtral-8x22b's attention at its 512-token prefill: 48 heads on 8 kv heads
    cases += [(1, 48, 8, 512, 128, True, None, torch.bfloat16)]
    for b, h, kv, s, dd, causal, window, dtype in cases:
        q, k, v = qkv(b, h, kv, s, dd, dtype)
        name = (f"flash (b={b},h={h},kv={kv},s={s},d={dd}) causal={causal} "
                f"window={window} {dtype}")
        out = flash_attention_op(q, k, v, causal=causal, window=window)
        err = check_close(name, out, flash_attention_ref(q, k, v, causal=causal, window=window),
                          TOL[dtype])
        tiles = ""
        if dtype == torch.bfloat16:  # the tensor-core kernel: also its own tiles' mirror
            mirror = flash_attention_tiles_ref(q, k, v, causal=causal, window=window)
            err_t = check_close(name + " vs the tiles mirror", out, mirror, TILES_TOL)
            tiles = (f"; against the tiles mirror {err_t:.3e}, "
                     f"{limit_share(out, mirror, TILES_TOL):.3f} of its limit (atol="
                     f"{TILES_TOL[0]} rtol={TILES_TOL[1]})")
        torch.cuda.synchronize()
        print(f"check {name}: max abs err {err:.3e} (atol={TOL[dtype][0]} "
              f"rtol={TOL[dtype][1]}){tiles}")
        results["flash_attention"]["err"] = max(results["flash_attention"]["err"], err)
    # timing at the prefill shapes of zamba2's shared block (32 heads of 80)
    # and, for the kernels line, of qwen2.5-3b
    for label, (b, h, kv, s, dd) in (("flash_attention head_dim 80", (1, 32, 32, 512, 80)),
                                     ("flash_attention", (1, 16, 2, 512, 128))):
        q, k, v = qkv(b, h, kv, s, dd, torch.bfloat16)
        k_rep = k.repeat_interleave(h // kv, dim=1)
        v_rep = v.repeat_interleave(h // kv, dim=1)
        bound, by = flash_bound(b, h, kv, s, dd, torch.bfloat16)
        t = time_three(lambda: flash_attention_op(q, k, v, causal=True),
                       lambda: flash_attention_ref(q, k, v, causal=True),
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q, k_rep, v_rep, is_causal=True))
        t.update(bound_ms=bound, bound_by=by,
                 shape=f"q ({b},{h},{s},{dd}) kv {kv} causal bf16; library: SDPA, K/V repeated")
        report(label, t)
    results["flash_attention"].update(t)
    return results["flash_attention"]


def profile_decode(engine, prompts, gen_request, steps: int = 4) -> dict:
    """Where a decode step's time goes, on ``n_slots`` fresh requests (see
    :func:`profile_steps`)."""
    for i in range(engine.n_slots):
        engine.add(gen_request(id=1000 + i, prompt=prompts[i], max_new=steps + 2))
    engine.step()
    out = profile_steps(engine, steps)
    engine.run()
    return out


# the names of each op's kernels (every pass) as the profiler shows them, inside
# a demangled signature such as "void (anonymous namespace)::paged_split_kernel<...>(...)";
# rmsnorm's three forms are one kernel whose second template argument is the
# form, "rmsnorm_kernel<__nv_bfloat16, 1, true, 1>" (RMS_FORM_OF_ARG)
HAND_WRITTEN = {"rmsnorm": ("rmsnorm_kernel",),
                "flash_attention": ("flash_fwd_kernel", "flash_tc_kernel"),
                "paged_attention": ("paged_split_kernel", "paged_combine_kernel"),
                "moe_gmm": ("moe_gmm_kernel", "gmm_narrow_kernel", "gmm_wgmma_kernel"),
                "ssd": ("ssd_kernel", "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                        "ssd_chunk_scan_kernel")}


def profile_steps(engine, steps: int) -> dict:
    """Where the engine's next ``steps`` decode steps' time goes (see
    :func:`profile_run`)."""
    def run():
        for _ in range(steps):
            engine.step()
    return profile_run(run, f"{steps} decode steps ({engine.n_slots} slots, profiler on)",
                       steps, "decode", "step")


def profile_prefill(engine, prompt, gen_request) -> dict:
    """Where one admission's time goes on an idle engine: the prefill of
    ``prompt`` at batch 1, the graft and the first token (see
    :func:`profile_run`)."""
    out = profile_run(lambda: engine.add(gen_request(id=2000, prompt=prompt, max_new=2)),
                      f"one admission ({len(prompt)}-token prefill at batch 1, profiler on)",
                      1, "prefill", "prefill")
    engine.run()
    return out


def profile_run(run, label: str, n: int, key: str, unit: str) -> dict:
    """Device-busy time (sum of CUDA kernel times seen by ``torch.profiler``)
    against the host wall time of ``run()``, which does ``n`` of ``unit``,
    with the profiler on; the kernels that take the most, and the
    hand-written kernels' time by op (every pass of an op together), per
    ``unit``. Keys start with ``profile_<key>_``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile: {label}: the profiler saw no CUDA kernel; device time not measured")
        return {f"profile_{key}": "not measured"}
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    by_op: dict = {}   # the hand-written kernels, every pass of an op together
    for name, ms in by_name.items():
        for op, kernel_names in HAND_WRITTEN.items():
            if any(re.search(rf"(?<!\w){k}(?!\w)", name) for k in kernel_names):
                by_op[op] = by_op.get(op, 0.0) + ms
    per = f"_per_{unit}"
    out = {f"profile_{key}_wall_ms{per}": wall_ms / n,
           f"profile_{key}_device_ms{per}": busy_ms / n,
           f"profile_{key}_idle_share": 1.0 - busy_ms / wall_ms,
           f"profile_{key}_kernels{per}": len(kernels) / n}
    print(f"profile: {label}: wall {wall_ms / n:.2f} ms/{unit}, device busy "
          f"{busy_ms / n:.2f} ms/{unit}, idle share {1.0 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels) / n:.0f} kernels/{unit}")
    for name, ms in top:
        print(f"profile: {ms / n:.3f} ms/{unit}  {name[:100]}")
    by_form: dict = {}  # rmsnorm by form
    for name, ms in by_name.items():
        form = re.search(r"rmsnorm_kernel<[^,<>]+, (\d),", name)
        if form:
            label = RMS_FORM_OF_ARG[form.group(1)]
            by_form[label] = by_form.get(label, 0.0) + ms
    if by_op:
        print("profile: hand-written kernels, all passes: " + ", ".join(
            f"{op} {ms / n:.3f} ms/{unit}" for op, ms in sorted(by_op.items()))
            + ("; rmsnorm by form: " + ", ".join(f"{f} {ms / n:.3f} ms/{unit}"
                                                 for f, ms in sorted(by_form.items()))
               if by_form else ""))
    out[f"profile_{key}_kernel_ms{per}"] = {op: ms / n for op, ms in by_op.items()}
    out[f"profile_{key}_rmsnorm_form_ms{per}"] = {f: ms / n for f, ms in by_form.items()}
    return out


def slice_phase(seed: int):
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ContinuousEngine

    n_req, prompt_len, new_tok, n_slots, max_seq = 8, 512, 64, 4, 640
    cfg = with_kernel_impls(get_config("qwen2.5-3b"), "auto")
    print(f"slice: {cfg.arch_id} layers={cfg.n_layers} d={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"dtype={cfg.dtype} kernel_impls={dict(cfg.kernel_impls)}")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen, "cuda")
    engine = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=max_seq, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    print(f"slice: {n_params} parameters, init + bf16 copy {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(n_req, prompt_len)).tolist()

    # warm-up (cuBLAS handles, allocator): one short request, not counted
    engine.add(GenRequest(id=-1, prompt=prompts[0][:16], max_new=2))
    engine.run()
    torch.cuda.synchronize()

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps0, prefill0 = engine.n_decode_steps, engine.prefill_tokens
    add_ms, step_ms, admit_step_ms = [], [], []
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        t = time.perf_counter()
        engine.add(GenRequest(id=i, prompt=p, max_new=new_tok))
        if i < n_slots:  # admitted at once: prefill + graft + first token
            add_ms.append(1e3 * (time.perf_counter() - t))
    while engine.batcher.active():
        before = engine.prefill_tokens
        t = time.perf_counter()
        engine.step()  # ends in a host copy of the picked tokens
        (step_ms if engine.prefill_tokens == before else admit_step_ms).append(
            1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t_start
    counts, forms = launch_counts(), rmsnorm_form_counts()
    done = engine.run()
    peak = torch.cuda.max_memory_allocated()

    n_steps = engine.n_decode_steps - steps0
    n_prefills = (engine.prefill_tokens - prefill0) // prompt_len
    per_pass = 2 * cfg.n_layers + 1
    expect = {"rmsnorm": per_pass * (n_prefills + n_steps),
              "flash_attention": cfg.n_layers * n_prefills, "paged_attention": 0,
              "moe_gmm": 0, "ssd": 0}
    print(f"slice: {n_prefills} prefills, {n_steps} decode steps, launches {counts}, "
          f"expected {expect}")
    if n_prefills != n_req:
        raise AssertionError(f"{n_prefills} prefills, expected {n_req}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    counts = check_norm_forms("slice", cfg, n_prefills + n_steps, counts, forms)
    if sorted(r.id for r in done) != list(range(n_req)):
        raise AssertionError(f"finished ids {sorted(r.id for r in done)}")
    for r in done:
        if len(r.generated) != new_tok or not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.id}: {len(r.generated)} tokens "
                                 f"{r.generated[:8]}...")
    n_tok = n_req * new_tok
    serving = {
        "tokens_per_s": n_tok / wall,
        "wall_s": wall,
        "prefill_ms": statistics.median(add_ms),
        "decode_ms_per_step": statistics.median(step_ms),
        "admit_step_ms": admit_step_ms,
        "peak_memory_bytes": peak,
        "decode_steps": n_steps,
    }
    print(f"slice: served {n_req} requests x {new_tok} tokens in {wall:.3f} s = "
          f"{serving['tokens_per_s']:.1f} tok/s; prefill ({prompt_len} tokens, batch 1) median "
          f"{serving['prefill_ms']:.2f} ms; decode step ({n_slots} slots) median "
          f"{serving['decode_ms_per_step']:.2f} ms; steps with an admission "
          f"{['%.2f' % x for x in admit_step_ms]} ms; peak memory {peak} bytes")
    serving.update(profile_decode(engine, prompts, GenRequest))
    serving.update(profile_prefill(engine, prompts[0], GenRequest))
    del engine, done

    # float32 prefill under auto vs reference, same weights (f32 params)
    tok = torch.as_tensor([prompts[0]], dtype=torch.int64, device="cuda")
    logits = {}
    for pol in ("auto", "reference"):
        c32 = with_kernel_impls(dataclasses.replace(cfg, dtype="float32"), pol)
        logits[pol], _ = M.prefill(M.cast_params(params, c32), {"tokens": tok}, c32)
    torch.cuda.synchronize()
    v = cfg.vocab_size
    err = check_close("f32 prefill logits auto vs reference", logits["auto"][:, :v],
                      logits["reference"][:, :v], SLICE_TOL)
    same = bool(torch.equal(logits["auto"][:, :v].argmax(-1), logits["reference"][:, :v].argmax(-1)))
    print(f"slice: f32 prefill logits auto vs reference max abs err {err:.3e} "
          f"(limit atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]}), same argmax {same}, "
          f"logit scale {logits['reference'][:, :v].abs().max().item():.3f}")
    serving["f32_logits_max_abs_err"] = err
    return counts, serving, cfg, params


def paged_phase(cfg, params, seed: int):
    """Full-width paged serving through the paged-attention kernel: one
    registered tenant prefix forked into 8 requests (its tail block is
    shared, so each fork copies it on its first write), a drain after a few
    waves and a parked resume of every drained request."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import PagedContinuousEngine

    n_req, prompt_len, prefix_len, new_tok = 8, 512, 488, 32
    n_slots, max_seq, block_size, drain_after = 8, 640, 16, 4
    engine = PagedContinuousEngine(cfg, params, n_slots=n_slots, max_seq=max_seq,
                                   block_size=block_size, attn="kernel", device="cuda")
    v = cfg.vocab_size
    rng = np.random.default_rng(seed + 1)
    prefix = rng.integers(0, v, size=prefix_len).tolist()
    prompts = [prefix + rng.integers(0, v, size=prompt_len - prefix_len).tolist()
               for _ in range(n_req)]
    print(f"paged: {n_req} requests x ({prompt_len}-token prompt sharing a {prefix_len}-token "
          f"prefix, {new_tok} new tokens), {n_slots} slots, block_size {block_size}, "
          f"{engine.n_blocks} blocks of {engine.kv.block_bytes} bytes, attn=kernel")

    # warm-up: one short request outside the prefix, not counted
    engine.add(GenRequest(id=-1, prompt=prompts[0][-16:], max_new=2))
    engine.run()
    torch.cuda.synchronize()

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps0, prefill0 = engine.n_decode_steps, engine.prefill_tokens
    t_start = time.perf_counter()
    if not engine.register_prefix(prefix):
        raise AssertionError("paged: register_prefix failed")
    torch.cuda.synchronize()
    prefix_ms = 1e3 * (time.perf_counter() - t_start)
    admit_ms, step_ms = [], []
    for i, p in enumerate(prompts):  # fork + one batch-1 wave per suffix token + first token
        t = time.perf_counter()
        engine.add(GenRequest(id=i, prompt=p, max_new=new_tok))
        admit_ms.append(1e3 * (time.perf_counter() - t))
    for _ in range(drain_after):
        t = time.perf_counter()
        engine.step()  # ends in a host copy of the picked tokens
        step_ms.append(1e3 * (time.perf_counter() - t))
    drained = engine.drain()
    if len(drained) != n_req or engine.batcher.active():
        raise AssertionError(f"paged: drained {len(drained)} of {n_req}")
    for r in drained:
        engine.add(r)  # parked resume: the pinned blocks are re-referenced
    print("paged profile (the next waves after the resume, contexts of about 520 tokens):")
    prof = profile_steps(engine, 4)  # not counted in the step times
    while engine.batcher.active():
        t = time.perf_counter()
        engine.step()
        step_ms.append(1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t_start
    counts, forms = launch_counts(), rmsnorm_form_counts()
    done = engine.run()
    peak = torch.cuda.max_memory_allocated()

    n_waves = engine.n_decode_steps - steps0
    n_extend = engine.prefill_tokens - prefill0 - prefix_len
    n_prefills = 1  # the prefix: every request forks it
    per_pass = 2 * cfg.n_layers + 1
    expect = {"rmsnorm": per_pass * (n_prefills + n_waves + n_extend),
              "flash_attention": cfg.n_layers * n_prefills,
              "paged_attention": cfg.n_layers * (n_waves + n_extend), "moe_gmm": 0, "ssd": 0}
    st = engine.kv_stats()
    print(f"paged: {n_prefills} prefill, {n_extend} extend waves, {n_waves} decode waves, "
          f"launches {counts}, expected {expect}")
    print(f"paged: kv_stats share_hits={st['share_hits']} shared_tokens={st['shared_tokens']} "
          f"cow_copies={st['cow_copies']} resume_hits={st['resume_hits']} "
          f"resumed_tokens={st['resumed_tokens']} mem_preempts={st['mem_preempts']} "
          f"blocks_in_use={st['blocks_in_use']} blocks_high_water={st['blocks_high_water']}")
    if n_extend != n_req * (prompt_len - prefix_len):
        raise AssertionError(f"paged: {n_extend} extend tokens, expected "
                             f"{n_req * (prompt_len - prefix_len)}")
    if counts != expect:
        raise AssertionError(f"paged: launch counts {counts} != expected {expect}")
    counts = check_norm_forms("paged", cfg, n_prefills + n_waves + n_extend, counts, forms)
    if st["share_hits"] != n_req or st["cow_copies"] < n_req or st["resume_hits"] < 1:
        raise AssertionError(f"paged: share_hits {st['share_hits']}, cow_copies "
                             f"{st['cow_copies']}, resume_hits {st['resume_hits']}")
    if sorted(r.id for r in done) != list(range(n_req)):
        raise AssertionError(f"paged: finished ids {sorted(r.id for r in done)}")
    for r in done:
        if len(r.generated) != new_tok or not all(0 <= t < v for t in r.generated):
            raise AssertionError(f"paged: request {r.id}: {len(r.generated)} tokens "
                                 f"{r.generated[:8]}...")
    engine.kv.check()
    prefix_blocks = -(-prefix_len // block_size)
    left = set(engine.kv.alloc.tables)
    if left != {engine.kv.NULL_SEQ, ("prefix", 0)} or st["blocks_in_use"] != 1 + prefix_blocks:
        raise AssertionError(f"paged: sequences left {left}, {st['blocks_in_use']} blocks "
                             f"in use; expected the null block and the prefix's "
                             f"{prefix_blocks}")
    n_tok = n_req * new_tok
    serving = {
        "paged_tokens_per_s": n_tok / wall,
        "paged_wall_s": wall,
        "paged_prefix_prefill_ms": prefix_ms,
        "paged_admit_ms": statistics.median(admit_ms),
        "paged_decode_ms_per_step": statistics.median(step_ms),
        "paged_peak_memory_bytes": peak,
        "paged_decode_waves": n_waves,
        "paged_extend_waves": n_extend,
    }
    print(f"paged: served {n_req} requests x {new_tok} tokens in {wall:.3f} s = "
          f"{serving['paged_tokens_per_s']:.1f} tok/s; prefix prefill ({prefix_len} tokens) "
          f"{prefix_ms:.2f} ms; admission (fork + {prompt_len - prefix_len} batch-1 waves) "
          f"median {serving['paged_admit_ms']:.2f} ms; decode wave ({n_slots} slots) median "
          f"{serving['paged_decode_ms_per_step']:.2f} ms; peak memory {peak} bytes")
    serving.update({"paged_" + k: x for k, x in prof.items()})
    del engine, done
    serving["paged_f32_logits_max_abs_err"] = paged_parity(cfg, params, seed)
    return counts, serving


def paged_parity(cfg, params, seed: int, waves: int = 8) -> float:
    """Float32 paged decode of one request through the kernel
    (``paged_decode_step``) against the gather path (a dense copy gathered
    from the same pool, ``decode_step``), teacher-forced with the gather
    path's tokens, on two pools that start equal."""
    from repro_torch.configs import with_kernel_impls
    from repro_torch.models import model as M
    from repro_torch.serving.kvcache import PagedKVCache

    c32 = with_kernel_impls(dataclasses.replace(cfg, dtype="float32"), "auto")
    p32 = M.cast_params(params, c32)
    prompt = np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, size=100).tolist()
    max_blocks, bs = 40, 16
    kv = PagedKVCache(c32, n_blocks=10, block_size=bs, device="cuda")
    logits, pre = M.prefill(p32, {"tokens": torch.tensor([prompt], device="cuda")}, c32)
    kv.create("s")
    kv.write_prefill("s", pre["dense"]["k"][:, 0], pre["dense"]["v"][:, 0])
    k_pool, v_pool = kv.k_pool.clone(), kv.v_pool.clone()   # the kernel path's pools
    v = cfg.vocab_size
    tok = logits[:, :v].argmax(-1)[:, None]
    worst = 0.0
    for w in range(waves):
        p = kv.length("s")
        bid, off = kv.append("s")
        tables = torch.as_tensor(kv.table_array(["s"], max_blocks), device="cuda").long()
        pos = torch.tensor([p], device="cuda")
        lk, _, _ = M.paged_decode_step(p32, tok, k_pool, v_pool, tables, pos, [bid], [off], c32)
        gk, gv = kv.gather_dense(tables, max_blocks * bs)
        lg, cache = M.decode_step(p32, tok, {"dense": {"k": gk, "v": gv}}, pos, c32)
        kv.write_tokens([bid], [off], cache["dense"]["k"][:, :, p], cache["dense"]["v"][:, :, p])
        torch.cuda.synchronize()
        err = check_close(f"paged f32 wave {w} kernel vs gather logits", lk[:, :v], lg[:, :v],
                          SLICE_TOL)
        same = bool(torch.equal(lk[:, :v].argmax(-1), lg[:, :v].argmax(-1)))
        if not same:
            raise AssertionError(f"paged f32 wave {w}: argmax differs")
        print(f"paged f32 wave {w} (pos {p}): kernel vs gather logits max abs err {err:.3e} "
              f"(limit atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]}), same argmax {same}")
        worst = max(worst, err)
        tok = lg[:, :v].argmax(-1)[:, None]
    err = check_close("paged f32 pools kernel vs gather", k_pool, kv.k_pool, SLICE_TOL)
    err = max(err, check_close("paged f32 pools kernel vs gather", v_pool, kv.v_pool, SLICE_TOL))
    print(f"paged f32: pools after {waves} waves, kernel vs gather max abs err {err:.3e}")
    return worst


def moe_phase(seed: int):
    """Full-width mixtral-8x22b, 4 of its 56 layers (the only cut), bf16
    weights, served through ContinuousEngine under ``kernel_impls="auto"``:
    attention, the MoE grouped matmul and every norm on the kernels."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ContinuousEngine

    n_req, prompt_len, new_tok, n_slots, max_seq = 8, 512, 32, 4, 640
    cfg = with_kernel_impls(dataclasses.replace(get_config("mixtral-8x22b"), n_layers=4,
                                                param_dtype="bfloat16"), "auto")
    print(f"moe: {cfg.arch_id} layers={cfg.n_layers} of 56 d={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads} experts={cfg.n_experts} top_k={cfg.top_k} "
          f"moe_d_ff={cfg.moe_d_ff} window={cfg.sliding_window} vocab={cfg.vocab_size} "
          f"moe_impl={cfg.moe_impl} dtype={cfg.dtype}/{cfg.param_dtype} "
          f"kernel_impls={dict(cfg.kernel_impls)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen, "cuda")
    engine = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=max_seq, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"moe: {n_params} parameters ({M.nbytes(params)} bytes), init "
          f"{time.perf_counter() - t0:.2f} s, peak memory during init {init_peak} bytes")
    rng = np.random.default_rng(seed + 3)
    prompts = rng.integers(0, cfg.vocab_size, size=(n_req, prompt_len)).tolist()

    engine.add(GenRequest(id=-1, prompt=prompts[0][:16], max_new=2))  # warm-up, not counted
    engine.run()
    torch.cuda.synchronize()

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps0, prefill0 = engine.n_decode_steps, engine.prefill_tokens
    add_ms, step_ms, admit_step_ms = [], [], []
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        t = time.perf_counter()
        engine.add(GenRequest(id=i, prompt=p, max_new=new_tok))
        if i < n_slots:  # admitted at once: prefill + graft + first token
            add_ms.append(1e3 * (time.perf_counter() - t))
    while engine.batcher.active():
        before = engine.prefill_tokens
        t = time.perf_counter()
        engine.step()  # ends in a host copy of the picked tokens
        (step_ms if engine.prefill_tokens == before else admit_step_ms).append(
            1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t_start
    counts, forms = launch_counts(), rmsnorm_form_counts()
    done = engine.run()
    peak = torch.cuda.max_memory_allocated()

    n_steps = engine.n_decode_steps - steps0
    n_prefills = (engine.prefill_tokens - prefill0) // prompt_len
    passes = n_prefills + n_steps
    expect = {"rmsnorm": (2 * cfg.n_layers + 1) * passes,
              "flash_attention": cfg.n_layers * n_prefills, "paged_attention": 0,
              "moe_gmm": 3 * cfg.n_layers * passes, "ssd": 0}
    print(f"moe: {n_prefills} prefills, {n_steps} decode steps, launches {counts}, "
          f"expected {expect}")
    if n_prefills != n_req:
        raise AssertionError(f"moe: {n_prefills} prefills, expected {n_req}")
    if counts != expect:
        raise AssertionError(f"moe: launch counts {counts} != expected {expect}")
    counts = check_norm_forms("moe", cfg, passes, counts, forms)
    if sorted(r.id for r in done) != list(range(n_req)):
        raise AssertionError(f"moe: finished ids {sorted(r.id for r in done)}")
    for r in done:
        if len(r.generated) != new_tok or not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"moe: request {r.id}: {len(r.generated)} tokens "
                                 f"{r.generated[:8]}...")
    serving = {
        "moe_tokens_per_s": n_req * new_tok / wall,
        "moe_wall_s": wall,
        "moe_prefill_ms": statistics.median(add_ms),
        "moe_decode_ms_per_step": statistics.median(step_ms),
        "moe_admit_step_ms": admit_step_ms,
        "moe_peak_memory_bytes": peak,
        "moe_init_peak_memory_bytes": init_peak,
        "moe_decode_steps": n_steps,
    }
    print(f"moe: served {n_req} requests x {new_tok} tokens in {wall:.3f} s = "
          f"{serving['moe_tokens_per_s']:.2f} tok/s; prefill ({prompt_len} tokens, batch 1) "
          f"median {serving['moe_prefill_ms']:.2f} ms; decode step ({n_slots} slots) median "
          f"{serving['moe_decode_ms_per_step']:.2f} ms; steps with an admission "
          f"{['%.2f' % x for x in admit_step_ms]} ms; peak memory {peak} bytes")
    serving.update({"moe_" + k: x for k, x in profile_decode(engine, prompts, GenRequest).items()})
    del engine, done, params
    gc.collect()
    torch.cuda.empty_cache()
    serving["moe_f32_logits_max_abs_err"] = moe_parity(seed, prompts[0])
    return counts, serving


def moe_parity(seed: int, prompt) -> float:
    """One layer of full-width mixtral at float32: prefill logits under
    ``auto`` (flash, rmsnorm and the moe_gmm capacity twin) against
    ``reference`` (einsum attention, the scatter einsum) on the same weights."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.models import model as M

    base = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=1, dtype="float32",
                               param_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(base, torch.Generator(device="cuda").manual_seed(seed + 4), "cuda")
    tok = torch.as_tensor([prompt], dtype=torch.int64, device="cuda")
    logits = {}
    for pol in ("auto", "reference"):
        c32 = with_kernel_impls(base, pol)
        logits[pol], _ = M.prefill(params, {"tokens": tok}, c32)
    torch.cuda.synchronize()
    v = base.vocab_size
    err = check_close("moe f32 prefill logits auto vs reference", logits["auto"][:, :v],
                      logits["reference"][:, :v], SLICE_TOL)
    same = bool(torch.equal(logits["auto"][:, :v].argmax(-1),
                            logits["reference"][:, :v].argmax(-1)))
    if not same:
        raise AssertionError("moe f32 prefill: argmax differs")
    print(f"moe: f32 1-layer prefill ({tok.shape[1]} tokens) logits auto vs reference max abs "
          f"err {err:.3e} (limit atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]}), same argmax {same}, "
          f"logit scale {logits['reference'][:, :v].abs().max().item():.3f}, peak memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    del params, logits
    torch.cuda.empty_cache()
    return err


def ssm_phase(arch: str, seed: int):
    """Full-width, full-depth mamba2-2.7b or zamba2-2.7b (fp32 master
    weights plus the bf16 copy) served through ContinuousEngine under
    ``kernel_impls="auto"``: every prefill's SSM layers on the ssd kernel,
    every norm (the gated one too) on rmsnorm and zamba2's shared attention
    on flash. 8 requests with prompts of 480-512 tokens (most not a multiple
    of the 256-token chunk, so the dt=0 padding is on the path), a drain
    after 4 decode steps and a resume of every drained request."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ContinuousEngine

    tag = arch.split("-")[0]  # mamba2 | zamba2
    n_req, new_tok, n_slots, max_seq, drain_after = 8, 32, 4, 640, 4
    cfg = with_kernel_impls(get_config(arch), "auto")
    print(f"{tag}: {cfg.arch_id} family={cfg.family} layers={cfg.n_layers} d={cfg.d_model} "
          f"ssm heads={cfg.n_ssm_heads}x{cfg.ssm_headdim} state={cfg.ssm_state} "
          f"chunk={cfg.ssm_chunk} attn every {cfg.attn_every} ({cfg.n_attn_layers} shared-block "
          f"uses, {cfg.n_heads} heads of {cfg.head_dim}) vocab={cfg.vocab_size} "
          f"dtype={cfg.dtype}/{cfg.param_dtype} kernel_impls={dict(cfg.kernel_impls)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    engine = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=max_seq, device="cuda")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: {sum(t.numel() for t in M.tree_leaves(params))} parameters "
          f"({M.nbytes(params)} bytes fp32, bf16 copy {M.nbytes(engine.params)} bytes), init + "
          f"copy {time.perf_counter() - t0:.2f} s, peak memory {init_peak} bytes")
    rng = np.random.default_rng(seed + 5)
    lens = rng.integers(480, 513, size=n_req)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    engine.add(GenRequest(id=-1, prompt=prompts[0][:16], max_new=2))  # warm-up, not counted
    engine.run()
    torch.cuda.synchronize()

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps0 = engine.n_decode_steps
    add_ms, step_ms, admit_step_ms = [], [], []

    def timed_step():
        before = engine.prefill_tokens
        t = time.perf_counter()
        engine.step()  # ends in a host copy of the picked tokens
        (step_ms if engine.prefill_tokens == before else admit_step_ms).append(
            1e3 * (time.perf_counter() - t))

    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        t = time.perf_counter()
        engine.add(GenRequest(id=i, prompt=p, max_new=new_tok))
        if i < n_slots:  # admitted at once: prefill + graft + first token
            add_ms.append(1e3 * (time.perf_counter() - t))
    for _ in range(drain_after):
        timed_step()
    drained = engine.drain()
    resumed = sum(1 for r in drained if r.generated and r.remaining > 0)
    if len(drained) != n_req or resumed != n_slots or engine.batcher.active():
        raise AssertionError(f"{tag}: drained {len(drained)}, {resumed} in flight")
    for r in drained:
        engine.add(r)  # resume: prompt + generated so far, prefilled again
    while engine.batcher.active():
        timed_step()
    wall = time.perf_counter() - t_start
    counts, forms = launch_counts(), rmsnorm_form_counts()
    done = engine.run()
    peak = torch.cuda.max_memory_allocated()

    n_steps = engine.n_decode_steps - steps0
    n_prefills = n_req + resumed  # each request once, each drained in-flight one again
    passes = n_prefills + n_steps
    n_attn = cfg.n_attn_layers  # zamba2's shared block, once per group
    expect = {"rmsnorm": (2 * cfg.n_layers + 2 * n_attn + 1) * passes,
              "flash_attention": n_attn * n_prefills, "paged_attention": 0, "moe_gmm": 0,
              "ssd": cfg.n_layers * n_prefills}
    print(f"{tag}: {n_prefills} prefills ({resumed} of them resumes), {n_steps} decode "
          f"steps, launches {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts} != expected {expect}")
    counts = check_norm_forms(tag, cfg, passes, counts, forms)
    if sorted(r.id for r in done) != list(range(n_req)):
        raise AssertionError(f"{tag}: finished ids {sorted(r.id for r in done)}")
    for r in done:
        if len(r.generated) != new_tok or not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"{tag}: request {r.id}: {len(r.generated)} tokens "
                                 f"{r.generated[:8]}...")
    serving = {
        "tokens_per_s": n_req * new_tok / wall,
        "wall_s": wall,
        "prefill_ms": statistics.median(add_ms),
        "decode_ms_per_step": statistics.median(step_ms),
        "admit_step_ms": admit_step_ms,
        "peak_memory_bytes": peak,
        "init_peak_memory_bytes": init_peak,
        "decode_steps": n_steps,
        "prefills": n_prefills,
    }
    print(f"{tag}: served {n_req} requests x {new_tok} tokens (prompts {int(lens.min())}-"
          f"{int(lens.max())}, drain after {drain_after} steps) in {wall:.3f} s = "
          f"{serving['tokens_per_s']:.2f} tok/s; prefill (batch 1) median "
          f"{serving['prefill_ms']:.2f} ms; decode step ({n_slots} slots) median "
          f"{serving['decode_ms_per_step']:.2f} ms; steps with an admission "
          f"{['%.2f' % x for x in admit_step_ms]} ms; peak memory {peak} bytes")
    serving.update(profile_decode(engine, prompts, GenRequest))
    serving.update(profile_prefill(engine, prompts[0], GenRequest))
    del engine, done, params
    gc.collect()
    torch.cuda.empty_cache()
    serving["f32_logits_max_abs_err"] = ssm_parity(arch, seed, prompts[1])
    return counts, {f"{tag}_{k}": x for k, x in serving.items()}


def ssm_parity(arch: str, seed: int, prompt) -> float:
    """Full-width float32 prefill and one decode step under ``auto`` (ssd,
    rmsnorm, flash) against ``reference`` on the same weights: one mamba2
    layer, or one zamba2 group (6 mamba layers and the shared block)."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.models import model as M

    full = get_config(arch)
    base = dataclasses.replace(full, n_layers=max(1, full.attn_every), dtype="float32")
    params = M.init_params(base, torch.Generator(device="cuda").manual_seed(seed + 6), "cuda")
    tok = torch.as_tensor([prompt], dtype=torch.int64, device="cuda")
    v = base.vocab_size
    logits, nxt = {}, {}
    for pol in ("auto", "reference"):
        c32 = with_kernel_impls(base, pol)
        lg, cache = M.prefill(params, {"tokens": tok}, c32)
        grown = M.init_cache(c32, 1, tok.shape[1] + 8, "cuda")
        for seg in cache:
            for key, leaf in cache[seg].items():
                grown[seg][key][tuple(slice(0, n) for n in leaf.shape)] = leaf
        step = torch.tensor([[int(lg[0, :v].argmax())]], device="cuda")
        nxt[pol], _ = M.decode_step(params, step, grown, tok.shape[1], c32)
        logits[pol] = lg
    torch.cuda.synchronize()
    tag = arch.split("-")[0]
    err = max(check_close(f"{tag} f32 prefill logits auto vs reference", logits["auto"][:, :v],
                          logits["reference"][:, :v], SLICE_TOL),
              check_close(f"{tag} f32 decode logits auto vs reference", nxt["auto"][:, :v],
                          nxt["reference"][:, :v], SLICE_TOL))
    for what, d in (("prefill", logits), ("decode", nxt)):
        if not torch.equal(d["auto"][:, :v].argmax(-1), d["reference"][:, :v].argmax(-1)):
            raise AssertionError(f"{tag} f32 {what}: argmax differs")
    print(f"{tag}: f32 {base.n_layers}-layer prefill ({tok.shape[1]} tokens) and decode logits "
          f"auto vs reference max abs err {err:.3e} (limit atol={SLICE_TOL[0]} "
          f"rtol={SLICE_TOL[1]}), same argmax, logit scale "
          f"{logits['reference'][:, :v].abs().max().item():.3f}")
    del params, logits, nxt
    torch.cuda.empty_cache()
    return err


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v`` output: the
    kernel and its template arguments, registers, static shared memory and
    spills (dynamic shared memory is set at launch and not listed)."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"entry function '([^']+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"([a-z_]+_kernel)(I(.*?)EE)?", mangled)
            kernel = base.group(1) if base else mangled
            if base and base.group(3):
                targs = base.group(3)
                dtype = ["bf16"] if "bfloat16" in targs else (["f32"] if targs[0] == "f" else [])
                kernel += "<" + ", ".join(dtype + re.findall(r"L[ib](\d+)E", targs + "E")) + ">"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and kernel is not None:
            used = line.split("Used", 1)[1].strip() if "Used" in line else line.strip()
            out.append(f"{kernel}: {used}; {spills}")
            kernel, spills = None, ""
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build_all()
    for name in build.SIGNATURES:
        build.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(build.SIGNATURES)} "
          f"(built now: {sorted(logs)})")
    for name, log in logs.items():
        for line in ptxas_summary(log):
            print(f"ptxas {name}: {line}")
    paged_lib, gmm_lib = build.library("paged_attention"), build.library("moe_gmm")
    print(f"dynamic shared memory: paged_split_kernel<bf16, 128, G 8> "
          f"{paged_lib.paged_attention_smem_bytes(128, 8, build.DTYPE_CODES[torch.bfloat16])} "
          f"bytes; gmm_wgmma_kernel {gmm_lib.moe_gmm_smem_bytes(192)} bytes; "
          f"gmm_narrow_kernel {gmm_lib.moe_gmm_smem_bytes(8)} bytes")

    # each kernel phase draws from a generator of its own, so that a check
    # added to one phase leaves the other phases' inputs as they were
    def gen(offset: int) -> torch.Generator:
        return torch.Generator(device="cuda").manual_seed(args.seed + offset)

    kern = rmsnorm_kernel_phase(gen(4))
    kern["flash_attention"] = flash_kernel_phase(gen(0))
    kern["paged_attention"] = paged_kernel_phase(gen(1))
    kern["moe_gmm"] = moe_kernel_phase(gen(2))
    kern["ssd"] = ssd_kernel_phase(gen(3))
    counts, serving, cfg, params = slice_phase(args.seed)
    paged_counts, paged_serving = paged_phase(cfg, params, args.seed)
    serving.update(paged_serving)
    del params  # free qwen2.5-3b before mixtral's 20.8 GB of weights
    gc.collect()
    torch.cuda.empty_cache()
    moe_counts, moe_serving = moe_phase(args.seed)  # frees mixtral before it returns
    serving.update(moe_serving)
    ssm_counts, ssm_serving = ssm_phase("mamba2-2.7b", args.seed)
    serving.update(ssm_serving)
    hybrid_counts, hybrid_serving = ssm_phase("zamba2-2.7b", args.seed)
    serving.update(hybrid_serving)
    # each kernel's launches on the path that first carried it: the plain and
    # residual rmsnorm forms and flash on the dense path, paged attention on
    # the paged path, the grouped matmul on the MoE path, ssd and the gated
    # rmsnorm form on the SSM path
    print(f"launches: dense path {counts}, paged path {paged_counts}, moe path {moe_counts}, "
          f"ssm path {ssm_counts}, hybrid path {hybrid_counts}")
    counts = dict(counts, rmsnorm=counts["rmsnorm_forms"]["plain"],
                  add_rmsnorm=counts["rmsnorm_forms"]["residual"],
                  gated_rmsnorm=ssm_counts["rmsnorm_forms"]["gated"],
                  paged_attention=paged_counts["paged_attention"],
                  moe_gmm=moe_counts["moe_gmm"], ssd=ssm_counts["ssd"])

    rms_source = ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25")
    sources = {**dict.fromkeys(RMS_FORMS, rms_source),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:79"),
               "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:67"),
               "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                           "src/repro/kernels/moe_gmm.py:34"),
               "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:66")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": counts[name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
         **({"library_calls_ms": kern[name]["library_calls_ms"],
             "unfused_ms": kern[name]["unfused_ms"]} if "unfused_ms" in kern[name] else {}),
         "shape": kern[name]["shape"]}
        for name in (*RMS_FORMS, "flash_attention", "paged_attention", "moe_gmm", "ssd")]}
    if not all(k["launches"] > 0 for k in line["kernels"]):
        raise AssertionError(f"a kernel of the path was not launched: {line}")
    print(json.dumps({"serving": serving, "card": smi}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

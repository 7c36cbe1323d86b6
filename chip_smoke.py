#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's five CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, in parallel);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (flash and paged attention also at head_dim 8 and
   160, flash not causal at hubert-xlarge's head_dim 80 and at one tensor-
   parallel rank's shape of qwen2.5-3b, 8 query heads on one KV head,
   ``moe_gmm`` at
   deepseek-v2-lite-16b's 64 experts of 1408, also at a 4096-token
   admission's dropless buffer) and times kernel, plain
   version and a library yardstick (CUDA events); the rmsnorm kernel's three forms (plain, residual add, Mamba2
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
6. runs HPC-Whisk on the card on the same weights: the port's
   ``Platform.build(ScenarioConfig)`` (Slurm idle windows, pilot jobs,
   invokers, controller) with the ``batched-serving`` executor hosting
   full-width qwen2.5-3b, once dense and once paged (a 96-token tenant
   prefix forked through the paged-attention kernel), then once with the
   smoke engine the executor's factory builds itself on the default
   device; each run checks that every request ends in a terminal outcome
   and at least one succeeds, that every finished stream has its
   ``n_new`` tokens, that the ``kv_*`` gauges read ``kv_stats()``, and the
   kernels' launch counts (rmsnorm's by form) against the prefills, waves
   and decode steps it counted, and profiles one batch through the
   executor;
6b. runs elastic sharded serving on the same weights (the ``elastic``
   phase): ``ElasticReplica`` gangs of full-width qwen2.5-3b (4 slots,
   max_seq 256, 4 requests of 128 + 16 new) shrink 4 -> 2 after 4 decode
   steps in each KV mode (``migrate`` then grows 2 -> 3), against an
   unbroken gang of 2: ``migrate`` equal to it token for token, every
   stream 16 long, each ``MigrationRecord``'s bytes equal to the counts
   from the shapes, ``replay``'s wire the parameters only, the parameters
   on ``cuda`` after each resize, the launches against the prefills and
   steps counted; the walls, the peak device memory across each resize,
   the decode step before and after and each stream's prefix that matches
   the unbroken one print; then the port's ``Platform.build`` of
   ``elastic_storm`` (600 virtual s, gang 3, migrating) with
   ``ElasticServingExecutor`` over a full-width replica (the gang pool's
   SIGTERM hook drives real resizes: migrations through the replica, at
   least one success, launches as counted; outcomes, goodput, charged
   p50/p95, migrations by kind, bytes and walls print), and the storm with
   ``executor="sharded-serving"``, whose factory builds its smoke replica
   on the card;
6c. runs tensor parallelism on the same weights (the ``tp`` phase): two
   ranks on the one card (``spawn_tp``; gloo, as ``backend_for`` rules for
   ranks that share a card) each build full-width, full-depth qwen2.5-3b in
   bf16 from ``--seed`` and keep half (query heads, the replicated KV head,
   ``d_ff``, the vocabulary); rank 0 serves 4 requests of 128 + 16 new at
   TP 2 with the collectives timed, then again shrinking 2 -> 1 after 4
   steps and growing 1 -> 2 after 4 more (``migrate``); held against the
   one-rank ``ElasticReplica`` on the same weights in this process: the
   float32 prefills of the served bf16 values within ``SLICE_TOL``, each
   admission's bf16 logits no farther from them than the one-rank leg's
   (``tp_bf16_logits``), the streams equal or split only where the
   one-rank leg's top-2 margin is within the legs' logit disagreement
   (``near_tie_rule``), each rank's launches as counted, the records'
   bytes as counted from the shapes, both ranks' peak memory under
   ``TP_PEAK_LIMIT``; the steps' walls, the collectives' share, each
   resize's wall and bytes gathered or shipped print; then a group of one
   rank takes NCCL and runs an all-reduce and a broadcast;
7. frees those weights and serves 8 requests of full-width mixtral-8x22b
   cut to 4 of its 56 layers (bf16 weights from ``--seed``) through
   ``ContinuousEngine`` under ``kernel_impls="auto"``, checks the launch
   counts of the grouped-matmul, flash and rmsnorm kernels and every
   request's length, and holds one float32 1-layer prefill under ``auto``
   against ``reference``;
8. frees those weights and serves 8 requests each of full-width,
   full-depth mamba2-2.7b and zamba2-2.7b (fp32 weights from ``--seed``
   plus the bf16 copy) through ``ContinuousEngine`` under
   ``kernel_impls="auto"``, with a drain after 4 steps and a resume,
   checks the exact launch counts of ssd, rmsnorm and flash and every
   request's length, profiles a decode step and one admission, and holds a
   float32 prefill and decode step of one mamba2 layer (one zamba2 group)
   under ``auto`` against ``reference``;
9. serves 8 requests of (512, 32) of full-width, full-depth
   deepseek-v2-lite-16b (MLA over a 576-wide latent cache, 64 experts
   top-6 on ``moe_gmm``; bf16 weights) through ``ContinuousEngine`` under
   ``kernel_impls="auto"``, with a drain after 4 steps and a resume, checks
   the exact launches (rmsnorm by form, ``moe_gmm`` 3 a moe layer a pass,
   no flash), every request's length and the latent cache's bytes against
   ``cache_spec``, profiles a decode step and one admission, and at float32
   on a 1 dense + 2 moe layer cut holds a prefill under ``auto`` against
   ``reference`` and the absorbed decode at position S against the
   decompressed forward;
9b. runs tensor parallelism for MoE and MLA (the ``tp moe`` phase): the
   one-rank replicas of full-width, full-depth deepseek-v2-lite-16b and of
   full-width mixtral-8x22b at 4 layers run first here and are freed; then
   two ranks on the one card, each drawing only its shards
   (``init_params(..., tp=...)``, one rank at a time), serve each at TP 2
   (deepseek: 8 MLA heads, 32 of 64 experts; mixtral: 24 heads on 4 KV
   heads, 4 of 8 experts) with the collectives timed, and deepseek cut to 1
   dense + 3 moe layers shrinks 2 -> 1 and grows 1 -> 2 mid-stream against
   its unbroken 2-rank run; gates: the float32 prefills on the served bf16
   values within ``SLICE_TOL`` of one rank, the streams equal or split only
   at a near tie of the logits or of a router pick
   (:func:`moe_near_tie_rule`), the ranks' picks equal, each rank's
   launches as counted (moe_gmm 3 a moe layer a pass, rmsnorm by form,
   flash at mixtral's rank shape), each rank's peaks under limits from its
   shard bytes; then moe_gmm at the per-rank shapes and flash at mixtral's
   rank shape against their plain versions, timed beside torch.bmm and
   SDPA;
9c. runs tensor parallelism for SSM and hybrid (the ``tp ssm`` phase):
   the one-rank replicas of full-width, full-depth mamba2-2.7b and
   zamba2-2.7b (bf16) run first here and are freed; then two ranks on the
   one card, each drawing only its shards (the Mamba2 channels of 40 of 80
   heads, ``in_proj`` cut into its z, x, B/C and dt; zamba2's shared block
   16 of 32 heads), serve each at TP 2 with the collectives timed, and
   full-depth zamba2 shrinks 2 -> 1 and grows 1 -> 2 mid-stream (leaf by
   leaf: each rank's peak under its old and new shards and two layers of
   its largest leaf) against its unbroken 2-rank run; gates as the
   ``tp moe`` phase's (the float32 prefills
   within ``SLICE_TOL``, the bf16 admissions by ``tp_bf16_logits``, the
   streams by the near-tie rule, each rank's launches: the gated norm as
   the rmsnorm kernel's two passes, ``gated_ssq`` and ``gated_scale``, ssd
   at the rank's 40 heads; each rank's peaks); then ssd and both gated
   passes at the per-rank shapes (the split norm against the one-pass
   kernel on the whole row, and pass B of pass A against it bit for bit)
   and flash at zamba2's rank shape, timed;
10. runs ``loss_fn`` through the frontends at full width and depth:
   hubert-xlarge on (2, 512) audio frames (non-causal flash, LayerNorm)
   and internvl2-26b (bf16 weights) on 256 patches + 256 text tokens,
   each with exact launch counts; and hubert at float32 cut to 2 layers,
   ``auto`` against ``reference``;
10b. runs the frontends' loss and training under a group and a grid (the
   ``tp train`` phase), ranks on the one card over gloo against one rank
   on the same seeded weights: two ranks run full-width, full-depth
   hubert-xlarge's ``forward`` and ``loss_fn`` at float32 (non-causal
   flash at q (2, 8, 512, 80) a rank) within ``SLICE_TOL``, internvl2-26b's
   in bf16 (flash at q (2, 24, 512, 128) on 4 KV heads, rmsnorm) against a
   float32 witness on the same weights (``tp_bf16_logits``; the loss no
   farther than twice the one-rank leg's distance plus one bf16 ulp), each
   rank's launches as counted; then full-width internlm2-1.8b cut to
   ``TPT_TP2_LAYERS`` layers trains 3 steps of (2, 256) at float32 on the
   two ranks against one (losses and grad norms within ``PARAM_TOL`` at
   the first step, ``TPT_LATER_TOL`` after it, the
   first batch's gradient norm of every layer of every leaf within its
   rtol, the final parameters by ``TPT_PARAM_MAX`` and
   ``TPT_PARAM_SHARE``, every rank's copy of a leaf held whole rank 0's
   bit for bit; the step's collectives timed, those of the backward
   apart); then at full width and full depth the same steps on four ranks
   as the grid (data 2, model 2) against the one-rank leg, run first and
   its final tree written once (the same gates, each rank comparing its
   cut on the card; each rank's parameter and moment bytes at most 1.1
   times a quarter of the tree's; every leaf several ranks hold equal
   across them bit for bit; init and training peaks a rank, the step
   walls, the collectives by axis); at ``TPT_CKPT_LAYERS`` layers the grid
   checkpoints the whole arrays after step 2 (each leaf gathered to rank 0
   alone), and (data 1, model 2) and one rank each restore them through
   ``reshard_restore`` and take step 3, equal to the grid's;
11. serves 4 requests of (512, 16) of full-width, full-depth stablelm-12b
   (bf16 weights; flash at head_dim 160) with exact launch counts;
12. trains on the card under ``kernel_impls="reference"`` (the kernels
   have no backward, as in ``repro``): (a) full-width, full-depth
   internlm2-1.8b (1.889 B fp32 parameters, bf16 compute) 12 steps of (8,
   512) tokens in 2 microbatches from ``DataPipeline``: finite losses and
   grad norms, the last loss below the first, no kernel launched; step ms,
   tokens/s, init and training peak memory, one profiled step, steps with
   the stacked leaves split by ``v[i]`` against one ``unbind`` in turns,
   and ``adamw_update`` alone against its bytes floor; (b) one microbatch's
   loss and gradients under each ``remat`` mode: equal within
   ``REMAT_REL_TOL``, and ``"full"`` below ``"none"`` in peak memory; (c)
   under ``auto``, ``loss_fn`` on 1 layer with parameters that require grad
   raises before any launch, with the refusal bypassed its backward leaves
   parameters without gradient, and under ``torch.no_grad()`` it launches
   as counted; (d) at full width cut to 2 layers, 8 steps unbroken against 4,
   an async checkpoint, a restore (bit for bit, the pipeline step too) and
   4 more (``RESUME_REL_TOL``), with the bytes and the save and restore
   seconds; (e) ``launch.train.train()`` with a checkpoint and a resume,
   ``launch.train_lm``, and 3 smoke f32 steps on the card against the CPU;
13. every serving phase (qwen2.5-3b, mixtral, mamba2, zamba2, deepseek,
   stablelm) also calls ``ServingEngine.score`` on (2, 512) tokens with the
   weights it holds, checks the forward's launches and a finite loss, and
   frees its weights before the next phase; each phase's wall prints;
13b. on the dense phase's qwen2.5-3b, before it is freed, prefills one
   prompt of ``prefill_32k``'s 32,768 tokens (its batch cut to 1) through
   ``attn_impl="chunked"`` with the rmsnorm kernel and through ``auto``
   (flash): walls, peaks, exact launches, device ms and idle share (the
   chunked leg profiled on a 1-layer cut), the counted floors, and the
   last-position logits of both legs held together within the bf16
   tolerance and set beside a float32 witness (the chunked path on the
   fp32 weights); the greedy picks are equal, or the witness scores them
   apart by no more than the legs' measured logit disagreement; after the
   training phase it times flash at 32k beside ``chunked_mha`` (its plain
   twin: the plain version's scores do not fit) and SDPA, holding the
   kernel against ``chunked_mha`` at float32 row block by row block
   (relative L2 within ``FLASH_32K_REL_L2``), runs the two example twins
   on the card (quickstart, elastic demo; each a path of its own in the
   launch sums), and, after every timed phase, runs the
   dry run of the 40 cells on ``meta`` (32 ok, 8 skipped; qwen2.5-3b's
   parameter bytes on a 1 x 1 mesh equal to what the dense phase's
   parameters took on the card);
14. prints a ``{"kernels": [...]}`` line (the rmsnorm kernel once for each
   form, the gated norm's two passes across ranks included; each kernel's
   launches summed over every path above) and, last,
   the ``{"ok": true, ...}`` line.

Any failed check raises, so the exit code is not 0. Without CUDA it exits
with code 2 before printing any result. It imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W), from the
# port's roofline (its one source); the import fails outside a checkout
from repro_torch.launch import roofline as _roofline  # noqa: E402

PEAK_BYTES_PER_S = _roofline.HBM_BW
# bf16 tensor cores / fp32 CUDA cores
PEAK_FLOPS = {torch.bfloat16: _roofline.PEAK_FLOPS, torch.float32: _roofline.PEAK_FLOPS_F32}

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
# the MLA prefill kernel against the same math in float32 (its bf16 inputs
# upcast): the plain bf16 path also rounds the summed scores to bf16, the
# kernel keeps them fp32, so the kernel must come at least as close to the
# float32 result as the plain path does (PERF.md: 8e-3 to 1e-2 against
# 2.6e-2 to 3.7e-2 on outputs up to about 3), and within this
MLA_TRUTH_ATOL = 2e-2
# DeepSeek-V2-Lite's published rope_scaling (its config.json): YaRN's
# temperature enters the MLA softmax scale
DEEPSEEK_YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                 "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
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
# (batch, head), fp32 FMAs) before their tensor-core designs; the grouped
# matmul's wide tile at a 4096-token admission before its TMA-fed design
# (192-row tiles staged by cp.async), timed on the same construction with
# other routing draws
PREVIOUS_MS = {"paged_attention": 0.52284, "moe_gmm decode": 1.65361,
               "moe_gmm prefill": 10.13531, "flash_attention": 0.17507,
               "flash_attention head_dim 80": 0.21983, "ssd mamba2": 0.54182,
               "ssd zamba2": 0.36733, "rmsnorm": 0.00192, "rmsnorm prefill": 0.00335,
               "moe_gmm deepseek s4096 admission w_gate/w_up": 0.96090,
               "moe_gmm deepseek s4096 admission w_down": 1.10433}
# the rmsnorm kernel's forms by the name of their wrapper (kernels/rmsnorm.py)
RMS_FORMS = {"rmsnorm": "plain", "add_rmsnorm": "residual", "gated_rmsnorm": "gated"}
# the gated norm split over ranks (a row's channels on several ranks): its
# two passes, forms of their own (the tp ssm phase)
RMS_TP_FORMS = {"gated_rmsnorm_ssq": "gated_ssq", "gated_rmsnorm_scale": "gated_scale"}
# the form as rmsnorm_kernel's template argument (csrc/rmsnorm.cu's Form)
RMS_FORM_OF_ARG = {"0": "plain", "1": "residual", "2": "gated", "3": "gated_ssq",
                   "4": "gated_scale"}
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


def check_row_blocks(name: str, got: torch.Tensor, want: torch.Tensor, limit: float,
                     rows: int = 512) -> float:
    """Hold (B, S, ...) outputs together block by block: each run of
    ``rows`` consecutive positions of each batch row has a relative L2
    error ||got - want|| / ||want|| within ``limit``. The limit scales with
    each block's own size, where an element-wise atol does not: an
    attention output row averages over its keys, so a late row's values
    are far smaller than an atol that suits the early rows. Returns the
    largest block error."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    b, s = want.shape[:2]
    pad = (-s) % rows
    num = torch.nn.functional.pad((got - want).pow(2).reshape(b, s, -1).sum(-1), (0, pad))
    den = torch.nn.functional.pad(want.pow(2).reshape(b, s, -1).sum(-1), (0, pad))
    rel = (num.reshape(b, -1, rows).sum(-1) / den.reshape(b, -1, rows).sum(-1)).sqrt()
    worst = int(rel.argmax())
    if not bool((rel <= limit).all()):
        raise AssertionError(f"{name}: {int((rel > limit).sum())} of {rel.numel()} blocks of "
                             f"{rows} rows beyond relative L2 {limit}; worst "
                             f"{rel.max().item():.3e} at rows {worst % rel.shape[1] * rows}+")
    return rel.max().item()


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
    the product. The gated norm's passes across ranks: ``gated_ssq`` reads
    x and z and writes a float32 sum a row (silu, the product,
    square-add), ``gated_scale`` reads x, z, w and the sums and writes y
    (silu, the product, scale and weight)."""
    elt = torch.empty((), dtype=dtype).element_size()
    moved = {"plain": 2, "residual": 4, "gated": 3, "gated_ssq": 2, "gated_scale": 3}[form]
    ops = {"plain": 4, "residual": 5, "gated": 9, "gated_ssq": 7,
           "gated_scale": 7}[form] * rows * d
    # w (fp32) but for gated_ssq; the fp32 sums, written by gated_ssq and
    # read by gated_scale
    side = (0 if form == "gated_ssq" else d * 4) + (rows * 4 if form in RMS_TP_FORMS.values()
                                                    else 0)
    t_bytes = (moved * rows * d * elt + side) / PEAK_BYTES_PER_S
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


def _by_ranks(passes) -> dict:
    """``passes`` as {ranks of the group that ran them: passes}: an int is
    passes of one rank."""
    return passes if isinstance(passes, dict) else {1: passes}


def expected_norm_forms(cfg, passes) -> dict:
    """The rmsnorm kernel's launches by form over ``passes`` forward passes
    (prefills, decode steps, paged waves; an int, or {ranks: passes} of a
    tensor-parallel rank), from the model code: per pass one plain (the
    stack's first norm follows the embedding and no add), one gated for
    each Mamba2 mixer (on a group of more than one rank its two passes,
    gated_ssq and gated_scale, instead), and the residual form for every
    other norm (each follows a residual add; the final norm too)."""
    gated = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    total = 2 * cfg.n_layers + 1 + (2 * cfg.n_attn_layers if cfg.family == "hybrid" else 0)
    out = dict.fromkeys(("plain", "residual", "gated", "gated_ssq", "gated_scale"), 0)
    for ranks, n in _by_ranks(passes).items():
        out["plain"] += n
        out["residual"] += (total - 1 - gated) * n
        for form in (("gated_ssq", "gated_scale") if ranks > 1 else ("gated",)):
            out[form] += gated * n
    return out


def check_norm_forms(tag: str, cfg, passes, counts: dict, forms: dict) -> dict:
    """Assert this path's rmsnorm launches by form (read beside ``counts``);
    returns ``counts`` with them under ``rmsnorm_forms``."""
    expect = expected_norm_forms(cfg, passes)
    print(f"{tag}: rmsnorm launches by form {forms}, expected {expect}")
    if forms != expect:
        raise AssertionError(f"{tag}: rmsnorm forms {forms} != expected {expect}")
    return dict(counts, rmsnorm_forms=forms)


def attention_pairs(s: int, causal: bool = True, window=None) -> int:
    """The (query, key) pairs a mask of S positions allows, in closed form
    (no S x S mask: at 32k that would be 1 GiB): causal, key <= query and,
    with a window w, key > query - w; not causal, key > query - w only."""
    if causal:
        if window is None:
            return s * (s + 1) // 2
        m = min(s, window)
        return m * (m + 1) // 2 + (s - m) * window
    if window is None:
        return s * s
    n = max(s - window, 0)
    return s * s - n * (n + 1) // 2


def flash_bound(b, h, kv, s, d, dtype, causal=True, window=None):
    """(bound ms, 'bytes' | 'operations') for attention over this run's mask."""
    pairs = attention_pairs(s, causal, window)
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


def gmm_bound(lhs, rhs, te, rows=None, used=None):
    """(bound ms, 'bytes' | 'operations') for one grouped matmul on these
    inputs: lhs, the rhs experts the tiles use and out moved once, te read;
    2*T*D*F operations. ``rows`` and ``used`` count only the rows that carry
    a token and the experts that received rows (a dropless buffer's padding
    rows and slack tiles carry none), as ``harvest_bench``'s bound does."""
    t, d = lhs.shape
    f = rhs.shape[2]
    elt = lhs.element_size()
    used = int(torch.unique(te).numel()) if used is None else used
    t = t if rows is None else rows
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
    # path (cap 8 at the 4-slot decode wave, cap 160 at a 512-token prefill,
    # here at block_t 8 and 32; the path passes block_t = cap, one map entry
    # an expert, which gives the same bits), w_gate/w_up and w_down shapes,
    # then small float32 cases
    d_model, d_ff, e_full = 6144, 16384, 8
    # deepseek-v2-lite-16b: 64 experts, moe_d_ff 1408 (not a multiple of
    # 256 columns); cap 8 at the 4-slot decode wave, 64 at a 512-token
    # prefill, 120 at a forward of (2, 512) (checked at block_t 8 under the
    # 128-row tile, and at the path's 120)
    ds_d, ds_f, ds_e = 2048, 1408, 64
    cases = [(64, d_model, d_ff, e_full, 8, torch.bfloat16, "decode w_gate/w_up"),
             (64, d_ff, d_model, e_full, 8, torch.bfloat16, "decode w_down"),
             (1280, d_model, d_ff, e_full, 32, torch.bfloat16, "prefill w_gate/w_up"),
             (1280, d_ff, d_model, e_full, 32, torch.bfloat16, "prefill w_down"),
             (512, ds_d, ds_f, ds_e, 8, torch.bfloat16, "deepseek decode w_gate/w_up"),
             (512, ds_f, ds_d, ds_e, 8, torch.bfloat16, "deepseek decode w_down"),
             (4096, ds_d, ds_f, ds_e, 64, torch.bfloat16, "deepseek prefill w_gate/w_up"),
             (7680, ds_d, ds_f, ds_e, 8, torch.bfloat16, "deepseek forward w_gate/w_up"),
             (7680, ds_f, ds_d, ds_e, 8, torch.bfloat16, "deepseek forward w_down"),
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
        print(f"check {name}: max abs err {err:.3e}, {row_tile(t, e)}-row tiles")
        res["err"] = max(res["err"], err)
        if label.startswith("deepseek"):
            check_repeat(f"moe_gmm {label}", lambda: moe_gmm_op(lhs, rhs, te, block_t=bt))
        if label == "deepseek forward w_gate/w_up":
            # the path passes block_t = cap (one map entry an expert): the
            # kernel cuts tiles per run of equal expert, so the same bits
            cap = t // e
            check_bits(f"moe_gmm {label} block_t {cap} vs {bt}",
                       moe_gmm_op(lhs, rhs, torch.arange(e, device=dev, dtype=torch.int32),
                                  block_t=cap), moe_gmm_op(lhs, rhs, te, block_t=bt))
            print(f"check moe_gmm {label}: block_t {cap} gives block_t {bt}'s bits")
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

    # timing at the main paths' shapes, bf16: mixtral's w_gate/w_up (D 6144
    # -> F 16384) and w_down (16384 -> 6144), deepseek's w_gate/w_up
    for t, d, f, e, bt, label in ((64, d_model, d_ff, e_full, 8, "decode"),
                                  (1280, d_model, d_ff, e_full, 32, "prefill"),
                                  (64, d_ff, d_model, e_full, 8, "decode w_down"),
                                  (1280, d_ff, d_model, e_full, 32, "prefill w_down"),
                                  (512, ds_d, ds_f, ds_e, 8, "deepseek decode"),
                                  (4096, ds_d, ds_f, ds_e, 64, "deepseek prefill"),
                                  (7680, ds_d, ds_f, ds_e, 120, "deepseek forward"),
                                  (7680, ds_d, ds_f, ds_e, 8, "deepseek forward block_t 8")):
        lhs, rhs, te = case(t, d, f, e, bt, torch.bfloat16, scale=d ** -0.5)
        buf = lhs.view(e, t // e, d)
        check_close(f"moe_gmm {label} library yardstick (torch.bmm) vs plain",
                    torch.bmm(buf, rhs).reshape(t, f), moe_gmm_tiles_ref(lhs, rhs, te, bt),
                    TOL[torch.bfloat16])
        check_repeat(f"moe_gmm {label}", lambda: moe_gmm_op(lhs, rhs, te, block_t=bt))
        bound, by = gmm_bound(lhs, rhs, te)
        tm = time_three(lambda: moe_gmm_op(lhs, rhs, te, block_t=bt),
                        lambda: moe_gmm_tiles_ref(lhs, rhs, te, bt),
                        lambda: torch.bmm(buf, rhs), plain_graph=False)
        tm.update(bound_ms=bound, bound_by=by,
                  shape=f"{label}: lhs ({t},{d}) rhs ({e},{d},{f}) "
                        f"block_t {bt} bf16, {row_tile(t, e)}-row tiles; plain timed "
                        f"eager (it waits for the device); library: torch.bmm over the "
                        f"(E, C, D) capacity buffer")
        report(f"moe_gmm {label}", tm)
        res[label] = tm
        del lhs, rhs, buf

    # deepseek's median extract16 admission, s = 4096 tokens of top-6 over
    # 64 experts, as models/moe.py's dropless path lays it out: 24,576 picks
    # in groups padded to 128 rows, t 32,768 launched (the slack tiles on
    # the last expert); bound on the rows that carry a token
    for d, f, label in ((ds_d, ds_f, "deepseek s4096 admission w_gate/w_up"),
                        (ds_f, ds_d, "deepseek s4096 admission w_down")):
        s_tok, k, bt = 4096, 6, 128
        picks = torch.rand(s_tok, ds_e, device=dev, generator=gen).topk(k, dim=1).indices
        sizes = torch.bincount(picks.reshape(-1), minlength=ds_e).to(torch.int32)
        t = (s_tok * k + bt - 1) // bt * bt + ds_e * bt
        _, offs = pad_group_sizes(sizes, bt)
        lhs = torch.zeros(t, d, device=dev, dtype=torch.bfloat16)
        for n, o in zip(sizes.tolist(), offs[:-1].tolist()):
            lhs[o:o + n] = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
        rhs = (torch.randn(ds_e, d, f, device=dev, generator=gen) * d ** -0.5).to(torch.bfloat16)
        te = (torch.searchsorted(offs, torch.arange(t // bt, device=dev, dtype=torch.int32) * bt,
                                 right=True) - 1).clamp(0, ds_e - 1).to(torch.int32)
        buf = lhs.view(ds_e, t // ds_e, d)
        name = f"moe_gmm {label} lhs ({t},{d}) rhs ({ds_e},{d},{f}) block_t {bt}"
        err = check_close(name, moe_gmm_op(lhs, rhs, te, block_t=bt),
                          moe_gmm_tiles_ref(lhs, rhs, te, bt), TOL[torch.bfloat16])
        print(f"check {name}: max abs err {err:.3e}, {row_tile(t, ds_e)}-row tiles")
        res["err"] = max(res["err"], err)
        check_repeat(f"moe_gmm {label}", lambda: moe_gmm_op(lhs, rhs, te, block_t=bt))
        rows, used = int(sizes.sum()), int((sizes > 0).sum())
        bound, by = gmm_bound(lhs, rhs, te, rows=rows, used=used)
        tm = time_three(lambda: moe_gmm_op(lhs, rhs, te, block_t=bt),
                        lambda: moe_gmm_tiles_ref(lhs, rhs, te, bt),
                        lambda: torch.bmm(buf, rhs), plain_graph=False)
        tm.update(bound_ms=bound, bound_by=by,
                  shape=f"{label}: lhs ({t},{d}) rhs ({ds_e},{d},{f}) block_t {bt} bf16, "
                        f"{rows} rows carry a token over {used} experts (the bound's), "
                        f"{row_tile(t, ds_e)}-row tiles; plain timed eager; library: "
                        f"torch.bmm over the buffer as ({ds_e}, {t // ds_e}, {d})")
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
    # mixtral-8x22b's and internvl2-26b's attention at a 512-token prefill:
    # 48 heads on 8 kv heads
    cases += [(1, 48, 8, 512, 128, True, None, torch.bfloat16)]
    # hubert-xlarge's encoder: 16 heads of 80, not causal
    cases += [(1, 16, 16, 512, 80, False, None, dt) for dt in (torch.float32, torch.bfloat16)]
    # one rank of qwen2.5-3b on 2 ranks (the tp phase): 8 query heads on its
    # one KV head
    cases += [(1, 8, 1, s, 128, True, None, dt) for s in (128, 512)
              for dt in (torch.float32, torch.bfloat16)]
    # one of 2 ranks of the frontends' loss_fn (the tp train phase): hubert's
    # encoder, 8 heads of 80 on 8 KV heads, not causal; internvl2-26b, 24
    # heads on 4 KV heads over 256 patches + 256 tokens
    cases += [(2, 8, 8, 512, 80, False, None, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 24, 4, 512, 128, True, None, dt) for dt in (torch.float32, torch.bfloat16)]
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
    timed = {}
    # timing at the prefill shapes of zamba2's shared block (32 heads of 80),
    # of hubert's encoder (16 heads of 80, not causal), of one rank of
    # qwen2.5-3b on 2 ranks and, for the kernels line, of qwen2.5-3b
    for label, (b, h, kv, s, dd), causal in (
            ("flash_attention head_dim 80", (1, 32, 32, 512, 80), True),
            ("flash_attention non-causal head_dim 80", (1, 16, 16, 512, 80), False),
            ("flash_attention tp rank", (1, 8, 1, 512, 128), True),
            ("flash_attention hubert tp rank", (2, 8, 8, 512, 80), False),
            ("flash_attention internvl2 tp rank", (2, 24, 4, 512, 128), True),
            ("flash_attention", (1, 16, 2, 512, 128), True)):
        q, k, v = qkv(b, h, kv, s, dd, torch.bfloat16)
        k_rep = k.repeat_interleave(h // kv, dim=1)
        v_rep = v.repeat_interleave(h // kv, dim=1)
        bound, by = flash_bound(b, h, kv, s, dd, torch.bfloat16, causal=causal)
        t = time_three(lambda: flash_attention_op(q, k, v, causal=causal),
                       lambda: flash_attention_ref(q, k, v, causal=causal),
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q, k_rep, v_rep, is_causal=causal))
        t.update(bound_ms=bound, bound_by=by,
                 shape=f"q ({b},{h},{s},{dd}) kv {kv} {'causal' if causal else 'not causal'} "
                       f"bf16; library: SDPA, K/V repeated")
        report(label, t)
        timed[label] = t
    results["flash_attention"].update(t)
    results["flash_attention"]["tp_rank"] = timed["flash_attention tp rank"]
    results["flash_attention"]["tp_frontends"] = {
        k.split()[1]: {f: timed[k][f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "shape")}
        for k in ("flash_attention hubert tp rank", "flash_attention internvl2 tp rank")}
    return results["flash_attention"]


def mla_prefill_bound(b, h, s):
    """(bound ms, 'bytes' | 'operations') of causal MLA prefill attention:
    QK depth 192 and V width 128 over the causal pairs, against q (192 a
    head), k_nope, v and out (128 a head each) and the shared k_rope (64)
    read or written once, bf16."""
    flops = 2 * b * h * attention_pairs(s) * (192 + 128)
    bytes_ = 2 * b * s * (h * (192 + 3 * 128) + 64)
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16], bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mla_prefill_kernel_phase(gen: torch.Generator) -> dict:
    """The MLA prefill kernel on inputs laid out as the prefill makes them
    (q_nope and q_rope views of one projection, k_rope a view of the
    latent's row), YaRN's softmax scale: against the plain bf16 version and
    the same math in float32 at 16 heads and a TP-2 rank's 8, a repeated
    call's bits; then timed at the median and longest extract16 prompts and
    the rank shape beside the plain version and SDPA (the yardstick only:
    the port never calls it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import mla_prefill_attention_op
    from repro_torch.kernels.ref import mla_prefill_attention_ref
    from repro_torch.models.attention import mla_softmax_scale

    scale = mla_softmax_scale(dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                                                  rope_scaling=DEEPSEEK_YARN))

    def inputs(b, s, h):
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
        q_nope, q_rope = rnd(b, s, h, 192).split([128, 64], dim=-1)
        return q_nope, q_rope, rnd(b, s, h, 128), rnd(b, s, 512 + 64)[..., 512:], rnd(b, s, h, 128)

    out = {"err": 0.0}
    for s in (1, 65, 2048, 4097):
        for h in (16, 8):
            ins = inputs(1, s, h)
            name = f"mla_prefill_attention (b=1,s={s},h={h}) bf16"
            got = mla_prefill_attention_op(*ins, scale=scale)
            check_repeat(name, lambda: mla_prefill_attention_op(*ins, scale=scale))
            plain = mla_prefill_attention_ref(*ins, scale=scale)
            truth = mla_prefill_attention_ref(*(x.float() for x in ins), scale=scale)
            err = check_close(name, got, plain, TOL[torch.bfloat16])
            e_k, e_p = ((x.float() - truth).abs().max().item() for x in (got, plain))
            if e_k > max(e_p, 1e-6) or e_k > MLA_TRUTH_ATOL:
                raise AssertionError(f"{name}: {e_k:.3e} from float32, the plain version "
                                     f"{e_p:.3e} (limit {MLA_TRUTH_ATOL})")
            print(f"check {name}: max abs err {err:.3e} against the plain version (atol="
                  f"{TOL[torch.bfloat16][0]} rtol={TOL[torch.bfloat16][1]}); against float32 "
                  f"{e_k:.3e}, the plain version's {e_p:.3e}")
            out["err"] = max(out["err"], err)
    timed = {}
    for label, (b, s, h) in (("mla_prefill_attention 8192", (1, 8192, 16)),
                             ("mla_prefill_attention tp rank", (1, 4096, 8)),
                             ("mla_prefill_attention", (1, 4096, 16))):
        ins = inputs(b, s, h)
        q_nope, q_rope, k_nope, k_rope, v = ins
        q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, 64)], dim=-1).transpose(1, 2)
        vt = v.transpose(1, 2)
        bound, by = mla_prefill_bound(b, h, s)
        t = time_three(lambda: mla_prefill_attention_op(*ins, scale=scale),
                       lambda: mla_prefill_attention_ref(*ins, scale=scale),
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q, k, vt, is_causal=True, scale=scale))
        t.update(bound_ms=bound, bound_by=by,
                 shape=f"q ({b},{s},{h},128+64) causal bf16, YaRN scale; library: SDPA, "
                       f"k_rope expanded to every head")
        report(label, t)
        timed[label] = {f: t[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "shape")}
        del ins, q, k, vt
        torch.cuda.empty_cache()
    out.update(t)
    out["shapes"] = timed
    return out


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
                        "ssd_chunk_scan_kernel"),
                "mla_prefill": ("mla_prefill_kernel",)}


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
    mem0 = torch.cuda.memory_allocated()
    params = M.init_params(cfg, gen, "cuda")
    param_bytes = torch.cuda.memory_allocated() - mem0   # the dry-run phase holds its count to it
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

    run = drive(engine, prompts, new_tok, GenRequest)
    n_steps, n_prefills = run["steps"], run["prefills"]
    print(f"slice: {n_prefills} prefills, {n_steps} decode steps")
    if n_prefills != n_req:
        raise AssertionError(f"{n_prefills} prefills, expected {n_req}")
    expect = dict(forward_counts(cfg, n_prefills + n_steps),
                  flash_attention=cfg.n_layers * n_prefills)
    counts = check_counts("slice", cfg, run["counts"], run["forms"], expect,
                          n_prefills + n_steps)
    serving = serving_summary("slice", run, n_req, new_tok, None)
    serving.update(profile_decode(engine, prompts, GenRequest))
    serving.update(profile_prefill(engine, prompts[0], GenRequest))
    del engine

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
    serving["param_bytes_on_card"] = param_bytes
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
              "paged_attention": cfg.n_layers * (n_waves + n_extend), "moe_gmm": 0, "ssd": 0,
              "mla_prefill": 0}
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


# The platform phase: HPC-Whisk on the card. One scenario for the full-width
# runs (600 virtual seconds, 59 requests, 32 pilots); the paged run is cut
# to PAGED_DURATION because each of its admissions decodes its 32 suffix
# tokens one batch-1 wave at a time (~1.3-2.2 s a request on the card), and
# the registry run builds the smoke engine itself
PLATFORM_DURATION, PAGED_DURATION, REGISTRY_DURATION = 600.0, 150.0, 300.0


def platform_run(tag: str, sc, expect_fn, profile_n: int = 4) -> dict:
    """Build ``sc`` through the port's ``Platform.build`` (its executor
    ``batched-serving``), drive it with every launch count at 0, and check:
    every request terminal and the counts summing to ``n_submitted``; at
    least one success; every stream the executor finished ``n_new`` long;
    the ``kv_*`` gauges reading ``kv_stats()``; the kernels' launches (by
    rmsnorm form too) equal to ``expect_fn(engine, calls)``, from the
    engine's counters and the calls the phase counts here. Then one batch of
    ``profile_n`` requests under the profiler (not counted)."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models.model import tree_leaves
    from repro_torch.platform import Platform
    from repro_torch.platform.executors import _KV_GAUGES

    t0 = time.perf_counter()
    plat = Platform.build(sc)
    ex, eng = plat.executor, plat.executor.engine
    param_devices = sorted({t.device.type for t in tree_leaves(eng.params)})
    calls = {"prefill": 0, "paged_wave": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    eng._prefill = counted("prefill", eng._prefill)
    if hasattr(eng, "_decode_paged"):
        eng._decode_paged = counted("paged_wave", eng._decode_paged)
    charged, batches, resumed, short = [], [], [0], []
    run_batch = ex.run_batch

    def recorded(reqs):
        resumed[0] += sum(r.id in ex._partials for r in reqs)
        times = run_batch(reqs)
        charged.extend(times)
        batches.append(len(reqs))
        short.extend(rid for rid, t in ex.last_results.items() if len(t) != ex.n_new)
        return times

    ex.run_batch = recorded
    steps0 = eng.n_decode_steps
    reset_launch_counts()
    res = plat.run()
    counts, forms = launch_counts(), rmsnorm_form_counts()
    wall = time.perf_counter() - t0

    ex.run_batch = run_batch   # the profiled batch below is not recorded
    oc = res.outcome_counts
    waves = eng.n_decode_steps - steps0
    mean_batch = statistics.fmean(batches) if batches else float("nan")
    p50, p95 = (float(q) for q in np.percentile(charged, [50, 95])) if charged else (
        float("nan"), float("nan"))
    print(f"{tag}: submitted {res.n_submitted}, outcomes {oc}, executions {len(charged)} "
          f"in {len(batches)} batches (mean batch {mean_batch:.3f}), waves {waves}, "
          f"occupancy {eng.occupancy:.3f}, parked partials resumed {resumed[0]}, charged s "
          f"p50 {p50:.4f} p95 {p95:.4f}, pilots {res.n_jobs_started}, evicted "
          f"{res.n_evicted}, coverage {res.slurm_coverage:.4f}, parameters on "
          f"{param_devices}, phase wall {wall:.2f} s")
    if any(r.outcome is None for r in res.requests) or sum(oc.values()) != res.n_submitted:
        raise AssertionError(f"{tag}: a request without a terminal outcome: {oc}, "
                             f"{res.n_submitted} submitted")
    if oc.get("success", 0) < 1:
        raise AssertionError(f"{tag}: no request succeeded: {oc}")
    if short:
        raise AssertionError(f"{tag}: streams of ids {short} are not {ex.n_new} tokens long")
    st = eng.kv_stats()
    gauges = {k: [g.read() for g in plat.metrics.gauges_matching(f"kv_{k}").values()]
              for k in _KV_GAUGES}
    print(f"{tag}: kv gauges {gauges}; kv_stats share_hits {st['share_hits']}, "
          f"resume_hits {st['resume_hits']}, mem_preempts {st['mem_preempts']}")
    if any(v != [st[k]] for k, v in gauges.items()):
        raise AssertionError(f"{tag}: kv gauges {gauges} != kv_stats {st}")
    expect, passes = expect_fn(eng, calls, waves)
    print(f"{tag}: {calls['prefill']} prefills, {calls['paged_wave']} paged waves "
          f"(decode and extend), {waves} decode steps, launches {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts} != expected {expect}")
    counts = check_norm_forms(tag, eng.cfg, passes, counts, forms)

    @dataclasses.dataclass
    class Req:
        id: int
        fn: str

    reqs = [Req(id=10 ** 6 + i, fn=f"profile-{i}") for i in range(profile_n)]
    out = {"submitted": res.n_submitted, "outcomes": oc, "executions": len(charged),
           "mean_batch": mean_batch, "waves": waves, "occupancy": eng.occupancy,
           "resumed": resumed[0], "charged_p50_s": p50, "charged_p95_s": p95,
           "coverage": res.slurm_coverage, "wall_s": wall, "launches": counts,
           "kv_share_hits": st["share_hits"], "param_devices": param_devices}
    t = time.perf_counter()
    out.update(profile_run(lambda: ex.run_batch(reqs),
                           f"{tag}: one batch of {profile_n} requests through the executor",
                           profile_n, "batch", "request"))
    out["profile_s"] = time.perf_counter() - t
    print(f"{tag}: the profiled batch took {out['profile_s']:.2f} s with the profiler's "
          f"processing")
    return out


def platform_phase(cfg, params, seed: int) -> dict:
    """HPC-Whisk on the card: the port's ``Platform.build(ScenarioConfig)``
    (Slurm idle windows, pilot jobs, invokers, controller) with the
    ``batched-serving`` executor hosting full-width qwen2.5-3b, dense and
    paged (tenant prefix forks through the paged-attention kernel), then a
    run whose executor builds its own smoke engine from the registry."""
    from repro_torch.platform import (PlatformSection, ScenarioConfig, SchedulingSection,
                                      TraceSection, WorkloadSection)
    from repro_torch.serving.engine import ContinuousEngine, PagedContinuousEngine

    def scenario(name, duration, **platform):
        return ScenarioConfig(
            name=name, duration=duration, seed=seed, trace=TraceSection(seed=4),
            workload=WorkloadSection(qps=0.1, n_functions=8),
            scheduling=SchedulingSection(model="fib"),
            platform=PlatformSection(executor="batched-serving", kernel_impls="auto",
                                     invoker_params={"concurrency": 4}, **platform))

    def dense_expect(eng, calls, waves):
        passes = calls["prefill"] + waves
        return ({"rmsnorm": (2 * eng.cfg.n_layers + 1) * passes,
                 "flash_attention": eng.cfg.n_layers * calls["prefill"],
                 "paged_attention": 0, "moe_gmm": 0, "ssd": 0, "mla_prefill": 0}, passes)

    def paged_expect(eng, calls, waves):
        passes = calls["prefill"] + calls["paged_wave"]
        return ({"rmsnorm": (2 * eng.cfg.n_layers + 1) * passes,
                 "flash_attention": eng.cfg.n_layers * calls["prefill"],
                 "paged_attention": eng.cfg.n_layers * calls["paged_wave"],
                 "moe_gmm": 0, "ssd": 0, "mla_prefill": 0}, passes)

    out, t0 = {}, time.perf_counter()
    engine = ContinuousEngine(cfg, params, n_slots=4, max_seq=256, device="cuda")
    sc = scenario("platform_dense", PLATFORM_DURATION,
                  executor_params={"engine": engine, "prompt_len": 128, "n_new": 8})
    print(f"platform dense: {cfg.arch_id} full width, ContinuousEngine 4 slots, max_seq 256, "
          f"prompts 128 + 8 new, {sc.duration:g} virtual s, qps {sc.workload.qps}")
    out["dense"] = platform_run("platform dense", sc, dense_expect)
    del engine, sc
    gc.collect()
    torch.cuda.empty_cache()

    engine = PagedContinuousEngine(cfg, params, n_slots=4, max_seq=256, block_size=16,
                                   attn="kernel", device="cuda")
    sc = scenario("platform_paged", PAGED_DURATION, kv_layout="paged",
                  executor_params={"engine": engine, "prompt_len": 128, "prefix_len": 96,
                                   "n_new": 8})
    print(f"platform paged: {cfg.arch_id} full width, PagedContinuousEngine(attn=kernel) 4 slots, "
          f"prompts 128 (a 96-token tenant prefix) + 8 new, {sc.duration:g} virtual s")
    # one profiled request: a paged admission is 32 batch-1 waves, ~2 s
    out["paged"] = platform_run("platform paged", sc, paged_expect, profile_n=1)
    if out["paged"]["kv_share_hits"] < 1:
        raise AssertionError("platform paged: no admission forked the tenant prefix")
    del engine, sc
    gc.collect()
    torch.cuda.empty_cache()

    sc = scenario("platform_registry", REGISTRY_DURATION, model="qwen2.5-3b")
    print(f"platform registry: executor_params {{}}, platform.model {sc.platform.model!r}: "
          f"the factory builds the smoke engine on the default device")
    out["registry"] = platform_run("platform registry", sc, dense_expect)
    if out["registry"]["param_devices"] != ["cuda"]:
        raise AssertionError(f"platform registry: the factory's engine holds parameters "
                             f"on {out['registry']['param_devices']}, not on cuda")
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"platform: phase wall {out['phase_wall_s']:.2f} s (three runs and their profiles)")
    return out


# The elastic phase: gangs of one full-width replica on the card. The gang
# size is logical (it sets the migration bytes); the mesh is this one card
ELASTIC_REQ, ELASTIC_PROMPT, ELASTIC_NEW, ELASTIC_SLOTS, ELASTIC_SEQ = 4, 128, 16, 4, 256
ELASTIC_STORM_DURATION, ELASTIC_REGISTRY_DURATION = 600.0, 300.0


class _CountPrefills:
    """Counts ``ContinuousEngine._prefill`` calls (``n``) and decode steps
    (``steps``) on every engine, the fresh engines a resize builds
    included, while the block runs; ``by_ranks``: both together by the
    ranks of the engine's group (1 without one)."""

    def __enter__(self):
        from repro_torch.distributed.tensor_parallel import tp_size
        from repro_torch.serving.engine import ContinuousEngine
        self.n, self.steps, self.by_ranks, self._cls = 0, 0, {}, ContinuousEngine
        self._orig = ContinuousEngine._prefill, ContinuousEngine._decode_active

        def ranked(engine):
            k = tp_size(engine.tp)
            self.by_ranks[k] = self.by_ranks.get(k, 0) + 1

        def counted(engine, context):
            self.n += 1
            ranked(engine)
            return self._orig[0](engine, context)

        def stepped(engine, pos):
            self.steps += 1
            ranked(engine)
            return self._orig[1](engine, pos)
        ContinuousEngine._prefill, ContinuousEngine._decode_active = counted, stepped
        return self

    def __exit__(self, *exc):
        self._cls._prefill, self._cls._decode_active = self._orig


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def elastic_replica_leg(tag: str, cfg, params, prompts, kv_mode, n_members: int,
                        resizes=()):
    """One ``ElasticReplica`` on the card serving ``prompts`` with every
    launch count at 0; ``resizes`` is ``[(steps before, new gang size),
    ...]``. Returns the streams, the records, each resize's device memory
    (allocated before, peak during), the decode step ms before the first
    resize and after it, the launches checked against the passes counted,
    and every parameter leaf's device after each resize."""
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models.model import tree_leaves
    from repro_torch.serving.batching import GenRequest

    rep = ElasticReplica(cfg, params, n_members, n_slots=ELASTIC_SLOTS, max_seq=ELASTIC_SEQ,
                         kv_mode=kv_mode or "migrate", device="cuda")
    torch.cuda.synchronize()
    step_ms, phase, mem, devices = ([], []), 0, [], []

    def timed_step():
        t = time.perf_counter()
        rep.step()   # ends in a host copy of the picked tokens
        step_ms[phase].append(1e3 * (time.perf_counter() - t))

    reset_launch_counts()
    with _CountPrefills() as prefills:
        for i, p in enumerate(prompts):
            rep.add(GenRequest(id=i, prompt=p, max_new=ELASTIC_NEW))
        for steps, n_after in resizes:
            for _ in range(steps):
                timed_step()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if n_after < rep.n_members:
                rep.shrink(rep.n_members - n_after)
            else:
                rep.grow(n_after - rep.n_members)
            torch.cuda.synchronize()
            mem.append({"allocated_before_bytes": base,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "allocated_after_bytes": torch.cuda.memory_allocated()})
            devices.append(sorted({str(t.device.type) for t in tree_leaves(rep.params)}))
            phase = 1
        while rep.batcher.active():
            timed_step()
    counts, forms = launch_counts(), rmsnorm_form_counts()
    done = rep.run()
    steps = rep.engine.n_decode_steps
    passes = prefills.n + steps
    expect = dict(forward_counts(cfg, passes), flash_attention=cfg.n_layers * prefills.n)
    print(f"{tag}: {prefills.n} prefills, {steps} decode steps")
    # each request once; replay prefills every live request again at each resize
    replayed = sum(r.n_requests_live for r in rep.migrations if r.kv_mode == "replay")
    if prefills.n != len(prompts) + replayed:
        raise AssertionError(f"{tag}: {prefills.n} prefills, expected {len(prompts)} + "
                             f"{replayed} replayed")
    counts = check_counts(tag, cfg, counts, forms, expect, passes)
    streams = {r.id: list(r.generated) for r in done}
    if sorted(streams) != list(range(len(prompts))) or any(
            len(s) != ELASTIC_NEW for s in streams.values()):
        raise AssertionError(f"{tag}: streams {({k: len(v) for k, v in streams.items()})}, "
                             f"expected {len(prompts)} of {ELASTIC_NEW} tokens")
    if any(d != ["cuda"] for d in devices):
        raise AssertionError(f"{tag}: parameters on {devices} after the resizes")
    out = {"streams": streams, "records": [dataclasses.asdict(r) for r in rep.migrations],
           "memory": mem, "counts": counts, "prefills": prefills.n, "steps": steps,
           "decode_ms_before": statistics.median(step_ms[0]) if step_ms[0] else None,
           "decode_ms_after": statistics.median(step_ms[1]) if step_ms[1] else None,
           "param_devices": devices}
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    return out


def elastic_shape_bytes(cfg, n_slots: int, max_seq: int) -> tuple:
    """(parameter bytes at ``param_dtype``, KV bytes at the compute dtype,
    the KV's int8 wire bytes) of a replica, reckoned from the config's
    shapes: the parameter tree's shapes and the K and V of every layer, slot
    and position."""
    from repro_torch.models.model import param_specs, tree_leaves

    n_params = sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(cfg)))
    elem = torch.empty((), dtype=cfg.param_torch_dtype).element_size()
    kv_elems = cfg.n_layers * n_slots * max_seq * cfg.n_kv_heads * cfg.head_dim
    kv_elem = torch.empty((), dtype=cfg.compute_dtype).element_size()
    return n_params * elem, 2 * kv_elems * kv_elem, 2 * kv_elems + 2 * 4


def elastic_phase(cfg, params, seed: int):
    """Elastic sharded serving on the card over the full-width qwen2.5-3b
    the dense phase built: (a) ``ElasticReplica`` gangs shrinking 4 -> 2 in
    the middle of a stream in each KV mode (``migrate`` also grows 2 -> 3)
    against an unbroken gang of 2; (b) the port's ``Platform.build`` of
    ``elastic_storm`` (gang 3, migrating) with ``ElasticServingExecutor``
    over a full-width replica, the gang pool's SIGTERM hook driving real
    resizes; (c) the same storm with ``executor="sharded-serving"``, whose
    factory builds its smoke replica on the card. Returns (launches by path,
    the phase's numbers)."""
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.platform import ElasticServingExecutor, ScenarioConfig

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 21)
    prompts = rng.integers(0, cfg.vocab_size, size=(ELASTIC_REQ, ELASTIC_PROMPT)).tolist()
    param_total, kv_total, kv_int8 = elastic_shape_bytes(cfg, ELASTIC_SLOTS, ELASTIC_SEQ)
    print(f"elastic: {cfg.arch_id} full width, {ELASTIC_REQ} requests of {ELASTIC_PROMPT} + "
          f"{ELASTIC_NEW} new, {ELASTIC_SLOTS} slots, max_seq {ELASTIC_SEQ}; from the shapes: "
          f"parameters {param_total} bytes at {cfg.param_dtype}, KV {kv_total} bytes at "
          f"{cfg.dtype}, KV int8 wire {kv_int8} bytes")
    counts, out = {}, {"shape_param_bytes": param_total, "shape_kv_bytes": kv_total,
                       "shape_kv_int8_bytes": kv_int8}

    # (a) the replica: golden unbroken gang of 2, then each KV mode
    legs = {"golden": elastic_replica_leg("elastic golden", cfg, params, prompts, None, 2)}
    golden = legs["golden"]["streams"]
    for mode in ("migrate", "replay", "migrate_int8"):
        resizes = [(4, 2), (4, 3)] if mode == "migrate" else [(4, 2)]
        legs[mode] = elastic_replica_leg(f"elastic {mode}", cfg, params, prompts, mode, 4,
                                         resizes)
    for name, leg in legs.items():
        counts[name] = leg["counts"]
        match = {i: _common_prefix(s, golden[i]) for i, s in leg["streams"].items()}
        summary = {k: leg[k] for k in ("records", "memory", "prefills", "steps",
                                       "decode_ms_before", "decode_ms_after")}
        summary["prefix_matching_golden"] = match
        out[name] = summary
        for rec, mem in zip(leg["records"], leg["memory"]):
            n_b, n_a = rec["n_before"], rec["n_after"]
            frac = abs(n_b - n_a) / max(n_b, n_a)
            want = {"param_bytes": int(param_total * frac), "kv_bytes": int(kv_total * frac)}
            kv_wire = {"migrate": want["kv_bytes"], "replay": 0,
                       "migrate_int8": int(kv_int8 * frac)}[name]
            want["wire_bytes"] = want["param_bytes"] + kv_wire
            got = {k: rec[k] for k in want}
            print(f"elastic {name}: {n_b} -> {n_a} members, {rec['n_requests_live']} live, "
                  f"wall {rec['wall_s'] * 1e3:.3f} ms, bytes {got} (from the shapes {want}); "
                  f"device memory allocated {mem['allocated_before_bytes']} -> "
                  f"{mem['allocated_after_bytes']}, peak across the resize "
                  f"{mem['peak_bytes']} (+{mem['peak_bytes'] - mem['allocated_before_bytes']})")
            if got != want:
                raise AssertionError(f"elastic {name}: record bytes {got} != {want}")
        print(f"elastic {name}: decode step median {leg['decode_ms_before']} ms before, "
              f"{leg['decode_ms_after']} ms after; prefix matching golden {match}")
    if legs["migrate"]["streams"] != golden:
        raise AssertionError(f"elastic migrate: streams {legs['migrate']['streams']} != "
                             f"the unbroken run's {golden}")

    # (b) the platform: the gang pool's hook drives real resizes of one replica
    replica = ElasticReplica(cfg, params, 3, n_slots=ELASTIC_SLOTS, max_seq=ELASTIC_SEQ,
                             device="cuda")
    ex = ElasticServingExecutor(replica, prompt_len=ELASTIC_PROMPT, n_new=8)
    sc = ScenarioConfig.elastic_storm(duration=ELASTIC_STORM_DURATION, gang_size=3,
                                      migrate=True)
    out["storm"], counts["storm"] = elastic_platform_run("elastic storm", sc, executor=ex)
    del ex, replica
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the registry: the factory builds the smoke replica on the card
    sc = ScenarioConfig.elastic_storm(duration=ELASTIC_REGISTRY_DURATION, gang_size=3)
    sc.platform.executor, sc.platform.model, sc.platform.kernel_impls = (
        "sharded-serving", "qwen2.5-3b", "auto")
    out["registry"], counts["registry"] = elastic_platform_run("elastic registry", sc)
    if out["registry"]["param_devices"] != ["cuda"]:
        raise AssertionError(f"elastic registry: the factory's replica holds parameters on "
                             f"{out['registry']['param_devices']}, not on cuda")
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"elastic: phase wall {out['phase_wall_s']:.2f} s")
    return counts, out


def elastic_platform_run(tag: str, sc, executor=None):
    """Build and run ``sc`` (gangs of ``gang_size``) with every launch count
    at 0; check every request terminal, at least one success, gang
    migrations that went through ``replica.migrations`` (the real protocol),
    every finished stream ``n_new`` long and the launches against the passes
    counted."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models.model import tree_leaves
    from repro_torch.platform import Platform

    t0 = time.perf_counter()
    plat = Platform.build(sc, executor=executor)
    ex = plat.executor
    replica = ex.replica
    charged, short = [], []
    run_batch = ex.run_batch

    def recorded(reqs):
        times = run_batch(reqs)
        charged.extend(times)
        short.extend(rid for rid, t in ex._inner.last_results.items() if len(t) != ex._inner.n_new)
        return times

    ex.run_batch = recorded
    steps0 = replica.engine.n_decode_steps
    reset_launch_counts()
    with _CountPrefills() as prefills:
        res = plat.run()
    counts, forms = launch_counts(), rmsnorm_form_counts()
    wall = time.perf_counter() - t0
    cfg = replica.cfg
    steps = replica.engine.n_decode_steps - steps0
    passes = prefills.n + steps
    expect = dict(forward_counts(cfg, passes), flash_attention=cfg.n_attn_layers * prefills.n)
    counts = check_counts(tag, cfg, counts, forms, expect, passes)
    oc, m = res.outcome_counts, plat.metrics
    by_kind = {dict(k)["kind"]: c.value for k, c in m.counters_matching("gang_migrations_total").items()}
    walls = [r.wall_s for r in replica.migrations]
    p50, p95 = (float(q) for q in np.percentile(charged, [50, 95])) if charged else (
        float("nan"), float("nan"))
    param_devices = sorted({t.device.type for t in tree_leaves(replica.params)})
    out = {"submitted": res.n_submitted, "outcomes": oc, "goodput_s": res.goodput_s,
           "executions": len(charged), "charged_p50_s": p50, "charged_p95_s": p95,
           "migrations_by_kind": by_kind, "replica_migrations": len(replica.migrations),
           "migrated_bytes": m.total("gang_migrated_bytes_total"),
           "wire_bytes": m.total("gang_wire_bytes_total"),
           "replica_losses": m.total("gang_replica_losses_total"),
           "migration_wall_s_min": min(walls) if walls else None,
           "migration_wall_s_max": max(walls) if walls else None,
           "prefills": prefills.n, "decode_steps": steps, "launches": counts,
           "param_devices": param_devices, "gang_members": replica.n_members, "wall_s": wall}
    print(f"{tag}: {cfg.arch_id} (n_layers {cfg.n_layers}, d {cfg.d_model}), submitted "
          f"{res.n_submitted}, outcomes {oc}, goodput {res.goodput_s} s, executions "
          f"{len(charged)}, charged s p50 {p50:.4f} p95 {p95:.4f}, migrations by kind "
          f"{by_kind} ({len(replica.migrations)} through the replica), migrated "
          f"{out['migrated_bytes']:.0f} bytes, wire {out['wire_bytes']:.0f} bytes, "
          f"migration wall {out['migration_wall_s_min']} - {out['migration_wall_s_max']} s, "
          f"parameters on {param_devices}, wall {wall:.2f} s")
    if any(r.outcome is None for r in res.requests) or sum(oc.values()) != res.n_submitted:
        raise AssertionError(f"{tag}: a request without a terminal outcome: {oc}")
    if oc.get("success", 0) < 1:
        raise AssertionError(f"{tag}: no request succeeded: {oc}")
    if short:
        raise AssertionError(f"{tag}: streams of ids {short} are short")
    if not m.total("gang_migrations_total") > 0 or not replica.migrations:
        raise AssertionError(f"{tag}: gang migrations {by_kind}, replica migrations "
                             f"{len(replica.migrations)}: the hook drove no real resize")
    if replica.protocol.kv_mode != "replay" and prefills.n != len(charged):
        raise AssertionError(f"{tag}: {prefills.n} prefills for {len(charged)} executions: "
                             f"a {replica.protocol.kv_mode} resize prefilled again")
    if len(replica.migrations) != m.total("gang_migrations_total"):
        raise AssertionError(f"{tag}: {len(replica.migrations)} replica migrations != "
                             f"{m.total('gang_migrations_total')} gang migrations")
    return out, counts


TP_REQ, TP_PROMPT, TP_NEW, TP_SLOTS, TP_SEQ = 4, 128, 16, 4, 256
TP_SHRINK_AFTER, TP_GROW_AFTER = 4, 4   # decode steps before the shrink, then before the grow
TP_PEAK_LIMIT = 40e9                    # both ranks' peak device memory together


def record_rows(engine, rows: dict) -> None:
    """Keep every logits row ``engine`` picks a token from, keyed (request
    id, index of the token in its stream), on the host at float32."""
    vocab = engine.cfg.vocab_size
    into_slot, decode = engine._context_into_slot, engine._decode_active

    def admitted(slot, req, context):
        logits = into_slot(slot, req, context)
        if logits is not None:
            rows[req.id, len(req.generated)] = logits[0, :vocab].float().cpu()
        return logits

    def stepped(pos):
        logits = decode(pos)
        for slot, req in engine.batcher.active().items():
            rows[req.id, len(req.generated)] = logits[slot, :vocab].float().cpu()
        return logits

    engine._context_into_slot, engine._decode_active = admitted, stepped


def near_tie_rule(tag: str, got: dict, ref: dict, got_rows: dict, ref_rows: dict) -> dict:
    """Streams ``got`` against the one-rank leg's ``ref``: equal, or each
    request diverging only where the one-rank leg's top-2 margin is within
    the legs' measured logit disagreement (the largest difference of two
    rows picked after the same context). Returns the disagreement and the
    divergences."""
    same_context = [k for k in ref_rows if k in got_rows
                    and got[k[0]][:k[1]] == ref[k[0]][:k[1]]]
    disagreement = max(float((got_rows[k] - ref_rows[k]).abs().max()) for k in same_context)
    divergences = []
    for rid, want in ref.items():
        i = _common_prefix(got[rid], want)
        if i == len(want) and len(got[rid]) == len(want):
            continue
        top2 = torch.topk(ref_rows[rid, i], 2).values
        margin = float(top2[0] - top2[1])
        divergences.append({"request": rid, "index": i, "got": got[rid][i], "one_rank": want[i],
                            "one_rank_margin": margin,
                            "got_logit_gap": float(got_rows[rid, i][got[rid][i]]
                                                   - got_rows[rid, i][want[i]])})
        if margin > disagreement:
            raise AssertionError(f"{tag}: request {rid} diverges at token {i} ({got[rid][i]} "
                                 f"against {want[i]}) where the one-rank leg's top-2 margin "
                                 f"{margin} exceeds the legs' disagreement {disagreement}")
    print(f"{tag}: rows of the same context {len(same_context)}, largest logit difference "
          f"{disagreement:.4e}; divergences {divergences or 'none'}")
    return {"disagreement": disagreement, "divergences": divergences}


def tp_bf16_logits(tag: str, tp: torch.Tensor, one: torch.Tensor, f32: torch.Tensor,
                   gate: bool = True) -> dict:
    """One admission's bf16 logits of the TP leg and of the one-rank leg,
    each beside the float32 prefill on the same (bf16) weights. Two bf16
    programs that round in other places (cuBLAS picks its kernels by the
    per-rank shapes) part by bf16 noise amplified over 36 layers: the legs
    differ element-wise by up to ~6e-2, beyond the one-kernel bf16
    tolerance at a few logits near 0 (recorded, not gated; ROADMAP §3),
    while each is ~1.5% (relative L2) from float32. The gate: the TP leg no
    farther from float32 than the one-rank leg, but for the bf16
    tolerance's 5e-2 of that distance (with ``gate``; else recorded)."""
    d = (tp - one).abs()
    tol = TOL[torch.bfloat16]
    beyond = int((d > tol[0] + tol[1] * one.abs()).sum())
    out = {"max_abs": float(d.max()), "beyond_bf16_tol": beyond,
           "rel_l2": float(d.norm() / one.norm()),
           "tp_to_f32_rel_l2": float((tp - f32).norm() / f32.norm()),
           "one_to_f32_rel_l2": float((one - f32).norm() / f32.norm()),
           "tp_to_f32_max_abs": float((tp - f32).abs().max()),
           "one_to_f32_max_abs": float((one - f32).abs().max())}
    print(f"{tag} admission logits bf16: TP 2 against one rank max abs {out['max_abs']:.4e} "
          f"({out['beyond_bf16_tol']} of {d.numel()} beyond atol={tol[0]} rtol={tol[1]}), rel "
          f"L2 {out['rel_l2']:.4e}; against the float32 prefill: TP 2 "
          f"{out['tp_to_f32_max_abs']:.4e} / rel L2 {out['tp_to_f32_rel_l2']:.4e}, one rank "
          f"{out['one_to_f32_max_abs']:.4e} / "
          f"rel L2 {out['one_to_f32_rel_l2']:.4e}; |logit| max {float(f32.abs().max()):.3f}")
    if gate and out["tp_to_f32_rel_l2"] > out["one_to_f32_rel_l2"] * (1 + tol[1]):
        raise AssertionError(f"{tag}: the TP leg's bf16 logits are farther from float32 "
                             f"({out['tp_to_f32_rel_l2']:.4e}) than the one-rank leg's "
                             f"({out['one_to_f32_rel_l2']:.4e}) allow")
    return out


def tp_rank(tp, seed: int, prompts) -> dict:
    """One rank of the tp phase (started by ``spawn_tp``): full-width,
    full-depth qwen2.5-3b from the seeded ``init_params`` (bf16, the values
    of the one-rank leg's bf16 copy), this rank's shard kept, the rest
    freed. Rank 0 drives the replica: leg A serves the requests at 2
    ranks with the collectives timed (a synchronisation around each), leg
    B serves them again, shrinking 2 -> 1 after ``TP_SHRINK_AFTER`` steps
    and growing 1 -> 2 ``TP_GROW_AFTER`` steps later; rank 1 follows. Each
    rank returns its launches (read just after the legs), passes and peak
    memory; rank 0 also the streams, the logits rows and the resizes."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(with_kernel_impls(get_config("qwen2.5-3b"), "auto"),
                              param_dtype="bfloat16")
    out = {"rank": tp.rank, "backend": tp.backend, "device": str(tp.device)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), tp.device)
    rep = ElasticReplica(cfg, full, 2, n_slots=TP_SLOTS, max_seq=TP_SEQ, tp=tp)
    del full
    gc.collect()
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0, init_peak_bytes=torch.cuda.max_memory_allocated(),
               shard_bytes=M.nbytes(rep.params), whole_bytes=rep.param_bytes)
    reset_launch_counts()
    tpar.reset_stats()
    peak = [out["init_peak_bytes"]]
    with _CountPrefills() as passes:
        if tp.rank != 0:
            rep.follow()
        else:
            legs = {}
            for leg in ("A", "B"):
                rows, walls, coll, resizes = {}, [], [], []
                tpar.time_collectives(leg == "A")
                record_rows(rep.engine, rows)
                reqs = [GenRequest(id=i, prompt=p, max_new=TP_NEW) for i, p in enumerate(prompts)]
                for r in reqs:
                    rep.add(r)
                plan = ({TP_SHRINK_AFTER: 1, TP_SHRINK_AFTER + TP_GROW_AFTER: 2}
                        if leg == "B" else {})
                steps = 0
                while rep.batcher.active():
                    if steps in plan:
                        torch.cuda.synchronize()
                        mem0 = torch.cuda.memory_allocated()
                        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
                        torch.cuda.reset_peak_memory_stats()
                        rec = rep.resize(plan.pop(steps))
                        torch.cuda.synchronize()
                        resizes.append({"record": dataclasses.asdict(rec), **rep.last_resize,
                                        "allocated_before_bytes": mem0,
                                        "allocated_after_bytes": torch.cuda.memory_allocated(),
                                        "peak_bytes": torch.cuda.max_memory_allocated(),
                                        "param_devices": sorted({str(t.device) for t in
                                                                 M.tree_leaves(rep.params)})})
                        record_rows(rep.engine, rows)
                    c0 = tpar.STATS["seconds"]
                    t = time.perf_counter()
                    rep.step()   # ends in a host copy of the picked tokens
                    walls.append((rep.mesh_size, 1e3 * (time.perf_counter() - t)))
                    coll.append(1e3 * (tpar.STATS["seconds"] - c0))
                    steps += 1
                legs[leg] = {"streams": {r.id: list(r.generated) for r in rep.run()}, "rows": rows,
                             "step_ms": walls, "collective_ms": coll, "resizes": resizes}
            tpar.time_collectives(False)
            rep.close()
            out["legs"] = legs
        out["counts"], out["forms"] = launch_counts(), rmsnorm_form_counts()
    out["passes"] = {"prefills": passes.n, "steps": passes.steps}
    out["collectives"] = dict(tpar.STATS)
    out["peak_bytes"] = max(peak[0], torch.cuda.max_memory_allocated())
    # float32 prefills on the same (bf16-valued) shards, every rank: the
    # logits the one-rank leg's float32 prefill is held against
    c32 = dataclasses.replace(cfg, dtype="float32")
    out["f32_logits"] = [M.prefill(rep.params, {"tokens": torch.tensor([p], device=tp.device)},
                                   c32, rep.mesh.tp)[0][0, :cfg.vocab_size].cpu()
                         for p in prompts]
    if tp.rank == 0:
        # the flash kernel at this rank's prefill shape against its plain
        # version (after the counts: a comparison is no launch of the path)
        from repro_torch.kernels.ops import flash_attention_op
        from repro_torch.kernels.ref import flash_attention_ref
        gen = torch.Generator(device="cuda").manual_seed(seed + 5)
        q, k, v = (torch.randn(1, TP_PROMPT, n, 128, device="cuda", generator=gen)
                   .to(torch.bfloat16).transpose(1, 2) for n in (8, 1, 1))
        out["flash_err"] = check_close("tp rank flash (b=1,h=8,kv=1,s=128,d=128) bf16",
                                       flash_attention_op(q, k, v, causal=True),
                                       flash_attention_ref(q, k, v, causal=True),
                                       TOL[torch.bfloat16])
    del rep
    return out


def nccl_rank(tp) -> dict:
    """A group of one rank with a card of its own: ``backend_for`` picks
    NCCL; one all-reduce and one broadcast on the card through it."""
    import torch.distributed as dist
    x = torch.arange(8, dtype=torch.float32, device=tp.device)
    dist.all_reduce(x, group=tp.group)
    dist.broadcast(x, src=0, group=tp.group)
    torch.cuda.synchronize()
    return {"backend": tp.backend, "devices": [str(d) for d in tp.devices],
            "nccl_version": str(torch.cuda.nccl.version()),
            "sum": float(x.sum())}


def tp_phase(cfg, params, seed: int):
    """Physical tensor parallelism on the card: two ranks on the one card
    (gloo, by ``backend_for``) serve full-width, full-depth qwen2.5-3b at
    TP 2 (leg A), and again shrinking 2 -> 1 and growing 1 -> 2 mid-stream
    with ``migrate`` (leg B), against the one-rank replica on the same
    weights in this process: the admission logits within the bf16
    tolerance, the streams equal or split only at a near tie
    (:func:`near_tie_rule`); the kernels' launches on each rank as
    counted; both ranks' peak memory together at most ``TP_PEAK_LIMIT``;
    then a group of one rank over NCCL. Returns (launches by path, the
    phase's numbers)."""
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.distributed.tensor_parallel import spawn_tp
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 23)
    prompts = rng.integers(0, cfg.vocab_size, size=(TP_REQ, TP_PROMPT)).tolist()
    print(f"tp: {cfg.arch_id} full width and depth, {TP_REQ} requests of {TP_PROMPT} + "
          f"{TP_NEW} new, {TP_SLOTS} slots, max_seq {TP_SEQ}; 2 ranks on one card, a rank "
          f"{cfg.n_heads // 2} query heads on {max(1, cfg.n_kv_heads // 2)} KV head, d_ff "
          f"{cfg.d_ff // 2}, vocabulary {cfg.vocab_padded // 2}")

    # the one-rank leg: the existing replica in this process, same weights
    rows, walls = {}, []
    rep = ElasticReplica(cfg, params, 1, n_slots=TP_SLOTS, max_seq=TP_SEQ, device="cuda")
    record_rows(rep.engine, rows)
    reset_launch_counts()
    with _CountPrefills() as prefills:
        for i, p in enumerate(prompts):
            rep.add(GenRequest(id=i, prompt=p, max_new=TP_NEW))
        while rep.batcher.active():
            t = time.perf_counter()
            rep.step()
            walls.append(1e3 * (time.perf_counter() - t))
    counts, forms = launch_counts(), rmsnorm_form_counts()
    one = {r.id: list(r.generated) for r in rep.run()}
    steps = rep.engine.n_decode_steps
    # float32 prefills on the bf16 values the engine serves
    c32 = dataclasses.replace(cfg, dtype="float32")
    one32 = [M.prefill(rep.engine.params, {"tokens": torch.tensor([p], device="cuda")},
                       c32)[0][0, :cfg.vocab_size].cpu() for p in prompts]
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    paths = {"tp one rank": check_counts(
        "tp one rank", cfg, counts, forms,
        dict(forward_counts(cfg, prefills.n + steps), flash_attention=cfg.n_layers * prefills.n),
        prefills.n + steps)}

    t1 = time.perf_counter()
    ranks = spawn_tp(tp_rank, 2, device="cuda:0", args=(seed, prompts), timeout=300)
    spawn_s = time.perf_counter() - t1
    r0 = ranks[0]
    for r in ranks:
        n = r["passes"]["prefills"] + r["passes"]["steps"]
        paths[f"tp rank {r['rank']}"] = check_counts(
            f"tp rank {r['rank']}", cfg, r["counts"], r["forms"],
            dict(forward_counts(cfg, n), flash_attention=cfg.n_layers * r["passes"]["prefills"]),
            n)
        print(f"tp rank {r['rank']}: backend {r['backend']} on {r['device']}, init "
              f"{r['init_s']:.2f} s, shard {r['shard_bytes']} of {r['whole_bytes']} parameter "
              f"bytes, peak {r['peak_bytes']} bytes (init {r['init_peak_bytes']}), passes "
              f"{r['passes']}, collectives {r['collectives']}")
        if r["backend"] != "gloo":
            raise AssertionError(f"tp: two ranks on one card took {r['backend']}, not gloo")
    peak = sum(r["peak_bytes"] for r in ranks)
    print(f"tp: both ranks' peak device memory {peak} bytes (limit {TP_PEAK_LIMIT:.0f})")
    if peak > TP_PEAK_LIMIT:
        raise AssertionError(f"tp: the ranks' peaks {peak} bytes exceed {TP_PEAK_LIMIT:.0f}")

    kv_total = elastic_shape_bytes(cfg, TP_SLOTS, TP_SEQ)[1]
    out = {"one_rank_step_ms": statistics.median(walls), "spawn_s": spawn_s, "peak_bytes": peak,
           "rank_peak_bytes": [r["peak_bytes"] for r in ranks], "flash_err": r0["flash_err"],
           "shard_bytes": [r["shard_bytes"] for r in ranks]}
    f32_err = [check_close(f"tp f32 prefill request {rid}, 2 ranks against one",
                           r0["f32_logits"][rid], one32[rid], SLICE_TOL) for rid in range(TP_REQ)]
    print(f"tp: float32 prefill logits on the served bf16 values, 2 ranks against one: max abs "
          f"err {max(f32_err):.3e} (atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]})")
    for leg, label in (("A", "tp 2"), ("B", "tp 2 -> 1 -> 2")):
        got = r0["legs"][leg]
        bf16 = [tp_bf16_logits(f"tp leg {leg} request {rid}", got["rows"][rid, 0], rows[rid, 0],
                               one32[rid]) for rid in range(TP_REQ)]
        rule = near_tie_rule(f"tp leg {leg} ({label})", got["streams"], one, got["rows"], rows)
        tp2 = [ms for size, ms in got["step_ms"] if size == 2]
        tp1 = [ms for size, ms in got["step_ms"] if size == 1]
        summary = {"streams_equal": got["streams"] == one, **rule, "admission_logits": bf16,
                   "step_ms_tp2": statistics.median(tp2),
                   "step_ms_tp1": statistics.median(tp1) if tp1 else None,
                   "resizes": got["resizes"]}
        if leg == "A":
            summary["collective_ms_per_step"] = statistics.median(got["collective_ms"])
            summary["collective_share"] = sum(got["collective_ms"]) / sum(tp2)
        out[f"leg_{leg}"] = summary
        print(f"tp leg {leg} ({label}): decode step median {summary['step_ms_tp2']:.2f} ms at "
              f"2 ranks, {summary['step_ms_tp1']} ms at 1 (the one-rank leg "
              f"{out['one_rank_step_ms']:.2f} ms)" + (
                  f"; collectives {summary['collective_ms_per_step']:.2f} ms a step, "
                  f"{summary['collective_share']:.3f} of the steps (a synchronisation "
                  f"around each)" if leg == "A" else ""))
        if any(len(t) != TP_NEW for t in (*got["streams"].values(), *one.values())):
            raise AssertionError(f"tp leg {leg}: a stream is not {TP_NEW} long")
        for rz in got["resizes"]:
            rec = rz["record"]
            frac = abs(rec["n_before"] - rec["n_after"]) / max(rec["n_before"], rec["n_after"])
            want = {"param_bytes": int(r0["whole_bytes"] * frac), "kv_bytes": int(kv_total * frac)}
            if {k: rec[k] for k in want} != want:
                raise AssertionError(f"tp leg {leg}: record bytes {rec} against the shapes' {want}")
            print(f"tp leg {leg}: {rec['n_before']} -> {rec['n_after']} ranks, wall "
                  f"{rec['wall_s'] * 1e3:.1f} ms, gathered {rz['gathered_bytes']} bytes, "
                  f"shipped {rz['shipped_bytes']} bytes, record bytes {rec['param_bytes']} + "
                  f"{rec['kv_bytes']}, allocated {rz['allocated_before_bytes']} -> "
                  f"{rz['allocated_after_bytes']} (peak {rz['peak_bytes']}), parameters on "
                  f"{rz['param_devices']}")
            if rz["param_devices"] != ["cuda:0"]:
                raise AssertionError(f"tp: parameters on {rz['param_devices']} after a resize")

    nccl = spawn_tp(nccl_rank, 1, device="cuda:0", timeout=120)[0]
    print(f"tp: a group of one rank on {nccl['devices']} took {nccl['backend']} (NCCL "
          f"{nccl['nccl_version']}), all-reduce and broadcast sum {nccl['sum']}")
    if nccl["backend"] != "nccl" or nccl["sum"] != 28.0:
        raise AssertionError(f"tp: the NCCL group of one rank gave {nccl}")
    out["nccl"] = nccl
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"tp: phase wall {out['phase_wall_s']:.2f} s (the ranks {spawn_s:.2f} s)")
    return paths, out


# --- tensor parallelism from shards: the tp moe and tp ssm phases ----------------------
# deepseek's resize leg: 1 dense + 3 moe layers of its 27 (see tp_moe_phase). At
# full depth it fits since the resize moves leaf by leaf (PERF.md §4), but
# moves 15.7 GB each way through host memory: the phase took 98 s against 48
TPM_CUT = 4
TPM_MIXTRAL = 4   # mixtral's layers of its 56, as the moe phase serves it
# a rank's serving peak above its shards (caches, activations, the float32
# prefills' casts of one layer's weights), and the slack of a rank's init
# peak beyond its shards and one whole leaf at float32 with its redraw mask
TP_SERVE_SLACK, TP_INIT_SLACK = 3e9, 2e9


class RouteProbe:
    """Every MoE layer's routing of the rows of each pass an engine runs,
    keyed (request id, index of the token in its stream) as
    :func:`record_rows` keys the logits: the picks and the top ``k + 1``
    router probabilities of the rows, kept on the device until
    :meth:`host` reads them. The probabilities are computed again beside
    ``route`` (a product and a softmax a layer; no kernel of the port)."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self.calls, self.current = {}, None
        self._mod, self._orig = moe_mod, moe_mod.route

        def probed(router_w, x, cfg, dp=None):
            out = self._orig(router_w, x, cfg, dp)
            if self.current is not None:
                top = torch.topk(torch.softmax(x.float() @ router_w.float(), dim=-1),
                                 cfg.top_k + 1).values
                for key, rows in self.current:
                    self.calls.setdefault(key, []).append((out[1][rows], top[rows]))
            return out
        moe_mod.route = probed
        return self

    def __exit__(self, *exc):
        self._mod.route = self._orig

    def host(self) -> dict:
        """{key: [(picks (rows, k), top probabilities (rows, k+1)) a layer]}
        on the host, each row's picks sorted."""
        return {k: [(i.reshape(-1, i.shape[-1]).sort(-1).values.cpu(),
                     p.reshape(-1, p.shape[-1]).float().cpu()) for i, p in v]
                for k, v in self.calls.items()}


def probe_passes(engine, probe: "RouteProbe") -> None:
    """Point ``probe`` at the rows of each pass of ``engine``: an admission's
    context rows, a decode step's row of each active slot (after
    :func:`record_rows`, around its wrappers)."""
    into_slot, decode = engine._context_into_slot, engine._decode_active

    def admitted(slot, req, context):
        probe.current = [((req.id, len(req.generated)), slice(None))]
        try:
            return into_slot(slot, req, context)
        finally:
            probe.current = None

    def stepped(pos):
        probe.current = [((req.id, len(req.generated)), slot)
                         for slot, req in engine.batcher.active().items()]
        try:
            return decode(pos)
        finally:
            probe.current = None

    engine._context_into_slot, engine._decode_active = admitted, stepped


def route_flips(got: dict, ref: dict, keys) -> tuple:
    """Over the passes ``keys`` (run on the same context by both legs), in
    stream order: the first layer of each pass where the legs' picks
    differ, with the reference leg's router margin there (its k-th
    probability less its (k+1)-th at the first row that differs), and the
    legs' router disagreement: the largest difference of their top k+1
    probabilities over the rows whose picks agree, in the layers up to and
    including the first differing one, in the passes of a request before
    any pick of it differed (the rounding noise of one function, not of two
    routings). Returns (flips {key: {...}}, disagreement)."""
    flips, disagreement, flipped = {}, 0.0, set()
    for key in sorted(k for k in keys if k in got and k in ref):
        for layer, ((gi, gp), (ri, rp)) in enumerate(zip(got[key], ref[key])):
            differ = (gi != ri).any(-1)
            if key[0] not in flipped and not bool(differ.all()):
                disagreement = max(disagreement, float((gp - rp)[~differ].abs().max()))
            if bool(differ.any()):
                row = int(differ.nonzero()[0, 0])
                k = ri.shape[-1]
                flips[key] = {"layer": layer, "row": row,
                              "one_rank_margin": float(rp[row, k - 1] - rp[row, k]),
                              "got": gi[row].tolist(), "one_rank": ri[row].tolist()}
                break
        if key in flips:
            flipped.add(key[0])
    return flips, disagreement


def moe_near_tie_rule(tag: str, got: dict, ref: dict, got_rows: dict, ref_rows: dict,
                      got_routes: dict, ref_routes: dict) -> dict:
    """:func:`near_tie_rule` for a MoE model, where a router pick that
    differs between the legs changes every later row of its request: the
    streams ``got`` against the reference leg's ``ref`` are equal, or each
    request diverges only (1) where the reference's top-2 logit margin is
    within the legs' logit disagreement measured over the rows of the same
    context before any pick of the request differed, or (2) after a pick
    that differed where the reference's router margin is within the legs'
    router disagreement (:func:`route_flips`). Records every request's
    first differing pick and its router margin."""
    same = [k for k in ref_rows if k in got_rows and got[k[0]][:k[1]] == ref[k[0]][:k[1]]]
    flips, router_dis = route_flips(got_routes, ref_routes, same)

    def first_flip(rid, upto):
        return next((flips[rid, j] for j in range(upto + 1) if (rid, j) in flips), None)

    clean = [k for k in same if first_flip(*k) is None]
    logit_dis = max((float((got_rows[k] - ref_rows[k]).abs().max()) for k in clean), default=0.0)
    divergences = []
    for rid, want in ref.items():
        i = _common_prefix(got[rid], want)
        if i == len(want) and len(got[rid]) == len(want):
            continue
        top2 = torch.topk(ref_rows[rid, i], 2).values
        div = {"request": rid, "index": i, "got": got[rid][i], "one_rank": want[i],
               "one_rank_margin": float(top2[0] - top2[1]),
               "got_logit_gap": float(got_rows[rid, i][got[rid][i]]
                                      - got_rows[rid, i][want[i]]),
               "earlier_flip": first_flip(rid, i)}
        divergences.append(div)
        flip = div["earlier_flip"]
        if div["one_rank_margin"] <= logit_dis or (
                flip is not None and flip["one_rank_margin"] <= router_dis):
            continue
        raise AssertionError(f"{tag}: request {rid} diverges at token {i} ({got[rid][i]} "
                             f"against {want[i]}): the logit margin {div['one_rank_margin']} "
                             f"exceeds the legs' disagreement {logit_dis}, and no earlier "
                             f"router pick differs within the router disagreement "
                             f"{router_dis} ({flip})")
    firsts = {rid: min((j for r, j in flips if r == rid), default=None) for rid in ref}
    out = {"disagreement": logit_dis, "router_disagreement": router_dis,
           "divergences": divergences,
           "route_flips": {f"{rid}:{j}": flips[rid, j] for rid, j in firsts.items()
                           if j is not None}}
    print(f"{tag}: rows of the same context {len(same)} ({len(clean)} before any pick "
          f"differed), largest logit difference there {logit_dis:.4e}; router disagreement "
          f"{router_dis:.4e}; first differing picks {out['route_flips'] or 'none'}; "
          f"divergences {divergences or 'none'}")
    return out


def tp_config(arch: str, n_layers=None):
    """The full config of ``arch`` (cut to ``n_layers``) in bf16 under
    ``auto``, as the tp moe and tp ssm phases serve it."""
    from repro_torch.configs import get_config, with_kernel_impls
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16",
                              **({"n_layers": n_layers} if n_layers else {}))
    return with_kernel_impls(cfg, "auto")


def tp_expect(cfg, prefills: int, passes) -> dict:
    """The launches of ``passes`` (an int, or {ranks: passes}; ``prefills``
    of them admissions) on one rank: every norm on rmsnorm (a Mamba2
    mixer's gated norm in two passes on more than one rank), moe_gmm 3 a
    moe layer a pass, flash once a GQA layer an admission (none under MLA),
    ssd once a mamba layer an admission (a decode step runs the state
    update in PyTorch), mla_prefill once an MLA layer an admission."""
    return dict(forward_counts(cfg, passes),
                flash_attention=0 if cfg.use_mla else cfg.n_attn_layers * prefills,
                ssd=cfg.n_ssm_layers * prefills, mla_prefill=mla_kernel_layers(cfg) * prefills)


def tp_one_rank(tag: str, cfg, seed: int, prompts) -> tuple:
    """The one-rank leg in this process, first: the seeded bf16 weights in
    an ``ElasticReplica`` of one member serving ``prompts`` with every
    launch counted and every logits row and route recorded, then the
    float32 prefills on the served bf16 values; everything freed on
    return. Returns (launches, the leg's numbers)."""
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest

    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    rep = ElasticReplica(cfg, params, 1, n_slots=TP_SLOTS, max_seq=TP_SEQ, device="cuda")
    del params
    rows, walls = {}, []
    with RouteProbe() as probe, _CountPrefills() as passes:
        record_rows(rep.engine, rows)   # after _CountPrefills, which patches the class
        probe_passes(rep.engine, probe)
        reset_launch_counts()
        for i, p in enumerate(prompts):
            rep.add(GenRequest(id=i, prompt=p, max_new=TP_NEW))
        while rep.batcher.active():
            t = time.perf_counter()
            rep.step()
            walls.append(1e3 * (time.perf_counter() - t))
        counts, forms = launch_counts(), rmsnorm_form_counts()
    n = passes.n + passes.steps
    counts = check_counts(tag, cfg, counts, forms, tp_expect(cfg, passes.n, n), n)
    assert passes.by_ranks == {1: n}, passes.by_ranks
    streams = {r.id: list(r.generated) for r in rep.run()}
    c32 = dataclasses.replace(cfg, dtype="float32")
    f32 = [M.prefill(rep.engine.params, {"tokens": torch.tensor([p], device="cuda")},
                     c32)[0][0, :cfg.vocab_size].cpu() for p in prompts]
    out = {"streams": streams, "rows": rows, "routes": probe.host(), "f32": f32,
           "step_ms": statistics.median(walls), "peak_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": rep.param_bytes}
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag}: {passes.n} prefills, {passes.steps} decode steps, step median "
          f"{out['step_ms']:.2f} ms, peak {out['peak_bytes']} bytes")
    return counts, out


def tp_shard_rank(tp, seed: int, legs) -> dict:
    """One rank of the tp moe and tp ssm phases (started by ``spawn_tp``),
    each rank drawing only its shards. For each leg
    ``(name, arch, layers, prompts, plan)``: this rank's bf16 shards drawn
    by ``init_params(..., tp=tp)`` (the ranks in turn, so one rank draws
    while the other holds only its shards), an ``ElasticReplica`` over them
    (``sharded``); rank 0 serves the prompts at TP 2 (the collectives timed
    on a leg without a plan) and, for a leg with a plan ``{steps: gang
    size}``, serves them again resizing mid-stream; the other rank follows.
    Each rank returns its launches, passes, memory, logits rows and routes
    (rank 0), the float32 prefills on its shards (a leg without a plan)."""
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, arch, layers, prompts, plan in legs:
        cfg = tp_config(arch, layers)
        out = {"rank": tp.rank, "backend": tp.backend}
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for r in range(tp.size):   # one rank draws at a time
            if r == tp.rank:
                torch.cuda.reset_peak_memory_stats()
                shards = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                                       tp.device, tp=tp)
                torch.cuda.synchronize()
                out["init_peak_bytes"] = torch.cuda.max_memory_allocated()
                torch.cuda.empty_cache()
            dist.barrier()
        out["init_s"] = time.perf_counter() - t0
        out["card_used_bytes"] = torch.cuda.mem_get_info()[1] - torch.cuda.mem_get_info()[0]
        rep = ElasticReplica(cfg, shards, 2, n_slots=TP_SLOTS, max_seq=TP_SEQ, tp=tp,
                             sharded=True)
        del shards
        out.update(shard_bytes=M.nbytes(rep.params), whole_bytes=rep.param_bytes,
                   largest_leaf=max(int(np.prod(s.shape)) for s in
                                    M.tree_leaves(M.param_specs(cfg))),
                   largest_layer_bytes=largest_layer_leaf(cfg) * cfg.param_torch_dtype.itemsize)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        tpar.reset_stats()
        runs = [{}] if not plan else [{}, dict(plan)]
        with RouteProbe() as probe, _CountPrefills() as passes:
            out["routes"] = None
            if tp.rank != 0:   # its picks, to hold against rank 0's
                probe_passes(rep.engine, probe)
                rep.follow()
                out["routes"] = probe.host()
            else:
                out["runs"] = []
                for run in runs:
                    rows, walls, coll, resizes = {}, [], [], []
                    probe.calls = {}
                    tpar.time_collectives(not plan)
                    record_rows(rep.engine, rows)
                    probe_passes(rep.engine, probe)
                    for i, p in enumerate(prompts):
                        rep.add(GenRequest(id=i, prompt=p, max_new=TP_NEW))
                    steps = 0
                    while rep.batcher.active():
                        if steps in run:
                            torch.cuda.synchronize()
                            mem0 = torch.cuda.memory_allocated()
                            rec = rep.resize(run.pop(steps))
                            torch.cuda.synchronize()
                            resizes.append({"record": dataclasses.asdict(rec), **rep.last_resize,
                                            "allocated_before_bytes": mem0,
                                            "allocated_after_bytes":
                                                torch.cuda.memory_allocated()})
                            record_rows(rep.engine, rows)
                            probe_passes(rep.engine, probe)
                        c0 = tpar.STATS["seconds"]
                        t = time.perf_counter()
                        rep.step()   # ends in a host copy of the picked tokens
                        walls.append((rep.mesh_size, 1e3 * (time.perf_counter() - t)))
                        coll.append(1e3 * (tpar.STATS["seconds"] - c0))
                        steps += 1
                    out["runs"].append({
                        "streams": {r.id: list(r.generated) for r in rep.run()}, "rows": rows,
                        "routes": probe.host(), "step_ms": walls, "collective_ms": coll,
                        "resizes": resizes})
                tpar.time_collectives(False)
                rep.close()
            out["counts"], out["forms"] = launch_counts(), rmsnorm_form_counts()
        out["passes"] = {"prefills": passes.n, "steps": passes.steps,
                         "by_ranks": dict(passes.by_ranks)}
        out["collectives"] = dict(tpar.STATS)
        out["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
        if not plan:
            # float32 prefills on the same (bf16-valued) shards, every rank
            c32 = dataclasses.replace(cfg, dtype="float32")
            out["f32_logits"] = [
                M.prefill(rep.params, {"tokens": torch.tensor([p], device=tp.device)}, c32,
                          rep.mesh.tp)[0][0, :cfg.vocab_size].cpu() for p in prompts]
        del rep
        results[name] = out
    return results


def tp_moe_kernels(gen: torch.Generator) -> dict:
    """The kernels at this phase's per-rank shapes, each against its plain
    version and timed beside its library yardstick: moe_gmm (bf16, the
    capacity path's (E_local, cap, D) buffers) for deepseek's 32 of 64
    experts (2048 -> 1408; its decode wave, its 128- and 512-token
    admissions), mixtral's 4 of 8 experts (6144 -> 16384) and the
    in-expert cut of mixtral's 8 experts over 2 ranks (6144 -> 8192), each
    at a decode wave and a 128-token admission, both row tiles; flash at
    mixtral's rank shape, 24 query heads on 4 KV heads, window 4096."""
    from repro_torch.kernels.moe_gmm import row_tile
    from repro_torch.kernels.ops import flash_attention_op, moe_gmm_op
    from repro_torch.kernels.ref import flash_attention_ref, moe_gmm_tiles_ref

    out = {"moe_gmm": {}, "err": 0.0}
    # (label, experts a rank, cap, D, F): cap from the GLOBAL expert count,
    # 4 tokens a decode wave, 128 (and for deepseek 512) an admission
    cases = (("deepseek EP decode", 32, 8, 2048, 1408),
             ("deepseek EP decode w_down", 32, 8, 1408, 2048),
             ("deepseek EP prefill 128", 32, 16, 2048, 1408),
             ("deepseek EP prefill 512", 32, 64, 2048, 1408),
             ("mixtral EP decode", 4, 8, 6144, 16384),
             ("mixtral EP prefill 128", 4, 40, 6144, 16384),
             ("in-expert decode", 8, 8, 6144, 8192),
             ("in-expert prefill 128", 8, 40, 6144, 8192))
    for label, e, cap, d, f in cases:
        t = e * cap
        lhs = torch.randn(t, d, device="cuda", generator=gen).to(torch.bfloat16)
        rhs = (torch.randn(e, d, f, device="cuda", generator=gen) * d ** -0.5).to(torch.bfloat16)
        te = torch.arange(e, device="cuda", dtype=torch.int32)
        name = f"moe_gmm {label} lhs ({t},{d}) rhs ({e},{d},{f}) block_t {cap} bf16"
        err = check_close(name, moe_gmm_op(lhs, rhs, te, block_t=cap),
                          moe_gmm_tiles_ref(lhs, rhs, te, cap), TOL[torch.bfloat16])
        buf = lhs.view(e, cap, d)
        check_close(f"{name} library yardstick (torch.bmm) vs plain",
                    torch.bmm(buf, rhs).reshape(t, f), moe_gmm_tiles_ref(lhs, rhs, te, cap),
                    TOL[torch.bfloat16])
        out["err"] = max(out["err"], err)
        bound, by = gmm_bound(lhs, rhs, te)
        tm = time_three(lambda: moe_gmm_op(lhs, rhs, te, block_t=cap),
                        lambda: moe_gmm_tiles_ref(lhs, rhs, te, cap),
                        lambda: torch.bmm(buf, rhs), plain_graph=False)
        tm.update(bound_ms=bound, bound_by=by, err=err,
                  shape=f"{label}: lhs ({t},{d}) rhs ({e},{d},{f}) block_t {cap} bf16, "
                        f"{row_tile(t, e)}-row tiles; library: torch.bmm over the capacity "
                        f"buffer")
        report(f"moe_gmm {label}", tm)
        out["moe_gmm"][label] = tm
        del lhs, rhs, buf
    b, h, kv, s, dd, window = 1, 24, 4, 128, 128, 4096
    q, k, v = (torch.randn(b, s, n, dd, device="cuda", generator=gen).to(torch.bfloat16)
               .transpose(1, 2) for n in (h, kv, kv))
    err = check_close("flash mixtral rank (b=1,h=24,kv=4,s=128,d=128) window 4096 bf16",
                      flash_attention_op(q, k, v, causal=True, window=window),
                      flash_attention_ref(q, k, v, causal=True, window=window),
                      TOL[torch.bfloat16])
    k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
    bound, by = flash_bound(b, h, kv, s, dd, torch.bfloat16, causal=True, window=window)
    tm = time_three(lambda: flash_attention_op(q, k, v, causal=True, window=window),
                    lambda: flash_attention_ref(q, k, v, causal=True, window=window),
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k_rep, v_rep, is_causal=True))
    tm.update(bound_ms=bound, bound_by=by, err=err,
              shape=f"q ({b},{h},{s},{dd}) kv {kv} causal window {window} bf16 (window > S); "
                    f"library: SDPA causal, K/V repeated")
    report("flash_attention mixtral rank", tm)
    out["flash_attention"] = tm
    out["err"] = max(out["err"], err)
    return out


def tp_gate(tag: str, cfg, one: dict, r0: dict, got: dict, leg_ranks) -> dict:
    """The gates of one served leg against its reference leg ``one``: the
    float32 prefills (where the ranks ran them), the bf16 admissions, the
    streams (:func:`moe_near_tie_rule`), each rank's launches."""
    summary = {}
    if "f32_logits" in r0:
        errs = [check_close(f"{tag} f32 prefill request {rid}, 2 ranks against one",
                            r0["f32_logits"][rid], one["f32"][rid], SLICE_TOL)
                for rid in range(len(one["f32"]))]
        summary["f32_max_abs_err"] = max(errs)
        print(f"{tag}: float32 prefill logits on the served bf16 values, 2 ranks against one: "
              f"max abs err {max(errs):.3e} (atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]})")
        # gated without experts (PR 23's rule); with experts recorded, not
        # gated: a router pick that differs in a bf16 admission changes its
        # logits beyond rounding
        differ = route_flips(got["routes"], one["routes"],
                             [(rid, 0) for rid in range(len(one["f32"]))])[0]
        summary["admission_logits"] = [
            dict(tp_bf16_logits(f"{tag} request {rid}", got["rows"][rid, 0],
                                one["rows"][rid, 0], one["f32"][rid], gate=not cfg.n_experts),
                 picks_differ=(rid, 0) in differ) for rid in range(len(one["f32"]))]
    summary.update(moe_near_tie_rule(tag, got["streams"], one["streams"], got["rows"],
                                     one["rows"], got["routes"], one["routes"]))
    summary["streams_equal"] = got["streams"] == one["streams"]
    if any(len(t) != TP_NEW for t in got["streams"].values()):
        raise AssertionError(f"{tag}: a stream is not {TP_NEW} long")
    counts = {}
    for r in leg_ranks:
        n = r["passes"]["by_ranks"]
        counts[f"{tag} rank {r['rank']}"] = check_counts(
            f"{tag} rank {r['rank']}", cfg, r["counts"], r["forms"],
            tp_expect(cfg, r["passes"]["prefills"], n), n)
    return summary, counts


def layer_lead(names, cfg) -> tuple:
    """The layer axes that lead the parameter leaf at ``names``, counted
    from the config as ``init_params`` stacks them: a segment's layers, a
    hybrid group's mamba leaves (groups, then the ``attn_every`` mamba
    layers of a group), none for the hybrid's shared block or a leaf
    outside the stack."""
    if names[0] != "stack":
        return ()
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.attn_every, cfg.attn_every) if names[2] == "mamba" else ()
    if cfg.family == "moe":
        dense = cfg.first_dense_layers
        return (dense,) if names[1] == "dense0" else (cfg.n_layers - dense,)
    return (cfg.n_layers,)


def largest_layer_leaf(cfg) -> int:
    """Elements of the largest layer of one parameter leaf of ``cfg`` (a
    stacked leaf's one layer, a leaf outside the stack whole): the most a
    leaf-by-leaf resize holds whole at once."""
    from repro_torch.distributed.sharding import map_with_names
    from repro_torch.models import model as M
    sizes = []

    def one(names, t):
        lead = layer_lead(names, cfg)
        if tuple(t.shape[:len(lead)]) != lead:
            raise AssertionError(f"{'.'.join(names)}: shape {tuple(t.shape)} does not lead "
                                 f"with the layers {lead}")
        sizes.append(t.numel() // max(int(np.prod(lead)), 1))
    map_with_names(one, M.params_meta(cfg))
    return max(sizes)


def tp_leg(tag: str, cfg, rs, one, resize: bool) -> tuple:
    """The checks of one leg that ``tp_shard_rank`` served on 2 ranks (``rs``,
    each rank's results), against the one-rank leg ``one`` (None for a
    leg with a resize, held against its own unbroken run): each rank's
    init and serving peaks against limits from its shard bytes (a resize
    also holds the gathered whole tree), a rank's share of the whole tree,
    both ranks' peaks together, the ranks' routes alike, the gates of
    :func:`tp_gate` and, with ``resize``, the records' bytes against
    the shapes'; the decode steps' times and the collectives' share.
    Returns (summary, launches by path)."""
    r0 = rs[0]
    for r in rs:
        if r["backend"] != "gloo":
            raise AssertionError(f"{tag}: two ranks on one card took {r['backend']}")
        init_limit = r["shard_bytes"] + 5 * r["largest_leaf"] + TP_INIT_SLACK
        # a resize (2 -> 1 -> 2) moves leaf by leaf: a rank holds its old
        # shards, its new ones (rank 0 the whole tree at 1 rank, rank 1
        # nothing) and one whole layer of one leaf, with its gathered parts
        held = r["shard_bytes"] + ((r["whole_bytes"] if r["rank"] == 0 else 0)
                                   + 2 * r["largest_layer_bytes"] if resize else 0)
        serve_limit = held + TP_SERVE_SLACK
        why = (f": the old and new shards, twice a layer of the largest leaf "
               f"({r['largest_layer_bytes']} bytes)" if resize else "")
        print(f"{tag} rank {r['rank']}: init {r['init_s']:.2f} s, shard {r['shard_bytes']} "
              f"of {r['whole_bytes']} parameter bytes, init peak {r['init_peak_bytes']} "
              f"(limit {init_limit:.0f}: the shards, one whole leaf of "
              f"{r['largest_leaf']} elements at float32 and its mask, "
              f"{TP_INIT_SLACK:.0f}), serving peak {r['serve_peak_bytes']} (limit "
              f"{serve_limit:.0f}{why}, slack {TP_SERVE_SLACK:.0f}), card in use after both "
              f"inits {r['card_used_bytes']}, "
              f"passes {r['passes']}, collectives {r['collectives']}")
        if r["init_peak_bytes"] > init_limit or r["serve_peak_bytes"] > serve_limit:
            raise AssertionError(f"{tag} rank {r['rank']}: peaks {r['init_peak_bytes']} / "
                                 f"{r['serve_peak_bytes']} over {init_limit} / "
                                 f"{serve_limit}")
        if r["shard_bytes"] * 2 > r["whole_bytes"] * 1.1:
            raise AssertionError(f"{tag}: a rank holds {r['shard_bytes']} of "
                                 f"{r['whole_bytes']} bytes")
    both = sum(r["serve_peak_bytes"] for r in rs)
    both_limit = (r0["whole_bytes"] * (2 if resize else 1) + sum(
        r["shard_bytes"] for r in rs) * 0.1 + 2 * TP_SERVE_SLACK
        + (4 * r0["largest_layer_bytes"] if resize else 0))
    print(f"{tag}: both ranks' serving peaks {both} bytes (limit {both_limit:.0f})")
    if both > both_limit:
        raise AssertionError(f"{tag}: both ranks' serving peaks {both} > {both_limit}")
    summary = {"rank_init_peak_bytes": [r["init_peak_bytes"] for r in rs],
               "rank_serve_peak_bytes": [r["serve_peak_bytes"] for r in rs],
               "shard_bytes": [r["shard_bytes"] for r in rs],
               "whole_bytes": r0["whole_bytes"], "init_s": [r["init_s"] for r in rs]}
    if resize:
        unbroken, resized = r0["runs"]
        gate, counts = tp_gate(tag, cfg, unbroken, {}, resized, rs)
        kv_total = tp_cache_bytes(cfg)
        for rz in resized["resizes"]:
            rec = rz["record"]
            frac = abs(rec["n_before"] - rec["n_after"]) / max(rec["n_before"],
                                                                rec["n_after"])
            want = {"param_bytes": int(r0["whole_bytes"] * frac),
                    "kv_bytes": int(kv_total * frac)}
            if {k: rec[k] for k in want} != want:
                raise AssertionError(f"{tag}: record bytes {rec} against the shapes' {want}")
            print(f"{tag}: {rec['n_before']} -> {rec['n_after']} ranks, wall "
                  f"{rec['wall_s'] * 1e3:.1f} ms, gathered {rz['gathered_bytes']} bytes, "
                  f"shipped {rz['shipped_bytes']} bytes, record bytes "
                  f"{rec['param_bytes']} + {rec['kv_bytes']}")
        summary["resizes"] = resized["resizes"]
        steps = resized["step_ms"]
    else:
        got = r0["runs"][0]
        # the ranks route alike: rank 1's picks are rank 0's
        for key, layers in got["routes"].items():
            theirs = rs[1]["routes"].get(key)
            if theirs is None or any(not torch.equal(a[0], b[0])
                                     for a, b in zip(layers, theirs)):
                raise AssertionError(f"{tag}: rank 1's picks differ from rank 0's at {key}")
        gate, counts = tp_gate(tag, cfg, one, r0, got, rs)
        steps = got["step_ms"]
        tp2 = [ms for size, ms in steps if size == 2]
        summary.update(one_rank_step_ms=one["step_ms"],
                       collective_ms_per_step=statistics.median(got["collective_ms"]),
                       collective_share=sum(got["collective_ms"]) / sum(tp2))
    summary.update(gate, step_ms_tp2=statistics.median([ms for size, ms in steps if size == 2]),
                   step_ms_tp1=statistics.median([ms for size, ms in steps if size == 1]
                                                 or [float("nan")]))
    print(f"{tag}: decode step median {summary['step_ms_tp2']:.2f} ms at 2 ranks"
          + (f", {summary['step_ms_tp1']:.2f} ms at 1" if resize else
             f" (one rank {summary['one_rank_step_ms']:.2f} ms); collectives "
             f"{summary['collective_ms_per_step']:.2f} ms a step, "
             f"{summary['collective_share']:.3f} of the steps (a synchronisation around "
             f"each)") + f"; streams equal: {summary['streams_equal']}")
    return summary, counts


def tp_moe_phase(seed: int):
    """Tensor parallelism for MoE and MLA on the card: two ranks on the one
    card (gloo) serve (a) full-width, full-depth deepseek-v2-lite-16b and
    (c) full-width mixtral-8x22b at 4 of 56 layers at TP 2, each rank
    drawing only its shards, against the one-rank replica on the same
    seeded weights, run first in this process and freed; (b) full-width
    deepseek cut to 1 dense + 3 moe layers shrinks 2 -> 1 and grows 1 -> 2
    mid-stream (``migrate``) against its unbroken 2-rank run (depth cut:
    gloo moves a shrink's gathered leaves through host memory at about
    0.35 GB/s on one card, about 15 GB a rank at full depth); then the
    kernels at the per-rank shapes. Returns (launches by path, numbers)."""
    from repro_torch.distributed.tensor_parallel import spawn_tp

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 24)
    dsa, mxa = "deepseek-v2-lite-16b", "mixtral-8x22b"
    ds, mx = tp_config(dsa), tp_config(mxa, TPM_MIXTRAL)
    cut = tp_config(dsa, TPM_CUT)
    prompts = {a: rng.integers(0, c.vocab_size, size=(TP_REQ, TP_PROMPT)).tolist()
               for a, c in ((dsa, ds), (mxa, mx))}
    print(f"tp moe: 2 ranks on one card, {TP_REQ} requests of {TP_PROMPT} + {TP_NEW} new, "
          f"{TP_SLOTS} slots, max_seq {TP_SEQ}; deepseek a rank {ds.n_heads // 2} MLA heads, "
          f"experts {ds.n_experts // 2} of {ds.n_experts} (top {ds.top_k} of all), shared "
          f"width {ds.moe_d_ff * ds.n_shared_experts // 2}, layer 0 d_ff {ds.d_ff // 2}; "
          f"mixtral ({mx.n_layers} layers) {mx.n_heads // 2} heads on {mx.n_kv_heads // 2} KV "
          f"heads, experts {mx.n_experts // 2} of {mx.n_experts}")
    paths, one = {}, {}
    for tag, arch, cfg in (("tp moe deepseek one rank", dsa, ds),
                           ("tp moe mixtral one rank", mxa, mx)):
        paths[tag], one[arch] = tp_one_rank(tag, cfg, seed, prompts[arch])
    legs = (("a", dsa, None, prompts[dsa], None),
            ("b", dsa, TPM_CUT, prompts[dsa],
             {TP_SHRINK_AFTER: 1, TP_SHRINK_AFTER + TP_GROW_AFTER: 2}),
            ("c", mxa, TPM_MIXTRAL, prompts[mxa], None))
    t1 = time.perf_counter()
    ranks = spawn_tp(tp_shard_rank, 2, device="cuda:0", args=(seed, legs), timeout=900)
    spawn_s = time.perf_counter() - t1
    out = {"spawn_s": spawn_s}
    for leg, cfg, ref_key, label in (("a", ds, dsa, "deepseek tp 2"),
                                     ("b", cut, None, "deepseek cut 2 -> 1 -> 2"),
                                     ("c", mx, mxa, "mixtral tp 2")):
        out[f"leg_{leg}"], counts = tp_leg(f"tp moe {leg} ({label})", cfg,
                                           [r[leg] for r in ranks], one.get(ref_key),
                                           resize=ref_key is None)
        paths.update(counts)
    out["kernels"] = tp_moe_kernels(torch.Generator(device="cuda").manual_seed(seed + 24))
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"tp moe: phase wall {out['phase_wall_s']:.2f} s (the ranks {spawn_s:.2f} s)")
    return paths, out


# --- tensor parallelism for SSM and hybrid (the tp ssm phase) ---------------------------
def tp_ssm_kernels(gen: torch.Generator) -> dict:
    """The kernels at the tp ssm phase's per-rank shapes, each against its
    plain version and timed: ssd at one of 2 ranks of mamba2 and of zamba2
    at a 128-token admission (40 of 80 heads, S padded to the 256-token
    chunk; no library yardstick), the gated norm's two passes at 4 and 512
    rows x 2560 of mamba2's 5120 channels (z a column slice of the rank's
    in_proj row): pass A's sums against its plain version, pass B on the
    summed sums against its plain version, the two ranks' rows side by
    side against the one-pass gated kernel on the whole row (bf16 within
    ``GATE_ULPS``), and on one rank pass B of pass A against the one-pass
    kernel bit for bit (no one PyTorch call computes either pass); flash
    at zamba2's rank shape, 16 of 32 heads of 80, beside SDPA."""
    from repro_torch.kernels.ops import (flash_attention_op, gated_rmsnorm_op,
                                         gated_rmsnorm_scale_op, gated_rmsnorm_ssq_op, ssd_op)
    from repro_torch.kernels.ref import (flash_attention_ref, gated_rmsnorm_scale_ref,
                                         gated_rmsnorm_ssq_ref, ssd_chunk_ref)

    bf16, dev = torch.bfloat16, "cuda"
    out = {"ssd": {}, "err": 0.0}
    for label, n in (("mamba2", 128), ("zamba2", 64)):
        b, s, h, p = 1, 256, 40, 64
        x = torch.randn(b, s, h, p, device=dev, generator=gen).to(bf16)
        dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=dev, generator=gen))
        a = -torch.exp(torch.randn(h, device=dev, generator=gen) * 0.3)
        bm, cm = (torch.randn(b, s, 1, n, device=dev, generator=gen).to(bf16) for _ in range(2))
        inputs = (x, dt, a, bm, cm)
        y, fin = ssd_op(*inputs, chunk=256)
        want = ssd_chunk_ref(*inputs, 256)
        name = f"ssd {label} rank x {tuple(x.shape)} B {tuple(bm.shape)} chunk 256 bf16"
        err = max(check_close(name + " y", y, want[0], SSD_TOL),
                  check_close(name + " final state", fin, want[1], SSD_TOL))
        print(f"check {name}: max abs err {err:.3e} (atol={SSD_TOL[0]} rtol={SSD_TOL[1]})")
        bound, by = ssd_bound(*inputs, 256)
        t = time_three(lambda: ssd_op(*inputs, chunk=256), lambda: ssd_chunk_ref(*inputs, 256),
                       None)
        t.update(bound_ms=bound, bound_by=by, err=err,
                 shape=f"one of 2 ranks of {label}, a 128-token admission: x {tuple(x.shape)} "
                       f"bf16, dt fp32, B/C {tuple(bm.shape)} bf16, chunk 256; library: none")
        report(f"ssd {label} tp rank", t)
        out["ssd"][label] = t
        out["err"] = max(out["err"], err)

    d, ranks = 5120, 2
    width = d // ranks
    stride = 2 * width + 2 * 128 + 40   # a rank's in_proj row: z, x, B, C, dt
    res = {name: {"err": 0.0} for name in RMS_TP_FORMS}
    split_ulps = 0.0
    for rows in (512, 4):   # the kernels line carries the decode wave's numbers
        x = torch.randn(rows, d, device=dev, generator=gen).to(bf16)
        w = torch.randn(d, device=dev, generator=gen)
        rows_z = [torch.randn(rows, stride, device=dev, generator=gen).to(bf16)[:, :width]
                  for _ in range(ranks)]
        parts = [(x[:, r * width:(r + 1) * width].contiguous(), rows_z[r],
                  w[r * width:(r + 1) * width].contiguous()) for r in range(ranks)]
        sums = [gated_rmsnorm_ssq_op(xs, zs) for xs, zs, _ in parts]
        for (xs, zs, _), got in zip(parts, sums):
            res["gated_rmsnorm_ssq"]["err"] = max(res["gated_rmsnorm_ssq"]["err"], check_close(
                f"gated_rmsnorm_ssq rows={rows} d={width} bf16", got,
                gated_rmsnorm_ssq_ref(xs, zs), TOL[torch.float32]))
        ssq = sums[0] + sums[1]
        ys = [gated_rmsnorm_scale_op(xs, zs, ws, ssq, d) for xs, zs, ws in parts]
        for (xs, zs, ws), got in zip(parts, ys):
            res["gated_rmsnorm_scale"]["err"] = max(
                res["gated_rmsnorm_scale"]["err"],
                check_close(f"gated_rmsnorm_scale rows={rows} d={width} of {d} bf16", got,
                            gated_rmsnorm_scale_ref(xs, zs, ws, ssq, d), TOL[bf16]))
        z_whole = torch.cat(rows_z, dim=-1)
        one = gated_rmsnorm_op(x, z_whole, w)
        ulps = bf16_ulps(torch.cat(ys, dim=-1), one)
        split_ulps = max(split_ulps, ulps.max().item())
        if ulps.max().item() > GATE_ULPS:
            raise AssertionError(f"the gated norm split over {ranks} ranks, {rows} rows: "
                                 f"{ulps.max().item():.0f} bf16 ulps from the one-pass kernel "
                                 f"on the whole row (limit {GATE_ULPS})")
        check_bits(f"gated passes on one rank, rows={rows} d={d}: pass B of pass A against "
                   f"the one-pass kernel", gated_rmsnorm_scale_op(
                       x, z_whole, w, gated_rmsnorm_ssq_op(x, z_whole), d), one)
        xs, zs, ws = parts[0]
        for name, kernel, plain, form in (
                ("gated_rmsnorm_ssq", lambda: gated_rmsnorm_ssq_op(xs, zs),
                 lambda: gated_rmsnorm_ssq_ref(xs, zs), "gated_ssq"),
                ("gated_rmsnorm_scale", lambda: gated_rmsnorm_scale_op(xs, zs, ws, ssq, d),
                 lambda: gated_rmsnorm_scale_ref(xs, zs, ws, ssq, d), "gated_scale")):
            t = time_three(kernel, plain, None)
            bound, by = rmsnorm_bound(rows, width, bf16, form)
            t.update(bound_ms=bound, bound_by=by,
                     shape=f"one of {ranks} ranks of mamba2-2.7b: x ({rows}, {width}) of {d} "
                           f"channels bf16, z its columns of a ({rows}, {stride}) in_proj row, "
                           f"w fp32; library: none (no one PyTorch call)")
            report(f"{name}{' prefill' if rows > 4 else ''}", t)
            res[name]["prefill" if rows > 4 else "decode"] = t
        torch.cuda.synchronize()
    print(f"check the gated norm split over {ranks} ranks (rows 4 and 512, {width} of {d}): "
          f"at most {split_ulps:.0f} bf16 ulps from the one-pass kernel on the whole row; on "
          f"one rank pass B of pass A is the one-pass kernel bit for bit")
    for name in RMS_TP_FORMS:
        res[name].update(res[name]["decode"])
        res[name]["split_max_ulps"] = split_ulps
    out.update(res)

    b, h, kv, s, dd = 1, 16, 16, 128, 80
    q, k, v = (torch.randn(b, s, n, dd, device=dev, generator=gen).to(bf16).transpose(1, 2)
               for n in (h, kv, kv))
    err = check_close(f"flash zamba2 rank (b={b},h={h},kv={kv},s={s},d={dd}) bf16",
                      flash_attention_op(q, k, v, causal=True),
                      flash_attention_ref(q, k, v, causal=True), TOL[bf16])
    bound, by = flash_bound(b, h, kv, s, dd, bf16, causal=True)
    t = time_three(lambda: flash_attention_op(q, k, v, causal=True),
                   lambda: flash_attention_ref(q, k, v, causal=True),
                   lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                                            is_causal=True))
    t.update(bound_ms=bound, bound_by=by, err=err,
             shape=f"one of 2 ranks of zamba2's shared block: q ({b},{h},{s},{dd}) kv {kv} "
                   f"causal bf16; library: SDPA")
    report("flash_attention zamba2 rank", t)
    out["flash_attention"] = t
    out["err"] = max(out["err"], err)
    return out


def tp_ssm_phase(seed: int):
    """Tensor parallelism for SSM and hybrid on the card: two ranks on the
    one card (gloo) serve (a) full-width, full-depth mamba2-2.7b and (b)
    zamba2-2.7b at TP 2, each rank drawing only its shards (the Mamba2
    channels of its 40 of 80 heads, the B/C group whole; zamba2's shared
    block on the dense split), against the one-rank replica on the same
    seeded bf16 weights, run first in this process and freed; (c) zamba2
    at full depth (the resize moves leaf by leaf, a rank holding its old
    and new shards and one layer of one leaf whole) shrinks 2 -> 1 and
    grows 1 -> 2 mid-stream
    (``migrate``) against its unbroken 2-rank run; then the kernels at the
    per-rank shapes. Every
    rank's gated norm is the two passes of the rmsnorm kernel around one
    float32 sum a layer. Returns (launches by path, numbers)."""
    from repro_torch.distributed.tensor_parallel import spawn_tp, ssm_span

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 25)
    m2a, z2a = "mamba2-2.7b", "zamba2-2.7b"
    m2, z2 = tp_config(m2a), tp_config(z2a)
    prompts = {a: rng.integers(0, c.vocab_size, size=(TP_REQ, TP_PROMPT)).tolist()
               for a, c in ((m2a, m2), (z2a, z2))}
    loc = ssm_span(m2, 0, 2)
    print(f"tp ssm: 2 ranks on one card, {TP_REQ} requests of {TP_PROMPT} + {TP_NEW} new, "
          f"{TP_SLOTS} slots, max_seq {TP_SEQ}; a rank {loc.n_heads} of {m2.n_ssm_heads} SSM "
          f"heads ({loc.d_inner} of {m2.d_inner} channels), {loc.n_groups} B/C group of "
          f"{m2.ssm_ngroups}, conv {loc.conv_dim} of {m2.conv_dim} channels; zamba2's shared "
          f"block {z2.n_heads // 2} of {z2.n_heads} heads of {z2.head_dim}, d_ff "
          f"{z2.d_ff // 2}")
    paths, one = {}, {}
    for tag, arch, cfg in (("tp ssm mamba2 one rank", m2a, m2),
                           ("tp ssm zamba2 one rank", z2a, z2)):
        paths[tag], one[arch] = tp_one_rank(tag, cfg, seed, prompts[arch])
    legs = (("a", m2a, None, prompts[m2a], None), ("b", z2a, None, prompts[z2a], None),
            ("c", z2a, None, prompts[z2a],
             {TP_SHRINK_AFTER: 1, TP_SHRINK_AFTER + TP_GROW_AFTER: 2}))
    t1 = time.perf_counter()
    ranks = spawn_tp(tp_shard_rank, 2, device="cuda:0", args=(seed, legs), timeout=600)
    spawn_s = time.perf_counter() - t1
    out = {"spawn_s": spawn_s}
    for leg, cfg, ref_key, label in (("a", m2, m2a, "mamba2 tp 2"), ("b", z2, z2a, "zamba2 tp 2"),
                                     ("c", z2, None, "zamba2 2 -> 1 -> 2")):
        out[f"leg_{leg}"], counts = tp_leg(f"tp ssm {leg} ({label})", cfg,
                                           [r[leg] for r in ranks], one.get(ref_key),
                                           resize=ref_key is None)
        paths.update(counts)
    for leg in ("a", "b"):
        coll = [r[leg]["collectives"] for r in ranks]
        steps = ranks[0][leg]["passes"]["prefills"] + ranks[0][leg]["passes"]["steps"]
        print(f"tp ssm {leg}: rank 0's collectives {coll[0]['calls']} over {steps} passes "
              f"({coll[0]['calls'] / steps:.1f} a pass), {coll[0]['bytes']} bytes sent")
    out["kernels"] = tp_ssm_kernels(torch.Generator(device="cuda").manual_seed(seed + 25))
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"tp ssm: phase wall {out['phase_wall_s']:.2f} s (the ranks {spawn_s:.2f} s)")
    return paths, out


def tp_cache_bytes(cfg) -> int:
    """Bytes of the whole decode cache of a replica of ``TP_SLOTS`` slots
    and ``TP_SEQ`` positions (the latent cache under MLA)."""
    from repro_torch.models import model as M
    return M.nbytes(M.cache_spec(cfg, TP_SLOTS, TP_SEQ))


def moe_phase(seed: int):
    """Full-width mixtral-8x22b, 4 of its 56 layers (the only cut), bf16
    weights, served through ContinuousEngine under ``kernel_impls="auto"``:
    attention, the MoE grouped matmul and every norm on the kernels."""
    from repro_torch.configs import get_config, with_kernel_impls
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

    run = drive(engine, prompts, new_tok, GenRequest)
    n_steps, n_prefills = run["steps"], run["prefills"]
    passes = n_prefills + n_steps
    print(f"moe: {n_prefills} prefills, {n_steps} decode steps")
    if n_prefills != n_req:
        raise AssertionError(f"moe: {n_prefills} prefills, expected {n_req}")
    expect = dict(forward_counts(cfg, passes), flash_attention=cfg.n_layers * n_prefills)
    counts = check_counts("moe", cfg, run["counts"], run["forms"], expect, passes)
    serving = {"moe_" + k: x for k, x in
               serving_summary("moe", run, n_req, new_tok, init_peak).items()}
    serving.update({"moe_" + k: x for k, x in profile_decode(engine, prompts, GenRequest).items()})
    serving["moe_score"] = score_leg("moe", cfg, engine.params, seed)
    del engine, params
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

    run = drive(engine, prompts, new_tok, GenRequest, drain_after=drain_after)
    n_steps, n_prefills, resumed = run["steps"], run["prefills"], run["resumed"]
    if n_prefills != n_req + resumed:  # each request once, each drained in-flight one again
        raise AssertionError(f"{tag}: {n_prefills} prefills, expected {n_req + resumed}")
    passes = n_prefills + n_steps
    print(f"{tag}: {n_prefills} prefills ({resumed} of them resumes), {n_steps} decode "
          f"steps; prompts {int(lens.min())}-{int(lens.max())}, drain after {drain_after} steps")
    # decode steps run neither flash (zamba2's shared block attends once a
    # group at each prefill) nor ssd (the state steps in PyTorch)
    expect = dict(forward_counts(cfg, passes), flash_attention=cfg.n_attn_layers * n_prefills,
                  ssd=cfg.n_ssm_layers * n_prefills)
    counts = check_counts(tag, cfg, run["counts"], run["forms"], expect, passes)
    serving = serving_summary(tag, run, n_req, new_tok, init_peak)
    serving.update(profile_decode(engine, prompts, GenRequest))
    serving.update(profile_prefill(engine, prompts[0], GenRequest))
    serving["score"] = score_leg(tag, cfg, engine.params, seed)
    del engine, params
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


# repro's decode==forward tolerance (tests/test_models.py), for the absorbed
# MLA decode against the decompressed forward at float32
DECODE_TOL = (2e-4, 2e-3)


def forward_counts(cfg, passes=1) -> dict:
    """Each kernel's launches over ``passes`` full-sequence passes (prefills,
    forwards; an int, or {ranks: passes} of a tensor-parallel rank) under
    ``auto``: one rmsnorm a norm (none for the gelu encoder's LayerNorms;
    two for a Mamba2 mixer's gated norm on more than one rank), flash once
    a GQA attention layer (MLA has no flash twin), three moe_gmm a moe
    layer, ssd once a mamba layer; no mla_prefill (a forward's MLA is the
    einsum; a serving path adds :func:`mla_kernel_layers` an admission)."""
    by = _by_ranks(passes)
    passes = sum(by.values())
    moe_layers = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts else 0
    return {"rmsnorm": 0 if cfg.act == "gelu" else sum(expected_norm_forms(cfg, by).values()),
            "flash_attention": (0 if cfg.use_mla else cfg.n_attn_layers) * passes,
            "paged_attention": 0, "moe_gmm": 3 * moe_layers * passes,
            "ssd": cfg.n_ssm_layers * passes, "mla_prefill": 0}


def mla_kernel_layers(cfg) -> int:
    """The mla_prefill kernel's launches in one admission: once an MLA layer
    where the prefill's attention core fits it (bf16 on the card at
    DeepSeek-V2's head widths, ``attention._mla_kernel_fits``), else none."""
    from repro_torch.kernels import mla_prefill as kern
    fits = (cfg.use_mla and cfg.dtype == "bfloat16"
            and (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim)
            == (kern.NOPE_DIM, kern.ROPE_DIM, kern.V_DIM))
    return cfg.n_layers if fits else 0


def check_counts(tag: str, cfg, counts: dict, forms: dict, expect: dict, passes) -> dict:
    """Assert the launches (rmsnorm's by form, where the arch norms with
    it); returns ``counts`` with the forms under ``rmsnorm_forms``."""
    print(f"{tag}: launches {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts} != expected {expect}")
    if cfg.act == "gelu":
        if any(forms.values()):
            raise AssertionError(f"{tag}: rmsnorm forms {forms} on a LayerNorm arch")
        return dict(counts, rmsnorm_forms=forms)
    return check_norm_forms(tag, cfg, passes, counts, forms)


def score_leg(tag: str, cfg, params, seed: int, batch: int = 2, seq: int = 512) -> dict:
    """``ServingEngine.score`` on (batch, seq) random tokens with the
    phase's weights: one forward of (batch, seq - 1) tokens through
    ``loss_fn``, every launch counted; the loss must be finite."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine(cfg, params, max_seq=seq, device="cuda")
    toks = np.random.default_rng(seed + 11).integers(0, cfg.vocab_size, size=(batch, seq))
    engine.score(toks)  # warm-up at the same shape (allocator, cuBLAS), not counted
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    loss = engine.score(toks)   # float(): waits for the card
    wall_ms = 1e3 * (time.perf_counter() - t)
    counts = check_counts(f"{tag} score", cfg, launch_counts(), rmsnorm_form_counts(),
                          forward_counts(cfg), 1)
    if not np.isfinite(loss):
        raise AssertionError(f"{tag} score: loss {loss}")
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} score: ServingEngine.score on ({batch}, {seq}) tokens = {loss:.4f} "
          f"(ln vocab {np.log(cfg.vocab_size):.4f}), {wall_ms:.2f} ms, peak memory {peak} bytes")
    out = {"loss": loss, "wall_ms": wall_ms, "peak_memory_bytes": peak, "launches": counts}
    out.update(profile_run(lambda: engine.score(toks), f"{tag} score (one forward of "
                           f"({batch}, {seq - 1}) tokens, profiler on)", 1, "score", "score"))
    del engine
    torch.cuda.empty_cache()
    return out


def drive(engine, prompts, new_tok: int, gen_request, drain_after=None) -> dict:
    """Serve ``prompts`` through a warm ``engine`` with every launch count
    at 0: admit them all, step (and, after ``drain_after`` steps, drain
    and resubmit every request, resumed by re-prefill) until idle. Returns
    the timings, the launches read just after, the finished requests, and
    the prefills (counted at the engine's prefill call) and decode steps."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts

    n_slots = engine.n_slots
    prefills = [0]
    prefill = engine._prefill

    def counted(context):
        prefills[0] += 1
        return prefill(context)

    engine._prefill = counted
    add_ms, step_ms, admit_step_ms = [], [], []

    def timed_step():
        before = prefills[0]
        t = time.perf_counter()
        engine.step()  # ends in a host copy of the picked tokens
        (step_ms if prefills[0] == before else admit_step_ms).append(
            1e3 * (time.perf_counter() - t))

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps0, resumed = engine.n_decode_steps, 0
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        t = time.perf_counter()
        engine.add(gen_request(id=i, prompt=p, max_new=new_tok))
        if i < n_slots:  # admitted at once: prefill + graft + first token
            add_ms.append(1e3 * (time.perf_counter() - t))
    if drain_after is not None:
        for _ in range(drain_after):
            timed_step()
        drained = engine.drain()
        resumed = sum(1 for r in drained if r.generated and r.remaining > 0)
        if len(drained) != len(prompts) or resumed != n_slots or engine.batcher.active():
            raise AssertionError(f"drained {len(drained)}, {resumed} in flight")
        for r in drained:
            engine.add(r)  # resume: prompt + generated so far, prefilled again
    while engine.batcher.active():
        timed_step()
    wall = time.perf_counter() - t_start
    counts, forms = launch_counts(), rmsnorm_form_counts()
    done = engine.run()
    del engine._prefill
    if sorted(r.id for r in done) != list(range(len(prompts))):
        raise AssertionError(f"finished ids {sorted(r.id for r in done)}")
    vocab = engine.cfg.vocab_size
    for r in done:
        if len(r.generated) != new_tok or not all(0 <= t < vocab for t in r.generated):
            raise AssertionError(f"request {r.id}: {len(r.generated)} tokens {r.generated[:8]}...")
    return {"add_ms": add_ms, "step_ms": step_ms, "admit_step_ms": admit_step_ms, "wall": wall,
            "counts": counts, "forms": forms, "prefills": prefills[0], "resumed": resumed,
            "steps": engine.n_decode_steps - steps0, "peak": torch.cuda.max_memory_allocated()}


def serving_summary(tag: str, run: dict, n_req: int, new_tok: int, init_peak: int) -> dict:
    out = {"tokens_per_s": n_req * new_tok / run["wall"], "wall_s": run["wall"],
           "prefill_ms": statistics.median(run["add_ms"]),
           "decode_ms_per_step": statistics.median(run["step_ms"]),
           "admit_step_ms": run["admit_step_ms"], "peak_memory_bytes": run["peak"],
           "init_peak_memory_bytes": init_peak, "decode_steps": run["steps"],
           "prefills": run["prefills"]}
    print(f"{tag}: served {n_req} requests x {new_tok} tokens in {run['wall']:.3f} s = "
          f"{out['tokens_per_s']:.2f} tok/s; admission (batch 1) median {out['prefill_ms']:.2f} "
          f"ms; decode step median {out['decode_ms_per_step']:.2f} ms; steps with an admission "
          f"{['%.2f' % x for x in run['admit_step_ms']]} ms; peak memory {run['peak']} bytes")
    return out


def mla_phase(seed: int):
    """Full-width, full-depth deepseek-v2-lite-16b (bf16 weights from
    ``seed``) served through ContinuousEngine under ``kernel_impls="auto"``:
    each admission's MLA attention on the mla_prefill kernel, the absorbed
    decode in plain PyTorch over the latent cache, every norm on
    rmsnorm, every MoE layer's experts on moe_gmm (the capacity path). 8
    requests of (512, 32), 4 slots, a drain after 4 steps and a resume;
    then ``ServingEngine.score`` on the same weights."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ContinuousEngine

    n_req, prompt_len, new_tok, n_slots, max_seq = 8, 512, 32, 4, 640
    cfg = with_kernel_impls(dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                                                param_dtype="bfloat16"), "auto")
    print(f"mla: {cfg.arch_id} layers={cfg.n_layers} (dense {cfg.first_dense_layers}) "
          f"d={cfg.d_model} heads={cfg.n_heads} kv_lora={cfg.kv_lora_rank} "
          f"rope={cfg.qk_rope_dim} nope={cfg.qk_nope_dim} v={cfg.v_head_dim} experts="
          f"{cfg.n_experts} top_k={cfg.top_k} shared={cfg.n_shared_experts} moe_d_ff="
          f"{cfg.moe_d_ff} d_ff={cfg.d_ff} vocab={cfg.vocab_size} moe_impl={cfg.moe_impl} "
          f"dtype={cfg.dtype}/{cfg.param_dtype} kernel_impls={dict(cfg.kernel_impls)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    engine = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=max_seq, device="cuda")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    print(f"mla: {sum(t.numel() for t in M.tree_leaves(params))} parameters "
          f"({M.nbytes(params)} bytes), init {time.perf_counter() - t0:.2f} s, peak memory "
          f"during init {init_peak} bytes")
    cache_bytes = M.nbytes(engine.cache)
    spec_bytes = M.nbytes(M.cache_spec(cfg, n_slots, max_seq))
    shapes = {seg: tuple(leaf["c"].shape) for seg, leaf in engine.cache.items()}
    print(f"mla: latent cache {shapes}, {cache_bytes} bytes (cache_spec {spec_bytes})")
    if cache_bytes != spec_bytes or any(sh[-1] != cfg.kv_cache_head_dim for sh in shapes.values()):
        raise AssertionError(f"mla: latent cache {shapes} {cache_bytes} bytes vs spec {spec_bytes}")
    rng = np.random.default_rng(seed + 7)
    prompts = rng.integers(0, cfg.vocab_size, size=(n_req, prompt_len)).tolist()
    engine.add(GenRequest(id=-1, prompt=prompts[0][:16], max_new=2))  # warm-up, not counted
    engine.run()
    torch.cuda.synchronize()

    run = drive(engine, prompts, new_tok, GenRequest, drain_after=4)
    passes = run["prefills"] + run["steps"]
    print(f"mla: {run['prefills']} prefills ({run['resumed']} of them resumes), "
          f"{run['steps']} decode steps")
    if run["prefills"] != n_req + run["resumed"]:
        raise AssertionError(f"mla: {run['prefills']} prefills, expected {n_req + run['resumed']}")
    counts = check_counts("mla", cfg, run["counts"], run["forms"],
                          dict(forward_counts(cfg, passes),
                               mla_prefill=mla_kernel_layers(cfg) * run["prefills"]), passes)
    serving = serving_summary("mla", run, n_req, new_tok, init_peak)
    serving["latent_cache_bytes"] = cache_bytes
    serving.update(profile_decode(engine, prompts, GenRequest))
    serving.update(profile_prefill(engine, prompts[0], GenRequest))
    for key in ("decode", "prefill"):
        per = "step" if key == "decode" else "prefill"
        dev = serving.get(f"profile_{key}_device_ms_per_{per}")
        ops_ms = serving.get(f"profile_{key}_kernel_ms_per_{per}", {})
        if isinstance(dev, float) and "moe_gmm" in ops_ms:
            serving[f"profile_{key}_moe_gmm_share"] = ops_ms["moe_gmm"] / dev
            print(f"mla: moe_gmm {ops_ms['moe_gmm']:.3f} of {dev:.3f} device ms a {per} "
                  f"({ops_ms['moe_gmm'] / dev:.3f})")
    serving["score"] = score_leg("mla", cfg, engine.params, seed)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    serving.update(mla_parity(seed, prompts[0]))
    return counts, {f"mla_{k}": x for k, x in serving.items()}


def mla_parity(seed: int, prompt) -> dict:
    """deepseek at full width cut to 1 dense + 2 moe layers, float32: a
    prefill under ``auto`` (rmsnorm, moe_gmm's capacity path) against
    ``reference``; and the absorbed decode at position S against the
    decompressed forward's logits there, with the dropless MoE (``ragged``:
    a forward of S+1 tokens and a decode of one route with no drop, so
    they are one function)."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.models import model as M

    base = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=3, dtype="float32",
                               param_dtype="float32")
    params = M.init_params(base, torch.Generator(device="cuda").manual_seed(seed + 8), "cuda")
    s = len(prompt)
    tok = torch.as_tensor([prompt], dtype=torch.int64, device="cuda")
    v = base.vocab_size
    logits = {}
    for pol in ("auto", "reference"):
        logits[pol], _ = M.prefill(params, {"tokens": tok}, with_kernel_impls(base, pol))
    err = check_close("mla f32 prefill logits auto vs reference", logits["auto"][:, :v],
                      logits["reference"][:, :v], SLICE_TOL)
    if not torch.equal(logits["auto"][:, :v].argmax(-1), logits["reference"][:, :v].argmax(-1)):
        raise AssertionError("mla f32 prefill: argmax differs")
    dropless = with_kernel_impls(dataclasses.replace(base, moe_impl="ragged"), "auto")
    nxt = logits["auto"][:, :v].argmax(-1, keepdim=True)
    _, cache = M.prefill(params, {"tokens": tok}, dropless)
    grown = M.init_cache(dropless, 1, s + 1, "cuda")
    for seg in cache:
        grown[seg]["c"][:, :, :s] = cache[seg]["c"]
    dec, _ = M.decode_step(params, nxt, grown, s, dropless)
    fwd, _ = M.forward(params, {"tokens": torch.cat([tok, nxt], dim=1)}, dropless)
    err_d = check_close("mla f32 decode at position S vs forward", dec[:, :v], fwd[:, s, :v],
                        DECODE_TOL)
    torch.cuda.synchronize()
    print(f"mla: f32 3-layer (1 dense + 2 moe) prefill ({s} tokens) logits auto vs reference max "
          f"abs err {err:.3e} (limit atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]}), same argmax; "
          f"absorbed decode at position {s} vs the decompressed forward max abs err "
          f"{err_d:.3e} (limit atol={DECODE_TOL[0]} rtol={DECODE_TOL[1]}); logit scale "
          f"{logits['reference'][:, :v].abs().max().item():.3f}")
    del params, logits, cache, grown
    torch.cuda.empty_cache()
    return {"f32_logits_max_abs_err": err, "f32_decode_vs_forward_max_abs_err": err_d}


def frontend_phase(seed: int):
    """``loss_fn`` through the two frontends at full width and depth:
    hubert-xlarge (fp32 weights and the bf16 copy) on an audio batch of (2,
    512) frames, the encoder's attention on non-causal flash, LayerNorm
    (no rmsnorm); internvl2-26b (bf16 weights, 39.8 GB) on 256 patches +
    256 text tokens, flash and rmsnorm.
    Plus hubert at float32 cut to 2 layers: loss_fn's logits under
    ``auto`` (non-causal flash) against ``reference``."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.models.frontends import make_batch

    out, all_counts = {}, []
    for arch, pdt in (("hubert-xlarge", "float32"), ("internvl2-26b", "bfloat16")):
        tag = arch.split("-")[0]
        cfg = with_kernel_impls(dataclasses.replace(get_config(arch), param_dtype=pdt), "auto")
        print(f"{tag}: {cfg.arch_id} layers={cfg.n_layers} d={cfg.d_model} "
              f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} act={cfg.act} "
              f"frontend={cfg.frontend} ({cfg.frontend_seq} patches) causal="
              f"{cfg.is_autoregressive} vocab={cfg.vocab_size} dtype={cfg.dtype}/"
              f"{cfg.param_dtype} kernel_impls={dict(cfg.kernel_impls)}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        p16 = M.cast_params(params, cfg)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        print(f"{tag}: {sum(t.numel() for t in M.tree_leaves(params))} parameters "
              f"({M.nbytes(params)} bytes, compute copy {M.nbytes(p16)} bytes), init "
              f"{time.perf_counter() - t0:.2f} s, peak memory during init {init_peak} bytes")
        gen = torch.Generator(device="cuda").manual_seed(seed + 9)
        batch = make_batch(gen, cfg, 2, 512, device="cuda")
        M.loss_fn(p16, batch, cfg)  # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t = time.perf_counter()
        loss, metrics = M.loss_fn(p16, batch, cfg)
        loss = float(loss)
        wall_ms = 1e3 * (time.perf_counter() - t)
        counts = check_counts(f"{tag} loss_fn", cfg, launch_counts(), rmsnorm_form_counts(),
                              forward_counts(cfg), 1)
        all_counts.append(counts)
        if not np.isfinite(loss):
            raise AssertionError(f"{tag} loss_fn: loss {loss}")
        shapes = {k: tuple(x.shape) for k, x in batch.items()}
        print(f"{tag}: loss_fn on {shapes} = {loss:.4f} (ce {float(metrics['ce']):.4f}, ln vocab "
              f"{np.log(cfg.vocab_size):.4f}), {wall_ms:.2f} ms, peak memory "
              f"{torch.cuda.max_memory_allocated()} bytes")
        out[tag] = {"loss": loss, "wall_ms": wall_ms, "init_peak_memory_bytes": init_peak,
                    "launches": counts}
        del params, p16, batch
        gc.collect()
        torch.cuda.empty_cache()

    # hubert at float32, 2 layers: non-causal flash against the einsum
    base = dataclasses.replace(get_config("hubert-xlarge"), n_layers=2, dtype="float32")
    params = M.init_params(base, torch.Generator(device="cuda").manual_seed(seed + 10), "cuda")
    batch = make_batch(torch.Generator(device="cuda").manual_seed(seed + 9), base, 2, 512,
                       device="cuda")
    logits = {pol: M.forward(params, batch, with_kernel_impls(base, pol))[0]
              for pol in ("auto", "reference")}
    v = base.vocab_size
    err = check_close("hubert f32 forward logits auto vs reference", logits["auto"][..., :v],
                      logits["reference"][..., :v], SLICE_TOL)
    print(f"hubert: f32 2-layer forward ((2, 512) frames) logits auto vs reference max abs err "
          f"{err:.3e} (limit atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]}), logit scale "
          f"{logits['reference'][..., :v].abs().max().item():.3f}")
    out["hubert"]["f32_logits_max_abs_err"] = err
    del params, logits
    torch.cuda.empty_cache()
    return all_counts, out


# --- the frontends' loss and training under a group and a grid (tp train) ------------
TPT_FRONT_BATCH, TPT_FRONT_SEQ = 2, 512   # hubert's frames; internvl2's 256 patches + 256 tokens
TPT_BATCH, TPT_SEQ, TPT_STEPS, TPT_SAVE_AFTER = 2, 256, 3, 2
# the checkpoint round trip's depth: the training phase's restart depth
TPT_CKPT_LAYERS = 2
# the depth of the two-rank "model"-axis training leg: the (data 2, model 2)
# leg trains the "model" axis at full depth, so this one is cut (PERF.md §4)
TPT_TP2_LAYERS = 6
# the data-axis leg's grid, (pod, data, model), and the file of the one-rank
# leg's final parameters that its ranks compare their cuts with
DPT_GRID = (1, 2, 2)
DPT_ONE_RANK = "one_rank_internlm2.pt"
# tests/test_torch_train_step.py's optimizer and PARAM_TOL (atol, rtol): the
# losses and grad norms of 2 ranks against one
TPT_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
PARAM_TOL = (2e-5, 1e-4)
# the final parameters of 2 ranks against one, set from PR 26's readings
# with room (PERF.md §6): the largest difference of an element (1.617e-3
# read at full depth after 3 steps; 4.738e-5 for one step from the same
# state, the checkpoint's step), and the share of elements beyond
# PARAM_TOL (2.16e-6 read)
TPT_PARAM_MAX = {"3 steps": 3e-3, "1 step": 5e-4}
TPT_PARAM_SHARE = 2e-5
# a step's metrics after the first, against one rank's: three times
# PARAM_TOL. From the first step on the parameters are apart as
# TPT_PARAM_MAX admits, and Adam's update of the elements whose gradient is
# near zero turns the order of the float32 sums into steps 2-3's metrics:
# tools/dp_step_witness.py (PERF.md §6) read up to 1.064 of PARAM_TOL's
# limit on layouts that only reorder the sums (one rank against itself as
# 2 microbatches included), 0.016 from the same state, and 6.93 for a
# grid whose norms' gradients go unsummed over "data"
TPT_LATER_TOL = (6e-5, 3e-4)


def tpt_front_cfg(arch: str, dtype: str = None):
    """The frontend archs of the tp train phase under ``auto``: hubert-xlarge
    with float32 weights computing at float32 (its loss and logits gated at
    ``SLICE_TOL``), internvl2-26b with bf16 weights computing at bf16 (or at
    ``dtype``: the float32 witness on the same bf16 values)."""
    from repro_torch.configs import get_config, with_kernel_impls
    base = get_config(arch)
    if arch == "hubert-xlarge":
        cfg = dataclasses.replace(base, param_dtype="float32", dtype="float32")
    else:
        cfg = dataclasses.replace(base, param_dtype="bfloat16")
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return with_kernel_impls(cfg, "auto")


def tpt_train_cfg(n_layers: int = None):
    """internlm2-1.8b FULL (cut to ``n_layers``) at float32 (weights and
    compute) under ``reference``: the kernels have no backward."""
    from repro_torch.configs import get_config, with_kernel_impls
    base = get_config("internlm2-1.8b")
    return with_kernel_impls(dataclasses.replace(base, dtype="float32",
                                                 n_layers=n_layers or base.n_layers), "reference")


def layer_grad_ssq(grads) -> dict:
    """{leaf path: the float64 sum of squares of each layer of its gradient}
    (one value for a leaf outside the stack), on the host."""
    from repro_torch.distributed.sharding import map_with_names
    out = {}

    def one(names, g):
        g = g.double().square()
        out[tuple(names)] = (g.flatten(1).sum(1) if names[0] == "stack" else g.sum()[None]).cpu()
    map_with_names(one, grads)
    return out


def tpt_front_leg(arch: str, seed: int, device, tp=None, witness: bool = False) -> dict:
    """One leg of the frontends' ``loss_fn`` (on one rank, or on this rank
    of ``tp``, the ranks drawing their shards in turn): the whole logits
    (``forward``) and ``loss_fn``'s metrics, every launch of both counted,
    the init and forward peaks; with ``witness`` also the float32 loss and
    logits on the same bf16 weights."""
    import torch.distributed as dist

    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M
    from repro_torch.models.frontends import make_batch

    cfg = tpt_front_cfg(arch)
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    for r in range(1 if tp is None else tp.size):   # one rank draws at a time
        if tp is None or r == tp.rank:
            torch.cuda.reset_peak_memory_stats()
            params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                                   device, tp=tp)
            torch.cuda.synchronize()
            out["init_peak_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
        if tp is not None:
            dist.barrier()
    out["param_bytes"] = M.nbytes(params)
    batch = make_batch(torch.Generator(device="cuda").manual_seed(seed + 9), cfg,
                       TPT_FRONT_BATCH, TPT_FRONT_SEQ, device=device)
    with torch.no_grad():
        M.loss_fn(params, batch, cfg, tp=tp)   # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t = time.perf_counter()
        logits = M.forward(params, batch, cfg, tp)[0][..., :cfg.vocab_size].float().cpu()
        loss, metrics = M.loss_fn(params, batch, cfg, tp=tp)
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        out["wall_ms"] = 1e3 * (time.perf_counter() - t)
        out["counts"], out["forms"] = launch_counts(), rmsnorm_form_counts()
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["logits"] = logits
        if witness:
            c32 = tpt_front_cfg(arch, "float32")
            out["f32_logits"] = M.forward(params, batch, c32, tp)[0][..., :cfg.vocab_size].cpu()
            out["f32_loss"] = float(M.loss_fn(params, batch, c32, tp=tp)[0])
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tpt_train_leg(seed: int, device, tp=None, ckpt_dir=None, n_layers: int = None,
                  host_params: bool = True) -> dict:
    """internlm2-1.8b (cut to ``n_layers``) trains ``TPT_STEPS`` steps of
    (``TPT_BATCH``, ``TPT_SEQ``) tokens from ``DataPipeline`` at float32 on
    one rank or on this rank of ``tp`` (a group, or a grid whose rank takes
    its rows of each batch), from the seeded ``init_params``. Without
    ``ckpt_dir`` the first batch's gradient is taken once more before the
    steps, for its layers' sums of squares; under ``tp`` the collectives
    are timed (a synchronisation around each), those of the backward apart
    and each under its axis. With ``ckpt_dir`` the group checkpoints there
    after step ``TPT_SAVE_AFTER``. Returns the metrics, the steps' walls, the
    peaks, the parameter and moment bytes and the final parameters, on the
    host (``host_params``) or where they are."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.data_parallel import batch_rows, reduce_grads
    from repro_torch.distributed.sharding import map_with_names, sum_shared
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.training import train_step as TS
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

    cfg = tpt_train_cfg(n_layers)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), device, tp=tp)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    out = {"init_peak_bytes": torch.cuda.max_memory_allocated(), "param_bytes": M.nbytes(params),
           "moment_bytes": M.nbytes(opt["m"]) + M.nbytes(opt["v"]),
           "init_s": time.perf_counter() - t, "metrics": [], "step_ms": [], "collectives": []}
    step = TS.make_train_step(cfg, OptimizerConfig(**TPT_OPT), 1, tp)
    pipe = DataPipeline(cfg, TPT_BATCH, TPT_SEQ, seed=seed)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TPT_STEPS):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.next_batch().items()}
        if i == 0 and ckpt_dir is None:
            grads = reduce_grads(TS._grads_of(params, batch_rows(batch, tp), cfg, tp)[2], cfg, tp)
            if tp is not None:
                grads = map_with_names(lambda names, g: sum_shared(g, names, cfg, tp), grads)
            out["grad_ssq"] = layer_grad_ssq(grads)
            del grads
        tpar.reset_stats()
        tpar.time_collectives(tp is not None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            params, opt, m = step(params, opt, batch)
            metrics = {k: float(v) for k, v in m.items()}   # waits for the card
        finally:
            tpar.time_collectives(False)
        out["step_ms"].append(1e3 * (time.perf_counter() - t))
        out["metrics"].append(metrics)
        if tp is not None:
            st = dict(tpar.STATS)
            bwd = {k: st[f"backward_{k}"] for k in ("calls", "bytes", "seconds")}
            out["collectives"].append({"backward": bwd, "rest": {
                k: st[k] - bwd[k] for k in bwd}, "step": st})
        if ckpt_dir is not None and i + 1 == TPT_SAVE_AFTER:
            t = time.perf_counter()
            ckpt.save({"params": params, "opt": opt}, ckpt_dir, i + 1,
                      extra={"pipeline": pipe.state_dict()}, tp=tp, cfg=cfg)
            out["save_s"] = time.perf_counter() - t
    out["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = launch_counts()
    out["params"] = M.tree_map(lambda t: t.cpu(), params) if host_params else params
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tpt_rank(tp, seed: int) -> dict:
    """One of two ranks of the tp train phase (``spawn_tp``): the
    frontends' ``loss_fn`` at TP 2 (hubert at float32, internvl2 in bf16),
    then internlm2-1.8b's training at TP 2, cut to ``TPT_TP2_LAYERS``
    layers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": tp.rank, "backend": tp.backend}
    for arch in ("hubert-xlarge", "internvl2-26b"):
        out[arch] = tpt_front_leg(arch, seed, tp.device, tp)
    out["train"] = tpt_train_leg(seed, tp.device, tp, n_layers=TPT_TP2_LAYERS)
    return out


def dpt_rank(world, seed: int, d: str) -> dict:
    """One of four ranks of the tp train phase's data-axis leg
    (``spawn_tp``), as the grid ``DPT_GRID`` (data 2, model 2): (1)
    full-width, full-depth internlm2-1.8b trains ``TPT_STEPS`` steps, and
    the rank compares its final 2-D shard on the card with its cut of the
    one-rank leg's final tree (read from ``d`` on the host, a leaf at a
    time), and each leaf it shares with other ranks with theirs; (2) the
    checkpoint round trip at ``TPT_CKPT_LAYERS`` layers (:func:`dpt_ckpt`).
    Returns readings only: no parameter leaves the ranks."""
    from repro_torch.distributed.data_parallel import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = make_grid(world, DPT_GRID[1], DPT_GRID[2], DPT_GRID[0])
    out = {"rank": world.rank, "coords": (grid.pod_rank, grid.data_rank, grid.rank),
           "backend": grid.backend}
    cfg = tpt_train_cfg()
    leg = tpt_train_leg(seed, grid.device, grid, host_params=False)
    params = leg.pop("params")
    t = time.perf_counter()
    leg["against_one"] = dpt_against(params, os.path.join(d, DPT_ONE_RANK), cfg, grid)
    leg["shared_leaves"], unequal = dpt_shared_unequal(params, cfg, grid)
    if unequal:
        raise AssertionError(f"dp train: rank {world.rank}'s copies of {unequal} are not "
                             f"those of every rank that holds the same piece")
    leg["compare_s"] = time.perf_counter() - t
    out["train"] = leg
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["ckpt"] = dpt_ckpt(seed, world, grid, d)
    return out


def dpt_against(params, path: str, cfg, grid) -> dict:
    """{leaf path: the largest difference, the elements beyond
    ``PARAM_TOL`` and the element count} of this rank's final shards
    against its cut (``local_shard``) of the one-rank tree at ``path``,
    memory-mapped: each cut is read on the host and compared on the
    card."""
    from repro_torch.distributed.sharding import local_shard, map_with_names

    ref = torch.load(path, mmap=True, weights_only=True)
    stats = {}

    def one(names, p):
        want = local_shard(_at_path(ref, names), names, cfg, grid).to(p.device)
        stats[tuple(names)] = params_diff_stats([(p, want)])
    map_with_names(one, params)
    del ref
    return stats


def dpt_shared_unequal(params, cfg, grid) -> tuple:
    """(how many leaves several ranks of the grid hold, those of them whose
    copies differ anywhere): a leaf ``"data"`` or ``"model"`` leaves whole
    is held by every rank with its piece (``holder_key``), whose copies,
    gathered over every rank, must be equal bit for bit. Every rank calls
    it."""
    from repro_torch.distributed.data_parallel import holder_key
    from repro_torch.distributed.sharding import map_with_names
    from repro_torch.distributed.tensor_parallel import all_gather

    leaves = []
    map_with_names(lambda names, p: leaves.append((tuple(names), p)), params)
    n, unequal = 0, []
    for names, p in leaves:
        if len({holder_key(names, cfg, grid.dims, r) for r in range(grid.world.size)}) == \
                grid.world.size:
            continue
        mine = holder_key(names, cfg, grid.dims, grid.world.rank)
        if any(holder_key(names, cfg, grid.dims, r) == mine and not torch.equal(part, p)
               for r, part in enumerate(all_gather(p, grid.world))):
            unequal.append(".".join(names))
        n += 1
    return n, unequal


def dpt_ckpt(seed: int, world, grid, d: str) -> dict:
    """The checkpoint round trip at ``TPT_CKPT_LAYERS`` layers on the
    grid: it trains, checkpoints after step ``TPT_SAVE_AFTER`` (the whole
    arrays, each leaf gathered to rank 0 alone) and takes step 3, whose
    parameters are gathered to rank 0; then ranks 0 and 1 as ``(data 1,
    model 2)``, and rank 0 alone, each restore the checkpoint through
    ``reshard_restore`` and take step 3 (:func:`dpt_restore_step`)."""
    from repro_torch.distributed.sharding import Mesh, gather_to_root, group_mesh, map_with_names

    ck = tpt_train_cfg(TPT_CKPT_LAYERS)
    leg = tpt_train_leg(seed, grid.device, grid, ckpt_dir=d, n_layers=TPT_CKPT_LAYERS,
                        host_params=False)
    params = leg.pop("params")
    whole = map_with_names(lambda names, t: gather_to_root(t, names, ck, grid), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"group": leg}
    tp2 = world.subgroup(2)
    if tp2 is not None:
        out["model2"] = dpt_restore_step(seed, ck, d, group_mesh(tp2), tp2, whole)
    if world.rank == 0:
        out["one_rank"] = dpt_restore_step(seed, ck, d, Mesh([grid.device], ("model",)), None,
                                           whole)
    return out


def dpt_restore_step(seed: int, ck, d: str, mesh, tp, whole) -> dict:
    """Restore ``d``'s checkpoint onto ``mesh`` (``reshard_restore``: each
    rank of ``tp`` its shards, read leaf by leaf) and take step 3 from the
    restored pipeline; on rank 0 the parameters, gathered to it, against
    the grid's step-3 tree ``whole``."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.distributed.sharding import gather_to_root, map_with_names, mesh_device
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    meta = M.params_meta(ck)   # shapes and dtypes
    template = {"params": meta, "opt": init_opt_state(meta)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, manifest = reshard_restore(ck, template, d, mesh)
    torch.cuda.synchronize()
    out = {"restore_s": time.perf_counter() - t}
    pipe = DataPipeline(ck, TPT_BATCH, TPT_SEQ, seed=seed)
    pipe.load_state_dict(manifest["extra"]["pipeline"])
    dev = mesh_device(mesh)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
    step = make_train_step(ck, OptimizerConfig(**TPT_OPT), 1, tp)
    p, _, m = step(state["params"], state["opt"], batch)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    del state
    got = map_with_names(lambda names, x: gather_to_root(x, names, ck, tp), p)
    del p
    if whole is not None and got is not None and all(
            x is not None for x in M.tree_leaves(got)):
        out["against_group"] = params_diff_stats(zip(M.tree_leaves(got), M.tree_leaves(whole)))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train_phase(seed: int):
    """The frontends' ``loss_fn`` and training under a group of two ranks
    and a grid of four on the one card (gloo), each against one rank on
    the same seeded weights: (1) full-width, full-depth hubert-xlarge's
    loss and logits at float32 (its non-causal flash at q (2, 8, 512, 80)
    on 8 KV heads a rank) within ``SLICE_TOL``, and internvl2-26b's in bf16
    (q (2, 24, 512, 128) on 4 KV heads a rank, rmsnorm), its logits no
    farther from the float32 witness than the one-rank leg's
    (``tp_bf16_logits``) and its loss no farther than twice the one-rank
    leg's distance plus ``PARAM_TOL``'s rtol of it; each rank's launches as
    the shapes predict; (2) internlm2-1.8b at full width cut to
    ``TPT_TP2_LAYERS`` layers trains ``TPT_STEPS`` steps of (2, 256) at
    float32 at TP 2: losses and grad norms within ``PARAM_TOL`` at the
    first step and ``TPT_LATER_TOL`` after it, the first batch's gradient norm of every layer of every leaf within its rtol,
    the final parameters by ``TPT_PARAM_MAX`` and ``TPT_PARAM_SHARE``, and
    each rank's copy of a leaf held whole equal to rank 0's; (3) at full
    width and full depth the same steps on four ranks as (data 2, model 2)
    against the one-rank leg (run first, its final tree written once),
    under the same gates, each rank's parameter and moment bytes at most
    1.1 times a quarter of the tree's, every leaf several ranks hold equal
    across them bit for bit; (4) at ``TPT_CKPT_LAYERS`` layers the grid
    checkpoints after step 2 and (data 1, model 2) and one rank each
    restore it through ``reshard_restore`` and take step 3, equal to the
    grid's. Returns (launches by path, numbers)."""
    from repro_torch.distributed.tensor_parallel import spawn_tp
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    hub, vl = tpt_front_cfg("hubert-xlarge"), tpt_front_cfg("internvl2-26b")
    lm, lm6, ck = tpt_train_cfg(), tpt_train_cfg(TPT_TP2_LAYERS), tpt_train_cfg(TPT_CKPT_LAYERS)
    print(f"tp train: 2 ranks on one card; hubert ({hub.n_layers} layers, float32) a rank "
          f"{hub.n_heads // 2} of {hub.n_heads} heads of {hub.head_dim}, not causal; internvl2 "
          f"({vl.n_layers} layers, bf16) {vl.n_heads // 2} heads on {vl.n_kv_heads // 2} KV "
          f"heads; both on ({TPT_FRONT_BATCH}, {TPT_FRONT_SEQ}); internlm2-1.8b (float32, "
          f"reference) {TPT_STEPS} steps of ({TPT_BATCH}, {TPT_SEQ}), lr {TPT_OPT['lr']}, at "
          f"TP 2 cut to {lm6.n_layers} layers, on 4 ranks as (pod, data, model) {DPT_GRID} at "
          f"{lm.n_layers} layers, the grid's checkpoint round trip at {ck.n_layers} layers")
    n_lm = sum(int(np.prod(s.shape)) for s in M.tree_leaves(M.param_specs(lm)))
    need = 3 * 4 * sum(int(np.prod(s.shape)) for s in M.tree_leaves(M.param_specs(ck))) \
        + 4 * n_lm
    d = tempfile.mkdtemp(prefix="chip_smoke_tp_train_")
    if shutil.disk_usage(d).free < 1.5 * need:
        raise AssertionError(f"tp train: {shutil.disk_usage(d).free} bytes free for "
                             f"{need} bytes of checkpoint and one-rank tree")
    walls = {}
    # each rank draws internvl2's stacked leaves (and internlm2's) whole at
    # float32 and keeps its shard: its live shards end up inside the freed
    # leaves' segments, which the caching allocator can then neither release
    # nor reuse (20 GB a rank stranded so); expandable segments return them
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        # the ranks first, while this process holds nothing on the card: two
        # ranks drawing internvl2's shards in turn peak near 60 GB together
        free, total = torch.cuda.mem_get_info()
        print(f"tp train: before the ranks this process has {torch.cuda.memory_allocated()} "
              f"bytes allocated, {torch.cuda.memory_reserved()} reserved; the card "
              f"{total - free} of {total} in use")
        t1 = time.perf_counter()
        ranks = spawn_tp(tpt_rank, 2, device="cuda:0", args=(seed,), timeout=900)
        walls["tp2_ranks"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        one = {arch: tpt_front_leg(arch, seed, "cuda", witness=arch == "internvl2-26b")
               for arch in ("hubert-xlarge", "internvl2-26b")}
        one["train"] = tpt_train_leg(seed, "cuda", n_layers=TPT_TP2_LAYERS)
        walls["one_rank_legs"] = time.perf_counter() - t1
        out, paths = {}, {}
        t1 = time.perf_counter()
        out.update(tpt_front_check(ranks, one, hub, vl, paths))
        out["train"] = tpt_tp2_check(ranks, one["train"], lm6)
        walls["tp2_compare"] = time.perf_counter() - t1
        del ranks, one
        # the data-axis leg: the one-rank leg first, its final tree on disk
        t1 = time.perf_counter()
        ref = tpt_train_leg(seed, "cuda")
        torch.save(ref.pop("params"), os.path.join(d, DPT_ONE_RANK))
        walls["one_rank_full"] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        grid = spawn_tp(dpt_rank, int(np.prod(DPT_GRID)), device="cuda:0", args=(seed, d),
                        timeout=900)
        walls["grid_ranks"] = time.perf_counter() - t1
        out["data_axis"] = dpt_check(grid, ref, lm, ck, d)
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        shutil.rmtree(d, ignore_errors=True)
    out["walls"] = walls
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"tp train: phase wall {out['phase_wall_s']:.2f} s ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()) + ")")
    return paths, out


def tpt_front_check(ranks, one, hub, vl, paths) -> dict:
    """The frontends' legs: every rank's launches as counted, its shard
    bytes, and the loss and logits of two ranks against one."""
    out = {}
    for arch, cfg in (("hubert-xlarge", hub), ("internvl2-26b", vl)):
        tag = f"tp train {arch.split('-')[0]}"
        ref = one[arch]
        paths[f"{tag} one rank"] = check_counts(f"{tag} one rank", cfg, ref["counts"],
                                                ref["forms"], forward_counts(cfg, 2), 2)
        leg = {"one_rank": {k: ref[k] for k in ("metrics", "wall_ms", "init_peak_bytes",
                                                "peak_bytes", "param_bytes")}}
        for r in ranks:
            got = r[arch]
            if r["backend"] != "gloo":
                raise AssertionError(f"{tag}: two ranks on one card took {r['backend']}")
            paths[f"{tag} rank {r['rank']}"] = check_counts(
                f"{tag} rank {r['rank']}", cfg, got["counts"], got["forms"],
                forward_counts(cfg, {2: 2}), {2: 2})
            if 2 * got["param_bytes"] > 1.1 * ref["param_bytes"]:
                raise AssertionError(f"{tag}: a rank holds {got['param_bytes']} of "
                                     f"{ref['param_bytes']} bytes")
            leg[f"rank_{r['rank']}"] = {k: got[k] for k in (
                "metrics", "wall_ms", "init_peak_bytes", "peak_bytes", "param_bytes")}
        got = ranks[0][arch]
        if arch == "hubert-xlarge":
            errs = [check_close(f"{tag} loss_fn {k}, 2 ranks against one",
                                torch.tensor(got["metrics"][k]), torch.tensor(
                                    ref["metrics"][k]), SLICE_TOL) for k in ref["metrics"]]
            errs.append(check_close(f"{tag} forward logits, 2 ranks against one",
                                    got["logits"], ref["logits"], SLICE_TOL))
            leg["max_abs_err"] = max(errs)
            print(f"{tag}: float32 loss {got['metrics']['loss']:.6f} at TP 2, "
                  f"{ref['metrics']['loss']:.6f} on one rank; loss and logits max abs err "
                  f"{max(errs):.3e} (atol={SLICE_TOL[0]} rtol={SLICE_TOL[1]})")
        else:
            leg["logits"] = tp_bf16_logits(tag, got["logits"].flatten(),
                                           ref["logits"].flatten(),
                                           ref["f32_logits"].flatten())
            w, l1, l2 = ref["f32_loss"], ref["metrics"]["loss"], got["metrics"]["loss"]
            allowed = 2 * abs(l1 - w) + PARAM_TOL[1] * abs(w)
            leg.update(f32_loss=w, loss_tp2=l2, loss_one=l1, loss_allowed=allowed)
            print(f"{tag}: bf16 loss {l2:.6f} at TP 2, {l1:.6f} on one rank, float32 "
                  f"witness {w:.6f}: TP 2 {abs(l2 - w):.3e} from it (allowed {allowed:.3e}: "
                  f"twice the one rank's {abs(l1 - w):.3e} plus rtol {PARAM_TOL[1]} of it)")
            if abs(l2 - w) > allowed:
                raise AssertionError(f"{tag}: the TP loss {l2} is {abs(l2 - w)} from the "
                                     f"float32 witness {w}, over {allowed}")
        out[arch.split("-")[0]] = leg
    return out


def tpt_metric_misses(tag: str, legs, ref):
    """(each step's metric's largest distance from the one-rank leg's over
    ``legs`` as a share of its limit, the misses): the losses, ``ce``, grad
    norms and ``lr`` step by step, the first step's within ``PARAM_TOL``
    (the same parameters), a later step's within ``TPT_LATER_TOL``. Raises
    if a leg launched a kernel or the one-rank losses are not finite."""
    if any(any(r["launches"].values()) for r in list(legs) + [ref]):
        raise AssertionError(f"{tag}: training launched kernels {[r['launches'] for r in legs]}")
    if any(not np.isfinite(m["loss"]) for m in ref["metrics"]):
        raise AssertionError(f"{tag}: losses {ref['metrics']}")
    shares, misses = {}, []
    for r in legs:
        for i, (g, w) in enumerate(zip(r["metrics"], ref["metrics"])):
            tol = PARAM_TOL if i == 0 else TPT_LATER_TOL
            for key in ("loss", "ce", "grad_norm", "lr"):
                err = abs(g[key] - w[key])
                limit = tol[0] + tol[1] * abs(w[key])
                shares[f"step {i + 1} {key}"] = max(shares.get(f"step {i + 1} {key}", 0.0),
                                                    err / limit)
                if not err <= limit:
                    misses.append(f"{tag} step {i + 1} {key}: {g[key]!r} against one rank's "
                                  f"{w[key]!r}, {err:.3e} apart, over atol={tol[0]} "
                                  f"rtol={tol[1]} ({limit:.3e})")
    return shares, list(dict.fromkeys(misses))


def tpt_tp2_check(ranks, ref, lm6) -> dict:
    """The two-rank training leg at ``TPT_TP2_LAYERS`` layers against its
    one-rank leg."""
    from repro_torch.models import model as M

    tag = f"tp train internlm2 {lm6.n_layers} layers"
    rs = [r["train"] for r in ranks]
    _, misses = tpt_metric_misses(tag, rs, ref)
    if misses:
        raise AssertionError("; ".join(misses))
    leg = {"layers": lm6.n_layers, "grad_norms": tpt_grad_norms(tag, lm6, rs, ref),
           "whole_leaves": tpt_whole_leaves(tag, lm6, [r["params"] for r in rs]),
           "params_vs_one_rank": tpt_params_against(
               f"{tag} 2 ranks against one", params_diff_stats(zip(
                   M.tree_leaves(tpt_whole(lm6, rs)), M.tree_leaves(ref["params"]))),
               "3 steps")}
    coll = rs[0]["collectives"]
    share = [{w: c[w]["seconds"] * 1e3 / ms for w in ("rest", "backward")}
             for c, ms in zip(coll, rs[0]["step_ms"])]
    leg.update(
        losses_tp2=[x["loss"] for x in rs[0]["metrics"]],
        losses_one=[x["loss"] for x in ref["metrics"]],
        grad_norms_tp2=[x["grad_norm"] for x in rs[0]["metrics"]],
        step_ms_tp2=rs[0]["step_ms"], step_ms_one=ref["step_ms"], collectives=coll,
        collective_share=share, rank_peak_bytes=[r["train_peak_bytes"] for r in rs],
        one_rank_peak_bytes=ref["train_peak_bytes"],
        rank_param_bytes=[r["param_bytes"] for r in rs], param_bytes=ref["param_bytes"])
    print(f"{tag}: losses {['%.6f' % x for x in leg['losses_tp2']]} at TP 2, "
          f"{['%.6f' % x for x in leg['losses_one']]} on one rank; steps "
          f"{['%.1f' % x for x in rs[0]['step_ms']]} ms at TP 2 (median "
          f"{statistics.median(rs[0]['step_ms']):.1f}), "
          f"{['%.1f' % x for x in ref['step_ms']]} ms on one rank; collectives a step "
          + "; ".join(f"outside the backward (the forward, the norm) {c['rest']['calls']} "
                      f"calls {c['rest']['bytes']} bytes {1e3 * c['rest']['seconds']:.1f} "
                      f"ms, in the backward {c['backward']['calls']} calls "
                      f"{c['backward']['bytes']} bytes "
                      f"{1e3 * c['backward']['seconds']:.1f} ms" for c in coll[-1:])
          + "; share of the step outside / in the backward "
          + ", ".join(f"{s['rest']:.3f} / {s['backward']:.3f}" for s in share)
          + f"; peaks {leg['rank_peak_bytes']} a rank, {leg['one_rank_peak_bytes']} on one "
          f"rank")
    return leg


def dpt_pieces(names, cfg, grid) -> list:
    """The ranks (indexes into ``grid``, the readings by world rank) that
    hold each piece of the leaf at ``names`` (``holder_key``), a list a
    piece (internlm2 shares no segment between ``"model"`` ranks)."""
    from repro_torch.distributed.data_parallel import holder_key
    pieces = {}
    for i in range(len(grid)):
        pieces.setdefault(holder_key(names, cfg, DPT_GRID, i), []).append(i)
    return list(pieces.values())


def dpt_check(grid, ref, lm, ck, d) -> dict:
    """The data-axis leg's gates and readings from the four ranks'
    readings and the one-rank leg's (``ref``)."""
    from repro_torch.models import model as M

    tag = "tp train internlm2 (data 2, model 2)"
    rs = [r["train"] for r in grid]
    if any(r["backend"] != "gloo" for r in grid):
        raise AssertionError(f"{tag}: four ranks on one card took {[r['backend'] for r in grid]}")
    if [r["coords"] for r in grid] != [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]:
        raise AssertionError(f"{tag}: the ranks' coordinates {[r['coords'] for r in grid]}")
    print(f"{tag}: metrics by step on the grid (rank 0) and on one rank: "
          + "; ".join(f"step {i + 1} " + ", ".join(f"{k} {g[k]:.7g} / {w[k]:.7g}" for k in (
              "loss", "ce", "grad_norm", "lr")) for i, (g, w) in enumerate(
                  zip(rs[0]["metrics"], ref["metrics"]))))
    # the first batch's gradient norms: each piece once, every holder's equal
    worst, n = 0.0, 0
    for names, want in ref["grad_ssq"].items():
        pieces = dpt_pieces(names, lm, grid)
        for held in pieces:
            if any(not torch.equal(rs[i]["grad_ssq"][names], rs[held[0]]["grad_ssq"][names])
                   for i in held[1:]):
                raise AssertionError(f"{tag}: the ranks' gradients of {'.'.join(names)} "
                                     f"differ where they hold the same piece")
        got = sum(rs[held[0]]["grad_ssq"][names] for held in pieces)
        got, want = got.sqrt(), want.sqrt()
        if bool(((want == 0) != (got == 0)).any()):
            raise AssertionError(f"{tag}: a layer of {'.'.join(names)} has a zero gradient on "
                                 f"one leg only")
        rel = ((got - want).abs() / want.clamp_min(1e-300))[want > 0]
        if rel.numel():
            worst = max(worst, float(rel.max()))
        n += want.numel()
        if bool((rel > PARAM_TOL[1]).any()):
            raise AssertionError(f"{tag}: the gradient norm of {'.'.join(names)} is "
                                 f"{float(rel.max()):.3e} from one rank's (limit {PARAM_TOL[1]})")
    print(f"{tag}: first-batch gradient norms of {n} layers of {len(ref['grad_ssq'])} leaves, "
          f"4 ranks against one: max rel err {worst:.3e} (limit {PARAM_TOL[1]})")
    shares, misses = tpt_metric_misses(tag, rs, ref)
    print(f"{tag}: each step's metric against one rank as a share of its limit: "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    if misses:
        raise AssertionError("; ".join(misses))
    # the final parameters: each rank's cut against the one-rank tree's
    stats = {"max_abs": max(st["max_abs"] for r in rs for st in r["against_one"].values()),
             "beyond": 0, "elements": 0}
    for names in rs[0]["against_one"]:
        for held in dpt_pieces(names, lm, grid):
            stats["beyond"] += rs[held[0]]["against_one"][names]["beyond"]
            stats["elements"] += rs[held[0]]["against_one"][names]["elements"]
    params = tpt_params_against(f"{tag} 4 ranks against one", stats, "3 steps")
    if stats["elements"] != sum(int(np.prod(s.shape)) for s in M.tree_leaves(M.param_specs(lm))):
        raise AssertionError(f"{tag}: the pieces hold {stats['elements']} elements")
    quarter = 1.1 * ref["param_bytes"] / 4
    for r in rs:
        if r["param_bytes"] > quarter or r["moment_bytes"] > 2 * quarter:
            raise AssertionError(f"{tag}: a rank holds {r['param_bytes']} parameter and "
                                 f"{r['moment_bytes']} moment bytes of {ref['param_bytes']} "
                                 f"and {2 * ref['param_bytes']}")
    shared = {r["shared_leaves"] for r in rs}
    print(f"{tag}: every leaf several ranks hold ({shared} of them) equal across its holders "
          f"bit for bit; a rank holds {[r['param_bytes'] for r in rs]} parameter and "
          f"{[r['moment_bytes'] for r in rs]} moment bytes of {ref['param_bytes']} and "
          f"{2 * ref['param_bytes']} (limit 1.1 x a quarter)")
    coll = [r["collectives"] for r in rs]
    axes = ("model", "data", "batch", "world")
    by_axis = [{ax: {w: {k: st[f"{pre}{ax}_{k}"] for k in ("calls", "bytes", "seconds")}
                     for w, pre in (("all", ""), ("backward", "backward_"))} for ax in axes}
               for st in (c["step"] for c in coll[0])]
    leg = {"grad_norms": {"layers": n, "max_rel_err": worst}, "params_vs_one_rank": params,
           "metric_limit_shares": shares,
           "shared_leaves": min(shared),
           "losses": [x["loss"] for x in rs[0]["metrics"]],
           "losses_one": [x["loss"] for x in ref["metrics"]],
           "grad_norms_grid": [x["grad_norm"] for x in rs[0]["metrics"]],
           "step_ms": [r["step_ms"] for r in rs], "step_ms_one": ref["step_ms"],
           "collectives_by_axis": by_axis,
           "init_peak_bytes": [r["init_peak_bytes"] for r in rs],
           "train_peak_bytes": [r["train_peak_bytes"] for r in rs],
           "one_rank_peak_bytes": ref["train_peak_bytes"],
           "param_bytes": [r["param_bytes"] for r in rs],
           "moment_bytes": [r["moment_bytes"] for r in rs], "whole_param_bytes":
           ref["param_bytes"], "init_s": [r["init_s"] for r in rs],
           "compare_s": [r["compare_s"] for r in rs]}
    print(f"{tag}: losses {['%.6f' % x for x in leg['losses']]} on the grid, "
          f"{['%.6f' % x for x in leg['losses_one']]} on one rank; steps "
          f"{['%.1f' % x for x in rs[0]['step_ms']]} ms on the grid (rank 0; median "
          f"{statistics.median(rs[0]['step_ms']):.1f}), "
          f"{['%.1f' % x for x in ref['step_ms']]} ms on one rank; collectives of the last "
          f"step by axis (calls, bytes, ms; the backward's apart) "
          + "; ".join(f"{ax} {v['all']['calls']}, {v['all']['bytes']}, "
                      f"{1e3 * v['all']['seconds']:.1f} (backward {v['backward']['calls']}, "
                      f"{v['backward']['bytes']}, {1e3 * v['backward']['seconds']:.1f})"
                      for ax, v in by_axis[-1].items())
          + f"; peaks a rank: init {leg['init_peak_bytes']}, training "
          f"{leg['train_peak_bytes']}; one rank {leg['one_rank_peak_bytes']}")
    # the checkpoint round trip
    tag = f"tp train internlm2 {ck.n_layers} layers"
    group = grid[0]["ckpt"]["group"]
    cks = {"save_s": group["save_s"],
           "checkpoint_bytes": sum(os.path.getsize(os.path.join(dp, f))
                                   for dp, _, fs in os.walk(d) for f in fs
                                   if not f.endswith(".pt"))}
    for name, what in (("model2", "(data 1, model 2)"), ("one_rank", "one rank")):
        res = grid[0]["ckpt"][name]
        for r in grid[:2 if name == "model2" else 1]:
            for key in ("loss", "ce", "grad_norm", "lr"):
                check_close(f"{tag} step {TPT_STEPS} {key}, restored on {what} (rank "
                            f"{r['rank']}) against the grid",
                            torch.tensor(r["ckpt"][name]["metrics"][key]),
                            torch.tensor(group["metrics"][-1][key]), PARAM_TOL)
        cks[name] = {"restore_s": res["restore_s"], "params_vs_grid": tpt_params_against(
            f"{tag} restored on {what}, step {TPT_STEPS}, against the grid",
            res["against_group"], "1 step")}
    print(f"{tag}: the grid's checkpoint of {cks['checkpoint_bytes']} bytes saved in "
          f"{cks['save_s']:.2f} s (each leaf gathered to rank 0 alone), restored in "
          f"{cks['model2']['restore_s']:.2f} s on (data 1, model 2) and "
          f"{cks['one_rank']['restore_s']:.2f} s on one rank")
    leg["ckpt"] = cks
    return leg


def tpt_whole(cfg, rs) -> dict:
    """The whole parameter tree from the two ranks' final shards (a leaf
    every rank holds whole is rank 0's; :func:`tpt_whole_leaves` holds the
    other rank's copy to it)."""
    from repro_torch.distributed.sharding import assemble_shards, map_with_names
    return map_with_names(lambda names, _: assemble_shards(
        [_at_path(r["params"], names) for r in rs], names, cfg), rs[0]["params"])


def tpt_whole_leaves(tag: str, cfg, trees) -> int:
    """Every rank's copy of each leaf it holds whole equals rank 0's bit for
    bit; returns how many leaves were held so."""
    from repro_torch.distributed.sharding import map_with_names, tp_split
    whole = []
    map_with_names(lambda names, _: whole.append(tuple(names))
                   if tp_split(names, cfg, len(trees)) is None else None, trees[0])
    for names in whole:
        for r, tree in enumerate(trees[1:], 1):
            if not torch.equal(_at_path(tree, names), _at_path(trees[0], names)):
                raise AssertionError(f"{tag}: rank {r}'s whole {'.'.join(names)} is not rank "
                                     f"0's")
    print(f"{tag}: every rank's copy of the {len(whole)} leaves held whole equals rank 0's "
          f"bit for bit")
    return len(whole)


def tpt_grad_norms(tag: str, cfg, rs, ref) -> dict:
    """The first batch's gradient norm of every layer of every leaf, two
    ranks against one: a split leaf's sums of squares added over the
    ranks, a whole leaf's equal on both; each within ``PARAM_TOL``'s rtol
    of one rank's (a partial, doubled or missing gradient of any layer of
    any leaf moves its norm far beyond it)."""
    from repro_torch.distributed.sharding import tp_split
    worst, n = 0.0, 0
    for names, want in ref["grad_ssq"].items():
        parts = [r["grad_ssq"][names] for r in rs]
        if tp_split(names, cfg, len(rs)) is None:
            if any(not torch.equal(x, parts[0]) for x in parts[1:]):
                raise AssertionError(f"{tag}: the ranks' gradients of the whole "
                                     f"{'.'.join(names)} differ")
            got = parts[0]
        else:
            got = sum(parts)
        got, want = got.sqrt(), want.sqrt()
        if bool(((want == 0) != (got == 0)).any()):
            raise AssertionError(f"{tag}: a layer of {'.'.join(names)} has a zero gradient on "
                                 f"one leg only")
        rel = ((got - want).abs() / want.clamp_min(1e-300))[want > 0]
        if rel.numel():
            worst = max(worst, float(rel.max()))
        n += want.numel()
        if bool((rel > PARAM_TOL[1]).any()):
            raise AssertionError(f"{tag}: the gradient norm of {'.'.join(names)} is "
                                 f"{float(rel.max()):.3e} from one rank's (limit {PARAM_TOL[1]})")
    print(f"{tag}: first-batch gradient norms of {n} layers of {len(ref['grad_ssq'])} leaves, "
          f"2 ranks against one: max rel err {worst:.3e} (limit {PARAM_TOL[1]})")
    return {"layers": n, "max_rel_err": worst}


def params_diff_stats(pairs) -> dict:
    """The largest difference over (got, want) tensor pairs, the elements
    beyond ``PARAM_TOL`` of ``want`` and the element count."""
    worst, beyond, total = 0.0, 0, 0
    for a, b in pairs:
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        beyond += int((diff > PARAM_TOL[0] + PARAM_TOL[1] * b.abs()).sum())
        total += b.numel()
    return {"max_abs": worst, "beyond": beyond, "elements": total}


def tpt_params_against(tag: str, stats: dict, steps: str) -> dict:
    """Two final parameter trees' :func:`params_diff_stats`: every element
    within ``TPT_PARAM_MAX`` of ``steps`` apart, at most
    ``TPT_PARAM_SHARE`` of them beyond ``PARAM_TOL``."""
    bound = TPT_PARAM_MAX[steps]
    worst, beyond, total = stats["max_abs"], stats["beyond"], stats["elements"]
    res = {"max_abs": worst, "beyond_param_tol": beyond, "elements": total,
           "share": beyond / total, "bound": bound}
    print(f"{tag}: final parameters max abs diff {worst:.3e} (bound {bound:.0e}), "
          f"{beyond} of {total} elements beyond atol={PARAM_TOL[0]} rtol={PARAM_TOL[1]} "
          f"({beyond / total:.2e}, limit {TPT_PARAM_SHARE:.0e})")
    if worst > bound or beyond / total > TPT_PARAM_SHARE:
        raise AssertionError(f"{tag}: {res}")
    return res


def _at_path(tree, names):
    for k in names:
        tree = tree[k]
    return tree


def stablelm_phase(seed: int):
    """Full-width, full-depth stablelm-12b (bf16 weights) served through
    ContinuousEngine under ``kernel_impls="auto"``: flash at head_dim 160
    and every norm on rmsnorm; 4 requests of (512, 16); then
    ``ServingEngine.score`` on the same weights."""
    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ContinuousEngine

    n_req, prompt_len, new_tok, n_slots = 4, 512, 16, 4
    cfg = with_kernel_impls(dataclasses.replace(get_config("stablelm-12b"),
                                                param_dtype="bfloat16"), "auto")
    print(f"stablelm: {cfg.arch_id} layers={cfg.n_layers} d={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"dtype={cfg.dtype}/{cfg.param_dtype} kernel_impls={dict(cfg.kernel_impls)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    engine = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=prompt_len + new_tok + 16,
                              device="cuda")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    print(f"stablelm: {sum(t.numel() for t in M.tree_leaves(params))} parameters "
          f"({M.nbytes(params)} bytes), init {time.perf_counter() - t0:.2f} s, peak memory "
          f"during init {init_peak} bytes")
    prompts = np.random.default_rng(seed + 12).integers(
        0, cfg.vocab_size, size=(n_req, prompt_len)).tolist()
    engine.add(GenRequest(id=-1, prompt=prompts[0][:16], max_new=2))  # warm-up, not counted
    engine.run()
    torch.cuda.synchronize()
    run = drive(engine, prompts, new_tok, GenRequest)
    if run["prefills"] != n_req:
        raise AssertionError(f"stablelm: {run['prefills']} prefills, expected {n_req}")
    passes = run["prefills"] + run["steps"]
    expect = dict(forward_counts(cfg, passes), flash_attention=cfg.n_layers * run["prefills"])
    print(f"stablelm: {run['prefills']} prefills, {run['steps']} decode steps")
    counts = check_counts("stablelm", cfg, run["counts"], run["forms"], expect, passes)
    serving = serving_summary("stablelm", run, n_req, new_tok, init_peak)
    serving["score"] = score_leg("stablelm", cfg, engine.params, seed)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {f"stablelm_{k}": x for k, x in serving.items()}


# HBM bytes a parameter moves in one AdamW update: p, g, m, v read (fp32)
# and p, m, v written
ADAMW_BYTES_PER_PARAM = 28
# the largest relative difference allowed between the remat modes' losses and
# grad norms on the card (the recomputed forward runs the same kernels on
# the same inputs; cuBLAS may pick another algorithm inside a checkpoint)
REMAT_REL_TOL = 1e-3
# the largest relative difference allowed between a resumed run and an
# unbroken one on the card, losses and parameters
RESUME_REL_TOL = 1e-5


def _train_cfg(n_layers=None, remat="none"):
    """internlm2-1.8b FULL (bf16 compute, fp32 parameters, reference ops),
    cut to ``n_layers`` when given."""
    from repro_torch.configs import get_config

    cfg = get_config("internlm2-1.8b")
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, remat=remat)


def _cuda_batch(pipe) -> dict:
    return {k: torch.from_numpy(v).to("cuda") for k, v in pipe.next_batch().items()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_full_leg(seed: int) -> dict:
    """(a) internlm2-1.8b FULL (1.889 B parameters) trains 12 steps of (8 x
    512) tokens in 2 microbatches under ``kernel_impls="reference"``: finite
    losses and grad norms, the last loss below the first, no kernel launched.
    Then one profiled step, (b) the remat modes on one microbatch of the
    first batch, and ``adamw_update`` alone against its bytes floor. Between
    the profiled step and (b), steps with the stacked leaves split per layer
    by ``v[i]`` (the earlier design) and by one ``unbind``, in turns."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import (OptimizerConfig, adamw_update, global_norm,
                                                init_opt_state)
    from repro_torch.training.train_step import _grads_of, make_train_step

    steps, batch, seq, n_mb = 12, 8, 512, 2
    cfg = _train_cfg()
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    print(f"training: {cfg.arch_id} layers={cfg.n_layers} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype="
          f"{cfg.dtype}/{cfg.param_dtype} remat={cfg.remat} kernel_impls={dict(cfg.kernel_impls)}; "
          f"batch {batch} x {seq} in {n_mb} microbatches, {steps} steps, {opt_cfg}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    state_bytes = M.nbytes(params) + M.nbytes(opt["m"]) + M.nbytes(opt["v"])
    pgmv = state_bytes + M.nbytes(params)  # + one fp32 gradient tree (counted)
    init_peak = torch.cuda.max_memory_allocated()
    print(f"training: {n_params} parameters; p + m + v {state_bytes} bytes, with one gradient "
          f"tree {pgmv} bytes (counted); init {time.perf_counter() - t0:.2f} s, peak memory "
          f"during init {init_peak} bytes")
    step_fn = make_train_step(cfg, opt_cfg, n_mb)
    pipe = DataPipeline(cfg, batch, seq, seed=seed)
    first_batch = None
    losses, gnorms, ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i in range(steps):
        b = _cuda_batch(pipe)
        if first_batch is None:
            first_batch = b
        t = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])  # wait for the card
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(loss)
        gnorms.append(gnorm)
        print(f"training: step {i + 1} loss {loss:.5f} ce {float(metrics['ce']):.5f} grad_norm "
              f"{gnorm:.5f} lr {float(metrics['lr']):.3e} {ms[-1]:.2f} ms")
    counts = launch_counts()
    train_peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"training: kernels launched on the reference path: {counts}")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"training: non-finite loss or grad norm {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: loss did not fall: {losses}")
    tokens = batch * seq
    med = statistics.median(ms[1:])
    flops = 6 * n_params * tokens
    out = {"params": n_params, "losses": losses, "grad_norms": gnorms, "step_ms": ms,
           "median_step_ms": med, "tokens_per_s": tokens / (med / 1e3),
           "init_peak_memory_bytes": init_peak, "train_peak_memory_bytes": train_peak,
           "state_bytes_counted": state_bytes, "pgmv_bytes_counted": pgmv,
           "launches": counts, "flops_per_step_counted": flops,
           "flops_floor_ms": 1e3 * flops / PEAK_FLOPS[torch.bfloat16]}
    print(f"training: loss {losses[0]:.5f} -> {losses[-1]:.5f} over {steps} steps; step median "
          f"{med:.2f} ms (steps 2-{steps}; step 1 {ms[0]:.2f} ms) = {out['tokens_per_s']:.1f} "
          f"tokens/s; counted 6 N T = {flops:.4e} FLOP a step, {out['flops_floor_ms']:.2f} ms at "
          f"the bf16 dense peak; launches {counts}; peak memory training {train_peak} bytes, "
          f"init {init_peak} bytes, counted p+g+m+v {pgmv} bytes")

    def one_step():
        nonlocal params, opt
        params, opt, _ = step_fn(params, opt, _cuda_batch(pipe))
    out.update(profile_run(one_step, f"one train step ((8, 512) in 2 microbatches, step "
                           f"{steps + 1}, profiler on)", 1, "train", "step"))

    # the stacked leaves split per layer by v[i] (the earlier design, whose
    # backward zero-fills a whole stacked leaf for every layer) against one
    # unbind (transformer._layers), in turns on the same card
    from repro_torch.models import transformer
    unbind = transformer._layers
    split = {"index": lambda tree, n: [transformer._layer(tree, i) for i in range(n)],
             "unbind": unbind}
    ab = {"index": [], "unbind": []}
    try:
        for label in ("index", "unbind", "unbind", "index"):
            transformer._layers = split[label]
            t_ms = []
            for _ in range(3):
                t = time.perf_counter()
                one_step()
                torch.cuda.synchronize()
                t_ms.append(1e3 * (time.perf_counter() - t))
            ab[label].append(statistics.median(t_ms[1:]))
    finally:
        transformer._layers = unbind
    out["layer_split_step_ms"] = ab
    print(f"training: step ms with the stacked leaves split by v[i] "
          f"{['%.2f' % x for x in ab['index']]}, by one unbind "
          f"{['%.2f' % x for x in ab['unbind']]} (in turns, median of the last 2 of 3 steps)")

    # (b) remat: one microbatch of the first batch, loss and gradients per mode
    mb = {k: v[:batch // n_mb] for k, v in first_batch.items()}
    remat = {}
    for mode in ("none", "full", "dots_saveable"):
        rcfg = dataclasses.replace(cfg, remat=mode)
        _grads_of(params, mb, rcfg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        walls = []
        for _ in range(2):
            grads = None
            t = time.perf_counter()
            loss, _, grads = _grads_of(params, mb, rcfg)
            gn = float(global_norm(grads))
            walls.append(1e3 * (time.perf_counter() - t))
        peak = torch.cuda.max_memory_allocated()
        remat[mode] = {"loss": float(loss), "grad_norm": gn, "ms": walls,
                       "peak_memory_bytes": peak, "peak_above_state_bytes": peak - base}
        if mode != "dots_saveable":
            del grads
        print(f"remat {mode}: loss {remat[mode]['loss']:.7f} grad_norm {gn:.7f}, loss and grads "
              f"of one (4, 512) microbatch {walls[0]:.2f} / {walls[1]:.2f} ms (two passes), peak "
              f"memory {peak} bytes ({peak - base} above the state)")
    worst = max(_rel(remat[m][k], remat["none"][k]) for m in ("full", "dots_saveable")
                for k in ("loss", "grad_norm"))
    print(f"remat: largest relative difference against none {worst:.3e} (limit "
          f"{REMAT_REL_TOL}); peak full < none: "
          f"{remat['full']['peak_memory_bytes'] < remat['none']['peak_memory_bytes']}")
    if worst > REMAT_REL_TOL:
        raise AssertionError(f"remat: modes disagree by {worst:.3e}: {remat}")
    if not remat["full"]["peak_memory_bytes"] < remat["none"]["peak_memory_bytes"]:
        raise AssertionError(f"remat: full does not lower the peak: {remat}")
    out["remat"] = dict(remat, max_rel_diff=worst)

    # adamw_update alone, on the last gradient tree (consumes params and opt)
    bytes_ = ADAMW_BYTES_PER_PARAM * n_params
    bound = 1e3 * bytes_ / PEAK_BYTES_PER_S
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    adamw_update(grads, opt, params, opt_cfg)  # warm-up
    torch.cuda.synchronize()
    reps = 5
    start.record()
    for _ in range(reps):
        adamw_update(grads, opt, params, opt_cfg)
    end.record()
    torch.cuda.synchronize()
    adamw_ms = start.elapsed_time(end) / reps
    out.update(adamw_ms=adamw_ms, adamw_bound_ms=bound, adamw_bytes_counted=bytes_)
    print(f"adamw_update: {adamw_ms:.3f} ms a call (CUDA events, {reps} calls) over {n_params} "
          f"parameters; bytes floor {bytes_} B / {PEAK_BYTES_PER_S:.3e} B/s = {bound:.3f} ms "
          f"({adamw_ms / bound:.2f}x)")
    del params, opt, grads, first_batch, mb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def guard_leg(seed: int) -> dict:
    """(c) internlm2-1.8b FULL cut to 1 layer under ``kernel_impls="auto"``:
    ``loss_fn`` with parameters that require grad raises ``RuntimeError``
    before any launch; with the refusal bypassed, the backward returns and
    leaves get no gradient (what the refusal prevents); under
    ``torch.no_grad()`` it launches the forward's kernels as counted.
    Returns those launches."""
    from repro_torch.configs import with_kernel_impls
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M

    cfg = with_kernel_impls(_train_cfg(n_layers=1), "auto")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed + 13))
    batch = {"tokens": tokens, "labels": tokens}
    grad_params = M.tree_map(lambda p: p.detach().requires_grad_(), params)
    reset_launch_counts()
    try:
        M.loss_fn(grad_params, batch, cfg)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("guard: loss_fn differentiated through the kernels")
    torch.cuda.synchronize()
    if "reference" not in refused or any(launch_counts().values()):
        raise AssertionError(f"guard: {refused!r}, launches {launch_counts()}")
    print(f"guard: loss_fn with parameters that require grad under auto raised RuntimeError "
          f"({refused[:90]}...), launches {launch_counts()}")
    # what the refusal prevents: with it bypassed, the backward returns and
    # the leaves upstream of the first kernel op get no gradient
    from repro_torch.kernels import ops
    refuse = ops._refuse_grad
    ops._refuse_grad = lambda *a: None
    try:
        M.loss_fn(grad_params, batch, cfg)[0].backward()
    finally:
        ops._refuse_grad = refuse
    leaves = M.tree_leaves(grad_params)
    no_grad_leaves = sum(t.grad is None for t in leaves)
    print(f"guard: with the refusal bypassed, backward returns and {no_grad_leaves} of "
          f"{len(leaves)} parameter leaves get no gradient")
    if no_grad_leaves == 0:
        raise AssertionError("guard: the bypassed backward reached every leaf")
    reset_launch_counts()
    with torch.no_grad():
        loss = float(M.loss_fn(grad_params, batch, cfg)[0])
    counts = check_counts("guard no_grad loss_fn", cfg, launch_counts(), rmsnorm_form_counts(),
                          forward_counts(cfg), 1)
    if not np.isfinite(loss):
        raise AssertionError(f"guard: loss {loss}")
    del params, grad_params, leaves
    torch.cuda.empty_cache()
    return counts


def restart_leg(seed: int) -> dict:
    """(d) checkpoint and restart at full width cut to 2 layers: 8 steps
    unbroken; then 4 steps, an async save at step 4, a restore that must
    give the saved bits and pipeline step, and steps 5-8, which must equal
    the unbroken run's (``RESUME_REL_TOL``)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    steps, save_at, batch, seq, n_mb = 8, 4, 8, 512, 2
    cfg = _train_cfg(n_layers=2)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, n_mb)

    def fresh():
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        return params, init_opt_state(params), DataPipeline(cfg, batch, seq, seed=seed)

    def run(params, opt, pipe, n):
        losses = []
        for _ in range(n):
            params, opt, m = step_fn(params, opt, _cuda_batch(pipe))
            losses.append(float(m["loss"]))
        return params, opt, losses

    params, opt, pipe = fresh()
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    p_full, o_full, l_full = run(params, opt, pipe, steps)
    params, opt, pipe = fresh()
    params, opt, l_first = run(params, opt, pipe, save_at)
    state = {"params": params, "opt": opt}
    need = M.nbytes(params) + M.nbytes(opt["m"]) + M.nbytes(opt["v"])
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        if free < 1.1 * need:
            raise RuntimeError(f"restart: the checkpoint needs {need} bytes (+10%) under {d}, "
                               f"{free} bytes free")
        t = time.perf_counter()
        ckpt.save(state, d, save_at, extra={"pipeline": pipe.state_dict()}, async_save=True)
        snapshot_s = time.perf_counter() - t
        ckpt.wait_for_saves()
        save_s = time.perf_counter() - t
        size = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        template = M.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), state)
        t = time.perf_counter()
        restored, manifest = ckpt.restore(template, d)  # device None: the card
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for a, b in zip(M.tree_leaves(restored), M.tree_leaves(state)):
        check_bits("restart: restored leaf", a, b)
    if manifest["step"] != save_at or manifest["extra"]["pipeline"] != pipe.state_dict():
        raise AssertionError(f"restart: manifest {manifest['step']} {manifest['extra']}")
    del state, params, opt  # "fail"
    pipe = DataPipeline(cfg, batch, seq, seed=seed)
    pipe.load_state_dict(manifest["extra"]["pipeline"])
    p_res, o_res, l_rest = run(restored["params"], restored["opt"], pipe, steps - save_at)
    loss_diff = max(_rel(a, b) for a, b in zip(l_first + l_rest, l_full))
    param_diff = max(((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)
                      ).item() for a, b in zip(M.tree_leaves({"p": p_res, "o": o_res}),
                                               M.tree_leaves({"p": p_full, "o": o_full})))
    print(f"restart: {cfg.arch_id} cut to {cfg.n_layers} layers, {n_params} parameters; "
          f"checkpoint of p + m + v at step {save_at}: {size} bytes on disk ({need} counted); "
          f"async save returned after {snapshot_s:.3f} s (host snapshot), written after "
          f"{save_s:.3f} s; restore {restore_s:.3f} s; restored tensors and pipeline step equal "
          f"the saved ones bit for bit; losses unbroken {['%.6f' % x for x in l_full]}, resumed "
          f"{['%.6f' % x for x in l_first + l_rest]}; largest relative difference: losses "
          f"{loss_diff:.3e}, parameters and m, v {param_diff:.3e} (limit {RESUME_REL_TOL})")
    if loss_diff > RESUME_REL_TOL or param_diff > RESUME_REL_TOL:
        raise AssertionError(f"restart: the resumed run differs from the unbroken one "
                             f"(losses {loss_diff:.3e}, parameters {param_diff:.3e})")
    del p_full, o_full, p_res, o_res, restored
    torch.cuda.empty_cache()
    return {"params": n_params, "bytes": size, "bytes_counted": need, "snapshot_s": snapshot_s,
            "save_s": save_s, "restore_s": restore_s, "loss_max_rel_diff": loss_diff,
            "param_max_rel_diff": param_diff}


def launcher_leg(seed: int) -> dict:
    """(e) ``repro_torch.launch.train.train()`` on the card at the smoke
    config, 4 steps with a checkpoint, then to 8 resuming from it; the
    ``train_lm`` twin; and 3 steps of ``make_train_step`` at smoke f32 on
    the card against the CPU (5e-5/5e-4)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train_lm
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tc = TrainConfig(steps=8, global_batch=8, seq_len=128, n_microbatches=2, seed=seed,
                         ckpt_dir=d, ckpt_every=4, log_every=2)
        _, _, h1 = train(dataclasses.replace(tc, steps=4))
        _, _, h2 = train(tc)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if h1[-1][0] != 4 or h2[0][0] != 6 or not np.isfinite([x for _, x in h1 + h2]).all():
        raise AssertionError(f"launcher: histories {h1} {h2}")
    first, last = train_lm.main(["--steps", "40"])
    if not last < first:
        raise AssertionError(f"train_lm: loss {first} -> {last}")
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), dtype="float32")
    step_fn = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    pc = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    pg = M.tree_map(lambda t: t.to("cuda"), pc)
    oc, og = init_opt_state(pc), init_opt_state(pg)
    pipe = DataPipeline(cfg, 4, 64, seed=seed)
    err = 0.0
    for _ in range(3):
        b = {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
        pc, oc, mc = step_fn(pc, oc, b)
        pg, og, mg = step_fn(pg, og, {k: v.to("cuda") for k, v in b.items()})
        for k in mc:
            err = max(err, check_close(f"launcher: cuda vs cpu {k}", mg[k].cpu(), mc[k],
                                       TOL[torch.float32]))
    for a, b in zip(M.tree_leaves(pg), M.tree_leaves(pc)):
        err = max(err, check_close("launcher: cuda vs cpu params", a.cpu(), b, TOL[torch.float32]))
    print(f"launcher: train() 4 steps then resumed to 8 on cuda (history {h1} then {h2}); "
          f"train_lm loss {first:.4f} -> {last:.4f}; smoke f32 3 steps cuda vs cpu max abs err "
          f"{err:.3e} (atol/rtol {TOL[torch.float32]})")
    return {"history": h1 + h2, "train_lm": [first, last], "cuda_vs_cpu_max_abs_err": err}


def training_phase(seed: int):
    """(a)-(e) of the training phase; returns ((c)'s launches, results)."""
    out = {"full": train_full_leg(seed)}
    guard_counts = guard_leg(seed)
    out["restart"] = restart_leg(seed)
    out["launcher"] = launcher_leg(seed)
    return guard_counts, out


# --- long prompts, the dry run and the example twins ----------------------------------------
LONG_PROMPT = 32_768   # prefill_32k's sequence (repro's SHAPES), one prompt
# the chunked leg's profile runs on a cut of this many layers (every layer
# does the same work at the same shapes): its whole-depth run launches about
# 1.8 million kernels, and the profiler takes over a minute to process a
# 4-layer cut's 200 thousand
LONG_PROFILE_LAYERS = 1
# flash at 32k against chunked_mha at float32: the relative L2 error of
# every block of 512 rows (bf16 rounding of the output and of the softmax
# weights gives a few 1e-3; a kernel that drops one 64-key tile of the
# rows past 16k gives about 5e-2)
FLASH_32K_REL_L2 = 1e-2


def long_prompt_floors(cfg, n_params: int, s: int) -> dict:
    """Counted floors of one (1, s) prefill at the bf16 peak: 2 FLOPs a
    non-embedding parameter a token (the tied head runs on the last
    position only), plus attention's QK^T and PV: every (512, 1024) block
    for chunked_mha (repro computes the masked upper triangle too, over S
    padded to the chunks), the causal pairs for flash."""
    from repro_torch.launch.roofline import PEAK_FLOPS
    dense = 2.0 * (n_params - cfg.vocab_padded * cfg.d_model) * s
    per_pair = 4.0 * cfg.n_heads * cfg.head_dim * cfg.n_layers
    s_pad = -(-s // 1024) * 1024
    attn = {"chunked": per_pair * (-(-s // 512) * 512) * s_pad,
            "flash": per_pair * s * (s + 1) / 2}
    return {leg: {"flops": dense + a, "floor_s": (dense + a) / PEAK_FLOPS}
            for leg, a in attn.items()}


def long_prompt_phase(cfg, params, seed: int) -> tuple:
    """Full-width, full-depth qwen2.5-3b (the dense phase's weights, bf16)
    on one prompt of prefill_32k's 32,768 tokens (its batch of 32 cut to 1):
    leg 1 ``attn_impl="chunked"`` with the rmsnorm kernel on, leg 2 ``auto``
    (flash). Each leg: wall, peak memory and launches of one prefill, then
    device ms and idle share from the profiler (leg 1 on a cut of
    LONG_PROFILE_LAYERS layers). Then a float32 witness: the chunked path
    on the fp32 weights, no kernel. The legs' last-position logits agree
    within the bf16 tolerance, each leg's distance from the witness is
    recorded, and the legs pick the same greedy token, or the witness
    scores the two picks apart by no more than the legs' measured logit
    disagreement."""
    from repro_torch.configs import with_kernel_impls
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.models import model as M

    legs = {"chunked": with_kernel_impls(dataclasses.replace(cfg, attn_impl="chunked"),
                                         {"rmsnorm": "kernel"}),
            "flash": with_kernel_impls(cfg, "auto")}
    s = LONG_PROMPT
    toks = torch.as_tensor(np.random.default_rng(seed + 21).integers(0, cfg.vocab_size, (1, s)),
                           device="cuda")
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    floors = long_prompt_floors(cfg, n_params, s)
    bf16 = M.cast_params(params, cfg)   # one bf16 copy for both legs
    out, counts, logits = {"reduced": "prefill_32k batch 32 -> 1", "seq": s}, {}, {}
    v = cfg.vocab_size
    with torch.no_grad():
        M.prefill(bf16, {"tokens": toks[:, :1024]}, legs["flash"])   # warm-up, not counted
        for name, c in legs.items():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t = time.perf_counter()
            lg, cache = M.prefill(bf16, {"tokens": toks}, c)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts[name] = dict(launch_counts(), rmsnorm_forms=rmsnorm_form_counts())
            peak = torch.cuda.max_memory_allocated()
            logits[name] = lg[:, :v].float()
            del cache
            expect_flash = cfg.n_layers if name == "flash" else 0
            forms = expected_norm_forms(cfg, 1)
            if (counts[name]["flash_attention"] != expect_flash
                    or counts[name]["rmsnorm_forms"] != forms
                    or counts[name]["moe_gmm"] or counts[name]["ssd"]
                    or counts[name]["paged_attention"]):
                raise AssertionError(f"long prompt {name}: launches {counts[name]}, expected "
                                     f"flash {expect_flash}, rmsnorm {forms}")
            if name == "chunked":
                cut = dataclasses.replace(c, n_layers=LONG_PROFILE_LAYERS)
                stack = {seg: M.tree_map(lambda x: x[:LONG_PROFILE_LAYERS], tree)
                         for seg, tree in bf16["stack"].items()}
                cut_params = dict(bf16, stack=stack)
                prof = profile_run(lambda: M.prefill(cut_params, {"tokens": toks}, cut),
                                   f"long prompt chunked, {LONG_PROFILE_LAYERS}-layer cut "
                                   f"({s} tokens, profiler on)", 1, "long", "prefill")
                scale = cfg.n_layers / LONG_PROFILE_LAYERS
                prof["profile_long_device_ms_full_depth_from_cut"] = (
                    prof.get("profile_long_device_ms_per_prefill", float("nan")) * scale)
            else:
                prof = profile_run(lambda: M.prefill(bf16, {"tokens": toks}, c),
                                   f"long prompt flash ({s} tokens, profiler on)", 1, "long",
                                   "prefill")
            out[name] = {"wall_s": wall, "peak_memory_bytes": peak,
                         "peak_above_weights_bytes": peak - base, "launches": counts[name],
                         "counted_flops": floors[name]["flops"],
                         "counted_floor_s": floors[name]["floor_s"], **prof}
            print(f"long prompt {name}: one ({1}, {s}) prefill in {wall:.3f} s (counted floor "
                  f"{floors[name]['floor_s']:.3f} s at 989e12 FLOP/s, "
                  f"{floors[name]['flops']:.4e} FLOPs), peak memory {peak} bytes "
                  f"({peak - base} above the weights), launches {counts[name]}")
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    # the float32 witness: the chunked path on the fp32 weights with every
    # op plain (no kernel), to say which leg's greedy pick is right
    wcfg = with_kernel_impls(dataclasses.replace(cfg, attn_impl="chunked", dtype="float32"),
                             "reference")
    reset_launch_counts()
    t = time.perf_counter()
    with torch.no_grad():
        lg, cache = M.prefill(params, {"tokens": toks}, wcfg)
    torch.cuda.synchronize()
    out["witness_f32_wall_s"] = time.perf_counter() - t
    if any(launch_counts().values()):
        raise AssertionError(f"long prompt f32 witness launched kernels: {launch_counts()}")
    witness = lg[:, :v].float()
    del lg, cache
    atol, rtol = TOL[torch.bfloat16]
    err = check_close("long prompt last-position logits chunked vs flash", logits["chunked"],
                      logits["flash"], TOL[torch.bfloat16])
    # each bf16 leg against the witness is recorded, not held to the bf16
    # tolerance: that tolerance is one kernel's, and a 36-layer bf16
    # forward departs further from its float32 twin
    if not bool(torch.isfinite(witness).all()):
        raise AssertionError("long prompt: the f32 witness's logits are not finite")
    err_w = {name: {"max_abs_err": (lg - witness).abs().max().item(),
                    "rel_l2": ((lg - witness).norm() / witness.norm()).item()}
             for name, lg in logits.items()}
    picks = {name: int(lg.argmax(-1)) for name, lg in logits.items()}
    picks["f32 witness"] = int(witness.argmax(-1))
    top = {name: [round(float(x), 5) for x in lg[0].topk(3).values]
           for name, lg in (*logits.items(), ("f32 witness", witness))}
    same = picks["chunked"] == picks["flash"]
    # where the legs pick apart, the witness must score the two picks apart
    # by no more than the legs' own measured logit disagreement: a split
    # that the exact logits do not make a tie is a fault
    witness_gap = float(witness[0, picks["chunked"]] - witness[0, picks["flash"]])
    tie = abs(witness_gap) <= err
    out.update(max_abs_err=err, vs_f32_witness=err_w, same_greedy_token=same,
               greedy_tokens=picks, top3_logits=top, witness_gap_between_picks=witness_gap,
               tie_within_measured_disagreement=tie,
               witness_agrees_with={name: picks[name] == picks["f32 witness"]
                                    for name in logits})
    print(f"long prompt: f32 witness (chunked, fp32 weights, no kernel) in "
          f"{out['witness_f32_wall_s']:.3f} s; last-position logits chunked vs flash max abs err "
          f"{err:.3e}, against the witness {err_w} (atol={atol} rtol={rtol}); greedy tokens "
          f"{picks}, same in both legs {same}; top-3 logits {top}; the witness scores the "
          f"chunked pick over the flash pick by {witness_gap:.5f}, within the legs' measured "
          f"disagreement {err:.5f}: {tie}; logit scale {witness.abs().max().item():.3f}")
    if not same and not tie:
        raise AssertionError(f"long prompt: chunked and flash pick {picks}, and the f32 witness "
                             f"scores them {witness_gap} apart, more than the legs' logit "
                             f"disagreement {err}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def flash_32k_phase(gen: torch.Generator) -> dict:
    """Flash at prefill_32k's length, qwen2.5-3b's heads (q (1,16,32768,128),
    2 kv heads, causal, bf16), three ways: the kernel, ``chunked_mha`` (the
    plain online softmax: the plain version's 68.7 GB score matrix does not
    fit) and SDPA (the library call, K/V repeated). The kernel is held
    against chunked_mha at float32 on the same values, element-wise within
    the bf16 tolerance and block by block within ``FLASH_32K_REL_L2``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import flash_attention_op
    from repro_torch.models.attention import chunked_mha

    b, h, kv, s, d = 1, 16, 2, LONG_PROMPT, 128
    cfg = get_config("qwen2.5-3b")
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, kv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, kv, d, device="cuda", generator=gen).to(torch.bfloat16)
    k_rep, v_rep = k.repeat_interleave(h // kv, dim=2), v.repeat_interleave(h // kv, dim=2)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kh_rep, vh_rep = k_rep.transpose(1, 2), v_rep.transpose(1, 2)

    def kernel():
        return flash_attention_op(qh, kh, vh, causal=True)

    def chunked():
        return chunked_mha(q, k_rep, v_rep, cfg)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh_rep, vh_rep, is_causal=True)

    got = kernel().transpose(1, 2).reshape(b, s, h * d)
    # the reference: chunked_mha at float32 on the same bf16 values
    want = chunked_mha(q.float(), k_rep.float(), v_rep.float(), cfg)
    err = check_close("flash 32k vs chunked_mha (f32)", got, want, TOL[torch.bfloat16])
    print(f"check flash 32k vs chunked_mha (f32), element-wise: max abs err {err:.3e} "
          f"(atol={TOL[torch.bfloat16][0]} rtol={TOL[torch.bfloat16][1]})")
    rel = check_row_blocks("flash 32k vs chunked_mha (f32)", got, want, FLASH_32K_REL_L2)
    del got, want
    bound, by = flash_bound(b, h, kv, s, d, torch.bfloat16)
    t = {"shape": f"q ({b},{h},{s},{d}) kv {kv} causal bf16; plain: chunked_mha (the plain "
                  f"flash's {b * h * s * s * 4 / 1e9:.1f} GB of scores do not fit); library: "
                  f"SDPA, K/V repeated", "bound_ms": bound, "bound_by": by, "err": err,
         "rel_l2_max": rel}
    t["ms"], t["eager_ms"] = cuda_ms(kernel, iters=10, reps=3)
    t["library_ms"], t["eager_library_ms"] = cuda_ms(library, iters=10, reps=3)
    t["plain_ms"] = t["eager_plain_ms"] = cuda_ms(chunked, iters=3, graph=False)[1]
    report("flash_attention 32k", t)
    t["plain_ms_note"] = ("chunked_mha, eager (host-bound); the plain flash version is not "
                          "timed: it does not fit")
    print(f"check flash 32k vs chunked_mha (f32): largest relative L2 error of a 512-row block "
          f"{rel:.3e} (limit {FLASH_32K_REL_L2}); plain flash not timed: its score matrix does "
          f"not fit")
    del q, k, v, k_rep, v_rep
    torch.cuda.empty_cache()
    return t


def dryrun_phase(param_bytes_on_card: int) -> dict:
    """The dry run of the 40 cells on the single-pod mesh without probes
    (host only, on ``meta``, after every timed phase so that its host work
    overlaps none of theirs): one line a cell (bottleneck,
    roofline_fraction, argument bytes a device), 32 ok, 8 skipped and 0
    errors, and qwen2.5-3b's parameter bytes on a 1 x 1 mesh held against
    what its fp32 parameters took on the card (the dense phase)."""
    from repro_torch.configs import ARCH_IDS, SHAPES, SHAPES_BY_NAME, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    mesh = make_production_mesh(multi_pod=False)
    recs = [D.run_cell(arch, shape.name, mesh, "single", probes=False)
            for arch in ARCH_IDS for shape in SHAPES]
    status = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "error")}
    for r in recs:
        if r["status"] == "ok":
            rl, mem = r["roofline"], r["memory_analysis"]
            print(f"dryrun {r['arch']} {r['shape']} single: {rl['bottleneck']}, roofline_fraction "
                  f"{rl['roofline_fraction']:.4f}, t_compute {rl['t_compute_s']:.6f} s, t_memory "
                  f"{rl['t_memory_s']:.6f} s, useful_ratio {rl['useful_ratio']:.3f}, argument "
                  f"bytes/dev {mem['argument_bytes_per_dev']}, host {r['run_s']} s")
        else:
            print(f"dryrun {r['arch']} {r['shape']} single: {r['status']} "
                  f"{r.get('reason') or r.get('error')}")
    if status != {"ok": 32, "skipped": 8, "error": 0}:
        raise AssertionError(f"dry run: {status}, expected 32 ok, 8 skipped, 0 errors")
    cfg = get_config("qwen2.5-3b")
    _, _, mem = D._build(cfg, SHAPES_BY_NAME["prefill_32k"], make_mesh((1, 1), ("data", "model")))
    counted = mem["parts"]["params"]
    bias = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    print(f"dryrun: qwen2.5-3b parameters on a 1 x 1 mesh {counted} bytes; the dense phase's "
          f"fp32 parameters took {param_bytes_on_card} bytes on the card; param_count "
          f"{cfg.param_count()} = {counted // 4} - {bias} (QKV biases, which param_count leaves "
          f"out); H100 roofline {RL.CARD}; dry-run host {sum(r.get('run_s', 0) for r in recs):.1f} "
          f"s over the cells")
    if counted != param_bytes_on_card or counted // 4 - bias != cfg.param_count():
        raise AssertionError(f"dry run: parameter bytes {counted} vs {param_bytes_on_card} on "
                             f"the card, param_count {cfg.param_count()}")
    return {"status": status, "param_bytes": counted,
            "cells": {f"{r['arch']} {r['shape']}": r.get("roofline", r.get("reason"))
                      for r in recs}}


def twins_phase() -> tuple:
    """The example twins on the card at their smoke configs: the quickstart
    and the elastic demo. Each twin's launches are read with the counts at
    0 just before it."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, rmsnorm_form_counts
    from repro_torch.launch import elastic_faas_demo, quickstart

    counts, out = {}, {}
    for name, main in (("quickstart", quickstart.main),
                       ("elastic_faas_demo", elastic_faas_demo.main)):
        reset_launch_counts()
        t = time.perf_counter()
        res = main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts[name] = dict(launch_counts(), rmsnorm_forms=rmsnorm_form_counts())
        out[name] = {"wall_s": wall, "launches": counts[name]}
        print(f"twin {name}: wall {wall:.2f} s, launches {counts[name]}")
        if not all(np.isfinite(x) for x in res.values() if isinstance(x, float)):
            raise AssertionError(f"twin {name}: {res}")
        gc.collect()
        torch.cuda.empty_cache()
    return counts, out


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
          f"bytes; gmm_wgmma_kernel {gmm_lib.moe_gmm_smem_bytes(128)} bytes; "
          f"gmm_narrow_kernel {gmm_lib.moe_gmm_smem_bytes(8)} bytes; mla_prefill_kernel "
          f"{build.library('mla_prefill').mla_prefill_smem_bytes()} bytes")

    # each kernel phase draws from a generator of its own, so that a check
    # added to one phase leaves the other phases' inputs as they were
    def gen(offset: int) -> torch.Generator:
        return torch.Generator(device="cuda").manual_seed(args.seed + offset)

    walls = {}

    def phase(label: str, fn, *a):
        """Run one phase, keeping its wall."""
        t = time.perf_counter()
        result = fn(*a)
        walls[label] = time.perf_counter() - t
        print(f"phase {label}: wall {walls[label]:.2f} s")
        return result

    walls["build"] = time.perf_counter() - t0
    kern = phase("rmsnorm kernel", rmsnorm_kernel_phase, gen(4))
    kern["flash_attention"] = phase("flash kernel", flash_kernel_phase, gen(0))
    kern["paged_attention"] = phase("paged kernel", paged_kernel_phase, gen(1))
    kern["moe_gmm"] = phase("moe_gmm kernel", moe_kernel_phase, gen(2))
    kern["ssd"] = phase("ssd kernel", ssd_kernel_phase, gen(3))
    kern["mla_prefill"] = phase("mla_prefill kernel", mla_prefill_kernel_phase, gen(6))
    counts, serving, cfg, params = phase("dense", slice_phase, args.seed)
    paged_counts, paged_serving = phase("paged", paged_phase, cfg, params, args.seed)
    serving.update(paged_serving)
    serving["platform"] = phase("platform", platform_phase, cfg, params, args.seed)
    elastic_counts, serving["elastic"] = phase("elastic", elastic_phase, cfg, params, args.seed)
    tp_counts, serving["tp"] = phase("tp", tp_phase, cfg, params, args.seed)
    serving["tp"]["flash_rank_shape"] = {k: kern["flash_attention"]["tp_rank"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")}
    serving["slice_score"] = phase("dense score", score_leg, "slice", cfg, params, args.seed)
    long_counts, serving["long_prompt"] = phase("long prompt", long_prompt_phase, cfg, params,
                                                args.seed)
    del params  # free qwen2.5-3b before mixtral's 20.8 GB of weights
    gc.collect()
    torch.cuda.empty_cache()
    moe_counts, moe_serving = phase("moe", moe_phase, args.seed)  # frees mixtral on return
    serving.update(moe_serving)
    ssm_counts, ssm_serving = phase("mamba2", ssm_phase, "mamba2-2.7b", args.seed)
    serving.update(ssm_serving)
    hybrid_counts, hybrid_serving = phase("zamba2", ssm_phase, "zamba2-2.7b", args.seed)
    serving.update(hybrid_serving)
    mla_counts, mla_serving = phase("mla", mla_phase, args.seed)
    serving.update(mla_serving)
    tp_moe_counts, serving["tp_moe"] = phase("tp moe", tp_moe_phase, args.seed)
    tp_ssm_counts, serving["tp_ssm"] = phase("tp ssm", tp_ssm_phase, args.seed)
    kern.update({name: serving["tp_ssm"]["kernels"][name] for name in RMS_TP_FORMS})
    frontend_counts, serving["frontend"] = phase("frontend", frontend_phase, args.seed)
    tpt_counts, serving["tp_train"] = phase("tp train", tp_train_phase, args.seed)
    serving["tp_train"]["flash_rank_shapes"] = kern["flash_attention"]["tp_frontends"]
    stablelm_counts, stablelm_serving = phase("stablelm", stablelm_phase, args.seed)
    serving.update(stablelm_serving)
    guard_counts, serving["training"] = phase("training", training_phase, args.seed)
    serving["flash_32k"] = phase("flash 32k", flash_32k_phase, gen(5))
    twin_counts, serving["twins"] = phase("twins", twins_phase)
    serving["dryrun"] = phase("dryrun", dryrun_phase, serving["param_bytes_on_card"])
    walls["total"] = time.perf_counter() - t0
    serving["phase_wall_s"] = walls
    print(f"phases: walls {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}")
    # each kernel's launches summed over every path that drove it (each read
    # just after its path ran with the counts at 0): the serving phases, the
    # platform runs, the score legs, the frontends' loss_fn and the training
    # phase's no_grad loss_fn under auto (its training path launches none)
    paths = {"dense": counts, "paged": paged_counts,
             **{f"platform {k}": serving["platform"][k]["launches"]
                for k in ("dense", "paged", "registry")},
             **{f"elastic {k}": v for k, v in elastic_counts.items()}, **tp_counts,
             **tp_moe_counts, **tp_ssm_counts, **tpt_counts,
             "dense score": serving["slice_score"]["launches"], "moe": moe_counts,
             "moe score": serving["moe_score"]["launches"], "mamba2": ssm_counts,
             "mamba2 score": serving["mamba2_score"]["launches"], "zamba2": hybrid_counts,
             "zamba2 score": serving["zamba2_score"]["launches"], "mla": mla_counts,
             "mla score": serving["mla_score"]["launches"],
             "hubert loss_fn": frontend_counts[0], "internvl2 loss_fn": frontend_counts[1],
             "stablelm": stablelm_counts, "stablelm score": serving["stablelm_score"]["launches"],
             "training guard no_grad loss_fn": guard_counts,
             **{f"long prompt {k}": v for k, v in long_counts.items()},
             **{f"twin {k}": v for k, v in twin_counts.items()}}
    print("launches by path: " + "; ".join(f"{k} {v}" for k, v in paths.items()))
    counts = {name: sum(c["rmsnorm_forms"].get(form, 0) for c in paths.values())
              for name, form in {**RMS_FORMS, **RMS_TP_FORMS}.items()}
    for name in ("flash_attention", "paged_attention", "moe_gmm", "ssd", "mla_prefill"):
        counts[name] = sum(c.get(name, 0) for c in paths.values())

    rms_source = ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25")
    sources = {**dict.fromkeys({**RMS_FORMS, **RMS_TP_FORMS}, rms_source),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:79"),
               "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:67"),
               "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                           "src/repro/kernels/moe_gmm.py:34"),
               "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:66"),
               "mla_prefill": ("src/repro_torch/kernels/csrc/mla_prefill.cu",
                               "none: repro leaves MLA's attention products to XLA")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": counts[name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
         **({"library_calls_ms": kern[name]["library_calls_ms"],
             "unfused_ms": kern[name]["unfused_ms"]} if "unfused_ms" in kern[name] else {}),
         "shape": kern[name]["shape"]}
        for name in (*RMS_FORMS, *RMS_TP_FORMS, "flash_attention", "paged_attention", "moe_gmm",
                     "ssd", "mla_prefill")]}
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

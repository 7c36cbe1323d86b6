"""The partitions of the redesigned paged-attention and grouped-matmul CUDA
kernels, as plain PyTorch mirrors, against ``repro``'s Pallas kernels
(interpret mode) and the plain versions, on the CPU.

``ref.paged_attention_split_ref`` cuts each row's block table into splits,
takes each split's fp32 partial ``(m, l, acc)`` and merges them in split
order, as ``csrc/paged_attention.cu`` does; ``ref.moe_gmm_schedule_ref``
takes the bf16 ``moe_gmm`` kernel's row tiles (fixed 8-row tiles walking
runs, or 192-row tiles cut per run), as ``csrc/moe_gmm.cu`` does. Inputs
come from numpy with a
seed; the tolerance is 5e-5/5e-4 at float32, as in ``tests/test_kernels.py``.
The kernels themselves are held against these mirrors on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, close
from repro.kernels import ref as jref
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm
from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.kernels import moe_gmm as gmm_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import paged_attention as paged_kernel

pytestmark = pytest.mark.slow


# --- paged attention: split-KV partition ----------------------------------------
def _paged_case(b, h, kv, d, bs, maxb, lens, seed=0, null_rows=()):
    """numpy pools, distinct non-null block tables (block 0 is the null
    block; rows in ``null_rows`` point only at it) and ragged lengths."""
    rng = np.random.default_rng(seed)
    nb = b * maxb + 1
    k_pool = rng.standard_normal((nb, bs, kv, d), dtype=np.float32)
    v_pool = rng.standard_normal((nb, bs, kv, d), dtype=np.float32)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    tables = (rng.permutation(nb - 1)[:b * maxb] + 1).reshape(b, maxb).astype(np.int32)
    tables[list(null_rows)] = 0
    return q, k_pool, v_pool, tables, np.asarray(lens, np.int32)


PAGED_SPLIT_CASES = [
    # (b, h, kv, d, bs, maxb, lens, null rows)
    (4, 8, 2, 32, 16, 7, [0, 1, 33, 112], ()),        # lengths 0 and 1, a full table
    (3, 4, 4, 16, 16, 5, [1, 17, 80], (0,)),          # MHA; a null-block row of length 1
    (2, 4, 2, 80, 48, 3, [50, 144], ()),              # blocks of 48 slots, head_dim 80
    (3, 6, 3, 32, 4, 9, [0, 13, 36], (1,)),           # tiny blocks; a null-block row
]


@pytest.mark.parametrize("blocks_per_split", [1, 2, 3, 64])
@pytest.mark.parametrize("b,h,kv,d,bs,maxb,lens,null_rows", PAGED_SPLIT_CASES)
def test_paged_split_mirror_matches_pallas_and_ref(b, h, kv, d, bs, maxb, lens, null_rows,
                                                   blocks_per_split):
    """Splits of one block, of a count that does not divide the table
    (2 and 3 against tables of 3, 5, 7 and 9 blocks) and one split longer
    than the table; rows of length 0 give zeros, as the Pallas kernel."""
    q, k_pool, v_pool, tables, lens = _paged_case(b, h, kv, d, bs, maxb, lens,
                                                  null_rows=null_rows)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k_pool, v_pool))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    out = ref.paged_attention_split_ref(tq, tk, tv, tt, tl, blocks_per_split=blocks_per_split)
    assert out.dtype == torch.float32 and out.shape == (b, h, d)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    close(out.numpy(), np.asarray(pallas_paged(jnp.asarray(q), jnp.asarray(k_pool),
                                               jnp.asarray(v_pool), jt, jl, interpret=True)),
          F32_TOL)
    rows = lens > 0    # the plain versions average a length-0 row uniformly
    close(out.numpy()[rows], ref.paged_attention_ref(tq, tk, tv, tt, tl).numpy()[rows], F32_TOL)
    close(out.numpy()[rows], np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jt, jl))[rows], F32_TOL)
    assert not out.numpy()[~rows].any()


def test_paged_split_mirror_does_not_depend_on_the_split():
    q, k_pool, v_pool, tables, lens = _paged_case(2, 8, 2, 64, 16, 12, [150, 192])
    args = [torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, lens)]
    outs = [ref.paged_attention_split_ref(*args, blocks_per_split=n) for n in (1, 2, 5, 12, 13)]
    for o in outs[1:]:
        close(o.numpy(), outs[0].numpy(), F32_TOL)


@pytest.mark.parametrize("b,kv,bs,maxb,want", [
    (8, 2, 16, 40, 2),      # the main decode wave: 20 splits, 320 CTAs
    (1, 2, 16, 40, 1),      # one row: one block a split (80 CTAs)
    (4, 8, 16, 64, 2),      # enough CTAs at 32 positions a split
    (8, 2, 48, 10, 1),      # blocks of more than 32 slots
    (8, 2, 4, 40, 4),       # tiny blocks: 8 make 32 positions, halved for 160 CTAs
    (1, 1, 16, 4096, 16),   # a long table: at most 256 splits
])
def test_blocks_per_split_rule(b, kv, bs, maxb, want):
    assert paged_kernel.blocks_per_split(b, kv, bs, maxb) == want
    assert -(-maxb // want) <= paged_kernel.MAX_SPLITS


def test_blocks_per_split_keeps_its_limits():
    """Over a grid of batches, kv heads, block sizes and table widths: at
    most MAX_SPLITS splits a row, and fewer positions a split than the
    SPLIT_POSITIONS start only where the grid would otherwise leave SMs
    empty."""
    for b in (1, 3, 8, 64):
        for kv in (1, 2, 8):
            for bs in (4, 16, 48):
                for maxb in (1, 7, 40, 300, 5000):
                    bps = paged_kernel.blocks_per_split(b, kv, bs, maxb)
                    n_splits = -(-maxb // bps)
                    assert bps >= 1 and n_splits <= paged_kernel.MAX_SPLITS
                    start = -(-paged_kernel.SPLIT_POSITIONS // bs)
                    if bps < start:
                        assert b * kv * -(-maxb // (2 * bps)) < paged_kernel.SMS


# --- grouped matmul: the bf16 kernel's row tiles -------------------------------
def _gmm_case(t, d, f, e, bt, seed=0):
    """Expert-sorted tiles with runs of uneven length (so runs cross the
    fixed 8-row tiles and make wide tiles of several sizes), every expert
    used where there are enough tiles."""
    rng = np.random.default_rng(seed)
    n = t // bt
    te = np.sort(rng.integers(0, e, n)).astype(np.int32)
    te[:min(n, e)] = np.arange(min(n, e))
    te = np.sort(te)
    lhs = rng.standard_normal((t, d), dtype=np.float32)
    rhs = rng.standard_normal((e, d, f), dtype=np.float32)
    return lhs, rhs, te


GMM_SCHEDULE_CASES = [
    # (t, d, f, e, block_t, block_f of the Pallas call)
    (64, 96, 64, 4, 8, 64),         # the decode-wave w_down shape at smoke width
    (39, 40, 52, 3, 13, 52),        # block_t 13: runs cross 8-row tiles; odd F
    (320, 64, 96, 3, 32, 32),       # runs of block_t 32: wide tiles shorter than 192
    (640, 128, 80, 3, 128, 80),     # block_t 128 (dropless tiles): runs above 192 rows
]


@pytest.mark.parametrize("tile_rows", [8, 192])
@pytest.mark.parametrize("t,d,f,e,bt,bf", GMM_SCHEDULE_CASES)
def test_moe_gmm_schedule_mirror_matches_pallas_and_ref(t, d, f, e, bt, bf, tile_rows):
    lhs, rhs, te = _gmm_case(t, d, f, e, bt)
    tl, tr, tte = torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(te)
    got = ref.moe_gmm_schedule_ref(tl, tr, tte, bt, tile_rows=tile_rows)
    assert got.dtype == torch.float32 and got.shape == (t, f)
    want = np.asarray(pallas_gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(te),
                                 block_t=bt, block_f=bf, interpret=True))
    close(got.numpy(), want, F32_TOL)
    close(got.numpy(), ref.moe_gmm_tiles_ref(tl, tr, tte, bt).numpy(), F32_TOL)


@pytest.mark.parametrize("tile_rows", [8, 192])
def test_moe_gmm_schedule_mirror_clamps_and_takes_any_map(tile_rows):
    """Expert ids out of range are clamped, and an unsorted map (runs that
    come back) is right in both row tiles."""
    lhs, rhs, _ = _gmm_case(96, 48, 40, 3, 8)
    te = np.array([2, 0, 0, 5, -1, 1, 1, 0, 2, 2, 2, 1], np.int32)
    args = (torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(te), 8)
    close(ref.moe_gmm_schedule_ref(*args, tile_rows=tile_rows).numpy(),
          ref.moe_gmm_tiles_ref(*args).numpy(), F32_TOL)


@pytest.mark.parametrize("t,e,want", [
    (64, 8, 8),       # mixtral decode wave (w_gate/w_up and w_down): 8 rows an expert
    (1280, 8, 192),   # 512-token prefill: one wide tile a 160-row run
    (255, 8, 8),      # just under 32 rows an expert
    (256, 8, 192),
    (64, 4, 8),       # smoke width
])
def test_moe_gmm_row_tile_rule(t, e, want):
    assert gmm_kernel.row_tile(t, e) == want

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances are those of ``tests/test_kernels.py``: 5e-5/5e-4 at float32,
5e-2 at bfloat16.
"""
import pytest
import torch

from repro_torch.kernels import moe_gmm as gmm_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as paged_kernel

pytestmark = pytest.mark.gpu

F32_TOL = dict(atol=5e-5, rtol=5e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run these tests on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 2048), (4, 2048), (777, 2048), (3, 80), (5, 100)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rows, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g)
    before = ops.launch_counts()["rmsnorm"]
    out = ops.rmsnorm_op(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.rmsnorm_ref(x, w).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (1, 16, 2, 1000, 128, True, None),
    (1, 8, 2, 384, 64, True, 128),
    (2, 4, 1, 100, 16, True, None),
    (1, 4, 4, 128, 80, False, None),
])
def test_flash_kernel_matches_plain_on_card(cuda, b, h, kv, s, d, causal, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(b, s, kv, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    out = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(
        q, k, v, causal=causal, window=window).float(), **tol)


def _paged_case(cuda, b, h, kv, d, bs, maxb, lens, dtype, seed=0):
    """Pool + distinct non-null block tables (block 0 plays the null block)
    + ragged lengths, on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    nb = b * maxb + 1
    k_pool = torch.randn(nb, bs, kv, d, device=cuda, generator=g).to(dtype)
    v_pool = torch.randn(nb, bs, kv, d, device=cuda, generator=g).to(dtype)
    q = torch.randn(b, h, d, device=cuda, generator=g).to(dtype)
    perm = torch.randperm(nb - 1, device=cuda, generator=g)[:b * maxb] + 1
    tables = perm.reshape(b, maxb).to(torch.int32)
    return q, k_pool, v_pool, tables, torch.tensor(lens, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,d,bs,maxb,lens", [
    (4, 4, 1, 16, 16, 4, [1, 16, 17, 64]),    # qwen-smoke GQA; block edges
    (2, 4, 4, 32, 8, 3, [5, 24]),             # MHA; full table
    (3, 8, 2, 64, 16, 2, [2, 31, 32]),        # GQA group 4
    (2, 6, 3, 32, 4, 5, [3, 13]),             # odd heads, tiny blocks
    (2, 4, 2, 80, 48, 2, [50, 96]),           # head_dim 80; blocks of more than 32 slots
    (8, 16, 2, 128, 16, 40, [1, 15, 16, 17, 255, 256, 511, 640]),  # full-width decode wave
])
def test_paged_kernel_matches_plain_on_card(cuda, b, h, kv, d, bs, maxb, lens, dtype):
    q, k_pool, v_pool, tables, lens = _paged_case(cuda, b, h, kv, d, bs, maxb, lens, dtype)
    before = ops.launch_counts()["paged_attention"]
    out = ops.paged_attention_op(q, k_pool, v_pool, tables, lens)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.paged_attention_ref(
        q, k_pool, v_pool, tables, lens).float(), **tol)
    # int64 tables and lengths from the host give the same result
    again = ops.paged_attention_op(q, k_pool, v_pool, tables.long().cpu().numpy(),
                                   lens.long().cpu().numpy())
    torch.testing.assert_close(again, out, atol=0, rtol=0)


def test_paged_kernel_null_rows_finite_and_empty_rows_zero(cuda):
    """Rows whose table is all null block with length 1 (inactive slots)
    stay finite; a row of length 0 gives zeros, as the Pallas kernel does
    (the plain version averages uniformly there, so no comparison)."""
    q, k_pool, v_pool, tables, _ = _paged_case(cuda, 3, 4, 2, 16, 8, 2, [1, 1, 1],
                                               torch.float32)
    null = ops.paged_attention_op(q, k_pool, v_pool, torch.zeros_like(tables),
                                  torch.ones(3, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(null).all())
    torch.testing.assert_close(null, ref.paged_attention_ref(
        q, k_pool, v_pool, torch.zeros_like(tables), torch.ones(3, device=cuda)),
        **F32_TOL)
    lens = torch.tensor([0, 9, 0], dtype=torch.int32, device=cuda)
    out = ops.paged_attention_op(q, k_pool, v_pool, tables, lens)
    torch.cuda.synchronize()
    assert bool((out[0] == 0).all()) and bool((out[2] == 0).all())
    torch.testing.assert_close(out[1:2], ref.paged_attention_ref(
        q[1:2], k_pool, v_pool, tables[1:2], lens[1:2]), **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,d,bs,maxb,lens,split_blocks", [
    # lengths at split boundaries (32 positions a split) and one past/short
    (8, 16, 2, 128, 16, 40, [31, 32, 33, 63, 64, 65, 97, 640], None),
    (8, 16, 2, 128, 16, 40, [63, 64, 65, 127, 128, 129, 191, 640], 4),   # 64 a split
    (1, 16, 2, 128, 16, 40, [640], None),        # B = 1: one 640-token row
    (3, 8, 8, 64, 16, 200, [1, 17, 40], None),   # maxb far above every length; group 1
    (2, 16, 2, 128, 16, 40, [300, 640], 1),      # one block a split
    (2, 16, 2, 128, 16, 40, [300, 640], 3),      # splits that do not divide maxb
    (2, 16, 2, 128, 16, 40, [300, 640], 64),     # one split longer than the table
    (2, 4, 2, 80, 48, 5, [50, 239], 2),          # blocks of 48 slots, head_dim 80
    (2, 32, 1, 32, 8, 9, [3, 70], None),         # group 32
])
def test_paged_kernel_splits_match_plain_on_card(cuda, b, h, kv, d, bs, maxb, lens,
                                                 split_blocks, dtype):
    """The split-KV partition at its edges, against the plain version and
    against the plain mirror of the same partition; a repeated call gives
    the same bits. ``split_blocks`` None is the wrapper's own rule; a number
    drives that split size through the private launch."""
    q, k_pool, v_pool, tables, lens = _paged_case(cuda, b, h, kv, d, bs, maxb, lens, dtype)
    before = ops.launch_counts()["paged_attention"]
    if split_blocks is None:
        call = lambda: paged_kernel.paged_attention(q, k_pool, v_pool, tables, lens)  # noqa: E731
    else:
        call = lambda: paged_kernel._launch(q, k_pool, v_pool, tables, lens,  # noqa: E731
                                            d ** -0.5, split_blocks)
    out, again = call(), call()
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == before + 2
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.paged_attention_ref(
        q, k_pool, v_pool, tables, lens).float(), **tol)
    bps = split_blocks or paged_kernel.blocks_per_split(b, kv, bs, maxb)
    torch.testing.assert_close(out.float(), ref.paged_attention_split_ref(
        q, k_pool, v_pool, tables, lens, blocks_per_split=bps).float(), **tol)
    torch.testing.assert_close(again, out, atol=0, rtol=0)


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.rmsnorm_op(x, torch.ones(64, device=cuda))
    q = torch.randn(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_op(q, q, q)
    q, k_pool, v_pool, tables, lens = _paged_case(cuda, 2, 4, 2, 16, 8, 2, [3, 9],
                                                  torch.float32)
    with pytest.raises(TypeError, match="dtypes"):
        ops.paged_attention_op(q.half(), k_pool.half(), v_pool.half(), tables, lens)
    with pytest.raises(TypeError, match="dtypes"):
        ops.paged_attention_op(q, k_pool.bfloat16(), v_pool, tables, lens)
    with pytest.raises(ValueError, match="different devices"):
        ops.paged_attention_op(q, k_pool.cpu(), v_pool.cpu(), tables, lens)
    with pytest.raises(TypeError, match="integers"):
        ops.paged_attention_op(q, k_pool, v_pool, tables.float(), lens)
    with pytest.raises(ValueError, match="head_dim"):
        q48 = torch.randn(2, 4, 48, device=cuda)
        pool48 = torch.randn(5, 8, 2, 48, device=cuda)
        ops.paged_attention_op(q48, pool48, pool48, tables, lens)
    with pytest.raises(ValueError, match="multiple of"):
        ops.paged_attention_op(q[:, :3], k_pool, v_pool, tables, lens)


def _gmm_case(cuda, t, d, f, e, block_t, dtype, seed=0, tile_expert=None):
    """lhs, rhs and an expert-sorted tile map (every expert gets at least one
    tile where there are enough tiles), on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    lhs = torch.randn(t, d, device=cuda, generator=g).to(dtype)
    rhs = torch.randn(e, d, f, device=cuda, generator=g).to(dtype)
    if tile_expert is None:
        n = t // block_t
        tile_expert = torch.sort(torch.randint(0, e, (n,), device=cuda, generator=g))[0]
        tile_expert[:min(n, e)] = torch.arange(min(n, e), device=cuda)
        tile_expert = torch.sort(tile_expert)[0]
    return lhs, rhs, torch.as_tensor(tile_expert, device=cuda).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f,e,block_t", [
    (256, 64, 96, 4, 32),       # tests/test_kernels.py grids: F not a multiple of the tile
    (512, 128, 128, 8, 64),
    (128, 32, 200, 2, 64),      # E = 2, F padding case of the TPU kernel
    (64, 64, 96, 8, 8),         # block_t 8: the decode wave's capacity buffer, smoke width
    (1280, 256, 384, 8, 128),   # block_t 128 (dropless tiles)
    (39, 40, 52, 3, 13),        # block_t not a multiple of 8; D, F not multiples of 16 bytes
])
def test_moe_gmm_kernel_matches_plain_on_card(cuda, t, d, f, e, block_t, dtype):
    lhs, rhs, te = _gmm_case(cuda, t, d, f, e, block_t, dtype)
    before = ops.launch_counts()["moe_gmm"]
    out = ops.moe_gmm_op(lhs, rhs, te, block_t=block_t)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gmm"] == before + 1
    assert out.dtype == dtype and out.shape == (t, f)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.moe_gmm_tiles_ref(lhs, rhs, te, block_t).float(),
                               **tol)


def test_moe_gmm_kernel_ragged_groups_and_capacity_helper(cuda):
    """Ragged group sizes padded by pad_group_sizes (zero rows, an empty
    group), the dropless layout; and moe_gmm_capacity over an (E, C, D)
    buffer against a batched product."""
    sizes = torch.tensor([5, 0, 17, 8], dtype=torch.int32, device=cuda)
    bt = 8
    padded, offs = ops.pad_group_sizes(sizes, bt)
    t = int(offs[-1])
    g = torch.Generator(device=cuda).manual_seed(1)
    lhs = torch.zeros(t, 64, device=cuda)
    for n, o in zip(sizes.tolist(), offs[:-1].tolist()):
        lhs[o:o + n] = torch.randn(n, 64, device=cuda, generator=g)
    rhs = torch.randn(4, 64, 96, device=cuda, generator=g)
    te = (torch.searchsorted(offs, torch.arange(t // bt, device=cuda, dtype=torch.int32) * bt,
                             right=True) - 1).clamp(0, 3)
    out = ops.moe_gmm_op(lhs, rhs, te, block_t=bt)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.moe_gmm_ref(lhs, rhs, padded), **F32_TOL)
    buf = torch.randn(4, 24, 64, device=cuda, generator=g)
    got = ops.moe_gmm_capacity(buf, rhs, block_t=128)   # block_t clamps to C = 24
    torch.cuda.synchronize()
    torch.testing.assert_close(got, torch.bmm(buf, rhs), **F32_TOL)


@pytest.mark.parametrize("tile_rows", [8, 192])
@pytest.mark.parametrize("t,d,f,e,block_t", [
    (64, 96, 64, 4, 8),         # the w_down decode shape at mixtral-smoke width (d_ff 96)
    (256, 64, 96, 4, 32),       # runs of block_t 32 that cross 8-row tiles
    (39, 40, 52, 3, 13),        # block_t 13: runs cross 8-row tiles; F not 16-byte rows
])
def test_moe_gmm_bf16_row_tiles_match_plain_on_card(cuda, t, d, f, e, block_t, tile_rows):
    """Each bf16 row tile (narrow, wide), driven through the private
    launch, against the plain version and the plain mirror of the same
    partition; repeated calls give the same bits."""
    lhs, rhs, te = _gmm_case(cuda, t, d, f, e, block_t, torch.bfloat16)
    out = gmm_kernel._launch(lhs, rhs, te, block_t, tile_rows)
    again = gmm_kernel._launch(lhs, rhs, te, block_t, tile_rows)
    torch.cuda.synchronize()
    want = ref.moe_gmm_tiles_ref(lhs, rhs, te, block_t).float()
    torch.testing.assert_close(out.float(), want, **BF16_TOL)
    torch.testing.assert_close(out.float(), ref.moe_gmm_schedule_ref(
        lhs, rhs, te, block_t, tile_rows=tile_rows).float(), **BF16_TOL)
    torch.testing.assert_close(again, out, atol=0, rtol=0)


def test_moe_gmm_runs_that_cross_the_row_tiles(cuda):
    """Runs of 96 rows (the wide tiles are cut per run; a warpgroup past a
    run's end idles), and block_t 12, where every other narrow 8-row tile
    spans two experts; in bf16 (each row tile through the private launch)
    and f32; repeated calls give the same bits."""
    cases = [(32, [0, 0, 0, 1, 1, 1, 2, 2], torch.bfloat16, 192),
             (32, [0, 0, 0, 1, 1, 1, 2, 2], torch.float32, None),
             (12, [0, 1, 1, 2, 2, 2, 0, 0, 1, 2], torch.bfloat16, 8),
             (12, [0, 1, 1, 2, 2, 2, 0, 0, 1, 2], torch.float32, None)]
    for block_t, te, dtype, tile_rows in cases:
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        t = block_t * len(te)
        lhs, rhs, te_t = _gmm_case(cuda, t, 128, 192, 3, block_t, dtype, tile_expert=te)
        if tile_rows is None:
            call = lambda: gmm_kernel.moe_gmm(lhs, rhs, te_t, block_t=block_t)  # noqa: E731
        else:
            call = lambda: gmm_kernel._launch(lhs, rhs, te_t, block_t, tile_rows)  # noqa: E731
        out, again = call(), call()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.moe_gmm_tiles_ref(
            lhs, rhs, te_t, block_t).float(), **tol)
        torch.testing.assert_close(again, out, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_repeat_gives_the_same_bits(cuda, dtype):
    lhs, rhs, te = _gmm_case(cuda, 64, 512, 384, 8, 8, dtype)
    outs = [ops.moe_gmm_op(lhs, rhs, te, block_t=8) for _ in range(3)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=0, rtol=0)


def test_moe_gmm_kernel_raises_on_what_it_does_not_take(cuda):
    lhs, rhs, te = _gmm_case(cuda, 64, 32, 48, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="multiple of block_t"):
        ops.moe_gmm_op(lhs[:60], rhs, te, block_t=16)
    with pytest.raises(TypeError, match="dtypes"):
        ops.moe_gmm_op(lhs, rhs.bfloat16(), te, block_t=16)
    with pytest.raises(TypeError, match="dtypes"):
        ops.moe_gmm_op(lhs.half(), rhs.half(), te, block_t=16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_gmm_op(lhs, rhs.transpose(1, 2).contiguous().transpose(1, 2), te, block_t=16)
    with pytest.raises(ValueError, match="tile_expert"):
        ops.moe_gmm_op(lhs, rhs, te[:2], block_t=16)
    with pytest.raises(TypeError, match="integers"):
        ops.moe_gmm_op(lhs, rhs, te.float(), block_t=16)
    with pytest.raises(ValueError, match="rhs on"):
        ops.moe_gmm_op(lhs, rhs.cpu(), te, block_t=16)


# tests/test_kernels.py's ssd tolerance at float32: the kernel and its plain
# version take sums of Q*N products of order 10 in another order
SSD_TOL = dict(atol=2e-3, rtol=1e-3)


def _ssd_case(cuda, b, s, h, p, g, n, dtype, seed=0):
    """tests/test_kernels.py's construction: x, B, C standard normal in
    ``dtype``, dt = softplus(N(0,1)) and a = -exp(0.3 N(0,1)) in fp32."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, s, h, p, device=cuda, generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=cuda, generator=gen))
    a = -torch.exp(torch.randn(h, device=cuda, generator=gen) * 0.3)
    bm = torch.randn(b, s, g, n, device=cuda, generator=gen).to(dtype)
    cm = torch.randn(b, s, g, n, device=cuda, generator=gen).to(dtype)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 16, 2, 8, 16),       # tests/test_kernels.py shapes
    (1, 128, 8, 64, 1, 32, 32),
    (2, 96, 2, 8, 2, 16, 32),
    (1, 256, 4, 64, 1, 64, 128),
    (1, 256, 4, 64, 1, 128, 256),   # S of one chunk
    (1, 512, 80, 64, 1, 128, 256),  # mamba2-2.7b's 512-token prefill
    (1, 512, 80, 64, 1, 64, 256),   # zamba2-2.7b's
])
def test_ssd_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk, dtype):
    x, dt, a, bm, cm = _ssd_case(cuda, b, s, h, p, g, n, dtype)
    before = ops.launch_counts()["ssd"]
    y, fin = ops.ssd_op(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd"] == before + 1
    assert y.dtype == fin.dtype == torch.float32
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    yr, finr = ref.ssd_chunk_ref(x, dt, a, bm, cm, chunk)
    torch.testing.assert_close(y, yr, **SSD_TOL)
    torch.testing.assert_close(fin, finr, **SSD_TOL)


def test_ssd_kernel_chunk_invariance_and_oracle(cuda):
    """The output does not depend on the chunk size, and it is the
    sequential recurrence's (ssd_ref)."""
    x, dt, a, bm, cm = _ssd_case(cuda, 1, 128, 2, 16, 1, 8, torch.float32)
    yr, finr = ref.ssd_ref(x, dt, a, bm, cm)
    outs = [ops.ssd_op(x, dt, a, bm, cm, chunk=c) for c in (16, 32, 64, 128)]
    torch.cuda.synchronize()
    for y, fin in outs:
        torch.testing.assert_close(y, outs[0][0], atol=1e-4, rtol=1e-3)
        torch.testing.assert_close(y, yr, **SSD_TOL)
        torch.testing.assert_close(fin, finr, **SSD_TOL)


def test_ssd_kernel_reads_strided_slices(cuda):
    """x, B and C as slices of one wider (B, S, C) tensor, as mamba_block
    hands them over, give what contiguous copies give."""
    h, p, n = 4, 16, 32
    gen = torch.Generator(device=cuda).manual_seed(2)
    xbc = torch.randn(2, 64, h * p + 2 * n, device=cuda, generator=gen).to(torch.bfloat16)
    x = xbc[..., :h * p].reshape(2, 64, h, p)
    bm = xbc[..., h * p:h * p + n].reshape(2, 64, 1, n)
    cm = xbc[..., h * p + n:].reshape(2, 64, 1, n)
    dt = torch.nn.functional.softplus(torch.randn(2, 64, h, device=cuda, generator=gen))
    a = -torch.ones(h, device=cuda)
    assert not x.is_contiguous()
    y, fin = ops.ssd_op(x, dt, a, bm, cm, chunk=32)
    yc, finc = ops.ssd_op(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(), chunk=32)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yc, atol=0, rtol=0)
    torch.testing.assert_close(fin, finc, atol=0, rtol=0)


def test_ssd_kernel_raises_on_what_it_does_not_take(cuda):
    x, dt, a, bm, cm = _ssd_case(cuda, 1, 64, 4, 16, 2, 8, torch.float32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_op(x, dt, a, bm, cm, chunk=48)
    with pytest.raises(ValueError, match="multiple of G"):
        x3, dt3, a3, bm3, cm3 = _ssd_case(cuda, 1, 64, 3, 16, 2, 8, torch.float32)
        ops.ssd_op(x3, dt3, a3, bm3, cm3, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_op(x, dt.bfloat16(), a, bm, cm, chunk=16)
    with pytest.raises(TypeError, match="dtypes"):
        ops.ssd_op(x, dt, a, bm.bfloat16(), cm, chunk=16)
    with pytest.raises(ValueError, match="head_dim"):
        x1, dt1, a1, bm1, cm1 = _ssd_case(cuda, 1, 16, 2, 80, 1, 8, torch.float32)
        ops.ssd_op(x1, dt1, a1, bm1, cm1, chunk=16)
    with pytest.raises(ValueError, match="shared memory"):
        ops.ssd_op(*_ssd_case(cuda, 1, 16384, 1, 64, 1, 128, torch.float32), chunk=16384)
    with pytest.raises(ValueError, match="different devices"):
        ops.ssd_op(x, dt.cpu(), a, bm, cm, chunk=16)

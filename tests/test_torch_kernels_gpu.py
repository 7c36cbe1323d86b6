"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances are those of ``tests/test_kernels.py``: 5e-5/5e-4 at float32,
5e-2 at bfloat16; the bf16 flash kernel is also held against the plain
mirror of its own tiles at ``TILES_TOL`` (as ``chip_smoke.py`` holds it),
and at 32k also block by block within ``FLASH_32K_REL_L2``.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import moe_gmm as gmm_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as paged_kernel

pytestmark = pytest.mark.gpu

F32_TOL = dict(atol=5e-5, rtol=5e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
# bf16 flash kernel vs ref.flash_attention_tiles_ref: chip_smoke.TILES_TOL
TILES_TOL = dict(atol=1e-2, rtol=2 ** -7)
# flash at 32k vs chunked_mha at f32, per 512-row block: chip_smoke.FLASH_32K_REL_L2
FLASH_32K_REL_L2 = 1e-2


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


# the widths the configs norm: qwen2.5-3b, mamba2/zamba2 d_model, their gated
# d_inner, mixtral-8x22b; and an odd width (the element-wise path)
RMS_WIDTHS = (2048, 2560, 5120, 6144, 777)
# Mamba2's in_proj row is [z, xBC, dt]: z's row stride is 2 d_inner + 2 G N + H
# (mamba2-2.7b: 2 * 5120 + 2 * 128 + 80 = 10576)
def _zxbcdt_z(cuda, g, rows, d, dtype, extra=336, offset=0):
    wide = torch.randn(rows, 2 * d + extra + offset, device=cuda, generator=g).to(dtype)
    return wide[:, offset:offset + d]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4, 8, 512, 777])
@pytest.mark.parametrize("d", RMS_WIDTHS)
def test_rmsnorm_forms_match_plain_on_card(cuda, d, rows, dtype):
    """The plain, residual and gated forms against their plain versions, the
    gated one on z as a strided column slice; each launch counted once, by
    form."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    h = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    z = _zxbcdt_z(cuda, g, rows, d, dtype)
    w = torch.randn(d, device=cuda, generator=g)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    ops.reset_launch_counts()
    y = ops.rmsnorm_op(x, w)
    s, ys = ops.add_rmsnorm_op(x, h, w)
    yg = ops.gated_rmsnorm_op(x, z, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == 3
    assert ops.rmsnorm_form_counts() == {"plain": 1, "residual": 1, "gated": 1,
                                         "gated_ssq": 0, "gated_scale": 0}
    torch.testing.assert_close(y.float(), ref.rmsnorm_ref(x, w).float(), **tol)
    want_s, want_ys = ref.add_rmsnorm_ref(x, h, w)
    torch.testing.assert_close(s, want_s, atol=0, rtol=0)
    torch.testing.assert_close(ys.float(), want_ys.float(), **tol)
    torch.testing.assert_close(yg.float(), ref.gated_rmsnorm_ref(x, z, w).float(), **tol)
    assert y.is_contiguous() and s.is_contiguous() and yg.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2048), (4, 2048), (8, 6144), (512, 2048), (777, 2560),
                                   (2, 251, 5120), (3, 777)])
def test_add_rmsnorm_is_torch_add_then_the_plain_kernel_bit_for_bit(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    h = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    w = torch.randn(shape[-1], device=cuda, generator=g)
    s, y = ops.add_rmsnorm_op(x, h, w)
    torch.cuda.synchronize()
    assert s.data_ptr() not in (x.data_ptr(), h.data_ptr())
    torch.testing.assert_close(s, torch.add(x, h), atol=0, rtol=0)
    torch.testing.assert_close(y, ops.rmsnorm_op(s, w), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4, 5120), (502, 5120), (3, 64), (8, 2560)])
def test_gated_rmsnorm_reads_zxbcdt_and_misaligned_views_on_card(cuda, rows, d, dtype):
    """z as the strided slice of Mamba2's in_proj row (16-byte path) and as
    a view one element into a wider row (base and stride not 16-byte
    multiples: the element-wise path) gives what a contiguous copy gives, bit
    for bit: both paths own the same elements and sum in the same order."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for offset, extra in ((0, 336), (1, 335)):
        z = _zxbcdt_z(cuda, g, rows, d, dtype, extra=extra, offset=offset)
        assert (z.data_ptr() % 16 == 0) == (offset == 0)
        out = ops.gated_rmsnorm_op(x, z, w)
        want = ops.gated_rmsnorm_op(x, z.contiguous(), w)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, atol=0, rtol=0)
        torch.testing.assert_close(out.float(), ref.gated_rmsnorm_ref(x, z, w).float(), **tol)
    # x misaligned too, through the residual form as well
    xm = _zxbcdt_z(cuda, g, rows, d, dtype, extra=1, offset=1)
    xm.copy_(x)
    hm = _zxbcdt_z(cuda, g, rows, d, dtype, extra=1, offset=1)
    s, y = ops.add_rmsnorm_op(xm, hm, w)
    s2, y2 = ops.add_rmsnorm_op(x, hm.contiguous(), w)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, s2, atol=0, rtol=0)
    torch.testing.assert_close(y, y2, atol=0, rtol=0)


# the gated form rounds silu(z) to bf16 before the product, as `x * F.silu(z)`
# does; its silu takes the fast exp and divide, which may flip that rounding
# now and then, so it is held against the plain kernel on the composition by
# chip_smoke.py's GATE_ULPS and GATE_DIFF_SHARE, set in PERF.md from sound
# and planted-fault readings
GATE_ULPS, GATE_DIFF_SHARE = 1, 1e-3


def _bf16_ulps(got, want):
    want = want.float()
    spacing = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    return (got.float() - want).abs() / spacing


@pytest.mark.parametrize("rows,d", [(4, 5120), (502, 5120), (8, 2560), (512, 2048), (777, 777)])
def test_gated_rmsnorm_rounds_silu_before_the_product_on_card(cuda, rows, d):
    """bf16: the gated form against the plain kernel on ``x * F.silu(z)``,
    z at a Mamba2 in_proj row stride, by bf16 ulps and by the share of
    elements that differ; a gate that skips rounding silu(z) moves far more
    elements than the fast silu does."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(rows, d, device=cuda, generator=g).to(torch.bfloat16)
    z = _zxbcdt_z(cuda, g, rows, d, torch.bfloat16)
    w = torch.randn(d, device=cuda, generator=g)
    ulps = _bf16_ulps(ops.gated_rmsnorm_op(x, z, w),
                      ops.rmsnorm_op(x * torch.nn.functional.silu(z), w))
    share = (ulps > 0).float().mean().item()
    assert ulps.max().item() <= GATE_ULPS and share <= GATE_DIFF_SHARE, (
        f"{ulps.max().item():.0f} bf16 ulps at most, {share:.3e} of the elements differ")


def _split_gated(x, z, w, ranks: int, eps: float = 1e-5):
    """The gated norm of each row split over ``ranks`` slices of its
    channels: pass A on each slice, the sums added, pass B on each slice,
    side by side; and the passes' sums."""
    d = x.shape[-1]
    cut = [slice(r * d // ranks, (r + 1) * d // ranks) for r in range(ranks)]
    parts = [(x[:, c].contiguous(), z[:, c], w[c].contiguous()) for c in cut]
    sums = [ops.gated_rmsnorm_ssq_op(xs, zs) for xs, zs, _ in parts]
    ssq = torch.stack(sums).sum(0)
    ys = [ops.gated_rmsnorm_scale_op(xs, zs, ws, ssq, d, eps) for xs, zs, ws in parts]
    return torch.cat(ys, dim=-1), parts, sums, ssq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4, 512, 777])
@pytest.mark.parametrize("d,ranks", [(5120, 2), (5120, 4), (2560, 2), (777, 1)])
def test_gated_norm_split_over_ranks_matches_plain_on_card(cuda, d, ranks, rows, dtype):
    """Mamba2's gated norm with its channels on ``ranks`` ranks (mamba2's
    d_inner 5120 on 2 and 4, zamba2-sized 2560 on 2, an odd width on one):
    each pass against its plain version, z a column slice of a rank's
    in_proj row; the split norm against the one-pass gated kernel on the
    whole row (bf16 within ``GATE_ULPS``); each pass counted as a form of
    its own."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    z = _zxbcdt_z(cuda, g, rows, d, dtype)
    w = torch.randn(d, device=cuda, generator=g)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    ops.reset_launch_counts()
    y, parts, sums, ssq = _split_gated(x, z, w, ranks)
    torch.cuda.synchronize()
    assert ops.rmsnorm_form_counts() == {"plain": 0, "residual": 0, "gated": 0,
                                         "gated_ssq": ranks, "gated_scale": ranks}
    assert ops.launch_counts()["rmsnorm"] == 2 * ranks
    for (xs, zs, ws), got in zip(parts, sums):
        assert got.shape == (rows,) and got.dtype == torch.float32
        torch.testing.assert_close(got, ref.gated_rmsnorm_ssq_ref(xs, zs), **F32_TOL)
    for r, (xs, zs, ws) in enumerate(parts):
        c = slice(r * d // ranks, (r + 1) * d // ranks)
        torch.testing.assert_close(y[:, c].float(), ref.gated_rmsnorm_scale_ref(
            xs, zs, ws, ssq, d).float(), **tol)
    one = ops.gated_rmsnorm_op(x, z, w)
    torch.testing.assert_close(y.float(), one.float(), **tol)
    if dtype == torch.bfloat16:
        assert _bf16_ulps(y, one).max().item() <= GATE_ULPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4, 5120), (512, 2560), (777, 777), (3, 64)])
def test_gated_passes_on_one_rank_are_the_one_pass_kernel_bit_for_bit(cuda, rows, d, dtype):
    """Pass B of pass A's own sums over the whole row gives the one-pass
    gated kernel's bits: the same ownership and order of sums, the same
    rsqrt; the sums are the one-pass form's."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    z = _zxbcdt_z(cuda, g, rows, d, dtype)
    w = torch.randn(d, device=cuda, generator=g)
    ssq = ops.gated_rmsnorm_ssq_op(x, z)
    y = ops.gated_rmsnorm_scale_op(x, z, w, ssq, d)
    torch.testing.assert_close(y, ops.gated_rmsnorm_op(x, z, w), atol=0, rtol=0)
    x3, z3 = x.view(1, rows, d), z.reshape(1, rows, d)   # leading dims as the model's
    ssq3 = ops.gated_rmsnorm_ssq_op(x3, z3)
    assert ssq3.shape == (1, rows)
    torch.testing.assert_close(ssq3[0], ssq, atol=0, rtol=0)


def test_gated_passes_raise_on_what_they_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    ssq = ops.gated_rmsnorm_ssq_op(x, x)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.gated_rmsnorm_ssq_op(x.bfloat16(), x)
    with pytest.raises(ValueError, match="ssq"):
        ops.gated_rmsnorm_scale_op(x, x, w, ssq[:2], 128)
    with pytest.raises(ValueError, match="ssq"):
        ops.gated_rmsnorm_scale_op(x, x, w, ssq.double(), 128)
    with pytest.raises(ValueError, match="ssq on"):
        ops.gated_rmsnorm_scale_op(x, x, w, ssq.cpu(), 128)
    with pytest.raises(ValueError, match="w shape"):
        ops.gated_rmsnorm_scale_op(x, x, torch.ones(32, device=cuda), ssq, 128)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.gated_rmsnorm_ssq_op(x.requires_grad_(), x)


def test_rmsnorm_forms_raise_on_what_they_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.add_rmsnorm_op(x, x.bfloat16(), w)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.gated_rmsnorm_op(x.bfloat16(), x, w)
    for op, args in ((ops.rmsnorm_op, (x,)), (ops.add_rmsnorm_op, (x, x)),
                     (ops.gated_rmsnorm_op, (x, x))):
        with pytest.raises(ValueError, match="different devices"):
            op(*args, w.cpu())
        with pytest.raises(ValueError, match="w shape"):
            op(*args, torch.ones(32, device=cuda))
        with pytest.raises(TypeError, match="float32"):
            op(*args, w.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        ops.add_rmsnorm_op(x, x[:2], w)
    with pytest.raises(ValueError, match="stride"):
        ops.gated_rmsnorm_op(x, torch.randn(64, 4, device=cuda).T, w)
    wide = torch.randn(1, 8192 + 4, device=cuda)
    with pytest.raises(RuntimeError, match="up to 16384 bf16 or 8192 fp32 elements"):
        ops.rmsnorm_op(wide, torch.ones(8192 + 4, device=cuda))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (1, 4, 2, 200, 8, True, None),      # head_dim 8 (internvl2-26b smoke): padded to 16
    (1, 4, 2, 130, 160, True, None),    # head_dim 160 (stablelm-12b)
    (2, 4, 4, 70, 160, False, None),    # 160, not causal, Sq not a multiple of 64
    (1, 8, 2, 333, 8, True, 100),       # 8 with a window
    (1, 2, 1, 1, 128, True, None),      # one row
    (2, 16, 2, 191, 128, True, 64),     # window of one tile, Sq one short of three tiles
    (1, 48, 8, 512, 128, True, None),   # mixtral-8x22b's prefill and internvl2-26b's: group 6
    (1, 16, 16, 512, 80, False, None),  # hubert-xlarge's encoder: not causal, head_dim 80
])
def test_flash_kernel_head_dims_and_edges_on_card(cuda, b, h, kv, s, d, causal, window,
                                                  dtype):
    """Every head dim of an attention config, Sq not a multiple of the
    64-row tile, mixtral's group of 6; bf16 also against the plain mirror of
    the kernel's tiles (P rounded to bf16 before P V) at the tighter
    TILES_TOL; a repeated call gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(b, s, kv, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    again = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2
    assert out.dtype == dtype and out.shape == q.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.flash_attention_tiles_ref(
        q, k, v, causal=causal, window=window).float(),
        **(F32_TOL if dtype == torch.float32 else TILES_TOL))
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(
        q, k, v, causal=causal, window=window).float(), **tol)
    torch.testing.assert_close(again, out, atol=0, rtol=0)


@pytest.mark.parametrize("d", [8, 80, 128, 160])
def test_flash_kernel_misaligned_views_take_the_scalar_path_on_card(cuda, d):
    """q, k, v as views whose base address and strides are not 16-byte
    multiples (one element into a wider row) give what aligned copies give."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, s, h, kv = 1, 150, 4, 2

    def view(heads):
        wide = torch.randn(b, s, heads, d + 1, device=cuda, generator=g).to(torch.bfloat16)
        return wide[..., 1:].transpose(1, 2)

    q, k, v = view(h), view(kv), view(kv)
    assert q.data_ptr() % 16 and q.stride(2) % 8
    out = ops.flash_attention_op(q, k, v, causal=True)
    want = ops.flash_attention_op(*(t.contiguous() for t in (q, k, v)), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(q, k, v).float(),
                               **BF16_TOL)


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
    (3, 4, 2, 8, 16, 4, [1, 33, 64]),         # head_dim 8 (internvl2-26b smoke)
    (4, 32, 8, 160, 16, 8, [5, 16, 100, 128]),  # head_dim 160 (stablelm-12b: 32/8 heads)
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
    for d in (8, 160):  # every head_dim of an attention config is built
        assert d in flash_kernel.HEAD_DIMS and d in paged_kernel.HEAD_DIMS
        qd = torch.randn(1, 2, 8, d, device=cuda)
        assert ops.flash_attention_op(qd, qd, qd).shape == qd.shape
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


@pytest.mark.parametrize("t,d,f,block_t,tile_rows", [
    (512, 2048, 1408, 8, 8),      # decode, 4 slots: cap 8, w_gate/w_up, the narrow tile
    (512, 1408, 2048, 8, 8),      # decode w_down
    (4096, 2048, 1408, 64, 192),  # a 512-token prefill: cap 64, the wide tile
    (7680, 2048, 1408, 8, 192),   # forward at B 2, S 512: cap 120, block_t 8 under the wide tile
    (7680, 1408, 2048, 8, 192),   # its w_down
])
def test_moe_gmm_deepseek_shapes_on_card(cuda, t, d, f, block_t, tile_rows):
    """deepseek-v2-lite-16b's capacity buffers (64 experts, moe_d_ff 1408,
    F not a multiple of the 256-column CTA tile) in bf16, as the model lays
    them out (each expert's capacity rows in a run): the row tile the
    wrapper picks, against the plain version and the plain mirror of its
    partition; a repeated call gives the same bits."""
    e = 64
    assert gmm_kernel.row_tile(t, e) == tile_rows
    g = torch.Generator(device=cuda).manual_seed(7)
    lhs = torch.randn(t, d, device=cuda, generator=g).to(torch.bfloat16)
    rhs = (torch.randn(e, d, f, device=cuda, generator=g) * d ** -0.5).to(torch.bfloat16)
    te = ops.tile_experts_for_capacity(e, t // e, block_t, device=cuda)
    out = ops.moe_gmm_op(lhs, rhs, te, block_t=block_t)
    again = ops.moe_gmm_op(lhs, rhs, te, block_t=block_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.moe_gmm_tiles_ref(lhs, rhs, te, block_t).float(),
                               **BF16_TOL)
    torch.testing.assert_close(out.float(), ref.moe_gmm_schedule_ref(
        lhs, rhs, te, block_t, tile_rows=tile_rows).float(), **BF16_TOL)
    torch.testing.assert_close(again, out, atol=0, rtol=0)


@pytest.mark.parametrize("e,cap,d,f,tile_rows", [
    (32, 8, 2048, 1408, 8),      # deepseek, 32 of 64 experts a rank: a decode wave
    (32, 8, 1408, 2048, 8),      # its w_down
    (32, 16, 2048, 1408, 8),     # a 128-token admission: cap 16, still the narrow tile
    (32, 64, 2048, 1408, 192),   # a 512-token admission: cap 64, the wide tile
    (4, 8, 6144, 16384, 8),      # mixtral, 4 of 8 experts a rank: a decode wave
    (4, 40, 6144, 16384, 192),   # a 128-token admission: cap 40, the wide tile
    (8, 8, 6144, 8192, 8),       # in-expert: every expert's half of 16384, a decode wave
    (8, 40, 6144, 8192, 192),    # and a 128-token admission
    (8, 40, 8192, 6144, 192),    # its w_down
])
def test_moe_gmm_per_rank_shapes_on_card(cuda, e, cap, d, f, tile_rows):
    """The capacity buffers one rank of a tensor-parallel gang multiplies:
    its experts' (E_local, cap, D) slab, cap from the global expert count.
    A local E moves ``row_tile``'s switch to a smaller T; the tile the
    wrapper picks at each shape, against the plain version; a repeated call
    gives the same bits."""
    t = e * cap
    assert gmm_kernel.row_tile(t, e) == tile_rows
    g = torch.Generator(device=cuda).manual_seed(24)
    lhs = torch.randn(t, d, device=cuda, generator=g).to(torch.bfloat16)
    rhs = (torch.randn(e, d, f, device=cuda, generator=g) * d ** -0.5).to(torch.bfloat16)
    te = torch.arange(e, device=cuda, dtype=torch.int32)
    out = ops.moe_gmm_capacity(lhs.view(e, cap, d), rhs, block_t=cap).reshape(t, f)
    again = ops.moe_gmm_op(lhs, rhs, te, block_t=cap)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.moe_gmm_tiles_ref(lhs, rhs, te, cap).float(),
                               **BF16_TOL)
    torch.testing.assert_close(again, out, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap,f", [(120, 1408), (160, 96), (19, 52)])
def test_moe_gmm_capacity_block_t_does_not_change_the_bits(cuda, cap, f, dtype):
    """The capacity path passes block_t = cap (one tile-map entry an
    expert); a finer map (block_t 8, or 1) gives the same bits in every
    row tile and dtype, since the kernels cut their tiles per run of equal
    expert."""
    e, d = 16, 256
    g = torch.Generator(device=cuda).manual_seed(9)
    buf = torch.randn(e, cap, d, device=cuda, generator=g).to(dtype)
    rhs = (torch.randn(e, d, f, device=cuda, generator=g) * d ** -0.5).to(dtype)
    want = ops.moe_gmm_capacity(buf, rhs, block_t=cap)
    fine = 8 if cap % 8 == 0 else 1
    got = ops.moe_gmm_capacity(buf, rhs, block_t=fine)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(want.float(), torch.bmm(buf.float(), rhs.float()),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))


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
    (2, 256, 8, 64, 2, 128, 128),   # B 2, G 2 at full widths
    (1, 96, 3, 8, 1, 8, 32),        # P and N padded to 16; one row tile of 32
    (2, 200, 4, 24, 2, 40, 100),    # P, N not multiples of 16; chunk not of 64
    (1, 256, 40, 64, 1, 128, 256),  # one of 2 ranks of mamba2: a 128-token admission
    (1, 256, 40, 64, 1, 64, 256),   # one of 2 ranks of zamba2
    (4, 256, 20, 64, 1, 128, 256),  # one of 4 ranks of mamba2, 4 rows
])
def test_ssd_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk, dtype):
    """Against the plain version and, in bf16, against the plain mirror of
    the three passes; one launch a call whatever the passes; a repeated
    call gives the same bits."""
    x, dt, a, bm, cm = _ssd_case(cuda, b, s, h, p, g, n, dtype)
    before = ops.launch_counts()["ssd"]
    y, fin = ops.ssd_op(x, dt, a, bm, cm, chunk=chunk)
    y2, fin2 = ops.ssd_op(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd"] == before + 2
    assert y.dtype == fin.dtype == torch.float32
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    wants = [ref.ssd_chunk_ref(x, dt, a, bm, cm, chunk)]
    if dtype == torch.bfloat16:
        wants.append(ref.ssd_passes_ref(x, dt, a, bm, cm, chunk))
    for yr, finr in wants:
        torch.testing.assert_close(y, yr, **SSD_TOL)
        torch.testing.assert_close(fin, finr, **SSD_TOL)
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(fin2, fin, atol=0, rtol=0)


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


@pytest.mark.parametrize("h,p,n,s,chunk,offset", [
    (4, 16, 32, 64, 32, 0),
    (8, 64, 128, 512, 256, 0),   # mamba2's widths, 16-byte aligned: copies
    (8, 64, 128, 512, 256, 1),   # one element off: scalar staging
])
def test_ssd_kernel_reads_strided_slices(cuda, h, p, n, s, chunk, offset):
    """x, B and C as slices of one wider (B, S, C) tensor, as mamba_block
    hands them over (at an offset of ``offset`` elements), give what
    contiguous copies give, and the same bits again."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    wide = torch.randn(2, s, offset + h * p + 2 * n, device=cuda, generator=gen)
    xbc = wide.to(torch.bfloat16)[..., offset:]
    x = xbc[..., :h * p].reshape(2, s, h, p)
    bm = xbc[..., h * p:h * p + n].reshape(2, s, 1, n)
    cm = xbc[..., h * p + n:].reshape(2, s, 1, n)
    dt = torch.nn.functional.softplus(torch.randn(2, s, h, device=cuda, generator=gen))
    a = -torch.ones(h, device=cuda)
    assert not x.is_contiguous()
    y, fin = ops.ssd_op(x, dt, a, bm, cm, chunk=chunk)
    again = ops.ssd_op(x, dt, a, bm, cm, chunk=chunk)
    yc, finc = ops.ssd_op(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(), chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yc, atol=0, rtol=0)
    torch.testing.assert_close(fin, finc, atol=0, rtol=0)
    torch.testing.assert_close(again[0], y, atol=0, rtol=0)
    torch.testing.assert_close(y, ref.ssd_chunk_ref(x, dt, a, bm, cm, chunk)[0], **SSD_TOL)


def test_ssd_bf16_chunk_invariance_on_card(cuda):
    """bf16 inputs: every chunk size gives the plain version's scan and the
    sequential recurrence's."""
    x, dt, a, bm, cm = _ssd_case(cuda, 2, 256, 4, 64, 2, 128, torch.bfloat16, seed=6)
    yr, finr = ref.ssd_ref(x, dt, a, bm, cm)
    for chunk in (16, 32, 64, 128, 256):
        y, fin = ops.ssd_op(x, dt, a, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        yc, finc = ref.ssd_chunk_ref(x, dt, a, bm, cm, chunk)
        torch.testing.assert_close(y, yc, **SSD_TOL)
        torch.testing.assert_close(fin, finc, **SSD_TOL)
        torch.testing.assert_close(y, yr, **SSD_TOL)
        torch.testing.assert_close(fin, finr, **SSD_TOL)


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


# --- training: no gradient through a kernel, the train step, checkpoints -----
def _op_calls(cuda):
    """Each kernel op on small CUDA inputs: name -> fn(requires_grad)."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def t(*shape, rg=False):
        return torch.randn(*shape, device=cuda, generator=g).requires_grad_(rg)
    w = torch.ones(64, device=cuda)
    tiles = torch.zeros(2, dtype=torch.int32, device=cuda)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([5, 7], dtype=torch.int32, device=cuda)
    return {
        "rmsnorm_op": lambda rg: ops.rmsnorm_op(t(4, 64, rg=rg), w),
        "add_rmsnorm_op": lambda rg: ops.add_rmsnorm_op(t(4, 64), t(4, 64, rg=rg), w),
        "gated_rmsnorm_op": lambda rg: ops.gated_rmsnorm_op(t(4, 64), t(4, 64),
                                                            w.clone().requires_grad_(rg)),
        "flash_attention_op": lambda rg: ops.flash_attention_op(
            t(1, 2, 64, 64, rg=rg), t(1, 2, 64, 64), t(1, 2, 64, 64)),
        "paged_attention_op": lambda rg: ops.paged_attention_op(
            t(2, 2, 64), t(4, 16, 2, 64, rg=rg), t(4, 16, 2, 64), tables, lens),
        "moe_gmm_op": lambda rg: ops.moe_gmm_op(t(16, 64), t(1, 64, 64, rg=rg), tiles,
                                                block_t=8),
        "moe_gmm_capacity": lambda rg: ops.moe_gmm_capacity(t(2, 8, 64, rg=rg), t(2, 64, 64),
                                                            block_t=8),
        "ssd_op": lambda rg: ops.ssd_op(t(1, 64, 2, 64, rg=rg), t(1, 64, 2).abs(),
                                        -torch.ones(2, device=cuda), t(1, 64, 1, 16),
                                        t(1, 64, 1, 16), chunk=32),
    }


@pytest.mark.parametrize("op", ["rmsnorm_op", "add_rmsnorm_op", "gated_rmsnorm_op",
                                "flash_attention_op", "paged_attention_op", "moe_gmm_op",
                                "moe_gmm_capacity", "ssd_op"])
def test_kernel_ops_refuse_cuda_inputs_that_require_grad(cuda, op):
    """The kernels have no backward: on the card each op refuses a call
    autograd would record, before any launch; under ``torch.no_grad()`` it
    launches."""
    call = _op_calls(cuda)[op]
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="kernel_impls=\"reference\""):
        call(True)
    assert ops.launch_counts() == before
    with torch.no_grad():
        call(True)
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == sum(before.values()) + 1


def test_train_step_on_card_matches_cpu(cuda):
    """3 steps of ``make_train_step`` at the smoke config, f32, on the card
    and on the CPU from the same parameters and batches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state, tree_leaves
    from repro_torch.training.train_step import make_train_step

    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), dtype="float32")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    pc = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pg = M.tree_map(lambda t: t.to(cuda), pc)
    oc, og = init_opt_state(pc), init_opt_state(pg)
    step = make_train_step(cfg, opt, 2)
    pipe = DataPipeline(cfg, 4, 32, seed=0)
    for _ in range(3):
        batch = {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
        pc, oc, mc = step(pc, oc, batch)
        pg, og, mg = step(pg, og, {k: v.to(cuda) for k, v in batch.items()})
        for key in mc:
            torch.testing.assert_close(mg[key].cpu(), mc[key], **F32_TOL)
    for got, want in zip(tree_leaves(pg), tree_leaves(pc)):
        torch.testing.assert_close(got.cpu(), want, **F32_TOL)


def test_checkpoint_from_card_restores_on_card_bit_for_bit(cuda, tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt

    g = torch.Generator(device=cuda).manual_seed(1)
    tree = {"params": {"w": torch.randn(64, 32, device=cuda, generator=g),
                       "b": torch.randn(32, device=cuda, generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32, device=cuda)}}
    ckpt.save(tree, str(tmp_path), step=3, async_save=True)
    tree["params"]["w"].mul_(2)  # the snapshot was taken before save returned
    ckpt.wait_for_saves()
    restored, man = ckpt.restore(tree, str(tmp_path))
    assert man["arrays"]["params/b"]["dtype"] == "bfloat16"
    assert restored["params"]["w"].device.type == "cuda"
    assert torch.equal(restored["params"]["w"] * 2, tree["params"]["w"])
    assert torch.equal(restored["params"]["b"], tree["params"]["b"])
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 3


def test_elastic_replica_shrinks_mid_stream_on_card(cuda):
    """A smoke ``ElasticReplica`` on the card under ``auto`` (rmsnorm and
    flash launched): a gang of 4 shrunk to 2 after 4 decode steps in
    ``migrate`` mode gives its own unbroken run's tokens, and every
    parameter stays on the card."""
    import numpy as np

    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest

    cfg = with_kernel_impls(get_config("qwen2.5-3b", smoke=True), "auto")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)

    def requests():
        rng = np.random.default_rng(3)
        return [GenRequest(id=i, prompt=rng.integers(0, cfg.vocab_size, size=9 + i).tolist(),
                           max_new=8) for i in range(3)]

    def run(n_members, shrink):
        rep = ElasticReplica(cfg, params, n_members, n_slots=2, device=cuda)
        for r in requests():
            rep.add(r)
        if shrink:
            for _ in range(4):
                rep.step()
            rec = rep.shrink(2)
            assert (rec.n_before, rec.n_after, rec.n_requests_live) == (4, 2, 3)
            assert rec.wire_bytes == rec.param_bytes + rec.kv_bytes > 0
        done = {r.id: list(r.generated) for r in rep.run()}
        assert {t.device.type for t in M.tree_leaves(rep.params)} == {"cuda"}
        return done

    before = ops.launch_counts()
    golden = run(2, False)
    assert ops.launch_counts()["flash_attention"] > before["flash_attention"]
    assert ops.launch_counts()["rmsnorm"] > before["rmsnorm"]
    assert run(4, True) == golden
    assert all(len(t) == 8 for t in golden.values())


def _smoke_tp_rank(tp, prompts):
    """One of two gloo ranks on the card (``spawn_tp``): a smoke
    ``ElasticReplica`` over the group at float32 under ``auto``, unbroken and
    then shrunk 2 -> 1 and grown 1 -> 2 mid-stream; rank 0 returns the
    streams and each rank its flash launches."""
    import dataclasses

    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = with_kernel_impls(dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                                                dtype="float32"), "auto")
    full = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), tp.device)
    out = {"backend": tp.backend, "flash_before": ops.launch_counts()["flash_attention"]}
    for label, plan in (("tp2", ()), ("shrink_grow", ((3, 1), (3, 2)))):
        rep = ElasticReplica(cfg, full, 2, n_slots=2, tp=tp)
        if tp.rank != 0:
            rep.follow()
            continue
        for i, p in enumerate(prompts):
            rep.add(GenRequest(id=i, prompt=p, max_new=8))
        for steps, n in plan:
            for _ in range(steps):
                rep.step()
            rep.resize(n)
            assert {t.device.type for t in M.tree_leaves(rep.params)} == {"cuda"}
        out[label] = {r.id: list(r.generated) for r in rep.run()}
        rep.close()
    out["flash_after"] = ops.launch_counts()["flash_attention"]
    return out


def test_two_ranks_on_the_card_serve_like_the_one_rank_replica(cuda):
    """Two gloo ranks on the one card (``backend_for`` gives gloo for a
    shared card) serve a smoke replica at float32 with the flash kernel at
    the per-rank shape: the same tokens as the one-rank replica on the
    card, unbroken and across a shrink 2 -> 1 and a grow 1 -> 2."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, with_kernel_impls
    from repro_torch.distributed.elastic_serving import ElasticReplica
    from repro_torch.distributed.tensor_parallel import spawn_tp
    from repro_torch.models import model as M
    from repro_torch.serving.batching import GenRequest

    cfg = with_kernel_impls(dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                                                dtype="float32"), "auto")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=9 + i).tolist() for i in range(3)]
    ranks = spawn_tp(_smoke_tp_rank, 2, device="cuda:0", args=(prompts,), timeout=300)
    rep = ElasticReplica(cfg, M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                                            cuda), 1, n_slots=2, device=cuda)
    for i, p in enumerate(prompts):
        rep.add(GenRequest(id=i, prompt=p, max_new=8))
    one = {r.id: list(r.generated) for r in rep.run()}
    assert ranks[0]["tp2"] == one == ranks[0]["shrink_grow"]
    for r in ranks:
        assert r["backend"] == "gloo" and r["flash_after"] > r["flash_before"]


@pytest.mark.parametrize("names", [["cuda", "cuda:0"], ["cuda:0", "cuda"], ["cuda", "cuda"]])
def test_a_bare_cuda_and_its_index_are_one_mesh_device(cuda, names):
    """``cuda`` names the current card, so a mesh over it and ``cuda:0``
    spans one device: placement goes there and nothing raises."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.elastic import reshard_in_place
    from repro_torch.distributed.elastic_serving import serving_mesh
    from repro_torch.distributed.sharding import mesh_device
    from repro_torch.models import model as M

    torch.cuda.set_device(0)
    mesh = serving_mesh(2, names)
    assert mesh.axis_sizes == (2,)
    assert mesh_device(mesh).type == "cuda"
    cfg = get_config("qwen2.5-3b", smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    placed = reshard_in_place(params, cfg, mesh)
    assert {(t.device.type, t.device.index) for t in M.tree_leaves(placed)} == {("cuda", 0)}


# --- long prompts: flash against the chunked online softmax ----------------------------------
def _chunked_cfg(causal=True, window=None):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2.5-3b"), encoder_only=not causal,
                               sliding_window=window)


def _row_block_rel_l2(got, want, rows=512):
    """||got - want|| / ||want|| of each block of ``rows`` positions (dim 1)."""
    b, s = want.shape[:2]
    num = (got.float() - want.float()).pow(2).reshape(b, s // rows, -1).sum(-1)
    return (num / want.float().pow(2).reshape(b, s // rows, -1).sum(-1)).sqrt()


def test_flash_kernel_at_32k_matches_chunked_mha_on_card(cuda):
    """qwen2.5-3b's attention at a 32,768-token prefill, bf16: the plain
    version would need a 68.7 GB score matrix, so the kernel is held against
    ``chunked_mha``, the plain online softmax over (512, 1024) blocks, at
    float32 on the same values: element-wise within the bf16 tolerance and,
    since a late row's output (an average over its many keys) is far smaller
    than that atol, block by block within a relative L2 error of
    ``FLASH_32K_REL_L2`` (chip_smoke.py's limit)."""
    from repro_torch.models.attention import chunked_mha
    g = torch.Generator(device=cuda).manual_seed(7)
    b, h, kv, s, d = 1, 16, 2, 32768, 128
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, kv, d, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, kv, d, device=cuda, generator=g).to(torch.bfloat16)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = chunked_mha(q.float(), k.float().repeat_interleave(h // kv, dim=2),
                       v.float().repeat_interleave(h // kv, dim=2), _chunked_cfg())
    got = out.transpose(1, 2).reshape(b, s, h * d)
    torch.testing.assert_close(got.float(), want, **BF16_TOL)
    rel = _row_block_rel_l2(got, want)
    assert rel.max().item() <= FLASH_32K_REL_L2, (rel.max().item(), int(rel.argmax()))


@pytest.mark.parametrize("causal,window,s", [(True, None, 1500), (True, 300, 1500),
                                             (False, None, 1100)])
def test_chunked_mha_on_card_matches_the_cpu_at_f32(cuda, causal, window, s):
    from repro_torch.models.attention import chunked_mha
    cfg = _chunked_cfg(causal, window)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, s, 4, 64, generator=g) for _ in range(3))
    want = chunked_mha(q, k, v, cfg)
    got = chunked_mha(q.to(cuda), k.to(cuda), v.to(cuda), cfg)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal", [
    (2, 8, 8, 512, 80, False),    # hubert-xlarge's encoder at one of 2 ranks
    (2, 24, 4, 512, 128, True),   # internvl2-26b at one of 2 ranks: 256 patches + 256 tokens
])
def test_flash_kernel_at_the_frontends_rank_shapes_on_card(cuda, b, h, kv, s, d, causal,
                                                           dtype):
    """The shapes ``loss_fn`` gives flash on a rank of two under a group:
    against the plain version, bf16 also against the mirror of its tiles."""
    g = torch.Generator(device=cuda).manual_seed(26)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(b, s, kv, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device=cuda, generator=g).to(dtype).transpose(1, 2)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(
        q, k, v, causal=causal).float(), **tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.flash_attention_tiles_ref(
            q, k, v, causal=causal).float(), **TILES_TOL)


def _tp_loss_rank(tp):
    """One of two gloo ranks on the card: internlm2-1.8b's smoke loss at
    float32 over the group (the vocab-parallel CE, the "copy" and "reduce"
    collectives) and this rank's gradients, summed where ranks share a
    segment."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import map_with_names, sum_shared
    from repro_torch.models import model as M
    from repro_torch.models.frontends import make_batch
    from repro_torch.training.train_step import _grads_of

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), dtype="float32")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), tp.device, tp=tp)
    batch = make_batch(torch.Generator(device="cuda").manual_seed(1), cfg, 2, 32,
                       device=tp.device)
    loss, _, grads = _grads_of(params, batch, cfg, tp)
    grads = map_with_names(lambda names, g: sum_shared(g, names, cfg, tp), grads)
    return {"loss": float(loss), "grads": M.tree_map(lambda g: g.cpu(), grads)}


def test_vocab_parallel_loss_and_gradient_on_two_ranks_of_the_card(cuda):
    """Two gloo ranks sharing the card: the loss over vocab-parallel logits
    and every rank's gradient of its shard equal the one-rank loss and the
    cut of its gradient on the card at float32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import local_shard, map_with_names
    from repro_torch.distributed.tensor_parallel import TPGroup, spawn_tp
    from repro_torch.models import model as M
    from repro_torch.models.frontends import make_batch
    from repro_torch.training.train_step import _grads_of

    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), dtype="float32")
    ranks = spawn_tp(_tp_loss_rank, 2, device="cuda:0", timeout=300)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), cuda)
    batch = make_batch(torch.Generator(device="cuda").manual_seed(1), cfg, 2, 32, device=cuda)
    loss, _, grads = _grads_of(params, batch, cfg)
    for rank, got in enumerate(ranks):
        torch.testing.assert_close(torch.tensor(got["loss"]), loss.cpu(), **F32_TOL)
        group = TPGroup(None, rank, 2, torch.device("cpu"), (torch.device("cpu"),) * 2, "gloo")
        map_with_names(lambda names, g: torch.testing.assert_close(
            _at(got["grads"], names), local_shard(g.cpu(), names, cfg, group), **F32_TOL),
            grads)


def _at(tree, names):
    for k in names:
        tree = tree[k]
    return tree


def _data_pair_rank(world):
    """One of two gloo ranks as a grid of ``(data 2, model 1)``: the
    ``"data"`` gather of a seeded shard and its backward's reduce-scatter
    (``data_parallel.gather_data``), and ``reduce_scatter`` called alone, on
    the rank's device; a backend that lacks the reduce-scatter for the
    device raises, and the rank reports the error."""
    from repro_torch.distributed.data_parallel import gather_data, make_grid, reduce_scatter

    grid = make_grid(world, 2, 1)
    gen = torch.Generator().manual_seed(7)
    whole = torch.randn(3, 8, 5, generator=gen)
    weights = torch.randn(2, 3, 8, 5, generator=gen)   # a rank's weight of the gathered leaf
    dev = world.device
    x = whole[:, 4 * grid.data_rank:4 * grid.data_rank + 4].to(dev).requires_grad_()
    out = {"gathered": None, "grad": None, "reduce_scatter": None, "error": None}
    try:
        y = gather_data(x, -2, grid)
        out["gathered"] = y.detach().cpu()
        (y * weights[grid.data_rank].to(dev)).sum().backward()
        out["grad"] = x.grad.cpu()
        out["reduce_scatter"] = reduce_scatter(weights[grid.data_rank].to(dev), -2,
                                               grid.data).cpu()
    except RuntimeError as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def test_data_axis_gather_and_reduce_scatter_on_the_card_equal_the_cpu(cuda):
    """The ``"data"`` axis's pair over two gloo ranks of the card gives the
    CPU's bits: the forward the whole leaf, the backward each rank's slice
    of the summed gradient. The reduce-scatter of CUDA tensors under gloo
    either runs, with the CPU's result, or raises by the designed path (the
    backend's error, never a quiet other result)."""
    from repro_torch.distributed.tensor_parallel import spawn_tp

    card = spawn_tp(_data_pair_rank, 2, device="cuda:0", timeout=300)
    host = spawn_tp(_data_pair_rank, 2, device="cpu", timeout=300)
    gen = torch.Generator().manual_seed(7)
    whole = torch.randn(3, 8, 5, generator=gen)
    summed = torch.randn(2, 3, 8, 5, generator=gen).sum(0)
    for rank, (c, h) in enumerate(zip(card, host)):
        assert h["error"] is None, h["error"]
        want = summed[:, 4 * rank:4 * rank + 4]
        assert torch.equal(h["gathered"], whole) and torch.equal(h["grad"], want)
        assert torch.equal(h["reduce_scatter"], want)
        if c["error"] is not None:   # the designed path: the backend's own error
            assert c["reduce_scatter"] is None and "gloo" in c["error"].lower(), c["error"]
            continue
        assert torch.equal(c["gathered"], whole)
        assert torch.equal(c["grad"], h["grad"]) and torch.equal(c["reduce_scatter"], want)

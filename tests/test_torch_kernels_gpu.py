"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances are those of ``tests/test_kernels.py``: 5e-5/5e-4 at float32,
5e-2 at bfloat16.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

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


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.rmsnorm_op(x, torch.ones(64, device=cuda))
    q = torch.randn(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_op(q, q, q)

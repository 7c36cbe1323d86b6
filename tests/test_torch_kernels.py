"""The port's kernels against the JAX package's: the plain PyTorch versions
(what a kernel wrapper runs for CPU tensors) against the Pallas kernels in
interpret mode and against ``repro.kernels.ref``, on the grids of
``tests/test_kernels.py``. Inputs come from numpy with a seed; tolerances
are 5e-5/5e-4 at float32 and 5e-2 at bfloat16. The CUDA kernels themselves
are held against the plain versions on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BF16_TOL, F32_TOL, close
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import build, ops, ref

pytestmark = pytest.mark.slow

DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounds the
    same float32 values to nearest even on both sides)."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


# --- rmsnorm ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64, 256), (1, 7, 512), (128, 128), (3, 100, 80)])
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-1:], dtype=np.float32)
    jx, tx = _both(x, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    tol = DTYPES[dtype][2]
    out = ref.rmsnorm_ref(tx, tw)
    assert out.dtype == tx.dtype
    close(_f32(out), _f32(pallas_rmsnorm(jx, jw, interpret=True)), tol)
    close(_f32(out), _f32(jref.rmsnorm_ref(jx, jw)), tol)
    before = ops.launch_counts()["rmsnorm"]
    close(_f32(ops.rmsnorm_op(tx, tw)), _f32(out), tol)  # CPU tensor: plain path
    assert ops.launch_counts()["rmsnorm"] == before


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64, 256), (1, 7, 512), (3, 100, 80), (2, 3, 777),
                                   (2, 2, 5120)])
def test_add_rmsnorm_plain_matches_pallas_composition(shape, dtype):
    """(s, y) = add_rmsnorm_ref(x, h, w) against JAX's x + h and the Pallas
    rmsnorm (interpret) of it; on CPU tensors the op takes the plain version
    and counts no launch."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape, dtype=np.float32)
    h = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal(shape[-1:], dtype=np.float32)
    (jx, tx), (jh, th) = _both(x, dtype), _both(h, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    tol = DTYPES[dtype][2]
    s, y = ref.add_rmsnorm_ref(tx, th, tw)
    assert s.dtype == y.dtype == tx.dtype
    js = jx + jh
    close(_f32(s), _f32(js), tol)
    close(_f32(y), _f32(pallas_rmsnorm(js, jw, interpret=True)), tol)
    before = ops.launch_counts()["rmsnorm"], ops.rmsnorm_form_counts()
    s_op, y_op = ops.add_rmsnorm_op(tx, th, tw)
    assert torch.equal(s_op, s) and torch.equal(y_op, y)
    assert (ops.launch_counts()["rmsnorm"], ops.rmsnorm_form_counts()) == before


@pytest.mark.parametrize("dtype", list(DTYPES))
# the last two: an odd width, and mamba2-2.7b's z in its in_proj row
@pytest.mark.parametrize("shape,z_width", [((4, 64, 256), 256), ((1, 7, 512), 1100),
                                           ((3, 100, 80), 191), ((2, 3, 777), 1890),
                                           ((2, 2, 5120), 10576)])
def test_gated_rmsnorm_plain_matches_pallas_composition(shape, z_width, dtype):
    """gated_rmsnorm_ref(x, z, w) against the Pallas rmsnorm (interpret) of
    JAX's x * silu(z); z is a column slice of a wider row, as Mamba2 slices
    it from in_proj's output, wherever the width leaves room for one."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape, dtype=np.float32)
    zw = rng.standard_normal(shape[:-1] + (z_width,), dtype=np.float32)
    w = rng.standard_normal(shape[-1:], dtype=np.float32)
    d = shape[-1]
    (jx, tx), (jzw, tzw) = _both(x, dtype), _both(zw, dtype)
    jz, tz = jzw[..., :d], tzw[..., :d]
    assert z_width == d or not tz.is_contiguous()
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    tol = DTYPES[dtype][2]
    y = ref.gated_rmsnorm_ref(tx, tz, tw)
    assert y.dtype == tx.dtype
    close(_f32(y), _f32(pallas_rmsnorm(jx * jax.nn.silu(jz), jw, interpret=True)), tol)
    before = ops.launch_counts()["rmsnorm"]
    assert torch.equal(ops.gated_rmsnorm_op(tx, tz, tw), y)
    assert ops.launch_counts()["rmsnorm"] == before


def test_rmsnorm_forms_raise_on_a_dtype_or_shape_mismatch_on_cpu():
    x = torch.randn(2, 16)
    w = torch.ones(16)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.add_rmsnorm_op(x, x.bfloat16(), w)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.gated_rmsnorm_op(x, x.double(), w)
    with pytest.raises(ValueError, match="shape"):
        ops.add_rmsnorm_op(x, x[:1], w)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in build.SIGNATURES.items()
                                    for fn in fns])
def test_ctypes_signatures_match_the_cuda_sources(lib, fn):
    """Every C function a wrapper calls takes, in csrc/<lib>.cu, the argument
    types ``build.SIGNATURES`` gives ctypes, in that order: a launch
    argument added to or dropped from a kernel's C interface without its
    binding would shift every argument after it."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert m, f"{fn} not found in {lib}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",") if p.strip()]
    types = [_C_TYPES[re.sub(r"\s*\w+$", "", p)] for p in params]
    assert types == build.SIGNATURES[lib][fn]


# --- flash attention --------------------------------------------------------------
def _qkv(b, h, kv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, kv, sk, d), dtype=np.float32),
            rng.standard_normal((b, kv, sk, d), dtype=np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window", [
    (2, 4, 2, 256, 256, 64, True, None),      # GQA causal
    (1, 4, 4, 128, 128, 128, False, None),    # MHA bidirectional
    (1, 8, 2, 384, 384, 64, True, 128),       # sliding window
    (2, 2, 1, 100, 100, 32, True, None),      # non-multiple seq
    (1, 16, 8, 128, 128, 128, True, None),    # internlm2-like head geometry
    (1, 2, 2, 512, 512, 80, True, None),      # head_dim=80
])
def test_flash_plain_matches_pallas_and_ref(b, h, kv, sq, sk, d, causal, window, dtype):
    q, k, v = _qkv(b, h, kv, sq, sk, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    tol = DTYPES[dtype][2]
    out = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    close(_f32(out), _f32(pallas_flash(jq, jk, jv, causal=causal, window=window,
                                       interpret=True)), tol)
    close(_f32(out), _f32(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                   window=window)), tol)


@pytest.mark.parametrize("window", [1, 64, 128, 256, 384])
def test_flash_plain_sliding_window_edges(window):
    q, k, v = _qkv(1, 4, 2, 256, 256, 32, seed=1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    close(out, pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                            window=window, interpret=True))
    if window >= 256:   # a window covering the whole sequence == plain causal
        close(out, ref.flash_attention_ref(tq, tk, tv, causal=True, window=None))


def test_flash_op_on_cpu_takes_plain_path_and_strided_views():
    """The wrapper runs the plain version for CPU tensors (no launch counted),
    including the (B,S,H,D) -> (B,H,S,D) views the model passes."""
    q, k, v = _qkv(1, 4, 2, 40, 40, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (tq, tk, tv)]
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention_op(*views, causal=True)
    assert ops.launch_counts()["flash_attention"] == before
    close(out, ref.flash_attention_ref(tq, tk, tv, causal=True))


@pytest.mark.parametrize("op", ["rmsnorm", "flash"])
def test_wrapper_rejects_other_devices(op):
    """Only cpu (plain version) and cuda (kernel) are taken."""
    x = torch.empty(2, 4, 8, 16, device="meta")
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        if op == "rmsnorm":
            ops.rmsnorm_op(x, torch.empty(16, device="meta"))
        else:
            ops.flash_attention_op(x, x, x)

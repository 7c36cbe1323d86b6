"""Helpers shared by the ``test_torch_*`` files: the same configuration and
parameters on both sides of the port (JAX reference, PyTorch port), and
tolerances.

Inputs are made with numpy from a seed and handed to both frameworks; JAX
parameters cross to the port as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs import with_kernel_impls as jax_with_kernel_impls
from repro.models import model as jax_model
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import with_kernel_impls as torch_with_kernel_impls
from repro_torch.models.weights import params_from_numpy

F32_TOL = dict(atol=5e-5, rtol=5e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def configs(arch: str, impls: str = "reference", **overrides):
    """(jax cfg, torch cfg): the smoke config at float32 with ``impls``."""
    overrides = {"dtype": "float32", **overrides}
    jc = jax_with_kernel_impls(
        dataclasses.replace(jax_get_config(arch, smoke=True), **overrides), impls)
    tc = torch_with_kernel_impls(
        dataclasses.replace(torch_get_config(arch, smoke=True), **overrides), impls)
    return jc, tc


def params(jc, tc, seed: int = 0):
    """(jax params, torch params on the CPU): the same values on both sides."""
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jp, tp


def close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)

"""Helpers shared by the ``test_torch_*`` files: the same configuration and
parameters on both sides of the port (JAX reference, PyTorch port), and
tolerances.

Inputs are made with numpy from a seed and handed to both frameworks; JAX
parameters cross to the port as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import itertools

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


RESULT_FIELDS = ["n_submitted", "outcome_counts", "invoked_share", "success_share",
                 "response_p50", "response_p95", "slurm_coverage", "sim_upper_bound",
                 "no_worker_time_share", "n_jobs_started", "n_evicted",
                 "worker_samples", "n_throttled", "n_wasted_execs", "goodput_s",
                 "reliability"]


def _requests(res):
    return [(r.id, r.fn, r.arrival, r.outcome, r.response_time) for r in res.requests]


def assert_same_result(jres, tres):
    """Exact equality (NaN equal to NaN) of every reported field of two
    platform runs' ``HarvestResult`` and of every request."""
    for name in RESULT_FIELDS:
        np.testing.assert_equal(getattr(tres, name), getattr(jres, name), err_msg=name)
    np.testing.assert_equal([dataclasses.asdict(c) for c in tres.per_class],
                            [dataclasses.asdict(c) for c in jres.per_class])
    assert _requests(tres) == _requests(jres)


def reset_ids(monkeypatch):
    """Both packages number requests and gangs from 0 (their counters are
    per process; a gang's id labels its ``gang_mesh_size`` gauge)."""
    import repro.core.queues as jqueues
    import repro.platform.elastic as jelastic
    import repro_torch.core.queues as tqueues
    import repro_torch.platform.elastic as telastic
    for mod, name in ((jqueues, "_REQ_IDS"), (tqueues, "_REQ_IDS"),
                      (jelastic, "_GANG_IDS"), (telastic, "_GANG_IDS")):
        monkeypatch.setattr(mod, name, itertools.count())

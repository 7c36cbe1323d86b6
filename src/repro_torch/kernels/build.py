"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``), all sources
at once in parallel. Libraries land in ``kernels/build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so a
changed source never loads a stale build. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# torch dtype -> code understood by csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# library name -> {C function -> argtypes}; every function returns int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "rmsnorm": {
        "rmsnorm_launch": [_P] * 5 + [_L, _L, _I, _I, _I, _F, _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
        + [_L] * 12 + [_I, _I, _F, _I, _P],
    },
    "paged_attention": {
        "paged_attention_launch": [_P] * 7 + [_I] * 8 + [_L] * 11 + [_F, _I, _P],
        "paged_attention_smem_bytes": [_I, _I, _I],
    },
    "moe_gmm": {
        "moe_gmm_launch": [_P] * 4 + [_I] * 7 + [_P],
        "moe_gmm_smem_bytes": [_I],
    },
    "mla_prefill": {
        "mla_prefill_launch": [_P] * 6 + [_I] * 3 + [_L] * 17 + [_F, _P],
        "mla_prefill_smem_bytes": [],
    },
    "ssd": {
        "ssd_launch": [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _P],
        "ssd_smem_bytes": [_I, _I, _I, _I],
        "ssd_smem_limit": [],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if Path(cand).is_file():
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "$PATH): the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every listed source that has no library yet, one ``nvcc``
    per source, all started together. Returns ``{name: compiler log}``
    (``ptxas`` register and shared-memory lines) for what it built; raises
    ``RuntimeError`` with the log if a build fails."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building every missing source
    (in parallel) on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

"""Build and load the port's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded with
``ctypes``. The build happens at first use, into ``kernels/build/`` next
to this file (whatever the working directory); the library's name
carries a hash of its source, so an edited source builds anew.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by its source hash."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    # processes that reach first use together (the rank processes of a
    # mesh) build once: the others wait on the lock, then find the
    # library; the kernel releases the lock when its holder dies
    with open(BUILD / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 str(CSRC / f"{name}.cu")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                   f"{proc.stdout}{proc.stderr}")
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)      # atomic: a reader sees all or none
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it if needed.
    Callers cache the handle (each kernel module's ``_lib``)."""
    return ctypes.CDLL(str(build(name)))

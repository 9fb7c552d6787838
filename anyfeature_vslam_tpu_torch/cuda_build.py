"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
nvcc for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` the first
time a wrapper launches it, keyed by a hash of the source and the flags, and
loaded with ctypes. Nothing here runs at import time: a CPU-only machine
imports the package without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME, else the toolkit's default
    install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME): the CUDA kernels of "
            "anyfeature_vslam_tpu_torch are built from csrc/ at first use"
        )
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the hashed .so already exists. The
    compiler's report (registers, shared memory, spills from -Xptxas=-v)
    is kept beside the library as <lib>.log."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a private file, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        Path(str(out) + ".log").write_text(" ".join(cmd) + "\n" + log)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu. The caller declares
    argtypes/restype of the functions it calls."""
    return ctypes.CDLL(str(build(name)))


def build_log(name: str) -> str:
    """nvcc's report for the library load() built or found."""
    log = Path(str(library_path(name)) + ".log")
    return log.read_text() if log.exists() else ""

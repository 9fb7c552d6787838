"""Build the hand-written CUDA kernels and the host library under
``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
nvcc for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` the first
time a wrapper launches it, keyed by a hash of the source and the flags, and
loaded with ctypes. ``csrc/<name>.cpp`` (the host library, native.py) is
compiled the same way with the host C++ compiler (``build_host``). Nothing
here runs at import time: a machine without nvcc imports the package.
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
# no -march=native: the hash below would not see the host the library was
# built for; -ffp-contract=off: no FMA contraction, as the numpy twins
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")


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


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else c++ or g++ from PATH."""
    cxx = os.environ.get("CXX")
    if cxx:
        found = shutil.which(cxx)
        if not found:
            raise RuntimeError(f"the C++ compiler $CXX={cxx!r} was not found: the host "
                               "library of anyfeature_vslam_tpu_torch is built from "
                               "csrc/ at first use")
        return found
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++, g++ or $CXX): the host library of "
                       "anyfeature_vslam_tpu_torch is built from csrc/ at first use")


def _hashed(name: str, src: Path, flags) -> Path:
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def library_path(name: str) -> Path:
    return _hashed(name, CSRC / f"{name}.cu", NVCC_FLAGS)


def host_library_path(name: str, cxx: str) -> Path:
    return _hashed(name, CSRC / f"{name}.cpp", (cxx,) + CXX_FLAGS)


def _compile(out: Path, cmd_for, what: str) -> Path:
    """Run cmd_for(private path) unless `out` exists. The build goes into a
    private file, then a rename: concurrent builders never load a
    half-written library. The compiler's report is kept beside the library
    as <lib>.log."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = cmd_for(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {what}:\n{log}")
        Path(str(out) + ".log").write_text(" ".join(cmd) + "\n" + log)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile csrc/<name>.cu with nvcc unless the hashed .so already
    exists; the log holds -Xptxas=-v's registers, shared memory, spills."""
    src = str(CSRC / f"{name}.cu")
    return _compile(library_path(name),
                    lambda tmp: [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src], f"{name}.cu")


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with the host C++ compiler (find_cxx)
    unless the hashed .so already exists; raises RuntimeError naming the
    compiler when there is none or it fails."""
    cxx = find_cxx()
    src = str(CSRC / f"{name}.cpp")
    return _compile(host_library_path(name, cxx),
                    lambda tmp: [cxx, *CXX_FLAGS, "-o", tmp, src], f"{name}.cpp")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu. The caller declares
    argtypes/restype of the functions it calls."""
    return ctypes.CDLL(str(build(name)))


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cpp; not cached, so a caller
    that changes $CXX or BUILD_DIR gets that build."""
    return ctypes.CDLL(str(build_host(name)))


def build_log(name: str) -> str:
    """nvcc's report for the library load() built or found."""
    log = Path(str(library_path(name)) + ".log")
    return log.read_text() if log.exists() else ""

"""Build and load the port's CUDA sources as plain-C shared libraries.

Each ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` into
``msclip_torch/_build/`` the first time a kernel from it is launched, and
loaded with ``ctypes``. The library's file name carries a hash of its source,
of the shared headers ``csrc/*.cuh`` and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded. Nothing is built at import time: machines without ``nvcc`` (the CPU
test runs) never reach this module's build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# --split-compile=0: the optimizer and ptxas run over the kernels of a
# source in as many threads as the host has CPUs (halfblock_tuning.cu holds
# 34 instantiations of K5-sized kernels)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of msclip_torch are built from source at first use")


def library_path(source: str) -> str:
    """The library's path: its name hashes the source, every header of
    ``csrc/`` (``*.cuh``, which a source may include) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library path. The compiler's ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside it as ``<lib>.log``."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, source)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{r.stderr}")
        with open(out + ".log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, out)  # atomic: a reader sees no half-written lib
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built if needed."""
    lib = ctypes.CDLL(build(source))
    lib.msclip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msclip_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.msclip_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

"""Build-on-first-use for the package's native libraries.

Each library is compiled from sources in the checkout into
`multimodalmusig_tpu_torch/_build/<name>-<hash>/lib<name>.so` (git-ignored),
where the hash covers the source bytes and the full compiler command, so a
stale library is never loaded after a source or flag change. The compile
writes to a temporary name and renames into place, so concurrent first uses
in several processes never load a half-written file. The compiler's output
(e.g. `nvcc -Xptxas -v` register counts) is kept beside the library as
`build.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_shared_library", "cuda_function", "nvcc"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

# Hopper only (sm_90a), full-precision float32 (no --use_fast_math), a plain
# C interface, and ptxas's register and shared-memory report in build.log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_shared_library(
    name: str, sources: Sequence[str], command: Sequence[str], timeout: float = 600.0
) -> str:
    """Compile `sources` with `command` (compiler and flags, without sources
    or `-o`) into a shared library; return its path. Raises
    FileNotFoundError when the compiler is missing and RuntimeError, with
    the compiler's output, when the compile fails."""
    sources = [os.path.abspath(s) for s in sources]
    digest = hashlib.sha256("\0".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp_path = f"{lib_path}.tmp{os.getpid()}"
    proc = subprocess.run(
        [*command, *sources, "-o", tmp_path],
        capture_output=True, text=True, timeout=timeout,
    )
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building lib{name}.so failed (exit {proc.returncode}):\n"
            f"{' '.join(command)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp_path, lib_path)
    return lib_path


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else $CUDA_PATH's, else
    /usr/local/cuda's."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


_cuda_lock = threading.Lock()
_cuda_functions = {}


def cuda_function(name: str, symbol: str, argtypes):
    """Compile csrc/<name>.cu with nvcc and NVCC_FLAGS (build_shared_library)
    once per process, load it, and return (library path, its C function
    `symbol` with `argtypes` and an int return). Raises if nvcc is missing
    or the compile fails."""
    with _cuda_lock:
        if name not in _cuda_functions:
            path = build_shared_library(
                name, [os.path.join(CSRC_DIR, f"{name}.cu")], [nvcc(), *NVCC_FLAGS]
            )
            fn = getattr(ctypes.CDLL(path), symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            _cuda_functions[name] = (path, fn)
        return _cuda_functions[name]

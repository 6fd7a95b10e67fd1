"""Build-on-first-use for the package's native libraries.

Each library is compiled from sources in the checkout into
`multimodalmusig_tpu_torch/_build/<name>-<hash>/lib<name>.so` (git-ignored),
where the hash covers the source bytes, the bytes of every header the
sources may include, and the full compiler command, so a stale library is
never loaded after a source, header or flag change. The compile
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

__all__ = [
    "BUILD_DIR", "NVCC_FLAGS", "build_dir", "build_shared_library", "csrc_headers",
    "cuda_command", "cuda_function", "nvcc",
]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

# Hopper only (sm_90a), full-precision float32 (no --use_fast_math), a plain
# C interface, and ptxas's register and shared-memory report in build.log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_dir(name: str, sources: Sequence[str], command: Sequence[str],
              headers: Sequence[str] = ()) -> str:
    """The build directory of library `name`: BUILD_DIR/<name>-<hash>, the
    hash over the command, then each source's bytes, then each header's
    bytes (headers sorted by path, so the order they are given in does not
    matter)."""
    digest = hashlib.sha256("\0".join(command).encode())
    for path in [*sources, *sorted(headers)]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")


def build_shared_library(
    name: str, sources: Sequence[str], command: Sequence[str], timeout: float = 600.0,
    headers: Sequence[str] = (),
) -> str:
    """Compile `sources` with `command` (compiler and flags, without sources
    or `-o`) into a shared library; return its path. `headers` are the
    files the sources may include: they take part in the hash (build_dir).
    Raises FileNotFoundError when the compiler is missing and RuntimeError,
    with the compiler's output, when the compile fails."""
    sources = [os.path.abspath(s) for s in sources]
    out_dir = build_dir(name, sources, command, [os.path.abspath(h) for h in headers])
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


def csrc_headers() -> list:
    """Every csrc/*.cuh: the headers a kernel source may include."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def cuda_command() -> list:
    """nvcc, NVCC_FLAGS and `-I csrc`, the command every kernel builds with."""
    return [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR]


def cuda_function(name: str, symbol: str, argtypes):
    """Compile csrc/<name>.cu with `cuda_command()` (build_shared_library,
    the hash covering every csrc/*.cuh too) once per process into a library
    of its own, load it, and return (library path, its C function `symbol`
    with `argtypes` and an int return). Raises if nvcc is missing or the
    compile fails."""
    with _cuda_lock:
        if name not in _cuda_functions:
            path = build_shared_library(
                name, [os.path.join(CSRC_DIR, f"{name}.cu")], cuda_command(),
                headers=csrc_headers(),
            )
            fn = getattr(ctypes.CDLL(path), symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            _cuda_functions[name] = (path, fn)
        return _cuda_functions[name]

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

import hashlib
import os
import subprocess
from typing import Sequence

__all__ = ["BUILD_DIR", "build_shared_library"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


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

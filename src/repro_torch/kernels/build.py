"""Build a kernel's CUDA source into a shared library at first use.

Each kernel keeps one ``csrc/<name>.cu`` with a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` beside the
kernel's package, as ``lib<name>_<hash>.so`` named by a hash of the
source and of the headers the kernels share (``csrc/*.cuh`` beside this
module, on the include path), so that an edited source or header is
rebuilt, and loaded with ``ctypes`` by the kernel's ``ops.py``.
``nvcc``'s messages (``-Xptxas -v``: registers, shared memory, spills)
are kept beside the library as ``<lib>.log``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# headers shared by the kernels' sources
INCLUDE = Path(__file__).resolve().parent / "csrc"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: building the kernels needs the "
                       "CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where the shared library for the current ``source`` (and the
    current shared headers) lives."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(INCLUDE.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:16]
    return source.parent.parent / "build" / f"lib{source.stem}_{tag}.so"


def build(source: Path) -> Path:
    """Compile ``source`` if its library is not built yet; returns the
    library's path."""
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE), "-o", str(tmp),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib

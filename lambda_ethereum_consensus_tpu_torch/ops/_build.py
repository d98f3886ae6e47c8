"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``_build/lib<name>-<digest>.so``, where the digest covers the source text and
the compiler flags, so an edited source builds anew.  A build writes to a
temporary name and renames it into place, so two processes never load a
half-written file.  Nothing here runs at import time: ``nvcc`` is looked up
when a CUDA tensor first needs a kernel (or when a caller asks for
:func:`build_all`), so the package imports on machines without a toolkit.

No PyTorch header is compiled in: a source that includes them takes minutes
to build, a plain C one seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SOURCE_DIR", "BUILD_DIR", "build_all", "library", "nvcc_path"]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
#: ``ptxas -v`` report (registers, spills) of each library built in this process
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = SOURCE_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build every named source that has no current library, one ``nvcc``
    process each, all started together.  Returns ``{name: path}``."""
    if names is None:
        names = sorted(p.stem for p in SOURCE_DIR.glob("*.cu"))
    targets = {name: _target(name) for name in names}
    pending = {}
    for name, (src, so) in targets.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, so)
    failed = []
    for name, (proc, tmp, so) in pending.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {name: so for name, (_, so) in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = _libraries[name] = ctypes.CDLL(str(build_all([name])[name]))
        return lib

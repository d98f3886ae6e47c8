"""Build the package's CUDA sources with ``nvcc``, and the repo's native host
library with ``g++``, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``_build/lib<name>-<digest>.so``, where the digest covers the source text and
the compiler flags, so an edited source builds anew.  A build writes to a
temporary name and renames it into place, so two processes never load a
half-written file.  Nothing here runs at import time: ``nvcc`` is looked up
when a CUDA tensor first needs a kernel (or when a caller asks for
:func:`build_all`), so the package imports on machines without a toolkit.

No PyTorch header is compiled in: a source that includes them takes minutes
to build, a plain C one seconds.

The host libraries are the repo's shared C++ layer under ``native/``, which
belongs to neither Python package: ``native/bls381/bls381.cpp`` (BLS12-381)
and ``native/kvstore/kvstore.cpp`` (the ordered key-value engine with its
write-ahead log).  Each is compiled in place with ``native/Makefile``'s
``libbls381.so`` flags into ``_build/lib<name>-<digest>.so`` (never into
``native/build/``) at first use, under a file lock so that concurrent
processes build it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "BUILD_DIR", "HOST_FLAGS", "HOST_SOURCES", "NVCC_FLAGS", "SOURCE_DIR", "build_all",
    "build_host", "cxx_path", "library", "nvcc_path",
]

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"
# host C++ sources of the repo's native layer, by library name
HOST_SOURCES = {
    "bls381": _PACKAGE_DIR.parent / "native" / "bls381" / "bls381.cpp",
    "kvstore": _PACKAGE_DIR.parent / "native" / "kvstore" / "kvstore.cpp",
}
# native/Makefile's flags for libbls381.so
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

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


def cxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native host library needs a C++17 compiler")
    return found


def build_host(name: str = "bls381") -> Path:
    """Path of the host library ``name`` (:data:`HOST_SOURCES`), compiled
    with ``g++`` and :data:`HOST_FLAGS` if no current build exists.  Raises
    if the compiler is missing or fails."""
    src = HOST_SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        out = subprocess.run([cxx_path(), *HOST_FLAGS, "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_logs[name] = out.stdout
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host build of {src} failed: g++ exited {out.returncode}\n"
                               f"{out.stdout}")
        os.replace(tmp, so)
    return so

"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled by ``nvcc``
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into its own
shared library with a plain C interface, under ``build/kernels/`` at the
repository root, keyed by a hash of the source, of every header
(``*.cuh``) under ``repro_torch/kernels`` and of the flags, so a changed
source or header rebuilds and an unchanged one loads the cached file.
All sources compile in parallel, one ``nvcc`` each.

Each C entry point returns ``cudaGetLastError()`` right after its
launch; :func:`check` raises on anything but 0. Nothing here imports
``torch.utils.cpp_extension`` or Triton.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
#: one lock for every launch and forward count of the port (the kernels'
#: ``ops`` modules, ``models.transformer``, ``models.encdec``): the
#: serving fabric's rank threads launch kernels and run forwards at once
count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: what the last build printed (``-Xptxas -v``: registers, shared memory,
#: spills per kernel) and how long it took; empty when every library was
#: already cached
build_log: Dict[str, str] = {}
build_seconds = 0.0


def count(counts: dict, name: str) -> None:
    """Add one to the module-level integer ``counts[name]`` (a module's
    ``globals()``) under :data:`count_lock`."""
    with count_lock:
        counts[name] += 1


def sources() -> List[Path]:
    return sorted(_PKG.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def headers() -> List[Path]:
    return sorted(_PKG.rglob("*.cuh"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers():
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile whatever is not cached (all sources at once) and load every
    library. Raises with the compiler's output when a build fails."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [(s, _target(s)) for s in sources()]
        procs = []
        for src, out in todo:
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[src.name] = log
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src, out in todo:
            _libs[src.stem] = ctypes.CDLL(str(out))
        build_seconds = time.perf_counter() - t0
        return _libs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return build_all()[stem]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error; every library exports
    ``error_string(int)`` for the message."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")

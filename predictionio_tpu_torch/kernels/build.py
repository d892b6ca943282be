"""Kernel build: ``nvcc`` by hand into plain-C shared libraries.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, where
the hash covers the source, every ``csrc/*.cuh`` header and the compile
command, so an edited kernel can never load a stale binary. A library
is built at first use under a file lock (two processes racing the first
query build it once), into a temporary name renamed into place, and
loaded with ``ctypes``. :func:`build_all` starts one ``nvcc`` per source
at once, so the build time of a process that needs every kernel is the
slowest file's, not the sum.

The libraries expose C entry points that take raw device pointers and
the CUDA stream as ``void*`` and ints as ``int``, and return
``cudaGetLastError()`` after their launches; a wrapper raises
:class:`KernelLaunchError` on a non-zero code. No PyTorch headers are
compiled, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

#: the compile flags every kernel library is built with (``sm_90a``
#: keeps the Hopper-only instructions — wgmma, setmaxnreg — available)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a CUDA error code."""


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``,
    the toolkit's standard prefix), else from ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "CUDA kernels are built from source at first use"
        )
    return found


def source_path(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(path):
        raise KernelBuildError(f"no kernel source {path}")
    return path


def kernel_names() -> List[str]:
    """Every kernel library the sources define (one per ``.cu``)."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))
    )


def build_command(name: str, out_path: str, nvcc: str = "nvcc") -> List[str]:
    """The ``nvcc`` command line that builds one kernel library."""
    return [nvcc, *NVCC_FLAGS, "-o", out_path, source_path(name)]


def library_path(name: str) -> str:
    """Where ``name``'s library lives, keyed by a hash of everything
    that goes into it."""
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [source_path(name), *headers]:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode())
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str, nvcc: str) -> "tuple[subprocess.Popen, str, str]":
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = build_command(name, tmp, nvcc=nvcc)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: str, out: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        raise KernelBuildError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)


class _BuildLock:
    """Cross-process lock on the build directory (``flock``)."""

    def __enter__(self):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._fh = open(os.path.join(BUILD_DIR, ".lock"), "w")
        fcntl.flock(self._fh, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._fh, fcntl.LOCK_UN)
        self._fh.close()


def build_all(names: Sequence[str] = ()) -> List[str]:
    """Build every missing library among ``names`` (default: all
    sources), one ``nvcc`` per source started together. Returns the
    names that were compiled (empty when every library was current)."""
    names = list(names) or kernel_names()
    with _BuildLock():
        missing = [n for n in names if not os.path.exists(library_path(n))]
        nvcc = nvcc_path() if missing else ""
        started = [(n, *_start_build(n, nvcc)) for n in missing]
        errors = []
        for name, proc, tmp, out in started:
            try:
                _finish_build(name, proc, tmp, out)
            except KernelBuildError as exc:
                errors.append(str(exc))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return missing


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib

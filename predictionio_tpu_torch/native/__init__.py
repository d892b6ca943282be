"""Native (C++) host runtime of the port.

Trimmed copy of the JAX package's native loader: the host-side C++
sources in this directory (the training infeed's bucketizer and index
sort, the event log and its ratings scan, the batch id hash) are
compiled on demand with the system ``g++`` into ``_build/lib<name>.so``
and loaded with ``ctypes`` — no pybind11 and no PyTorch headers. A
library is rebuilt whenever the SHA-1 of its sources (and of every
``.h`` here) differs from its stamp file.

This loader is separate from ``kernels/build.py``, which builds the
``.cu`` kernels with ``nvcc``; this one builds host ``.cc`` files with
``g++`` and compiles nothing outside this directory. A failed build
raises :class:`NativeBuildError` with the compiler's output: no caller
falls back to a slower path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_CACHE = {}

#: Every native component: library name → source list (None = <name>.cc).
LIBRARIES = {
    "eventlog": ["eventlog.cc", "ratings.cc"],
    "bucketize": None,
    "idhash": None,
}

#: compile flags of every host library
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-Wextra")


class NativeBuildError(RuntimeError):
    """Compilation (or loading) of a native component failed."""


def source_paths(name: str, sources=None) -> list:
    """Absolute paths of ``name``'s sources, all under this directory."""
    if sources is None:
        sources = LIBRARIES.get(name) or [f"{name}.cc"]
    return [os.path.join(_HERE, s) for s in sources]


def _source_digest(sources) -> str:
    sha = hashlib.sha1()
    # headers are not compile inputs but must invalidate the stamp
    headers = sorted(
        os.path.join(_HERE, f) for f in os.listdir(_HERE) if f.endswith(".h")
    )
    for src in list(sources) + headers:
        with open(src, "rb") as f:
            sha.update(f.read())
    sha.update(" ".join(CXX_FLAGS).encode())
    return sha.hexdigest()


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def build_library(name: str, sources=None) -> str:
    """Compile ``name`` into ``_build/lib<name>.so`` if it is missing or
    stale, and return its path. The build runs under a file lock, into a
    temporary name that is renamed into place, so a concurrent process
    never loads a half-written file."""
    srcs = source_paths(name, sources)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_BUILD_DIR, f"lib{name}.so")
    stamp_path = os.path.join(_BUILD_DIR, f"lib{name}.stamp")
    digest = _source_digest(srcs)
    with open(os.path.join(_BUILD_DIR, f".lock-{name}"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path) and os.path.exists(stamp_path):
            with open(stamp_path) as f:
                if f.read().strip() == digest:
                    return lib_path
        cxx = os.environ.get("CXX", "g++")
        tmp_path = f"{lib_path}.tmp.{os.getpid()}"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp_path, *srcs]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:
                raise NativeBuildError(f"cannot run {cxx!r}: {exc}") from exc
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"building {name} failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            # the stamp decides whether to rebuild, so the library must be
            # on disk before the stamp says it is current
            _fsync_path(tmp_path)
            os.replace(tmp_path, lib_path)
            _fsync_path(_BUILD_DIR)
        finally:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
        with open(stamp_path, "w") as f:
            f.write(digest)
    return lib_path


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load a native component, once per process."""
    with _LOCK:
        if name not in _CACHE:
            path = build_library(name)
            try:
                _CACHE[name] = ctypes.CDLL(path)
            except OSError as exc:  # dlopen failure
                raise NativeBuildError(f"loading {path} failed: {exc}") from exc
        return _CACHE[name]

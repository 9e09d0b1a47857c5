"""The port's host C++ library (``srf_tpu_torch/csrc/host/*.cc``): built with
g++ at first use, loaded with ``ctypes``.

It holds the C++ CTC prefix beam search (``csrc/host/ctc_beam.cc``). The
library goes to ``srf_tpu_torch/_build/`` (git-ignored), named by a hash of
the sources and the flags, so an edited source is rebuilt and an unchanged
one is not; a compile writes to a per-process temporary name and renames it,
so concurrent first uses never load a half-written file. Without a C++
compiler :func:`load_host_lib` returns False and logs why; the callers then
take their Python paths.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CSRC = os.path.join(_PACKAGE, "csrc", "host")
BUILD_DIR = os.path.join(_PACKAGE, "_build")
SOURCES = ("ctc_beam.cc",)
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None  # None: not tried yet; False: unavailable


def library_path():
    """_build/libsrf_host-<hash>.so, the hash over the sources and flags."""
    digest = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(HOST_CSRC, name), "rb") as src:
            digest.update(src.read())
    digest.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, "libsrf_host-%s.so"
                        % digest.hexdigest()[:16])


def _build(path):
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise OSError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        subprocess.run(
            [cxx, *FLAGS, *(os.path.join(HOST_CSRC, n) for n in SOURCES),
             "-o", tmp],
            capture_output=True, timeout=180, check=True,
        )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib):
    """Give the library's entry points their C signatures; returns it."""
    lib.srf_ctc_beam_search.restype = ctypes.c_int64
    lib.srf_ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    return lib


def load_host_lib():
    """The loaded library (built first if needed), or False."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        lib = False
        try:
            if not os.path.isfile(path):
                _build(path)
            lib = _declare(ctypes.CDLL(path))
        except (OSError, subprocess.SubprocessError) as exc:
            logging.getLogger(__name__).warning(
                "host library %s unavailable (%s); the Python paths are "
                "used", path, exc)
        _lib = lib
        return _lib

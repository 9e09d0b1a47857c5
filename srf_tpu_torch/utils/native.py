"""The port's host C++ library (``srf_tpu_torch/csrc/host/*.cc``): built with
g++ at first use, loaded with ``ctypes``.

It holds the C++ CTC prefix beam search (``csrc/host/ctc_beam.cc``) and the
TFRecord CRC-32C and framing scan (``csrc/host/srf_io.cc``; with
``-msse4.2`` where the build host has SSE4.2, as the JAX package's
``csrc/build.sh`` builds it). The
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
SOURCES = ("ctc_beam.cc", "srf_io.cc")


def _has_sse42():
    """Whether this host's CPU has SSE4.2 (the hardware CRC-32C)."""
    try:
        with open("/proc/cpuinfo") as info:
            return "sse4_2" in info.read()
    except OSError:
        return False


# the flags enter library_path's hash: a host without SSE4.2 builds its own
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall") + (
    ("-msse4.2",) if _has_sse42() else ())

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
    lib.srf_crc32c.restype = ctypes.c_uint32
    lib.srf_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.srf_tfrecord_scan.restype = ctypes.c_int64
    lib.srf_tfrecord_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
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

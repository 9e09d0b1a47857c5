"""Build the port's CUDA kernels (``srf_tpu_torch/csrc/*.cu``) with nvcc.

Each source has a plain C interface and becomes its own shared library,
loaded with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds. Libraries go to ``srf_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, the ``csrc/*.cuh`` headers it includes and the
flags, so an edited source or header is rebuilt and an unchanged one is
not. The build runs at first use, never at import: a box
without ``nvcc`` imports every module.
"""

import hashlib
import os
import re
import shutil
import subprocess

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "compiled from srf_tpu_torch/csrc at first use"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _sources(path, seen):
    """``path`` and, depth first, the csrc headers it includes (each once,
    in the order first reached)."""
    if path in seen:
        return
    seen.append(path)
    with open(path, "rb") as src:
        text = src.read()
    for header in _INCLUDE.findall(text):
        _sources(os.path.join(CSRC, header.decode()), seen)


def library_path(name):
    """Where csrc/<name>.cu is built to: _build/<name>-<hash>.so, the hash
    taken over the source, every csrc header it includes and the flags."""
    digest = hashlib.sha256()
    paths = []
    _sources(os.path.join(CSRC, name + ".cu"), paths)
    for path in paths:
        with open(path, "rb") as src:
            digest.update(src.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest.hexdigest()[:16]))


def build(names):
    """Compile every csrc/<name>.cu not built yet, one nvcc process per
    source, all started together. Returns {name: library path}; the
    compiler's output (registers, shared memory, spills from ptxas) is kept
    beside each library as ``.log``. Raises if a compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = {}
    for name, path in paths.items():
        if os.path.isfile(path):
            continue
        tmp = "%s.%d.tmp" % (path, os.getpid())
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        running[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in running.items():
        log, _ = proc.communicate()
        with open(paths[name] + ".log", "w") as log_file:
            log_file.write(log)
        if proc.returncode == 0:
            os.replace(tmp, paths[name])
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode, log))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths

"""What every cell's run shares: finding the cell's files by name, the run
context, process start time, the device line, the forbidden-module guard
and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its ``config``
names ``benchmark/configs/<config>.json`` and its ``traffic`` names
``benchmark/traffic/<traffic>.json``, whose ``generator`` names the general
generator ``benchmark/traffic/<generator>.py`` that runs it. Its limits
are ``benchmark/limits/<cell>.json``. A per-layer metric is
``benchmark/metrics/<metric>.py``, whose ``read(record)`` returns the
metric's value or None. Adding a cell, a configuration, a traffic mix or a
metric is a new file and a new entry: nothing here changes.
"""

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names that may not be loaded in a run: JAX and its
# libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "srf_tpu")


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    spec: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: str = ROOT
    # program faults to plant (benchmark/faults.py), for the tests only
    faults: List[str] = dataclasses.field(default_factory=list)
    started: float = 0.0

    @property
    def model(self):
        return self.config["model"]


def read_json(*parts):
    with open(os.path.join(*parts)) as src:
        return json.load(src)


def load_context(name, seed, seconds, trace, root=ROOT, **extra):
    """The context of cell ``name`` from ``root``'s ``BENCHMARK.json`` and
    the cell's files; raises KeyError for a cell it does not list."""
    spec = read_json(root, "BENCHMARK.json")
    cells = {cell["name"]: cell for cell in spec["workloads"]}
    if name not in cells:
        raise KeyError("no workload %r in BENCHMARK.json (%s)"
                       % (name, ", ".join(sorted(cells))))
    cell = cells[name]
    bench = os.path.join(root, "benchmark")
    return Context(
        cell=cell, spec=spec,
        config=read_json(bench, "configs", cell["config"] + ".json"),
        traffic=read_json(bench, "traffic", cell["traffic"] + ".json"),
        limits=read_json(bench, "limits", name + ".json"),
        seed=seed, seconds=seconds, trace=trace, root=root, **extra)


def generator(ctx):
    """The general generator module that runs the cell's traffic."""
    return importlib.import_module("benchmark.traffic."
                                   + ctx.traffic["generator"])


def end_to_end_names(ctx):
    """The end-to-end metrics the cell reports: those that list it, and
    those that list no cells."""
    name = ctx.cell["name"]
    return [m["name"] for m in ctx.spec["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer_metrics(ctx):
    """[(metric entry, reader module)] of the per-layer metrics that list
    the cell, or list no cells."""
    name, out = ctx.cell["name"], []
    for metric in ctx.spec["per_layer"]:
        if name not in metric.get("workloads", [name]):
            continue
        path = os.path.join(ctx.root, "benchmark", "metrics",
                            metric["name"] + ".py")
        mod_name = "benchmark_metric_" + metric["name"].replace(
            ".", "_").replace("-", "_")
        loader = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(loader)
        loader.loader.exec_module(module)
        out.append((metric, module))
    return out


def process_start():
    """The process's start on the ``time.time()`` clock, from the kernel's
    record of it (Linux), else the first time this module was asked."""
    try:
        with open("/proc/self/stat") as src:
            fields = src.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/stat") as src:
            boot = next(int(line.split()[1]) for line in src
                        if line.startswith("btime"))
        return boot + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def cache_dirs(root):
    """Every build and kernel cache of a run inside the checkout, at fixed
    paths, so that only a cell's first run there builds. The port builds
    its CUDA kernels into its own ``srf_tpu_torch/_build/``, also inside
    the checkout."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_loaded():
    """The forbidden top-level names among the loaded modules, compared
    whole (``srf_tpu_torch`` is not ``srf_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_line(torch, count, memory_peak, busy_s=None, window_s=None):
    """The result's ``device`` object."""
    import subprocess

    line = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(memory_peak)}
    try:
        limits = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.split("\n")
        line["power_limit"] = limits[0].strip()
    except (OSError, subprocess.SubprocessError):
        line["power_limit"] = "not read"
    if busy_s is not None:
        line["busy_s"] = busy_s
        line["window_s"] = window_s
    return line


def finite(value):
    return value is not None and math.isfinite(value)


def percentile(values, q):
    """The ``q``-th percentile of ``values`` by linear interpolation
    between the two nearest ranks (numpy's default)."""
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100.0
    low, high = math.floor(pos), math.ceil(pos)
    return ordered[low] + (ordered[high] - ordered[low]) * (pos - low)


def end_setup(ctx):
    """Set-up's end: the seconds since the process started. What set-up
    made is moved out of the garbage collector's scans (``gc.freeze``), so
    that a collection inside the window does not walk the weights, inputs
    and modules set-up left, only what the window makes."""
    gc.collect()
    gc.freeze()
    return time.time() - ctx.started

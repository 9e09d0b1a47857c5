"""What every cell's run shares: finding the cell's files by name, the run
context, process start time, the device line, the forbidden-module guard
and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its ``config``
names ``benchmark/configs/<config>.json`` and its ``traffic`` names
``benchmark/traffic/<traffic>.json``, whose ``generator`` names the general
generator ``benchmark/traffic/<generator>.py`` that runs it. Its limits
are ``benchmark/limits/<cell>.json``. A per-layer metric is
``benchmark/metrics/<metric>.py``, whose ``read(record)`` returns the
metric's value or None. Adding a cell, a configuration, a traffic mix, a
metric or a model family is a new file and a new entry: nothing here
changes.

A configuration's ``"reference": "<family>"`` names its model family's
plain reference, ``benchmark/reference/<family>.py``, loaded by path from
the run's root (:func:`family`; ``Context.family``). The generators, the
weights, the FLOP counts, the calibration and the CPU tests reach
everything that belongs to the model through it. It gives, with ``cfg``
the configuration's ``model`` object:

- ``param_shapes(cfg)``: {name: (shape, kind)} of every weight and
  statistic, in the program's state-dict names; ``kind`` is how
  ``benchmark/weights.py`` draws it (``fan_in``, ``bias``, ``routing``,
  ``scale``, ``variance``, ``count``);
- ``trained_names(cfg)``: the names of the trained weights;
- ``subsample(cfg)``: input frames a logit frame (CTC's frame count and
  the pools' feasibility check);
- ``forward(p, feats, lengths, cfg, drop, training)``: CTC logits [B, T',
  class_n] of padded ``feats`` [B, T, feat_dim], blank last; ``drop`` is
  the update's ``common.Dropout`` in training (its generator's
  ``initial_seed()`` is ``common.dropout_seed`` of the run's seed and the
  update count);
- ``forward_flops(batch, frames, cfg)``, ``train_step_flops(batch,
  frames, cfg)``: model FLOPs, delegating to ``benchmark/counts/``;
- ``TINY``: {model key: size} of the CPU tests (``tests/tiny.py``);
- ``FLAGS``: {model key: the flag of the configuration's ``argv`` that
  states it}.

What every family shares is ``benchmark/reference/common.py``. A general
generator gives ``run(ctx)`` and ``TINY``, the sizes of its mix's keys in
the CPU tests.
"""

import dataclasses
import functools
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

    @functools.cached_property
    def family(self):
        """The reference module the configuration names."""
        return family(self.root, self.config)


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


def generator(traffic):
    """The general generator module that runs a traffic mix."""
    return importlib.import_module("benchmark.traffic."
                                   + traffic["generator"])


def _load(path, name):
    """The Python file at ``path`` as a module named ``name`` (its dots and
    dashes made underscores)."""
    loader = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module


def family(root, config):
    """The plain reference that ``config`` names,
    ``benchmark/reference/<reference>.py`` under ``root``; raises
    FileNotFoundError naming the path where there is none."""
    name = config["reference"]
    path = os.path.join(root, "benchmark", "reference", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            "configuration %r names the reference %r: no file %s"
            % (config.get("name"), name, path))
    return _load(path, "benchmark_reference_" + name)


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
        out.append((metric, _load(path, "benchmark_metric_"
                                  + metric["name"])))
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

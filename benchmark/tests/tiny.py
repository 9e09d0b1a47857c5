"""A tiny copy of the benchmark's data files for the CPU tests: the cells
of ``BENCHMARK.json`` run at a small width and short buckets, through the
same generators, metric readers and references.

``make_root(path)`` writes ``BENCHMARK.json``, ``benchmark/configs``,
``benchmark/traffic``, ``benchmark/limits``, ``benchmark/metrics`` and
``benchmark/reference`` under ``path``; the rest of the code stays the
repository's own package. Each configuration takes its sizes and their
flags from its family (``TINY``, ``FLAGS``), each traffic mix its sizes
from its generator (``TINY``).
"""

import copy
import json
import os
import shutil
import time

from benchmark import harness

VOCAB = ["<PADDING_MASK>", "<SPACE>", "A", "B", "C"]


def tiny_config(config, family):
    """``config`` at its ``family``'s tiny sizes and the tiny vocabulary's
    classes, its argv's model flags to match."""
    config = copy.deepcopy(config)
    config["model"].update(family.TINY, class_n=len(VOCAB) + 1)
    flags = {k: family.FLAGS[k] for k in family.TINY if k in family.FLAGS}
    argv = [a for a in config["argv"]
            if not any(a.startswith("--%s=" % f) for f in flags.values())
            and not a.startswith("--path-vocab=")]
    argv += ["--%s=%s" % (flags[k], v) for k, v in family.TINY.items()
             if k in flags]
    config["argv"] = argv + ["--path-vocab=tiny.vocab"]
    return config


def make_root(path, limits=None):
    """A tiny checkout's data under ``path``; ``limits`` ({cell: {name:
    limit}}) replaces the cells' limits (default: the repository's)."""
    src = harness.ROOT
    spec = harness.read_json(src, "BENCHMARK.json")
    bench = os.path.join(path, "benchmark")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    for sub in ("metrics", "reference"):
        shutil.copytree(os.path.join(src, "benchmark", sub),
                        os.path.join(bench, sub), dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(path, "tiny.vocab"), "w") as out:
        out.write("\n".join(VOCAB) + "\n")
    for config in spec["configs"]:
        data = harness.read_json(src, config["file"])
        write(os.path.join(path, config["file"]),
              tiny_config(data, harness.family(path, data)))
    for cell in spec["workloads"]:
        traffic = harness.read_json(src, "benchmark", "traffic",
                                    cell["traffic"] + ".json")
        traffic.update(harness.generator(traffic).TINY)
        write(os.path.join(bench, "traffic", cell["traffic"] + ".json"),
              traffic)
        cell_limits = harness.read_json(src, "benchmark", "limits",
                                        cell["name"] + ".json")
        for name, limit in ((limits or {}).get(cell["name"], {})).items():
            cell_limits[name]["limit"] = limit
        write(os.path.join(bench, "limits", cell["name"] + ".json"),
              cell_limits)
    write(os.path.join(path, "BENCHMARK.json"), spec)
    return spec


def write(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as out:
        json.dump(data, out, indent=1)


def context(root, cell, seed=11, seconds=0.5, trace=False, faults=()):
    """A CPU run context of ``cell`` in the tiny checkout at ``root``."""
    return harness.load_context(cell, seed, seconds, trace, root=root,
                                device="cpu", faults=list(faults),
                                started=time.time())

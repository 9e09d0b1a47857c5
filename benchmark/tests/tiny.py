"""A tiny copy of the benchmark's data files for the CPU tests: the cells
of ``BENCHMARK.json`` run at a small width and short buckets, through the
same generators, metric readers and reference.

``make_root(path)`` writes ``BENCHMARK.json``, ``benchmark/configs``,
``benchmark/traffic``, ``benchmark/limits`` and ``benchmark/metrics``
under ``path``; the code stays the repository's own package.
"""

import copy
import json
import os
import shutil
import time

from benchmark import harness

TINY_MODEL = {"feat_dim": 8, "class_n": 6, "enc_num": 3,
              "caps_primary_num": 4, "caps_primary_dim": 4,
              "caps_conv_num": 4, "caps_conv_dim": 4, "caps_class_dim": 4,
              "conv_filter_num": 4}
FLAG = {"feat_dim": "feat-dim", "enc_num": "model-encoder-num",
        "caps_primary_num": "model-caps-primary-num",
        "caps_primary_dim": "model-caps-primary-dim",
        "caps_conv_num": "model-caps-convolution-num",
        "caps_conv_dim": "model-caps-convolution-dim",
        "caps_class_dim": "model-caps-class-dim",
        "conv_filter_num": "model-conv-filter-num"}
TINY_TRAFFIC = {
    "train_buckets": {"buckets": [[3, 41, 24, 41], [2, 61, 42, 61]],
                      "pool": 2, "trace_seconds": 0.2},
    "serve_open": {"rate": 40.0, "frames": [30, 90], "max_batch": 4,
                   "warm_widths": [128], "sample": 4, "trace_seconds": 0.2},
}
VOCAB = ["<PADDING_MASK>", "<SPACE>", "A", "B", "C"]


def tiny_config(config):
    """``config`` at the tiny width, its argv's model flags to match."""
    config = copy.deepcopy(config)
    config["model"].update(TINY_MODEL)
    argv = [a for a in config["argv"]
            if not any(a.startswith("--%s=" % f) for f in FLAG.values())
            and not a.startswith("--path-vocab=")]
    argv += ["--%s=%s" % (FLAG[k], v) for k, v in TINY_MODEL.items()
             if k in FLAG]
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
    shutil.copytree(os.path.join(src, "benchmark", "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True)
    with open(os.path.join(path, "tiny.vocab"), "w") as out:
        out.write("\n".join(VOCAB) + "\n")
    for config in spec["configs"]:
        data = harness.read_json(src, config["file"])
        write(os.path.join(path, config["file"]), tiny_config(data))
    for cell in spec["workloads"]:
        traffic = harness.read_json(src, "benchmark", "traffic",
                                    cell["traffic"] + ".json")
        traffic.update(TINY_TRAFFIC[traffic["generator"]])
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

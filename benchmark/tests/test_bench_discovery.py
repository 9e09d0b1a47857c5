"""A cell, a configuration, a traffic mix and a per-layer metric added as
files and entries alone, in a copy of the benchmark's data, run with the
harness unchanged."""

import json
import os
import shutil

from benchmark import harness, run
from benchmark.tests import tiny


def test_added_cell_config_and_metric_run(tmp_path):
    root = str(tmp_path)
    spec = tiny.make_root(root)
    bench = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(bench, "configs", "srf_timit.json"),
                os.path.join(bench, "configs", "srf_timit_copy.json"))
    traffic = harness.read_json(bench, "traffic", "timit_buckets.json")
    traffic["buckets"] = traffic["buckets"][:1]
    tiny.write(os.path.join(bench, "traffic", "timit_one_bucket.json"),
               traffic)
    shutil.copy(os.path.join(bench, "limits", "srf_timit.train.json"),
                os.path.join(bench, "limits", "srf_timit_copy.one.json"))
    with open(os.path.join(bench, "metrics", "steps_seen.train.py"),
              "w") as out:
        out.write('def read(record):\n    return float(record["steps"])\n')
    spec["configs"].append(dict(spec["configs"][1], name="srf_timit_copy",
                                file="benchmark/configs/srf_timit_copy.json"))
    spec["workloads"].append({"name": "srf_timit_copy.one",
                              "config": "srf_timit_copy",
                              "traffic": "timit_one_bucket", "chips": 1,
                              "why": "a copy"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "train_frames_per_s.timit":
            metric["workloads"].append("srf_timit_copy.one")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves":
                              "train_frames_per_s.timit",
                              "workloads": ["srf_timit_copy.one"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as out:
        json.dump(spec, out)
    line, _ = run.run(tiny.context(root, "srf_timit_copy.one", trace=True))
    assert line["correct"]
    assert line["metrics"]["steps_seen.train"]["value"] >= 1
    assert "step_mfu.train_timit" not in line["metrics"]

"""A cell, a configuration, a traffic mix, a per-layer metric and a model
family added as files and entries alone, in a copy of the benchmark's
data, run with the harness unchanged."""

import json
import os
import shutil

import pytest

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


def test_family_added_as_files_run(tmp_path):
    """A copy of the SRF reference under another name, named by a copied
    configuration, runs a training and a serving cell correct: the
    generators, the weights and the checks reach the model through the
    file the configuration names."""
    root = str(tmp_path)
    spec = tiny.make_root(root)
    bench = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(bench, "reference", "srf.py"),
                os.path.join(bench, "reference", "capsules.py"))
    config = harness.read_json(bench, "configs", "srf_wsj.json")
    config.update(name="caps_wsj", reference="capsules")
    tiny.write(os.path.join(bench, "configs", "caps_wsj.json"), config)
    spec["configs"].append(dict(spec["configs"][0], name="caps_wsj",
                                file="benchmark/configs/caps_wsj.json"))
    traffic = harness.read_json(bench, "traffic", "wsj_buckets.json")
    traffic["buckets"] = traffic["buckets"][:1]
    tiny.write(os.path.join(bench, "traffic", "caps_buckets.json"), traffic)
    cells = {"caps_wsj.train": ("caps_buckets", "srf_wsj.train"),
             "caps_wsj.serve": ("wsj_open_loop", "srf_wsj.serve")}
    for name, (mix, like) in cells.items():
        shutil.copy(os.path.join(bench, "limits", like + ".json"),
                    os.path.join(bench, "limits", name + ".json"))
        spec["workloads"].append({"name": name, "config": "caps_wsj",
                                  "traffic": mix, "chips": 1,
                                  "why": "another family"})
        for metric in spec["end_to_end"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(name)
    tiny.write(os.path.join(root, "BENCHMARK.json"), spec)
    for name in cells:
        ctx = tiny.context(root, name)
        assert ctx.family.__file__ == os.path.join(bench, "reference",
                                                   "capsules.py")
        line, checks = run.run(ctx)
        assert line["correct"], checks


def test_missing_reference_names_its_path(tmp_path):
    root = str(tmp_path)
    tiny.make_root(root)
    path = os.path.join(root, "benchmark", "configs", "srf_timit.json")
    config = harness.read_json(path)
    config["reference"] = "nowhere"
    tiny.write(path, config)
    with pytest.raises(FileNotFoundError) as error:
        run.run(tiny.context(root, "srf_timit.train"))
    assert os.path.join(root, "benchmark", "reference",
                        "nowhere.py") in str(error.value)

"""``BENCHMARK.json`` keeps to the benchmark's contract, and every file the
harness finds by name is there."""

import json
import os
import re

import pytest

from benchmark import harness, training

SPEC = harness.read_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    cells = len(SPEC["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a
    # cell to compile, 1200 s spare, for 24 cells, within 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert sum(c["chips"] == 4 for c in SPEC["workloads"]) <= max(
        1, cells // 4)


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [entry["name"] for entry in SPEC[section]]
    assert len(set(names)) == len(names)
    for entry in SPEC[section]:
        assert set(entry) <= KEYS[section]
        assert NAME.match(entry["name"])
        for key in ("why", "layer", "source"):
            if key in entry and section != "end_to_end" and (
                    section != "per_layer" or key != "source"):
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
        if "unit" in entry:
            assert UNIT.match(entry["unit"])
            assert entry["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert 0.01 <= entry["bound"] <= 0.25
            assert entry["source"] in ("host_clock", "device_trace")
        if section == "per_layer":
            assert entry["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
            if entry["name"].endswith("_roofline") or "_roofline." in \
                    entry["name"]:
                assert entry["unit"] == "%"


def test_cells_report_what_the_contract_asks():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for cell in SPEC["workloads"]:
        name = cell["name"]
        reported = [m for m in SPEC["end_to_end"]
                    if name in m.get("workloads", [name])]
        assert len(reported) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if name in m.get("workloads", [name])]
        assert layer
        for metric in layer:
            moves = e2e[metric["moves"]]
            assert name in moves.get("workloads", [name])


def test_files_found_by_name():
    bench = harness.BENCH_DIR
    for config in SPEC["configs"]:
        assert config["file"] == "benchmark/configs/%s.json" % config["name"]
        data = harness.read_json(harness.ROOT, config["file"])
        assert data["reduced"] == config["reduced"]
        assert data["source"] == config["source"]
        assert os.path.isfile(os.path.join(bench, "reference",
                                           data["reference"] + ".py"))
    for cell in SPEC["workloads"]:
        traffic = harness.read_json(bench, "traffic",
                                    cell["traffic"] + ".json")
        assert os.path.exists(os.path.join(bench, "traffic",
                                           traffic["generator"] + ".py"))
        limits = harness.read_json(bench, "limits", cell["name"] + ".json")
        for reading in limits.values():
            assert reading["lower"] < reading["limit"] < reading["upper"]
    for metric in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics",
                                           metric["name"] + ".py"))


# the optimizer's keys and their flags, shared by every family
OPTIMIZER_FLAGS = {"beta1": "train-adam-beta1", "beta2": "train-adam-beta2",
                   "eps": "train-adam-epsilon", "noam_k": "train-lr-param-k",
                   "d_model": "model-dimension", "warmup": "train-warmup-n",
                   "lr_max": "train-lr-max"}


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_argv_states_its_sizes(config):
    data = harness.read_json(harness.BENCH_DIR, "configs", config + ".json")
    ctx = harness.Context(cell={}, config=data, traffic={}, limits={},
                          spec={}, seed=0, seconds=1.0, trace=False)
    args = training.parse_config(ctx, "cpu")
    for section, flags in (("model", ctx.family.FLAGS),
                           ("optimizer", OPTIMIZER_FLAGS)):
        for key, flag in flags.items():
            assert getattr(args, flag.replace("-", "_")) == \
                data[section][key], (section, key, flag)

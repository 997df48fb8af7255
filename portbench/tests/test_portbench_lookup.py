"""The harness finds every cell, configuration, traffic kind and metric by
name, BENCHMARK.json agrees with the files, and a cell added as files only
runs through the harness's lookup."""

from __future__ import annotations

import json
import math
import os

import pytest
import torch

from portbench import harness, run
from portbench.tests import tiny

REPO = os.path.dirname(harness.ROOT)
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", harness.cell_names())
def test_every_cell_loads_with_its_configuration_mix_and_kind(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert cell.config["precision"] == {"dtype": "float32", "tf32": False}
    kind = cell.kind
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(kind, fn))
    assert set(cell.spec["end_to_end"]) == set(kind.END_TO_END) | {"setup_s"}
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_every_metric_reader_declares_its_layer_unit_source_and_target():
    # a reader's target is an end-to-end metric of some cell's file, also
    # of a cell that BENCHMARK.json does not run yet
    e2e = {m for name in harness.cell_names()
           for m in harness.load_cell(name).spec["end_to_end"]}
    readers = harness.metric_readers()
    assert readers
    for name, r in readers.items():
        assert r.SOURCE in SOURCES, name
        assert r.MOVES in e2e, name
        assert r.LAYER and "\n" not in r.LAYER
        assert callable(r.read)


def test_benchmark_json_names_the_files_that_exist():
    b = bench()
    assert b["paths"] == ["portbench"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert set(cells) <= set(harness.cell_names())
    for name, w in cells.items():
        cell = harness.load_cell(name)
        assert w["config"] == cell.spec["config"]
        assert w["traffic"] == cell.spec["traffic"]
        assert w["chips"] == cell.chips
        assert w["why"] == cell.spec["why"]
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    readers = harness.metric_readers()
    for m in b["per_layer"]:
        r = readers[m["name"]]
        assert (m["unit"], m["source"], m["layer"], m["moves"]) == (
            r.UNIT, r.SOURCE, r.LAYER, r.MOVES)
        for w in m["workloads"]:
            assert m["moves"] in harness.load_cell(w).spec["end_to_end"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        for w in m.get("workloads", cells):
            assert m["name"] in harness.load_cell(w).spec["end_to_end"]


def test_a_cell_added_as_files_only_runs_through_the_lookup(tmp_path):
    root = str(tmp_path)
    name = tiny.write(root, "cvae-offline-64x240", name="added-cell")
    assert harness.cell_names(root) == ["added-cell"]
    cell = harness.load_cell(name, root)
    result = run.run_cell(cell, 2 ** 31 + 17, 0.2, False,
                          torch.device("cpu"))
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in result["metrics"].values())
    assert list(result)[-1] == "checks"

"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the run length, and every cell's files found by name."""
import json
import os

import pytest

from harness import manifest
from harness.manifest import NAME_RE, UNIT_RE

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert len(json.dumps(M).encode()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME_RE.match(c["name"]) and _text_ok(c["why"])
        assert _text_ok(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME_RE.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME_RE.match(w["name"]) and NAME_RE.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert _text_ok(w["why"])
    for m in M["end_to_end"] + M["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in M["end_to_end"] else {"layer",
                                                          "moves"}
        assert set(m) <= allowed and NAME_RE.match(m["name"])
        assert UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    every = [m["name"] for m in M["end_to_end"] + M["per_layer"]] \
        + CELLS + names
    assert len(every) == len(set(every))


def test_bounds_and_run_length():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in M["end_to_end"])
    r = M["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells fits the check's time
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in M["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m for m in M["per_layer"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert _text_ok(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve_by_name(cell):
    files = manifest.cell_files(M, cell)
    assert all(files.values()), files
    c = manifest.cell(M, cell)
    for m in c["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
        if m["name"].split(".")[0].endswith("roofline"):
            assert manifest.kernel_patterns(m["name"])
    conf = next(x for x in M["configs"] if x["name"] == c["config"])
    assert set(conf["reduced"]) <= set(c["cfg"]), conf["reduced"]
    assert conf["source"] == c["cfg"]["source"]


def test_config_files_are_under_paths_and_distinct():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("benchmark/") and os.path.isfile(
            os.path.join(manifest.ROOT, f))

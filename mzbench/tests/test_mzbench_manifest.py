"""BENCHMARK.json keeps to the benchmark's contract, and every piece of a
cell is found by name in a file of its own."""

import json
import os
import re

import pytest

from mzbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = {w["name"] for w in BENCH["workloads"]}


def line_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_run_seconds_fit_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_no_name_shared_between_kinds():
    names = [e["name"] for k in ("end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith("mzbench/") and c["file"] not in files
        files.add(c["file"])
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_end_to_end_metrics():
    assert 1 <= len(E2E) <= 16 and "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= CELLS
    for cell in CELLS:
        got = {m["name"] for m in harness.metrics_of(cell, "end_to_end",
                                                     BENCH)}
        assert "setup_s" in got and len(got) >= 2


def test_per_layer_metrics():
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in E2E
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in {e["name"] for e in harness.metrics_of(
                cell, "end_to_end", BENCH)}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        assert harness.metrics_of(cell, "per_layer", BENCH)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_found_by_name(cell):
    files = harness.cell_files(cell, BENCH)
    mix = files["mix"]
    here = harness.HERE
    assert os.path.exists(os.path.join(here, "traffic", mix["kind"] + ".py"))
    assert os.path.exists(os.path.join(here, "entries", mix["entry"] + ".py"))
    assert line_ok(mix["why"])
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(cell, kind, BENCH):
            assert callable(harness.metric_reader(m["name"]))


def test_every_metric_file_is_named_in_the_manifest():
    names = {m["name"] for k in ("end_to_end", "per_layer")
             for m in BENCH[k]}
    files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics"))
             if f.endswith(".py")}
    assert files == names

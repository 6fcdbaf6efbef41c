"""BENCHMARK.json against the contract, and every file it names."""

import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == TOP
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)


def test_command_and_paths():
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for w in cmd:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])


def test_names_units_and_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert NAME.match(m["name"])
        names.append(m["name"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == \
        len(MAN["workloads"])
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)


def test_every_cell_reports_setup_a_rate_and_a_layer():
    for w in MAN["workloads"]:
        e2e, layer = harness.metrics_for(MAN, w)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        # each per-layer metric's `moves` is reported in the cell
        for m in layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(MAN["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"]
        for k in c["reduced"]:
            assert {"as_run", "deployment", "why_cut"} <= set(cfg[k])
        # the cuts as the configuration records them are the ones run
        for w in MAN["workloads"]:
            if w["config"] != c["name"]:
                continue
            tr = harness.load_json(harness.HERE, "traffic",
                                   w["traffic"] + ".json")
            assert cfg["yield_bp"]["as_run"]["n_reads"][w["traffic"]] == \
                tr["n_reads"]
            assert cfg["genome_bp"]["as_run"][w["traffic"]] == \
                tr["genome_bp"]
        for k in ("preset", "settings", "overlap", "reads", "assumed"):
            assert k in cfg


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files(cell):
    w = harness.cell_of(MAN, cell)
    tr = harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json")
    assert os.path.exists(os.path.join(harness.HERE, "entries",
                                       tr["entry"] + ".py"))
    assert any(m["name"] == tr["rate"] for m in MAN["end_to_end"])
    e2e, layer = harness.metrics_for(MAN, w)
    assert tr["rate"] in {m["name"] for m in e2e}
    for m in layer:
        assert os.path.exists(harness.module_path("metrics", m["name"]))
    for k in ("n_reads", "genome_bp", "warmup_reads", "check_rows",
              "limits"):
        assert k in tr
    if tr.get("control_share"):
        assert os.path.exists(os.path.join(harness.HERE,
                                           tr["control_fasta"]))


def test_check_fits_the_budget():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s to compile a
    # cell, 1200 s spare: within 43,200 s with the full 24 cells
    n = 24
    assert (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200


def test_manifest_is_json_text():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        json.load(f)

"""Each per-layer reader on recorded stats, and the rate arithmetic."""

import json
import os

import pytest

from benchmark import arith, harness, trace

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "fixtures", "stats.json")) as f:
    STATS = json.load(f)
MAN = harness.load_json(harness.ROOT, "BENCHMARK.json")


def _reading(kind, n_jobs=2, events=None, busy=None, window=None):
    rec = STATS[kind]
    jobs = [dict(rec) for _ in range(n_jobs)]
    return {"jobs": jobs, "bases": rec["bases"] * n_jobs,
            "events": events, "busy_s": busy, "window_s": window}


def test_per_gbp():
    assert arith.per_gbp(3.0, 1.5e9) == pytest.approx(2.0)


def test_stage_readers():
    r = _reading("sampleqc")
    st = STATS["sampleqc"]["stats"]["stage_s"]
    per = 2 / (r["bases"] / 1e9)
    assert harness.load_module("metrics", "pipeline.adapter_s").read(r) \
        == pytest.approx(st["adapter"] * per)
    assert harness.load_module("metrics", "pipeline.overlap_s").read(r) \
        == pytest.approx(st["overlap"] * per)


@pytest.mark.parametrize("kind", ["overlap", "sampleqc"])
def test_engine_readers(kind):
    r = _reading(kind)
    st = STATS[kind]["stats"]
    st = st.get("overlap", st)
    ph = st["phase_s"]
    per = 2 / (r["bases"] / 1e9)
    m = {n: harness.load_module("metrics", n).read(r) for n in
         ("overlap.step_s", "index.build_s", "index.pack_s",
          "overlap.host_fixed_share")}
    assert m["overlap.step_s"] == pytest.approx(
        (ph["count"] + ph["step"] + ph["pull"]) * per)
    assert m["index.build_s"] == pytest.approx(
        (ph["index"] + ph["part_wait"]) * per)
    assert m["index.pack_s"] == pytest.approx(st["index_s"]["pack"] * per)
    assert m["overlap.host_fixed_share"] == pytest.approx(
        100.0 * st["host_fixed_rows"] / STATS[kind]["queries"])


def test_trace_readers():
    ev = {"dev": [("lq_chain_fill_kernel", 0, 2_000_000),
                  ("lq_sketch", 1_000_000, 3_000_000),
                  ("lq_chain_fill_kernel", 5_000_000, 6_000_000)],
          "cpu": [("job", 0, 10_000_000), ("aten::item", 3_000_000,
                                            4_500_000)]}
    r = _reading("overlap", events=ev, busy=0.004, window=0.010)
    assert harness.load_module("metrics", "kernel.b2_s").read(r) == \
        pytest.approx(0.003 / (r["bases"] / 1e9))
    assert harness.load_module("metrics", "device.idle.overlap").read(r) \
        == pytest.approx(60.0)
    assert trace.busy_union_s([(s, e) for _n, s, e in ev["dev"]]) == \
        pytest.approx(0.004)
    gaps = trace.idle_gaps(ev, 0, 10_000_000)
    assert gaps[0] == ("job", pytest.approx(0.004))
    assert gaps[1] == ("aten::item", pytest.approx(0.002))
    assert trace.top_device_ops(ev)[0] == ("lq_chain_fill_kernel",
                                           pytest.approx(0.003))


def test_readers_give_nothing_without_their_source():
    r = _reading("overlap")
    assert harness.load_module("metrics", "kernel.b2_s").read(r) is None
    assert harness.load_module("metrics", "device.idle.overlap").read(r) \
        is None
    r = _reading("overlap", events={"dev": [], "cpu": []})
    assert harness.load_module("metrics", "kernel.b2_s").read(r) is None


def test_every_manifest_metric_has_a_reader():
    for m in MAN["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("name", ["device.idle.sampleqc",
                                  "device.idle.overlap"])
def test_split_metric_is_read_by_its_one_reader(name):
    assert harness.module_path("metrics", name) == os.path.join(
        harness.HERE, "metrics", "device.idle.py")
    r = _reading("sampleqc", busy=0.25, window=1.0)
    assert harness.load_module("metrics", name).read(r) == \
        pytest.approx(75.0)

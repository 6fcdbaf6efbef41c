"""The span readers (benchmark/spans.py and the seven metrics that read
the program's spans) on hand-built readings: jobs with `spans` and
`span_log`, device events with known gaps."""

import json
import os

import pytest

from benchmark import harness, spans, trace
from benchmark.arith import per_gbp

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "fixtures", "spans.json")) as f:
    FX = json.load(f)
with open(os.path.join(HERE, "fixtures", "stats.json")) as f:
    BARE = json.load(f)
MS = 1_000_000
READERS = ("pipeline.traceback_s", "pipeline.traceback_offcpu",
           "pipeline.mask_offcpu", "overlap.step_host_idle_s",
           "index.wait_on_pack_s", "spike_in.hpc_s", "spike_in.step_s")


def _read(name, reading):
    return harness.load_module("metrics", name).read(reading)


def _events(shift=0):
    """The fixture's device events and the profiler's `lq.*` ranges of
    the overlap job's main-thread spans, on a clock `shift` ns ahead of
    the spans'."""
    dev = [(n, s * MS + shift, e * MS + shift) for n, s, e in FX["device"]]
    cpu = [("lq." + e["name"], e["t0"] + shift, e["t1"] + shift)
           for e in FX["overlap"]["stats"]["span_log"]
           if e["role"] == "main"]
    return {"dev": dev, "cpu": cpu + [("aten::zeros", shift, shift + MS)]}


def _reading(kind, events=None, n_jobs=1):
    rec = FX[kind]
    return {"jobs": [dict(rec) for _ in range(n_jobs)],
            "bases": rec["bases"] * n_jobs, "events": events}


@pytest.mark.parametrize("name,want", [
    ("pipeline.traceback_s", per_gbp(4.0, 120e6)),
    ("pipeline.traceback_offcpu", 75.0),
    ("pipeline.mask_offcpu", 40.0),
    ("spike_in.hpc_s", per_gbp(0.5, 120e6)),
    # count + launch (its halves and host tables inside) + pull +
    # unpack + commit
    ("spike_in.step_s", per_gbp(0.1 + 0.4 + 0.2 + 0.01 + 0.02, 120e6))])
def test_sampleqc_span_readers(name, want):
    assert _read(name, _reading("sampleqc", n_jobs=2)) == \
        pytest.approx(want)


@pytest.mark.parametrize("shift", [0, 7 * MS, -3 * MS])
def test_interval_readers(shift):
    r = _reading("overlap", events=_events(shift))
    assert spans.clock_shift_ns(r["jobs"], r["events"]) == shift
    assert _read("overlap.step_host_idle_s", r) == pytest.approx(
        per_gbp(FX["expect"]["idle_in_host_steps_s"], r["bases"]))
    assert _read("index.wait_on_pack_s", r) == pytest.approx(
        per_gbp(FX["expect"]["wait_on_pack_s"], r["bases"]))


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_spans(name):
    # the parent commit's stats: no spans, no span_log
    for kind in ("sampleqc", "overlap"):
        rec = BARE[kind]
        r = {"jobs": [dict(rec)], "bases": rec["bases"],
             "events": _events()}
        assert _read(name, r) is None
        r["events"] = None
        assert _read(name, r) is None


def test_idle_intervals_are_the_busy_unions_complement():
    ev = _events()
    lo, hi = 0, 4000 * MS
    idle = spans.idle_intervals(ev, lo, hi)
    assert idle == [(150 * MS, 1050 * MS), (1250 * MS, 3100 * MS),
                    (3200 * MS, 4000 * MS)]
    busy = trace.busy_union_s([(s, e) for _n, s, e in ev["dev"]])
    assert spans.length_s(idle) == pytest.approx((hi - lo) / 1e9 - busy)
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == \
        [(5, 10), (20, 25), (28, 30)]
    assert spans.union([(3, 4), (0, 2), (1, 3), (5, 5)]) == [(0, 4)]
    assert spans.span_sum([{"stats": {}}], ("x",)) is None


def test_manifest_names_the_span_metrics_and_their_cells():
    man = harness.load_json(harness.ROOT, "BENCHMARK.json")
    by = {m["name"]: m for m in man["per_layer"]}
    for name in READERS:
        assert harness.module_path("metrics", name).endswith(name + ".py")
        assert by[name]["source"] == "program_span"
    assert by["spike_in.hpc_s"]["workloads"] == ["pb-hifi.sampleqc"]
    cell = harness.cell_of(man, "pb-hifi.sampleqc")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("pb-hifi", "sampleqc_8k_6mb_control1", 1)

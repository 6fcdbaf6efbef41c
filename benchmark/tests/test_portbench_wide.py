"""The ont-ultralong.overlap cell's pieces: the two readers of the wide
rungs' span and counters on hand-built stats (and on the parent
commit's, which have neither), the overlap_long entry stopping at once
on a port without ROW_ANCHORS_MAX, and the cell's place in the
manifest."""

import json
import os

import pytest

from benchmark import harness
from benchmark.arith import per_gbp

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "fixtures", "stats.json")) as f:
    BARE = json.load(f)
with open(os.path.join(HERE, "fixtures", "spans.json")) as f:
    FX = json.load(f)
MAN = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELL = "ont-ultralong.overlap"
READERS = ("overlap.wide_step_s", "overlap.wide_pad_share")


def _job(wall_s, slots, anchors, bases=120_000_000):
    """An overlap job's stats with `step.wide` spans and counters."""
    return {"bases": bases, "queries": 800, "stats": {"spans": {
        "by_name": {"overlap": {"n": 1, "wall_s": 30.0, "self_s": 1.0,
                                "cpu_s": 20.0},
                    "step.wide": {"n": 9, "wall_s": wall_s,
                                  "self_s": wall_s, "cpu_s": 1.0}},
        "counters": {"step.wide_rows": 500, "step.wide_slots": slots,
                     "step.wide_anchors": anchors}}}}


def _read(name, jobs):
    return harness.load_module("metrics", name).read(
        {"jobs": jobs, "bases": sum(j["bases"] for j in jobs),
         "events": None})


def test_wide_readers_on_hand_built_stats():
    jobs = [_job(6.0, 1 << 28, 3 << 26), _job(4.0, 1 << 28, 1 << 27)]
    assert _read("overlap.wide_step_s", jobs) == pytest.approx(
        per_gbp(10.0, 240e6))
    # 100 x (1 - (3/4 + 1/2) / 2)
    assert _read("overlap.wide_pad_share", jobs) == pytest.approx(37.5)
    assert _read("overlap.wide_pad_share", jobs[:1]) == pytest.approx(25.0)


@pytest.mark.parametrize("name", READERS)
def test_wide_readers_give_nothing_without_wide_steps(name):
    # the parent commit's stats (no spans), and spans with no wide step
    for rec in (BARE["overlap"], BARE["sampleqc"], FX["overlap"]):
        assert _read(name, [dict(rec), dict(rec)]) is None


def test_overlap_long_stops_on_a_port_without_row_anchors_max(
        monkeypatch):
    from longqc_tpu_torch.engine import device_overlap
    entry = harness.load_module("entries", "overlap_long")
    assert entry.row_anchors_max() == device_overlap.ROW_ANCHORS_MAX >= \
        entry.ROW_MIN
    monkeypatch.delattr(device_overlap, "ROW_ANCHORS_MAX")
    with pytest.raises(RuntimeError, match="ROW_ANCHORS_MAX") as e:
        entry.prepare({})
    assert "\n" not in str(e.value) and "none" in str(e.value)
    monkeypatch.setattr(device_overlap, "ROW_ANCHORS_MAX", 1 << 18,
                        raising=False)
    with pytest.raises(RuntimeError, match=str(1 << 18)):
        entry.prepare({})


def test_the_cell_in_the_manifest():
    cell = harness.cell_of(MAN, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("ont-ultralong", "overlap_800_ul_16mb", 1)
    tr = harness.load_json(harness.HERE, "traffic",
                           cell["traffic"] + ".json")
    assert tr["entry"] == "overlap_long" and tr["rate"] == "overlap_mbp_s"
    by = {m["name"]: m for m in MAN["end_to_end"] + MAN["per_layer"]}
    for name in ("overlap_mbp_s", "overlap.step_s",
                 "overlap.host_fixed_share", "kernel.b2_s",
                 "device.idle.overlap"):
        assert by[name]["workloads"][-1] == CELL
    for name in READERS:
        m = by[name]
        assert m["workloads"] == [CELL] and m["moves"] == "overlap_mbp_s"
        assert m["layer"] == "engine.device_overlap"
        assert harness.module_path("metrics", name).endswith(name + ".py")
    cfg = harness.load_json(harness.ROOT, "benchmark", "configs",
                            "ont-ultralong.json")
    ont = harness.load_json(harness.ROOT, "benchmark", "configs",
                            "ont-ligation.json")
    assert cfg["overlap"] == ont["overlap"] and cfg["preset"] == "ont-rapid"

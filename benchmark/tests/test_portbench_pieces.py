"""The kernel.b2_piece_share reader on hand-built counters, on stats
without them (the parent commit's, and a job without B2 calls), and
the metric's place in the manifest."""

import json
import os

import pytest

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "fixtures", "stats.json")) as f:
    BARE = json.load(f)
with open(os.path.join(HERE, "fixtures", "spans.json")) as f:
    FX = json.load(f)
MAN = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = "kernel.b2_piece_share"


def _job(pieces, row_span, piece_span, bases=120_000_000):
    return {"bases": bases, "queries": 800, "stats": {"spans": {
        "by_name": {}, "counters": {"chain.pieces": pieces,
                                    "chain.row_span": row_span,
                                    "chain.piece_span": piece_span}}}}


def _read(jobs):
    return harness.load_module("metrics", NAME).read(
        {"jobs": jobs, "bases": sum(j["bases"] for j in jobs),
         "events": None})


def test_piece_share_on_hand_built_counters():
    jobs = [_job(90_000, 4_000_000, 60_000), _job(80_000, 1_000_000,
                                                  40_000)]
    assert _read(jobs) == pytest.approx(100.0 * 100_000 / 5_000_000)
    assert _read(jobs[1:]) == pytest.approx(4.0)
    # a job whose calls were never split: one piece a row
    assert _read([_job(128, 8192, 8192)]) == pytest.approx(100.0)


def test_piece_share_gives_nothing_without_the_counters():
    for rec in (BARE["overlap"], BARE["sampleqc"], FX["overlap"]):
        assert _read([dict(rec), dict(rec)]) is None
    assert _read([_job(0, 0, 0)]) is None


def test_piece_share_in_the_manifest():
    m = next(m for m in MAN["per_layer"] if m["name"] == NAME)
    overlap = [w["name"] for w in MAN["workloads"]
               if w["name"].endswith(".overlap")]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) \
        == ("%", "lower", "program_counter", "kernels", "overlap_mbp_s")
    assert sorted(m["workloads"]) == sorted(overlap)

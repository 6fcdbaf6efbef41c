"""`runqc` in the port against the JAX package's on the same run folders
(the synthetic artefacts of tests/test_platform.py, whose BAM writer it
imports; an sts.xml added to the Sequel run): the QC JSON equal, the
gamma fit's parameters within rel 1e-12 (the same scipy call), the rest
exactly, keys in the same order; construct_polread and
aggregate_occupancy equal to the JAX functions on 200 seeded random
inputs each; --no-report writes the JSON alone, and without matplotlib
a run that must draw refuses to start."""

import json
import os
import shutil
import sys
import tarfile

import numpy as np
import pytest
import torch_util  # noqa: F401

from longqc_tpu.platform import nanopore as jax_nanopore
from longqc_tpu.platform import rs as jax_rs
from longqc_tpu.platform import sequel as jax_sequel
from longqc_tpu_torch.cli import main
from longqc_tpu_torch.platform import nanopore, sequel
from test_platform import _bam_record, _tag_A, _tag_Bf, write_bam

PIPE_NS = "http://pacificbiosciences.com/PacBioPipelineStats.xsd"
SEQUEL_NS = "http://pacificbiosciences.com/PacBioBaseDataModel.xsd"
RS_NS = "http://pacificbiosciences.com/PipelineStats/PipeStats.xsd"
FIGS = {"rs2": 2, "sequel": 2, "minion": 1, "gridion": 1}
JSON_NAME = {"rs2": "QC_vals_rs.json", "sequel": "QC_vals_sequel.json",
             "minion": "QC_vals_minion.json",
             "gridion": "QC_vals_gridion.json"}


def make_rs_run(d):
    """300 ZMWs in sts.csv (as tests/test_platform.py), and an sts.xml."""
    rng = np.random.RandomState(1)
    n = 300
    hq_start = rng.randint(0, 100, n)
    hq_len = rng.randint(500, 20000, n)
    with open(os.path.join(d, "x.sts.csv"), "w") as f:
        f.write("ReadScore,HQRegionStart,HQRegionEnd,NumBases\n")
        for i in range(n):
            f.write("%.3f,%d,%d,%d\n" % (
                rng.uniform(0.05, 0.9), hq_start[i],
                hq_start[i] + hq_len[i], hq_start[i] + hq_len[i] + 50))
    with open(os.path.join(d, "x.sts.xml"), "w") as f:
        f.write('<?xml version="1.0"?>\n<Report xmlns="%s">'
                "<ProdDist><BinCount>10</BinCount><BinCount>80</BinCount>"
                "<BinCount>10</BinCount>"
                "<BinLabel>Empty</BinLabel><BinLabel>Productive</BinLabel>"
                "<BinLabel>Other</BinLabel></ProdDist></Report>" % RS_NS)


def make_sequel_run(d):
    """30 ZMWs of two subreads around an adapter, low-quality tails on
    some, one control scrap (as tests/test_platform.py), an sts.xml."""
    rng = np.random.RandomState(0)
    scraps, subs = [], []
    for zmw in range(30):
        ln = int(rng.randint(800, 3000))
        cut = ln // 2
        subs.append(_bam_record("m/%d/0_%d" % (zmw, cut), "ACGT" * 3,
                                _tag_Bf("sn", [5.0, 6.0, 7.0, 8.0])))
        subs.append(_bam_record("m/%d/%d_%d" % (zmw, cut + 20, ln),
                                "ACGT" * 3))
        scraps.append(_bam_record("m/%d/%d_%d" % (zmw, cut, cut + 20),
                                  "ACGT" * 3,
                                  _tag_A("sz", "N") + _tag_A("sc", "A")))
        if zmw % 3 == 0:
            scraps.append(_bam_record(
                "m/%d/%d_%d" % (zmw, ln, ln + 300), "ACGT",
                _tag_A("sz", "N") + _tag_A("sc", "L")))
    scraps.append(_bam_record("m/999/0_500", "ACGT" * 3,
                              _tag_A("sz", "C") + _tag_A("sc", "F")))
    write_bam(os.path.join(d, "x.subreads.bam"),
              "@RG\tID:a\tDS:READTYPE=SUBREAD;Ipd:CodecV1\n", subs)
    write_bam(os.path.join(d, "x.scraps.bam"),
              "@RG\tID:a\tDS:READTYPE=SCRAP;Ipd:CodecV1\n", scraps)
    with open(os.path.join(d, "x.sts.xml"), "w") as f:
        f.write('<?xml version="1.0"?>\n<PipeStats xmlns="%s" '
                'xmlns:b="%s"><ProdDist><b:BinCounts><b:BinCount>7'
                "</b:BinCount><b:BinCount>21</b:BinCount><b:BinCount>2"
                "</b:BinCount></b:BinCounts><b:BinLabels><b:BinLabel>Empty"
                "</b:BinLabel><b:BinLabel>Productive</b:BinLabel>"
                "<b:BinLabel>Other</b:BinLabel></b:BinLabels></ProdDist>"
                "</PipeStats>" % (PIPE_NS, SEQUEL_NS))


def make_nanopore_run(d):
    """40 single-read fast5 files (as tests/test_platform.py)."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(2)
    rate = 4000
    for i in range(40):
        with h5py.File(os.path.join(d, "read_%d.fast5" % i), "w") as f:
            g = f.create_group("/UniqueGlobalKey/channel_id")
            g.attrs["channel_number"] = str(int(rng.randint(1, 513)))
            g.attrs["sampling_rate"] = float(rate)
            ct = f.create_group("/UniqueGlobalKey/context_tags")
            ct.attrs["flowcell_type"] = np.bytes_("FLO-MIN106")
            ct.attrs["sequencing_kit"] = np.bytes_("SQK-LSK108")
            r = f.create_group("Raw/Reads/Read_%d" % i)
            r.attrs["start_time"] = int(rng.randint(0, 100)) * rate
            r.attrs["duration"] = int(rng.randint(5, 60)) * rate


MAKERS = {"rs2": make_rs_run, "sequel": make_sequel_run,
          "minion": make_nanopore_run, "gridion": make_nanopore_run}


def _run_dir(tmp_path, platform):
    d = tmp_path / ("run_" + platform)
    d.mkdir()
    MAKERS[platform](str(d))
    return str(d)


def _jax_run(platform, data, out):
    if platform == "rs2":
        return jax_rs.run_platformqc(data, out)
    if platform == "sequel":
        return jax_sequel.run_platformqc(data, out)
    return jax_nanopore.run_platformqc(platform, data, out)


def compare_runqc_json(got, want):
    """Same keys in the same order; the gamma parameters within rel
    1e-12, everything else equal."""
    assert list(got) == list(want)
    for key in want:
        if key == "polread_gamma_params":
            assert got[key] == pytest.approx(want[key], rel=1e-12)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("platform", ["rs2", "sequel", "minion", "gridion"])
def test_runqc_json_equals_jax(tmp_path, platform):
    data = _run_dir(tmp_path, platform)
    want = _jax_run(platform, data, str(tmp_path / "jax"))
    out = str(tmp_path / "port")
    assert main(["runqc", "-o", out, platform, data]) == 0
    with open(os.path.join(out, JSON_NAME[platform])) as f:
        got = json.load(f)
    with open(os.path.join(str(tmp_path / "jax"), JSON_NAME[platform])) as f:
        compare_runqc_json(got, json.load(f))
    compare_runqc_json(got, json.loads(json.dumps(want)))
    assert len(os.listdir(os.path.join(out, "fig"))) == FIGS[platform]
    if platform == "rs2":
        assert got["Productivity"] == {"P0": 10, "P1": 80, "P2": 10}
    if platform == "sequel":
        assert got["Productivity"] == {"P0": 7, "P1": 21, "P2": 2}
        assert got["Num_of_reads"] == 30
        assert got["Throughput(Control)"] == 501


def test_runqc_nanopore_targz_equals_jax(tmp_path):
    """Fast5 files packed in a tar.gz: extracted beside it, read, and
    removed again."""
    runs = {}
    for who in ("jax", "port"):
        d = tmp_path / ("tgz_" + who)
        (d / "run1").mkdir(parents=True)
        make_nanopore_run(str(d / "run1"))
        with tarfile.open(str(d / "run1.tar.gz"), "w:gz") as tar:
            tar.add(str(d / "run1"), arcname="run1")
        shutil.rmtree(str(d / "run1"))
        runs[who] = str(d)
    want = jax_nanopore.run_platformqc("minion", runs["jax"],
                                       str(tmp_path / "jax"))
    got = nanopore.run_platformqc("minion", runs["port"],
                                  str(tmp_path / "port"), report=False)
    compare_runqc_json(got, want)
    assert os.listdir(runs["port"]) == ["run1.tar.gz"]


def _random_fragments(rng):
    """One ZMW's fragments: touching or gapped, classes S / A / L, in a
    shuffled order."""
    frags, pos = [], 0
    for _ in range(rng.randint(1, 9)):
        pos += int(rng.choice([0, 0, 1, rng.randint(2, 50)]))
        ln = int(rng.randint(1, 400))
        frags.append((pos, pos + ln, str(rng.choice(list("SSAL")))))
        pos += ln
    rng.shuffle(frags)
    return frags


def test_construct_polread_equals_jax():
    rng = np.random.RandomState(11)
    n_subread = 0
    for _ in range(200):
        frags = _random_fragments(rng)
        got = sequel.construct_polread(list(frags))
        assert got == jax_sequel.construct_polread(list(frags))
        n_subread += got[4]
    assert 0 < n_subread < 200


def test_aggregate_occupancy_equals_jax():
    rng = np.random.RandomState(12)
    for _ in range(200):
        n_channel = int(rng.randint(1, 24))
        bag = [set() for _ in range(n_channel)]
        for _ in range(rng.randint(0, 40)):
            s = int(rng.randint(0, 120))
            bag[rng.randint(n_channel)].add((s, s + int(rng.randint(0, 30))))
        got = nanopore.aggregate_occupancy(bag, n_channel)
        want = jax_nanopore.aggregate_occupancy(bag, n_channel)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("platform", ["rs2", "sequel", "minion"])
def test_no_report_and_missing_matplotlib(tmp_path, platform, monkeypatch):
    data = _run_dir(tmp_path, platform)
    out = str(tmp_path / "out")
    assert main(["runqc", "--no-report", "-o", out, platform, data]) == 0
    assert os.path.exists(os.path.join(out, JSON_NAME[platform]))
    assert not os.listdir(os.path.join(out, "fig"))
    # find_spec answers None for a module mapped to None
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out2 = str(tmp_path / "out2")
    with pytest.raises(ImportError, match="--no-report"):
        main(["runqc", "-o", out2, platform, data])
    assert not os.path.exists(out2)
    assert main(["runqc", "--no-report", "-o", out2, platform, data]) == 0

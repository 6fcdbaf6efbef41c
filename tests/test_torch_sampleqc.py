"""The port's sampleqc end to end against the JAX package's on the CPU.

Two inputs made from a seed: an ont-ligation FASTQ (60 reads, the 5'
adapter planted on 25 of them, -n 40) and a pb-sequel FASTQ (50 reads,
6 of them from the Sequel control, so the spike-in filter run marks
them; -n 30). Each runs once through the JAX `run_sampleqc` and once
through the port (the ont case through `cli.main`, `--device cpu`),
shared by module fixtures. Held: the coverage TSV, the spike-in TSV,
the sdust table and the subsample FASTQ byte-identical; the QC JSON's
integers and strings equal, its floats equal except those of the
coverage fits (Coverage_stats), which are within rel=1e-9 (EM summation
order, tests/test_torch_distfit.py); 8 figures each; the HTML holding
the JSON's values."""

import filecmp
import json
import os

import pytest
from torch_util import (QC_JSON as JSON, SAMPLEQC_TABLES as TABLES,
                        compare_qc_json, ont_sampleqc_reads,
                        pb_sampleqc_reads)

from longqc_tpu.engine.pipeline import run_sampleqc as jax_sampleqc
from longqc_tpu_torch.cli import main
from longqc_tpu_torch.engine import pipeline
from util_synth import write_fastq_file


def _run_both(tmp, name, reads, preset, nsample, port_via_cli):
    fq = str(tmp / (name + ".fq"))
    write_fastq_file(fq, reads)
    jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
    jax_sampleqc(fq, jax_out, preset, nsample=nsample)
    stats = {}
    if port_via_cli:
        spath = str(tmp / "stats.json")
        rc = main(["sampleqc", "-x", preset, "-n", str(nsample), "-o",
                   port_out, "--device", "cpu", "--stats", spath, fq])
        assert rc == 0
        with open(spath) as f:
            stats = json.load(f)
    else:
        pipeline.run_sampleqc(fq, port_out, preset, nsample=nsample,
                              device="cpu", stats=stats)
    return {"reads": reads, "jax": jax_out, "port": port_out,
            "stats": stats}


@pytest.fixture(scope="module")
def ont(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("ont"), "ont",
                     ont_sampleqc_reads(), "ont-ligation", 40,
                     port_via_cli=True)


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("pb"), "pb", pb_sampleqc_reads(),
                     "pb-sequel", 30, port_via_cli=False)


@pytest.fixture(params=["ont", "pb"])
def case(request):
    return request.getfixturevalue(request.param)


@pytest.mark.parametrize("table", TABLES, ids=["coverage", "sdust",
                                               "subsample"])
def test_tables_byte_identical(case, table):
    assert filecmp.cmp(os.path.join(case["jax"], table),
                       os.path.join(case["port"], table), shallow=False)


def test_qc_json_agrees(case):
    with open(os.path.join(case["jax"], JSON)) as f:
        want = json.load(f)
    with open(os.path.join(case["port"], JSON)) as f:
        got = json.load(f)
    compare_qc_json(got, want)
    reads = case["reads"]
    assert got["Num_of_reads"] == len(reads)
    assert got["Yield"] == sum(len(r[1]) for r in reads)


def test_figures_and_html(case):
    figs = sorted(os.listdir(os.path.join(case["port"], "figs")))
    assert figs == sorted(os.listdir(os.path.join(case["jax"], "figs")))
    assert len(figs) == 8
    with open(os.path.join(case["port"], "web_summary.html")) as f:
        html = f.read()
    with open(os.path.join(case["port"], JSON)) as f:
        jd = json.load(f)
    assert str(jd["Yield"]) in html
    assert str(jd["Num_of_reads"]) in html
    assert "%.3f" % jd["Length_stats"]["N50_read_length"] in html
    assert "%.3f %%" % (100 * jd["GC_stats"]["Mean_GC_content"]) in html
    assert html.count("data:image/png;base64,") == 8


def test_ont_adapters_and_stage_stats(ont):
    with open(os.path.join(ont["port"], JSON)) as f:
        jd = json.load(f)
    assert jd["Stats_for_adapter5"]["Num_of_trimmed_reads_5"] >= 20
    st = ont["stats"]
    assert set(st["stage_s"]) >= {"chunk_loop", "mask", "mask_wait",
                                  "adapter", "exclusion",
                                  "overlap", "spike_in", "analytics",
                                  "report"}
    assert st["overlap"]["host_fixed_rows"] >= 0
    assert st["sdust"]["name"] == "native"
    assert st["reader"]["name"] == "native"


def test_pb_spike_in_table(pb):
    name = "analysis/minimap2/spiked_in_control.txt"
    assert filecmp.cmp(os.path.join(pb["jax"], name),
                       os.path.join(pb["port"], name), shallow=False)
    with open(os.path.join(pb["port"], name)) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()]
    marked = {r[0] for r in rows if float(r[5]) >= 0.5}
    with open(os.path.join(pb["port"], "analysis/subsample.fastq")) as f:
        sampled = {ln[1:].strip() for i, ln in enumerate(f) if i % 4 == 0}
    ctl = {n for n in sampled if n.startswith("control")}
    assert ctl and marked == ctl
    with open(os.path.join(pb["port"], JSON)) as f:
        cov = json.load(f)["Coverage_stats"]
    assert cov["Estimated spiked-in control read fraction"] > 0


def test_cli_refuses_what_is_not_ported(tmp_path):
    fq = str(tmp_path / "in.fq")
    write_fastq_file(fq, ont_sampleqc_reads()[:5])
    with pytest.raises(SystemExit, match="not yet ported"):
        main(["sampleqc", "-x", "ont-ligation", "-d", "-o",
              str(tmp_path / "o"), "--device", "cpu", fq])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pipeline.run_sampleqc(fq, str(tmp_path / "o2"), "ont-ligation",
                              db=True, device="cpu")
    with pytest.raises(SystemExit, match="not yet ported"):
        main(["runqc", "sequel", str(tmp_path)])
    assert not os.path.exists(str(tmp_path / "o"))


def test_json_only_and_missing_report_modules(tmp_path, monkeypatch):
    """--no-report stops after the QC JSON; without matplotlib the run
    refuses before it starts unless --no-report is given."""
    reads = ont_sampleqc_reads()[:30]
    fq = str(tmp_path / "in.fq")
    write_fastq_file(fq, reads)
    out = str(tmp_path / "o")
    assert main(["sampleqc", "-x", "ont-ligation", "-n", "20", "-o", out,
                 "--device", "cpu", "--no-report", fq]) == 0
    assert os.path.exists(os.path.join(out, JSON))
    assert not os.listdir(os.path.join(out, "figs"))
    assert not os.path.exists(os.path.join(out, "web_summary.html"))
    monkeypatch.setattr(pipeline, "REPORT_MODULES",
                        ("matplotlib", "no_such_module_x"))
    with pytest.raises(ImportError, match="no_such_module_x"):
        pipeline.run_sampleqc(fq, str(tmp_path / "o2"), "ont-ligation",
                              device="cpu")
    assert not os.path.exists(str(tmp_path / "o2"))


def test_sampleqc_defaults_to_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fq = str(tmp_path / "in.fq")
    write_fastq_file(fq, ont_sampleqc_reads()[:5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sampleqc", "-x", "ont-ligation", "-o", str(tmp_path / "o"),
              fq])


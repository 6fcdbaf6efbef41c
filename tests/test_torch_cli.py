"""`python -m longqc_tpu_torch mmcov` prints the same TSV as
`python -m longqc_tpu mmcov` (the port on CPU tensors, --device cpu),
in plain mode (with the pb-hifi fast preset's wide hashes too) and in the
HPC spike-in filter run, and the surfaces that are not ported yet say
so."""

import json

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu.cli import main as jax_main
from longqc_tpu_torch.cli import main
from util_synth import make_genome, sample_reads, write_fastq_file


def _dataset(tmp_path, seed=13, n=60, nq=16, err=0.12):
    rng = np.random.RandomState(seed)
    genome = make_genome(rng, 15000)
    reads = sample_reads(rng, genome, n, min_len=600, max_len=1600,
                         err=err, junk_frac=0.1)
    tf = str(tmp_path / "target.fq")
    qf = str(tmp_path / "query.fq")
    write_fastq_file(tf, reads)
    write_fastq_file(qf, reads[:nq])
    return tf, qf


@pytest.mark.parametrize("flags", [
    ["-k", "12", "-w", "5", "-p", "160", "-q", "160", "-l", "0"],
    ["-p", "80", "-c", "2", "--filter"],
], ids=["ont-ligation", "filter"])
def test_mmcov_output_matches_jax_package(tmp_path, capsys, flags):
    tf, qf = _dataset(tmp_path)
    assert jax_main(["mmcov"] + flags + [tf, qf]) == 0
    want = capsys.readouterr().out
    stats = str(tmp_path / "stats.json")
    assert main(["mmcov"] + flags + ["--device", "cpu", "--stats", stats,
                                     tf, qf]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 16
    with open(stats) as f:
        st = json.load(f)
    assert st["device_calls"] >= 1 and "step" in st["phase_s"]
    assert st["hash_range_parts"] == st["host_only_parts"] == 0
    assert set(st["index_s"]) == {"pack", "tiles", "merge"}


def test_mmcov_wide_hashes_match_jax_package(tmp_path, capsys):
    """The pb-hifi fast preset's sketch (-k 19 -w 10) on low-error
    reads: int64 hash lanes end to end."""
    tf, qf = _dataset(tmp_path, err=0.03)
    flags = ["-k", "19", "-w", "10", "-p", "80", "-q", "160", "-l", "0"]
    assert jax_main(["mmcov"] + flags + [tf, qf]) == 0
    want = capsys.readouterr().out
    stats = str(tmp_path / "stats.json")
    assert main(["mmcov"] + flags + ["--device", "cpu", "--stats", stats,
                                     tf, qf]) == 0
    got = capsys.readouterr().out
    assert got == want
    rows = got.splitlines()
    assert len(rows) == 16
    assert sum(r.split("\t")[3] != "0" for r in rows) >= 8
    with open(stats) as f:
        st = json.load(f)
    assert st["device_calls"] >= 1 and st["host_fixed_rows"] == 0


def test_mmcov_hpc_filter_matches_jax_package(tmp_path, capsys):
    """The spike-in control filter run (longQC.py:255): one small
    control genome as the target, reads of which a few come from it."""
    rng = np.random.RandomState(41)
    control = make_genome(rng, 6000)
    reads = sample_reads(rng, make_genome(rng, 15000), 14, min_len=600,
                         max_len=1400, err=0.12, junk_frac=0.1)
    reads += [["ctl%d" % i] + r[1:] for i, r in enumerate(sample_reads(
        rng, control, 6, min_len=600, max_len=1400, err=0.12))]
    tf = str(tmp_path / "control.fa")
    qf = str(tmp_path / "query.fq")
    with open(tf, "w") as f:
        f.write(">control\n%s\n" % control)
    write_fastq_file(qf, reads)
    flags = ["-H", "-k", "15", "-w", "10", "-c", "1", "-l", "0", "--filter"]
    assert jax_main(["mmcov"] + flags + [tf, qf]) == 0
    want = capsys.readouterr().out
    assert main(["mmcov"] + flags + ["--device", "cpu", tf, qf]) == 0
    got = capsys.readouterr().out
    assert got == want
    rows = got.splitlines()
    assert len(rows) == 20
    # the control-derived reads are the ones the filter marks
    assert sum(r.split("\t")[3] != "0" for r in rows[14:]) >= 4


def test_unported_surfaces(tmp_path):
    tf, qf = _dataset(tmp_path, n=20, nq=4)
    for argv in (["mmcov", "-z", "--device", "cpu", tf, qf],
                 ["sampleqc", "-d", "-x", "ont-ligation", "-o", "out",
                  "--device", "cpu", tf],
                 ["runqc", "minion", "dir"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert "not yet ported" in str(e.value.code)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):      # --device defaults to cuda
            main(["mmcov", tf, qf])

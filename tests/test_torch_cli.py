"""`python -m longqc_tpu_torch mmcov` prints the same TSV as
`python -m longqc_tpu mmcov` (the port on CPU tensors, --device cpu),
and the surfaces that are not ported yet say so."""

import json

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu.cli import main as jax_main
from longqc_tpu_torch.cli import main
from util_synth import make_genome, sample_reads, write_fastq_file


def _dataset(tmp_path, seed=13, n=60, nq=16):
    rng = np.random.RandomState(seed)
    genome = make_genome(rng, 15000)
    reads = sample_reads(rng, genome, n, min_len=600, max_len=1600,
                         err=0.12, junk_frac=0.1)
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


def test_unported_surfaces(tmp_path):
    tf, qf = _dataset(tmp_path, n=20, nq=4)
    with pytest.raises(NotImplementedError):
        main(["mmcov", "-H", "--device", "cpu", tf, qf])
    for argv in (["mmcov", "-z", "--device", "cpu", tf, qf],
                 ["sampleqc", "-x", "ont-ligation", "-o", "out", tf],
                 ["runqc", "minion", "dir"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert "not yet ported" in str(e.value.code)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):      # --device defaults to cuda
            main(["mmcov", tf, qf])

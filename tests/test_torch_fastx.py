"""The port's own FASTA/FASTQ reader (csrc/fastx_native.cpp, built by
io/native.py into build/fastx/): records identical to the pure-Python
lexer on FASTA and FASTQ, plain and gzip; nothing read, built or loaded
under the repository's native/ directory; a failed build is visible in
mmcov's --stats JSON."""

import gzip
import json
import os

import numpy as np
import pytest
import torch_util  # noqa: F401

from longqc_tpu_torch.cli import main
from longqc_tpu_torch.io import fastx, native
from util_synth import make_genome, sample_reads, write_fastq_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(rng, n):
    reads = sample_reads(rng, make_genome(rng, 8000), n, min_len=1,
                         max_len=2500, err=0.1, junk_frac=0.2)
    for i, r in enumerate(reads):
        if i % 5 == 2:
            r[1] = r[1][:7] + "N" * 40 + r[1][7:]
            r[2] = r[2][:7] + "!" * 40 + r[2][7:]
    return reads


def _write(path, reads, fmt, gz):
    if fmt == "fastq":
        body = "".join("@%s extra words\n%s\n+\n%s\n" % tuple(r)
                       for r in reads)
    else:
        # multi-line FASTA, CRLF line ends, blank lines between records
        body = ""
        for i, (name, seq, _) in enumerate(reads):
            lines = [seq[j:j + 60] for j in range(0, len(seq), 60)] or [""]
            nl = "\r\n" if i % 2 else "\n"
            body += ">%s desc\n%s%s" % (name, nl.join(lines), nl)
            if i % 3 == 0:
                body += "\n"
    data = body.encode("ascii")
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(data)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_native_reader_matches_python_lexer(tmp_path, fmt, gz):
    assert native.available(), native.BUILD["error"]
    reads = _records(np.random.RandomState(3), 300)
    path = str(tmp_path / ("r.%s%s" % (fmt, ".gz" if gz else "")))
    _write(path, reads, fmt, gz)
    want = list(fastx._iter_fastx_py(path))
    got = list(native.iter_fastx_native(path, batch_records=37,
                                        batch_bases=20000))
    assert got == want
    assert [r[0] for r in got] == [r[0] for r in reads]
    assert [r[1] for r in got] == [r[1] for r in reads]
    if fmt == "fastq":
        assert [r[2] for r in got] == [r[2] for r in reads]
    assert fastx.reader_name() == "native"


def test_reader_builds_in_the_port_never_in_native():
    assert native.available(), native.BUILD["error"]
    lib = os.path.realpath(native.BUILD["lib"])
    src = os.path.realpath(native.SOURCE)
    assert lib.startswith(os.path.join(REPO, "build", "fastx") + os.sep)
    assert src == os.path.join(REPO, "longqc_tpu_torch", "csrc",
                               "fastx_native.cpp")
    assert "-O3" in native.BUILD_FLAGS
    with open(os.path.join(REPO, "longqc_tpu_torch", "io",
                           "native.py")) as f:
        code = f.read()
    assert '"native"' not in code and "'native'" not in code
    assert "make" not in code.split()


def test_failed_build_is_reported_in_mmcov_stats(tmp_path, monkeypatch,
                                                 capsys):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD", dict(native.BUILD))
    rng = np.random.RandomState(5)
    reads = sample_reads(rng, make_genome(rng, 9000), 20, min_len=600,
                         max_len=1400, err=0.1)
    tf = str(tmp_path / "t.fq")
    write_fastq_file(tf, reads)
    stats = str(tmp_path / "stats.json")
    assert main(["mmcov", "--device", "cpu", "--stats", stats, tf, tf]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 20
    with open(stats) as f:
        rd = json.load(f)["reader"]
    assert rd["name"] == "python"
    assert "exited" in rd["error"] and "broken.cpp" in rd["error"]
    assert set(rd["parse_s"]) == {"target", "query"}

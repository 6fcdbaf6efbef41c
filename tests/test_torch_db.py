"""The npz index cache (-d) and the minimizer-count aggregation (-z)
against the JAX package on the CPU: cache files with the same keys,
dtypes and arrays; a cache written by either package loads in the other
and gives the rows of a fresh run; `mmcov -d` (dump, then the cached
run) and `mmcov -z` print the JAX package's rows and `[z]` lines; and
`sampleqc -d` (the index prefetch beside the chunk-QC loop) writes the
JAX package's npz parts and the same tables and QC JSON as a run
without -d."""

import filecmp
import json
import os

import numpy as np
import pytest
from torch_util import QC_JSON, assert_same_npz, compare_qc_json

from longqc_tpu import config as JC
from longqc_tpu.cli import main as jax_main
from longqc_tpu.engine import overlap_host as jax_oh
from longqc_tpu.engine.pipeline import run_sampleqc as jax_sampleqc
from longqc_tpu_torch import config as C
from longqc_tpu_torch.cli import main
from longqc_tpu_torch.engine import overlap_host as oh
from longqc_tpu_torch.engine import pipeline
from test_torch_cli import _dataset
from util_synth import make_genome, sample_reads, write_fastq_file

CPU = ["--device", "cpu"]
MM2 = os.path.join("analysis", "minimap2")


@pytest.mark.parametrize("k,w,hpc", [(12, 5, False), (15, 10, True)],
                         ids=["plain", "hpc"])
def test_npz_arrays_equal_jax(tmp_path, k, w, hpc):
    rng = np.random.RandomState(3)
    reads = sample_reads(rng, make_genome(rng, 12000), 40, min_len=500,
                         max_len=1500, err=0.1, junk_frac=0.1)
    want, got = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_oh.build_index(reads, k, w, is_hpc=hpc).save(want)
    oh.build_index(reads, k, w, is_hpc=hpc, device="cpu").save(got)
    assert_same_npz(got, want)
    idx = oh.MinimizerIndex.load(got)
    assert idx.h.dtype == np.uint64 and len(idx.h) > 0
    start, count = idx.lookup(idx.h[0])
    assert start == 0 and count == int(idx.counts[0])
    assert idx.lookup(np.uint64(2 ** 63)) == (0, 0)


def _rows(out):
    return [ln for ln in out.splitlines() if ln.strip()]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_loads_across_packages(tmp_path, capsys, writer):
    """One package dumps the cache (mmcov -d PREFIX target), the other
    maps from it: the cache is read, not rebuilt, and the rows equal a
    fresh run's."""
    tf, qf = _dataset(tmp_path, seed=23)
    prefix = str(tmp_path / "tdb")
    flags = ["-I", "20000"]      # several parts
    if writer == "jax":
        assert jax_main(["mmcov", "-d", prefix] + flags + [tf]) == 0
    else:
        assert main(["mmcov", "-d", prefix] + flags + CPU + [tf]) == 0
    parts = sorted(f for f in os.listdir(str(tmp_path))
                   if f.startswith("tdb.part"))
    assert len(parts) >= 2
    mtimes = [os.stat(str(tmp_path / f)).st_mtime_ns for f in parts]
    capsys.readouterr()
    if writer == "jax":
        assert main(["mmcov", "-d", prefix] + flags + CPU + [tf, qf]) == 0
    else:
        assert jax_main(["mmcov", "-d", prefix] + flags + [tf, qf]) == 0
    cached = _rows(capsys.readouterr().out)
    assert [os.stat(str(tmp_path / f)).st_mtime_ns for f in parts] == mtimes
    assert jax_main(["mmcov"] + flags + [tf, qf]) == 0
    assert cached == _rows(capsys.readouterr().out)
    assert len(cached) == 16


def test_mmcov_db_dump_then_cached_run(tmp_path, capsys):
    """The port's dump, then its cached run: the rows of its device
    engine and of the JAX package's `mmcov -d`; the dump's parts equal
    the JAX dump's."""
    tf, qf = _dataset(tmp_path, seed=23)
    prefix, jprefix = str(tmp_path / "tdb"), str(tmp_path / "jdb")
    assert main(["mmcov", "-d", prefix] + CPU + [tf]) == 0
    assert capsys.readouterr().out == ""
    stats = str(tmp_path / "stats.json")
    assert main(["mmcov", "-d", prefix, "--stats", stats] + CPU
                + [tf, qf]) == 0
    cached = _rows(capsys.readouterr().out)
    with open(stats) as f:
        assert json.load(f)["engine"] == "host_spec"
    assert main(["mmcov"] + CPU + [tf, qf]) == 0
    assert cached == _rows(capsys.readouterr().out)
    assert jax_main(["mmcov", "-d", jprefix, tf, qf]) == 0
    assert cached == _rows(capsys.readouterr().out)
    assert len(cached) == 16
    assert_same_npz(prefix + ".part0000.npz", jprefix + ".part0000.npz")
    with pytest.raises(SystemExit, match="no query"):
        main(["mmcov"] + CPU + [tf])


def _z_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("[z]")]


@pytest.mark.parametrize("cache", [False, True], ids=["fresh", "cached"])
def test_mmcov_z_lines_equal_jax(tmp_path, capsys, cache):
    tf, qf = _dataset(tmp_path, seed=19)
    db = ["-d", str(tmp_path / "zdb")] if cache else []
    assert jax_main(["mmcov", "-z"] + db + [tf, qf]) == 0
    want = capsys.readouterr()
    assert main(["mmcov", "-z"] + db + CPU + [tf, qf]) == 0
    got = capsys.readouterr()
    lines = _z_lines(got.err)
    assert lines == _z_lines(want.err) and len(lines) > 100
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert counts == sorted(counts, reverse=True) and counts[0] > 0
    assert got.out == want.out
    assert main(["mmcov"] + CPU + [tf, qf]) == 0
    assert got.out == capsys.readouterr().out


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
@pytest.mark.parametrize("preset", sorted(C.PRESETS))
def test_prefetch_specs(tmp_path, preset, fast):
    """One spec per distinct (k, w) of the run, the -b short one
    included, under the JAX package's cache prefixes."""
    paths = pipeline._Paths(str(tmp_path), "s1")
    got = pipeline._IndexPrefetcher.for_sample(
        "in.fq", C.PRESETS[preset], fast, "4G", True, paths, "cpu").specs
    want = []
    for short in (False, True):
        cfg = JC.overlap_config_for_sample(JC.PRESETS[preset], fast=fast,
                                           short=short)
        kw = (cfg.index.k, cfg.index.w)
        if kw not in [s[:2] for s in want]:
            want.append(kw + (os.path.join(
                str(tmp_path), MM2, "t_db_longqc_s1_k%d_w%d" % kw),))
    assert got == want


def test_prefetch_error_is_raised_on_join(tmp_path):
    pf = pipeline._IndexPrefetcher(str(tmp_path / "missing.fq"),
                                   [(12, 5, str(tmp_path / "db"))], 10 ** 9,
                                   "cpu")
    pf.start()
    with pytest.raises(OSError, match="missing.fq"):
        pf.join()
    assert pf.seconds is not None


@pytest.fixture(scope="module")
def db_runs(tmp_path_factory):
    """sampleqc -x ont-ligation -n 30 on 50 reads (as
    tests/test_cli_surfaces.py): the port with and without -d, and the
    JAX package with -d."""
    tmp = tmp_path_factory.mktemp("db")
    rng = np.random.RandomState(31)
    reads = sample_reads(rng, make_genome(rng, 12000), 50, min_len=600,
                         max_len=1500, err=0.1, junk_frac=0.1)
    fq = str(tmp / "in.fq")
    write_fastq_file(fq, reads)
    outs = {n: str(tmp / n) for n in ("port_db", "port", "jax_db")}
    stats = str(tmp / "stats.json")
    base = ["sampleqc", "-x", "ont-ligation", "-n", "30"]
    assert main(base + ["-d", "-o", outs["port_db"], "--stats", stats]
                + CPU + [fq]) == 0
    assert main(base + ["-o", outs["port"]] + CPU + [fq]) == 0
    jax_sampleqc(fq, outs["jax_db"], "ont-ligation", nsample=30, db=True)
    with open(stats) as f:
        outs["stats"] = json.load(f)
    return outs


def _npz_names(out):
    return sorted(f for f in os.listdir(os.path.join(out, MM2))
                  if f.endswith(".npz"))


def test_sampleqc_db_npz_parts(db_runs):
    names = _npz_names(db_runs["port_db"])
    assert names == _npz_names(db_runs["jax_db"])
    assert names == ["t_db_longqc_k12_w5.part0000.npz"]
    assert _npz_names(db_runs["port"]) == []
    for n in names:
        assert_same_npz(os.path.join(db_runs["port_db"], MM2, n),
                        os.path.join(db_runs["jax_db"], MM2, n))
    pf = db_runs["stats"]["prefetch"]
    assert pf["parts"] == 1 and pf["thread_s"] > 0
    assert pf["join_wait_s"] >= 0 and len(pf["caches"]) == 1


@pytest.mark.parametrize("other", ["port", "jax_db"])
def test_sampleqc_db_tables_and_json(db_runs, other):
    """Coverage TSV byte-identical; the QC JSON equal to the port's run
    without -d, and to the JAX -d run's as tests/test_torch_sampleqc.py
    compares them."""
    got = db_runs["port_db"]
    assert filecmp.cmp(os.path.join(got, MM2, "coverage_out.txt"),
                       os.path.join(db_runs[other], MM2, "coverage_out.txt"),
                       shallow=False)
    with open(os.path.join(got, QC_JSON)) as f:
        j_got = json.load(f)
    with open(os.path.join(db_runs[other], QC_JSON)) as f:
        j_want = json.load(f)
    if other == "port":
        assert j_got == j_want
    else:
        compare_qc_json(j_got, j_want)

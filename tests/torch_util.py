"""Shared helpers of the port's tests (tests/test_torch_*.py).

The tests run on the CPU, where every kernel wrapper of
longqc_tpu_torch runs its plain PyTorch version; pytest-xdist runs
several workers, so each worker keeps to two intra-op threads."""

import numpy as np
import pytest
import torch

from longqc_tpu_torch.engine.pipeline import _control_ref_path
from longqc_tpu_torch.io.fastx import iter_fastx
from util_synth import make_genome, sample_reads

torch.set_num_threads(2)

ONT_ADP5 = "AATGTACTTCGTTCAGTTACGTATTGCT"
# sampleqc's tables and QC JSON, under its output directory
SAMPLEQC_TABLES = ["analysis/minimap2/coverage_out.txt",
                   "analysis/longqc_sdust.txt", "analysis/subsample.fastq"]
QC_JSON = "QC_vals_longQC_sampleqc.json"


def t32(a):
    """numpy -> int32 CPU tensor (uint32 words keep their bits)."""
    a = np.array(a)                     # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def np_(t):
    return t.cpu().numpy()


def rand_reads(rng, n, lo, hi, with_n=True):
    """[name, seq, ""] reads of lo..hi random bases, half of them (with
    with_n) carrying a short N run."""
    reads = []
    for i in range(n):
        ln = rng.randint(lo, hi)
        s = "".join("ACGT"[j] for j in rng.randint(0, 4, ln))
        if with_n and ln > 10 and rng.rand() < 0.5:
            p = rng.randint(0, ln - 5)
            s = s[:p] + "N" * rng.randint(1, 4) + s[p + 3:]
        reads.append(["r%04d" % i, s, ""])
    return reads


def index_triples(ih, irid, ips):
    """Sorted real (hash, rid, pos << 1 | strand) entries of a flat
    index or chunk; the max of the hash lanes' dtype marks the empty
    slots."""
    ih, irid, ips = (np.asarray(a) for a in (ih, irid, ips))
    keep = ih != np.iinfo(ih.dtype).max
    return sorted(zip(ih[keep].tolist(), irid[keep].tolist(),
                      ips[keep].tolist()))


def rand_seq(rng, n, with_n=0.0):
    s = rng.choice(list("ACGT"), size=n)
    if with_n:
        s[rng.random_sample(n) < with_n] = "N"
    return "".join(s)


def ont_sampleqc_reads():
    """60 reads of 0.7-2.2 kbp (err 0.1, 10 % junk), the ont-ligation 5'
    adapter planted on the first 25."""
    rng = np.random.RandomState(21)
    reads = sample_reads(rng, make_genome(rng, 15000), 60, min_len=700,
                         max_len=2200, err=0.1, junk_frac=0.1)
    for r in reads[:25]:
        r[1] = ONT_ADP5 + r[1]
        r[2] = "I" * len(ONT_ADP5) + r[2]
    return reads


def pb_sampleqc_reads():
    """50 reads of 0.7-1.8 kbp (err 0.12, 10 % junk), 6 of them (named
    control*) drawn from the Sequel control of the port's refs/."""
    # seed 31 draws a GC window at a read's last 149 bases, where the JAX
    # package raises IndexError (the port's fix is held in
    # tests/test_torch_chunkqc.py::test_chunk_gc_window_at_the_read_end)
    rng = np.random.RandomState(32)
    reads = sample_reads(rng, make_genome(rng, 12000), 44, min_len=700,
                         max_len=1800, err=0.12, junk_frac=0.1)
    ctl = [s for _n, s, _q in iter_fastx(_control_ref_path(True))]
    for i, r in enumerate(sample_reads(rng, ctl[0] * 3, 6, min_len=900,
                                       max_len=2500, err=0.1)):
        reads.insert(3 + 7 * i, ["control%d" % i] + r[1:])
    return reads


def compare_qc_json(got, want, path=""):
    """Two QC JSON dicts: the same keys in the same order, integers and
    strings equal, floats equal except those of the coverage fits
    (Coverage_stats), within rel=1e-9 (EM summation order; see
    tests/test_torch_distfit.py)."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            compare_qc_json(got[k], want[k], path + "/" + k)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            compare_qc_json(a, b, "%s[%d]" % (path, i))
    elif isinstance(want, float) and path.startswith("/Coverage_stats"):
        assert got == pytest.approx(want, rel=1e-9), path
    else:
        assert got == want, path

"""The port engine's part pipeline (part N+1 read and packed on a side
thread while part N steps), the dispatch between the device engine and
the batched chainer, the anchor rungs (`a_ladder=`) and the per-row
`progress` callback, against the JAX package and the host spec. Rows
are strings built from integers, so every comparison is exact
(tolerance 0)."""

import threading
from collections import Counter

import numpy as np
import pytest
import torch_util  # noqa: F401

from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import device_overlap as jdo
from longqc_tpu.engine import overlap as jov
from longqc_tpu.engine import overlap_host as joh
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import device_overlap as tdo
from longqc_tpu_torch.engine import overlap as tov
from longqc_tpu_torch.engine import overlap_host as toh
from util_synth import make_genome, sample_reads


def _cfgs(k=12, w=5, hpc=False, **index):
    t = OverlapConfig(index=IndexOpt(k=k, w=w, is_hpc=hpc, **index),
                      map=MapOpt(min_score_med=80, min_score_good=160),
                      flt=FltOpt(min_ovlp=0))
    j = JOverlapConfig(index=JIndexOpt(k=k, w=w, is_hpc=hpc, **index),
                       map=JMapOpt(min_score_med=80, min_score_good=160),
                       flt=JFltOpt(min_ovlp=0))
    return t, j


def _reads(seed=5, n=90, lo=500, hi=1500):
    rng = np.random.RandomState(seed)
    genome = make_genome(rng, 20000)
    return sample_reads(rng, genome, n, min_len=lo, max_len=hi, err=0.12,
                        junk_frac=0.1)


# ~90 kbp of targets in parts of 30 kbp: 4 parts
_PARTS = dict(batch_size=30000)


@pytest.fixture(scope="module")
def jax_parts_run():
    """The JAX engine's rows on the parts input, and the query indices
    its progress callback received."""
    reads = _reads()
    _, cfg_j = _cfgs(**_PARTS)
    seen = []
    rows = jdo.overlap_run_device2(list(reads), reads[:24], cfg_j,
                                   progress=seen.append)
    return rows, seen


def test_part_pipeline_matches_jax_engine(jax_parts_run):
    reads = _reads()
    cfg_t, _ = _cfgs(**_PARTS)
    eng = tdo.DeviceOverlapEngine(cfg_t, reads[:24], device="cpu")
    assert eng.run(iter(reads)) == jax_parts_run[0]
    st = eng.stats()
    n_parts = len(st["part_ranges"])
    assert n_parts >= 3
    # every part's host step ran on the side thread
    assert st["parts_packed_aside"] == n_parts
    assert {"index", "part_wait", "step"} <= set(st["phase_s"])
    assert set(st["index_s"]) == {"pack", "tiles", "merge"}


def _fail_on(monkeypatch, fn_owner, name, call):
    """Make fn_owner.name raise on its call-th call (1-based)."""
    orig = getattr(fn_owner, name)
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == call:
            raise RuntimeError("injected failure")
        return orig(*a, **kw)

    monkeypatch.setattr(fn_owner, name, failing)


def _failing_targets(reads, at):
    for i, r in enumerate(reads):
        if i == at:
            raise RuntimeError("injected failure")
        yield r


@pytest.mark.parametrize("where", ["pack_first", "pack_third", "reader",
                                   "build_second"])
def test_failed_part_raises_in_run(monkeypatch, where):
    """A failure in the side thread (reading or packing a part) or in the
    device step is raised by run(), within a time limit, and no part is
    skipped."""
    reads = _reads()
    cfg_t, _ = _cfgs(**_PARTS)
    targets = iter(reads)
    if where == "pack_first":
        _fail_on(monkeypatch, di, "pack_part", 1)
    elif where == "pack_third":
        _fail_on(monkeypatch, di, "pack_part", 3)
    elif where == "reader":
        targets = _failing_targets(reads, 50)
    else:
        _fail_on(monkeypatch, di, "build_device_index", 2)
    eng = tdo.DeviceOverlapEngine(cfg_t, reads[:8], device="cpu")
    out = {}

    def go():
        try:
            out["rows"] = eng.run(targets)
        except RuntimeError as e:
            out["error"] = str(e)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "run() hung on a failed part"
    assert out == {"error": "injected failure"}


def test_overlap_engine_v1_runs_batched_chainer(monkeypatch):
    """The batched-chainer path on a plain k = 12 configuration: rows
    equal to the device engine's and the JAX package's v1 rows."""
    reads = _reads()
    queries = reads[:24]
    cfg_t, cfg_j = _cfgs()
    rows_dev = tdo.overlap_run_device2(list(reads), queries, cfg_t,
                                       device="cpu")
    chainer = tov.DeviceChainer("cpu")
    rows = toh.overlap_run(list(reads), queries, cfg_t, device="cpu",
                           chain_many=chainer)
    assert chainer.n_calls >= 1
    assert rows == rows_dev
    monkeypatch.setenv("LONGQC_OVERLAP_ENGINE", "v1")
    assert rows == jov.overlap_run_device(list(reads), queries, cfg_j)


@pytest.mark.parametrize("k,w,hpc,engine", [
    (12, 5, False, "device"), (19, 10, False, "device"),
    (15, 10, True, "device"), (17, 10, True, "batched_chainer")],
    ids=["plain-k12", "wide-k19", "hpc-k15", "hpc-k17"])
def test_dispatch_follows_the_configuration(monkeypatch, k, w, hpc,
                                            engine):
    """The device engine for every configuration it takes, the batched
    chainer for the one it refuses (HPC with k > 15), whatever the
    environment holds; the rows equal the host spec's."""
    monkeypatch.setenv("LONGQC_OVERLAP_ENGINE", "v1")
    reads = _reads(n=40)
    queries = reads[:12]
    cfg_t, _ = _cfgs(k=k, w=w, hpc=hpc)
    stats = {}
    rows = tov.overlap_run_device(list(reads), queries, cfg_t,
                                  device="cpu", stats=stats)
    assert stats["engine"] == engine
    assert rows == toh.overlap_run(list(reads), queries, cfg_t,
                                   device="cpu")


def test_chainer_and_engine_share_the_rungs():
    cfg_t, _ = _cfgs()
    eng = tdo.DeviceOverlapEngine(cfg_t, _reads()[:4], device="cpu")
    assert tov.DeviceChainer("cpu").a_ladder == eng.a_ladder == \
        tdo.A_BUCKETS


def _host_boundary():
    """tests/test_torch_device_overlap.py::
    test_rows_match_jax_host_host_only_boundary's input."""
    rng = np.random.RandomState(41)
    genome = make_genome(rng, 20000)
    reads = sample_reads(rng, genome, 90, min_len=600, max_len=1800,
                         err=0.12, junk_frac=0.1)
    return reads, reads[:24]


@pytest.mark.parametrize("inp", ["plain", "host_fixed"])
@pytest.mark.parametrize("path", ["engine", "host_spec"])
def test_progress_matches_jax(jax_parts_run, inp, path):
    """The multiset of query indices progress() receives equals the JAX
    package's: once per row and part, whether the row was committed
    clean or fixed on the host."""
    if inp == "plain":
        reads = _reads()
        queries = reads[:24]
        cfg_t, cfg_j = _cfgs(**_PARTS)
    else:
        reads, queries = _host_boundary()
        cfg_t, cfg_j = _cfgs()
    got, want = [], []
    if path == "host_spec":
        toh.overlap_run(list(reads), queries, cfg_t, device="cpu",
                        progress=got.append)
        joh.overlap_run(list(reads), queries, cfg_j, progress=want.append)
    else:
        eng = tdo.DeviceOverlapEngine(cfg_t, queries, device="cpu")
        if inp == "host_fixed":
            eng.n_idx_sizes = (1 << 10,)     # every row host-fixed
            eng.max_index_entries = 1 << 10
        eng.run(list(reads), progress=got.append)
        assert (eng.n_host_fallback == len(queries)) == (inp == "host_fixed")
        if inp == "plain":
            want = jax_parts_run[1]
        else:
            jdo.overlap_run_device2(list(reads), queries, cfg_j,
                                    progress=want.append)
    assert Counter(got) == Counter(want)
    assert set(got) == set(range(len(queries)))


def test_a_ladder_keeps_the_rows(jax_parts_run):
    """Other anchor rungs (a top rung of 256 sends some rows to the wide
    rungs, sub-batches of fewer lanes past the top) give the rows of the
    default rungs, the JAX engine's."""
    reads = _reads()
    cfg_t, _ = _cfgs(**_PARTS)
    eng = tdo.DeviceOverlapEngine(cfg_t, reads[:24], device="cpu",
                                  a_ladder=(128, 256))
    assert eng.a_ladder == (128, 256)
    assert eng.run(list(reads)) == jax_parts_run[0]
    assert eng.spans["counters"]["step.wide_rows"] > 0
    assert eng.n_host_fallback == 0

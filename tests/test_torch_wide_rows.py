"""Rows past the top anchor rung: the port engine steps them in
sub-batches of fewer lanes at wider rungs (the wide ladder, in the
footprint of the group's lanes at the top rung) instead of handing them
to the host spec. The anchor rungs are shrunk (`a_ladder=`) so that
small inputs cross the top. Rows are strings built from integers, so
every comparison is exact."""

import numpy as np
import pytest
import torch_util  # noqa: F401

from benchmark.reference import overlap as ref_ov
from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import device_overlap as jdo
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_overlap as tdo
from longqc_tpu_torch.engine import overlap_host as toh
from util_synth import make_genome, mutate, sample_reads

CFG = OverlapConfig(index=IndexOpt(k=12, w=5),
                    map=MapOpt(min_score_med=80, min_score_good=160),
                    flt=FltOpt(min_ovlp=0))
# 24 queries of 0.5-3 kbp against 60 reads: 260-1,204 anchors a row, so
# a top rung of 512 leaves 16 rows past it
LADDER = (128, 512)


def _reads():
    rng = np.random.RandomState(7)
    return sample_reads(rng, make_genome(rng, 20000), 60, min_len=500,
                        max_len=3000, err=0.12, junk_frac=0.1)


class _Spy:
    """Records every step call's (lanes, rung, step's own n_q of its
    live rows) and every count pass's per-lane counts."""

    def __init__(self, monkeypatch):
        self.steps, self.counts = [], []
        step, count = tdo._step_impl, tdo._count_expanded
        collect = tdo._collect_anchors

        def spy_step(*a):
            self.steps.append([a[5].shape[0], a[-1].A, None])
            return step(*a)

        def spy_collect(*a, **kw):
            out = collect(*a, **kw)
            if self.steps and self.steps[-1][2] is None:
                self.steps[-1][2] = out[6].numpy()
            return out

        def spy_count(*a, **kw):
            out = count(*a, **kw)
            self.counts.append(out[0].numpy())
            return out
        monkeypatch.setattr(tdo, "_step_impl", spy_step)
        monkeypatch.setattr(tdo, "_collect_anchors", spy_collect)
        monkeypatch.setattr(tdo, "_count_expanded", spy_count)

    def wide(self, top):
        return [s for s in self.steps if s[1] > top]

    def n_q(self):
        return np.concatenate(self.counts)


def _engine(queries, cfg=CFG, **kw):
    return tdo.DeviceOverlapEngine(cfg, queries, device="cpu", **kw)


@pytest.fixture(scope="module")
def host_rows():
    reads = _reads()
    return toh.overlap_run(list(reads), reads[:24], CFG, device="cpu")


def test_wide_ladder_and_the_largest_row():
    assert tdo._wide_ladder(262144, 128)[0] == 524288
    assert tdo._wide_ladder(262144, 128)[-1] == tdo.ROW_ANCHORS_MAX == \
        1 << 25
    assert tdo._wide_ladder(512, 8) == (1024, 2048, 4096)
    assert tdo._wide_ladder(512, 1) == ()
    # each row at its own smallest rung, largest rows first, at most
    # budget // A lanes a batch
    nq = {0: 700, 1: 3000, 2: 1500, 3: 900, 4: 1000, 5: 600}
    assert tdo._wide_batches(list(nq), nq, (1024, 2048, 4096), 4096) == [
        (4096, [1]), (2048, [2]), (1024, [4, 3, 0, 5])]
    del nq[1]
    assert tdo._wide_batches(list(nq), nq, (1024, 2048), 2048) == [
        (2048, [2]), (1024, [4, 3]), (1024, [0, 5])]


def test_wide_rows_equal_host_spec_jax_and_reference(host_rows,
                                                     monkeypatch):
    reads = _reads()
    spy = _Spy(monkeypatch)
    eng = _engine(reads[:24], a_ladder=LADDER, lanes=8)
    assert eng.wide_ladder == (1024, 2048, 4096)
    rows = eng.run(list(reads))
    assert rows == host_rows
    jcfg = JOverlapConfig(index=JIndexOpt(k=12, w=5),
                          map=JMapOpt(min_score_med=80, min_score_good=160),
                          flt=JFltOpt(min_ovlp=0))
    assert rows == jdo.overlap_run_device2(list(reads), reads[:24], jcfg)
    ov = dict(k=12, w=5, max_gap=CFG.map.max_gap, bw=CFG.map.bw,
              max_skip=CFG.map.max_chain_skip, min_cnt=CFG.map.min_cnt,
              min_chain_score=CFG.map.min_chain_score, min_score_med=80,
              min_score_good=160, mid_occ_frac=CFG.map.mid_occ_frac,
              max_overhang=CFG.flt.max_overhang,
              min_ratio=CFG.flt.min_ratio, min_cov=CFG.flt.min_coverage,
              covt=CFG.covt)
    ref, _ = ref_ov.rows_for(reads, reads[:24], list(range(24)), ov)
    assert rows == [ref[i] for i in range(24)]

    st, ctr = eng.stats(), eng.spans["counters"]
    assert st["host_fixed_rows"] == 0
    nq = spy.n_q()
    over = nq[nq > LADDER[-1]]
    wide = spy.wide(LADDER[-1])
    # the rows past the top, each once, in sub-batches of fewer lanes at
    # more than one wide rung, each batch at the smallest rung that
    # holds its largest row
    assert len(over) == 16
    assert ctr["step.wide_rows"] == sum(q for q, _a, _n in wide) == 16
    assert ctr["step.wide_anchors"] == int(over.sum()) == \
        int(sum(n.sum() for _q, _a, n in wide))
    assert ctr["step.wide_slots"] == sum(q * a for q, a, _n in wide)
    assert len({a for _q, a, _n in wide}) >= 2
    for q, a, n in wide:
        assert q <= 8 * LADDER[-1] // a
        assert a == next(r for r in eng.wide_ladder if r >= n.max())
    assert st["device_calls"] == len(spy.steps)
    assert eng.spans["by_name"]["step.wide"]["n"] == len(wide)


def test_row_past_the_widest_rung_is_host_fixed(host_rows, monkeypatch):
    """Two lanes a group: one wide rung (1024); the rows past it are
    computed by the host spec, the others step."""
    reads = _reads()
    spy = _Spy(monkeypatch)
    eng = _engine(reads[:24], a_ladder=LADDER, lanes=2)
    assert eng.wide_ladder == (1024,) and eng.row_anchors_max == 1024
    assert eng.run(list(reads)) == host_rows
    nq = spy.n_q()
    n_past = int((nq > 1024).sum())
    n_wide = int(((nq > LADDER[-1]) & (nq <= 1024)).sum())
    assert n_past > 0 and n_wide > 0
    assert eng.stats()["host_fixed_rows"] == n_past
    assert eng.spans["counters"]["step.wide_rows"] == n_wide
    assert eng.stats()["flag_counts"][str(tdo.F_ANCH)] == n_past


def test_million_column_bucket_equals_host_spec(monkeypatch):
    """A query over 262,144 bp sits in the 1,048,576 query bucket (M2 of
    1,048,576 slots a lane); its row steps at a wide rung of one lane."""
    rng = np.random.RandomState(11)
    genome = make_genome(rng, 300000)
    targets = sample_reads(rng, genome, 40, min_len=2000, max_len=6000,
                           err=0.12, junk_frac=0.1)
    big = mutate(rng, genome[10000:280000], 0.12)
    queries = [["ul0", big, "I" * len(big)]] + targets[:2]
    assert tdo._len_bucket(len(big)) == 1 << 20
    spy = _Spy(monkeypatch)
    eng = _engine(queries, a_ladder=(1024, 2048), lanes=4)
    assert eng.wide_ladder == (4096, 8192)
    rows = eng.run(list(targets))
    assert rows == toh.overlap_run(list(targets), queries, CFG,
                                   device="cpu")
    g, = [g for g in eng.groups if g.blen == 1 << 20]
    assert tuple(g.m_cnts.shape) == (4, 1 << 20)
    assert eng.stats()["host_fixed_rows"] == 0
    (q, a, n), = spy.wide(2048)
    assert (q, a) == (1, 8192) and 4096 < int(n[0]) <= 8192
    assert eng.spans["counters"]["step.wide_rows"] == 1


def test_groups_that_fit_the_ladder_step_as_before(monkeypatch):
    """With no row past the top rung: one step a group and part, over
    the group's lanes, at the smallest rung that holds its largest live
    row; no wide step and no host fix."""
    reads = _reads()
    spy = _Spy(monkeypatch)
    eng = _engine(reads[:24])
    eng.run(list(reads))
    assert eng.a_ladder == tdo.A_BUCKETS
    assert len(spy.steps) == len(spy.counts) == len(eng.groups)
    for (q, a, _n), nq in zip(spy.steps, spy.counts):
        assert q == tdo.GROUP_Q
        assert a == next(r for r in tdo.A_BUCKETS if r >= nq.max())
    assert "step.wide_rows" not in eng.spans["counters"]
    assert "step.wide" not in eng.spans["by_name"]
    assert eng.stats()["host_fixed_rows"] == 0


def test_hpc_rows_past_the_top_step_wide(monkeypatch):
    """The HPC engine (the spike-in filter run) steps its rows past the
    top rung at the wide rungs too, through the same sub-batch step: 31
    of 70 rows, none host-fixed, the rows equal the host spec."""
    rng = np.random.RandomState(41)
    control = make_genome(rng, 12000)
    reads = sample_reads(rng, control, 70, min_len=600, max_len=1600,
                         err=0.1, junk_frac=0.2)
    target = [["control", control, ""]]
    cfg = OverlapConfig(index=IndexOpt(k=15, w=10, is_hpc=True),
                        flt=FltOpt(min_ovlp=0, min_coverage=1),
                        filter_mode=True)
    spy = _Spy(monkeypatch)
    eng = _engine(reads, cfg=cfg, a_ladder=(16, 32), lanes=16)
    assert eng.wide_ladder == (64, 128, 256, 512)
    assert eng.run(list(target)) == toh.overlap_run(list(target), reads,
                                                    cfg, device="cpu")
    nq = spy.n_q()
    ctr = eng.spans["counters"]
    assert ctr["step.wide_rows"] == int((nq > 32).sum()) == 31
    assert ctr["step.wide_anchors"] == int(nq[nq > 32].sum())
    assert eng.stats()["host_fixed_rows"] == 0
    assert eng.spans["by_name"]["step.hpc_b"]["n"] == \
        eng.stats()["device_calls"]

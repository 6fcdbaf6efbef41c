"""The HPC configuration (-H: homopolymer-compressed sketch, the
spike-in-control filter run) of the port against the JAX package, all
exact (tolerance 0: hashes, positions, spans, scores and TSV rows):
hpc_compress, the HPC tensor sketch, the host spec's rows, the B2 plain
version with one gap-penalty table per row against the Pallas kernel
with the matching per-row limbs (interpret mode), one two-phase HPC
step fed identical inputs through longqc_tpu_torch.convert, and the
device engine's rows on CPU tensors against the JAX engine and both
host specs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_util import np_, rand_seq, t32

from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import device_index as jdi
from longqc_tpu.engine import device_overlap as jdo
from longqc_tpu.engine import overlap_host as joh
from longqc_tpu.engine.device_overlap import overlap_run_device2
from longqc_tpu.ops import sketch_hpc as jhpc
from longqc_tpu.ops.chain_pallas import (chain_dp_batch_pallas,
                                         make_carry_pallas, penalty_limbs)
from longqc_tpu.ops.sketch import sketch_batch as jax_sketch_batch
from longqc_tpu_torch import convert
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_overlap as tdo
from longqc_tpu_torch.engine import overlap_host as toh
from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine
from longqc_tpu_torch.ops import sketch_hpc as thpc
from longqc_tpu_torch.ops.chain import gap_penalty_table
from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill
from longqc_tpu_torch.ops.sketch import sketch_batch
from test_torch_device_overlap import _events, jax_host_fix, jax_step_final
from util_synth import make_genome, sample_reads


def _hpc_reads(rng, n):
    """Reads with long homopolymers, N runs, lone Ns, IUPAC codes and
    edge cases (empty, all-N, one base, one long run)."""
    reads = ["", "N" * 40, "A", "C" * 300, "ANA", "ACGTRYNNACGT"]
    for i in range(n):
        s = "".join(c * (1 + rng.randint(0, 9 if i % 2 else 30))
                    for c in rand_seq(rng, rng.randint(20, 500)))
        if i % 3 == 0:
            p = rng.randint(0, len(s))
            s = s[:p] + "N" * rng.randint(1, 25) + s[p:]
        if i % 4 == 1:
            s = "N" + s + "NN"
        reads.append(s)
    return reads


def test_hpc_compress_matches_jax():
    rng = np.random.RandomState(3)
    for k in (5, 15, 27):
        for s in _hpc_reads(rng, 40):
            want = jhpc.hpc_compress(s, k)
            got = thpc.hpc_compress(s, k)
            for a, b in zip(want, got):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,w", [(15, 10), (9, 3)])
def test_hpc_sketch_batch_matches_jax(k, w):
    rng = np.random.RandomState(k + w)
    reads = _hpc_reads(rng, 30)
    codes, lengths, positions, spans = thpc.pack_hpc(
        [thpc.hpc_compress(s, k) for s in reads], 512)
    want = jax_sketch_batch(codes, lengths, w=w, k=k, positions=positions,
                            spans=spans)
    got = sketch_batch(*(torch.from_numpy(a) for a in (codes, lengths)),
                       w=w, k=k, positions=torch.from_numpy(positions),
                       spans=torch.from_numpy(spans))
    emit = np.asarray(want["emit"])
    assert emit.sum() > 100
    np.testing.assert_array_equal(np_(got["emit"]), emit)
    on = emit > 0
    hw = np.asarray(want["hash"])
    assert hw.dtype == np.uint64
    np.testing.assert_array_equal(np_(got["hash"])[on].astype(np.uint64),
                                  hw[on])
    for f in ("pos", "strand"):
        np.testing.assert_array_equal(np_(got[f])[on],
                                      np.asarray(want[f])[on], err_msg=f)
    # spans differ from k: the packed low byte carries them
    assert len(np.unique(hw[on] & np.uint64(0xFF))) > 5
    for a, b in zip(jhpc.sketch_reads_hpc([["r", s, ""] for s in reads],
                                          k, w),
                    thpc.sketch_reads_hpc([["r", s, ""] for s in reads],
                                          k, w, device="cpu")):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.astype(np.int64),
                                          y.astype(np.int64))


def _cfgs(filter_mode, **map_kw):
    t = OverlapConfig(index=IndexOpt(k=15, w=10, is_hpc=True),
                      map=MapOpt(**map_kw),
                      flt=FltOpt(min_ovlp=0,
                                 min_coverage=1 if filter_mode else 3),
                      filter_mode=filter_mode)
    j = JOverlapConfig(index=JIndexOpt(k=15, w=10, is_hpc=True),
                       map=JMapOpt(**map_kw),
                       flt=JFltOpt(min_ovlp=0,
                                   min_coverage=1 if filter_mode else 3),
                       filter_mode=filter_mode)
    return t, j


def _filter_input(seed=41):
    rng = np.random.RandomState(seed)
    control = make_genome(rng, 12000)
    reads = sample_reads(rng, control, 70, min_len=600, max_len=1600,
                         err=0.1, junk_frac=0.2)
    return [["control", control, ""]], reads


def _ava_input(seed=59):
    rng = np.random.RandomState(seed)
    base = make_genome(rng, 18000)
    # stretched homopolymers: spans far from k
    genome = "".join(c * (1 + rng.randint(0, 4)) for c in base)
    reads = sample_reads(rng, genome, 120, min_len=700, max_len=2000,
                         err=0.1, junk_frac=0.1)
    return reads, reads[:30]


def test_hpc_host_spec_rows_match_jax():
    target, reads = _filter_input()
    cfg_t, cfg_j = _cfgs(True)
    want = joh.overlap_run(list(target), reads, cfg_j)
    assert toh.overlap_run(list(target), reads, cfg_t,
                           device="cpu") == want
    assert sum(r.split("\t")[3] != "0" for r in want) > 20


def test_chain_fill_per_row_tables_match_pallas():
    """Distinct fractional mean spans per row (the HPC engine's
    avg_qspan): the plain version with one f64-exact table per row
    equals the Pallas kernel with each row's limbs on every row the
    Pallas kernel leaves unflagged, and the port's host fill with that
    row's avg_qspan on the rows it flags (ring truncation)."""
    rng = np.random.RandomState(13)
    Q, A, J, bw = 128, 256, 64, 500
    avg = [np.float32(15 + (r % 37) / 7.0) for r in range(Q)]
    limbs = np.stack([penalty_limbs(float(a), bw) for a in avg], axis=1)
    pen = torch.from_numpy(np.stack([gap_penalty_table(a, bw)
                                     for a in avg]))
    assert len({tuple(p) for p in pen.numpy().tolist()}) > 20
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aq = np.zeros((Q, A), np.int32)
    span = rng.randint(15, 40, (Q, A)).astype(np.int32)
    nb = rng.randint(40, A, Q).astype(np.int32)
    for r in range(Q):
        n = nb[r]
        pos = np.sort(rng.randint(0, 20000, n))
        axl[r, :n] = pos
        aq[r, :n] = np.clip(pos - 5000 + rng.randint(0, 3, n)
                            * rng.randint(1, 400)
                            + rng.randint(-40, 40, n), 0, None)
    j = chain_dp_batch_pallas(axh, axl, aq, span, nb, limbs,
                              np.zeros((1, Q), np.int32),
                              make_carry_pallas(Q, J), np.int32(0), J=J,
                              max_dist=5000, bw=bw, max_skip=25,
                              interpret=True)
    p = chain_dp_fill(t32(axh), t32(axl), t32(aq), t32(span), t32(nb), pen,
                      max_dist=5000, bw=bw, max_skip=25)
    flagged = np.asarray(j[3]) != 0
    assert 0 < flagged.sum() < Q
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(j[i])[~flagged],
                                      np_(p[i])[~flagged])
    for r in np.nonzero(flagged)[0]:
        n = int(nb[r])
        ax = axl[r, :n].astype(np.uint64)
        ay = (span[r, :n].astype(np.uint64) << np.uint64(32)) | \
            aq[r, :n].astype(np.uint64)
        want = toh.chain_fill(ax, ay, 5000, bw, 25, avg_qspan=avg[r])
        for i in range(3):
            np.testing.assert_array_equal(np_(p[i])[r, :n], want[i])
    # a single table for every row differs: the rows do use their own
    one = chain_dp_fill(t32(axh), t32(axl), t32(aq), t32(span), t32(nb),
                        pen[:1], max_dist=5000, bw=bw, max_skip=25)
    assert not torch.equal(one[0], p[0])


@pytest.mark.parametrize("ssum,dd", [(304, 125), (300, 420)],
                         ids=["avg15.2_dd125", "avg15_dd420"])
def test_gap_cost_follows_chain_c_double(ssum, dd):
    """chain.c:67 computes (int)(dd * .01 * avg_qspan) in double. At
    these (avg_qspan, dd) the f32 product truncates to another integer
    (18 against 19 at 15.2 / 125; 63 against 62 at 15.0 / 420). One
    chain: 8 anchors on a diagonal, a gap of `dd` to a second diagonal,
    10 more anchors there, and one anchor on another target, 20 with
    spans summing to `ssum`. The port's host spec, the port's B2 table
    and the JAX Pallas kernel's limbs all score the gap in f64; the JAX
    host spec's expression (a numpy float32 operand) is the one that
    differs."""
    n_a, bw, log_dd = 20, 500, dd.bit_length() - 1
    avg = np.float32(ssum / n_a)
    c64 = int(dd * 0.01 * float(avg))
    c32 = int(np.float32(np.float32(dd * 0.01) * avg))
    assert c64 != c32
    spans = np.full(n_a, 15, np.int64)
    spans[n_a - (ssum - 15 * n_a):] += 1
    assert spans.sum() == ssum
    step = 15 * np.arange(n_a)
    qp = 1000 + step
    pos = 1000 + step + np.where(np.arange(n_a) >= 8, dd, 0)
    qp[-1] = pos[-1] = 50
    rid = np.array([0] * (n_a - 1) + [1], np.int64)
    # anchor 8 joins the first diagonal's end (min(dq, dr) = 15) past
    # the gap; anchors 9..18 follow at no gap cost
    chain = 15 * 8 + sum(min(15, int(s)) for s in spans[8:n_a - 1])
    want = chain - (c64 + (log_dd >> 1))

    ax = (rid.astype(np.uint64) << np.uint64(32)) | pos.astype(np.uint64)
    ay = (spans.astype(np.uint64) << np.uint64(32)) | qp.astype(np.uint64)
    args = (ax, ay, 5000, bw, 25, 3, 40)
    assert [c[0] for c in toh.chain_dp(*args)] == [want]
    jax_host = chain - (int(dd * 0.01 * avg) + (log_dd >> 1))
    assert [c[0] for c in joh.chain_dp(*args)] == [jax_host]

    assert gap_penalty_table(avg, bw)[dd] == c64 + (log_dd >> 1)
    Q, A, J = 128, 256, 64
    lanes = [np.zeros((Q, A), np.int32) for _ in range(4)]
    for a, v in zip(lanes, (rid, pos, qp, spans)):
        a[0, :n_a] = v
    nb = np.zeros(Q, np.int32)
    nb[0] = n_a
    limbs = np.zeros((5, Q), np.int32)
    limbs[:, 0] = penalty_limbs(float(avg), bw)
    j = chain_dp_batch_pallas(*lanes, nb, limbs, np.zeros((1, Q), np.int32),
                              make_carry_pallas(Q, J), np.int32(0), J=J,
                              max_dist=5000, bw=bw, max_skip=25,
                              interpret=True)
    pen = torch.from_numpy(gap_penalty_table(avg, bw)[None])
    p = chain_dp_fill(*(t32(a) for a in lanes), t32(nb), pen,
                      max_dist=5000, bw=bw, max_skip=25)
    assert int(np.asarray(j[0])[0, n_a - 2]) == want
    assert int(np_(p[0])[0, n_a - 2]) == want


@pytest.mark.parametrize("case", ["filter", "ava"])
def test_hpc_engine_rows_match_jax_engine_and_host(case):
    if case == "filter":
        targets, queries = _filter_input()
        cfg_t, cfg_j = _cfgs(True)
    else:
        targets, queries = _ava_input()
        cfg_t, cfg_j = _cfgs(False, min_score_med=80, min_score_good=160)
    want = joh.overlap_run(list(targets), queries, cfg_j)
    assert overlap_run_device2(list(targets), queries, cfg_j) == want
    assert toh.overlap_run(list(targets), queries, cfg_t,
                           device="cpu") == want
    eng = DeviceOverlapEngine(cfg_t, queries, device="cpu")
    assert eng.run(list(targets)) == want
    assert eng.n_device_calls >= 1
    assert eng.n_host_fallback <= len(queries) // 10


def test_hpc_step_matches_jax_through_convert():
    """One HPC group through both packages' two-phase step, fed the
    same staged arrays (longqc_tpu_torch.convert): the (Q, 5) span
    statistics, then, with the per-row tables / limbs fitted from them,
    the committed state (avgk_val included), flags and events; two
    consecutive steps. Rows the JAX step flags F_KERNEL compare against
    the JAX engine's escalated (J = 128 / 256) rows."""
    targets, queries = _ava_input()
    cfg_t, cfg_j = _cfgs(False, min_score_med=80, min_score_good=160)
    k, w, Q, bw = 15, 10, tdo.GROUP_Q, cfg_t.map.bw
    jp = jdo._PartIndex(targets, k, w, 0, 2e-4, jdi.TILE_LADDER_SMALL,
                        jdi.N_IDX_SIZES_SMALL, hpc=True)
    jg = jdo._Group(list(range(len(queries))), queries, k, w, True,
                    hpc=True)
    qrank = np.full(Q, -1, np.int32)
    for r, q in enumerate(queries):
        qrank[r] = jp.name_rank.get(q[0], -1)
    qbisect = np.zeros(Q, np.int32)
    jcnt, jleft, jocc = jdo._count_expanded(
        jp.ih, jg.qh, jg.qcnt, jg.n_slots, jp.mid_occ, mcrop=jg.count_crop())
    idx = convert.index_from_arrays(jp.ih, jp.irid, jp.ips, jp.mid_occ,
                                    device="cpu")
    arrays = {n: np.asarray(getattr(jg, n)) for n in
              convert.GROUP_ARRAYS + convert.STATE_ARRAYS + convert.HPC_ARRAYS}
    g = convert.group_from_arrays(arrays, device="cpu")
    cnt, left, occ = tdo._count_expanded(idx["ih"], g["qh"], g["qcnt"],
                                         g["n_slots"], idx["mid_occ"],
                                         mcrop=jg.count_crop())
    np.testing.assert_array_equal(np_(cnt), np.asarray(jcnt))
    nq = np_(cnt)[:len(queries)]
    A = next(a for a in tdo.A_BUCKETS if a >= nq.max())
    jst = jdo._make_static(cfg_j, Q, jg.M, jg.M2, A, k, True)
    tst = tdo._make_static(cfg_t, jg.M, jg.M2, A, k)
    names = ("lam", "lam2", "avgk_set", "avgk_val", "m_cnts")
    jstate = [np.asarray(arrays[n]) for n in names]
    tstate = [g[n] for n in names]
    for _ in range(2):
        ja = jdo._step_hpc_a(
            jp.irid, jp.ips, jp.rid_rank, jp.mid_occ, jleft, jocc, jg.qps,
            jg.qcnt, jg.n_slots, jg.qspan, jg.qlen, jnp.asarray(qrank),
            jnp.asarray(qbisect), st=jst)
        tanch, tstats = tdo._step_hpc_a(
            idx["irid"], idx["ips"], t32(jp.rid_rank), idx["mid_occ"], left,
            occ, g["qps"], g["qcnt"], g["n_slots"], g["qspan"], g["qlen"],
            t32(qrank), t32(qbisect), tst)
        stats = np.asarray(ja[8])
        np.testing.assert_array_equal(np_(tstats), stats)
        limbs = np.zeros((5, Q), np.int32)
        pen = np.zeros((Q, bw + 1), np.int32)
        kept_avg = np.zeros(Q, np.float32)
        for r, (n_a, ssum, nk, kss, _nq) in enumerate(stats.tolist()):
            if nk > 0:
                kept_avg[r] = np.float32(kss / nk)
            if n_a > 0:
                avg_q = np.float32(ssum / n_a)
                limbs[:, r] = penalty_limbs(float(avg_q), bw)
                pen[r] = gap_penalty_table(avg_q, bw)
        def run_b(qvalid, jring):
            st = jdo._make_static(cfg_j, Q, jg.M, jg.M2, A, k, True,
                                  jring=jring)
            return jdo._step_hpc_b(
                *ja[:8], jp.seq_lens, jg.qlen,
                jg.qvalid if qvalid is None else qvalid, jg.n_exp,
                *[jnp.array(a, copy=True) for a in jstate],
                jnp.asarray(limbs), jnp.zeros((1, Q), jnp.int32),
                jnp.asarray(kept_avg), st=st)

        # the JAX engine's rows: F_KERNEL rows escalated to J = 128, then
        # host-fixed
        jfin, jflags, jev, _, _ = jax_step_final(
            run_b, Q, jax_host_fix(cfg_j, queries, jg, jp, names, jstate),
            n_state=5)
        tout = tdo._step_hpc_b(
            tanch, t32(jp.seq_lens), g["qlen"], g["qvalid"], g["n_exp"],
            *tstate, torch.from_numpy(pen), torch.from_numpy(kept_avg), tst)
        for a, b in zip(jfin, tout[:5]):
            np.testing.assert_array_equal(a, np_(b))
        tflags = np_(tout[5])[:Q]
        assert not (tflags & jdo.F_KERNEL).any()
        np.testing.assert_array_equal(jflags & ~jdo.F_KERNEL, tflags)
        assert (jflags[:len(queries)] == 0).sum() > len(queries) // 2
        assert jev == _events(np_(tout[5]), Q, np_(tout[6]))
        assert np_(tout[3]).sum() > 0          # avgk_val was set
        jstate, tstate = jfin, list(tout[:5])

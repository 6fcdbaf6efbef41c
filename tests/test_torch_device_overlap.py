"""Port engine (engine/device_overlap, plain kernel versions on CPU
tensors) vs the JAX engine: the count pass and one step fed identical
inputs through longqc_tpu_torch.convert, and whole-run rows. Every
comparison is exact (integers, event multisets, TSV rows)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_util import np_, t32

from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import device_index as jdi
from longqc_tpu.engine import device_overlap as jdo
from longqc_tpu.engine import overlap_host as joh
from longqc_tpu.ops.chain_pallas import penalty_limbs
from longqc_tpu_torch import convert
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_overlap as tdo
from longqc_tpu_torch.ops.chain import gap_penalty_table
from util_synth import make_genome, sample_reads


def _cfgs(k=12, w=5, **kw):
    t = OverlapConfig(index=IndexOpt(k=k, w=w),
                      map=MapOpt(min_score_med=80, min_score_good=160),
                      flt=FltOpt(min_ovlp=0), **kw)
    j = JOverlapConfig(index=JIndexOpt(k=k, w=w),
                       map=JMapOpt(min_score_med=80, min_score_good=160),
                       flt=JFltOpt(min_ovlp=0), **kw)
    return t, j


def _small(err=0.12):
    rng = np.random.RandomState(11)
    genome = make_genome(rng, 30000)
    reads = sample_reads(rng, genome, 150, min_len=700, max_len=2200,
                         err=err, junk_frac=0.1)
    return reads, reads[:40]


def _events(packed, Q, full):
    """Per-row sorted event lists from a packed [flags|ev_n|events]."""
    packed = np.asarray(packed)
    en = packed[Q:2 * Q]
    out, off = [], 0
    if en.sum() > jdo.EV_B:
        full = np.asarray(full)
        return [sorted(full[r, :en[r]].tolist()) for r in range(Q)]
    ev = packed[2 * Q:]
    for r in range(Q):
        out.append(sorted(ev[off:off + en[r]].tolist()))
        off += en[r]
    return out


def jax_step_final(run, Q, host_fix, n_state=4):
    """The JAX step as its engine resolves it: rows flagged F_KERNEL
    (chain-ring truncation) re-run alone at J = 128 from the same state,
    and the rows still flagged are recomputed by the JAX engine's exact
    host fix (its engine tries J = 256 before that; both are exact).
    `run(qvalid, jring)` runs one JAX step, whose output is n_state
    state arrays, the packed pull and the full events; `host_fix(rows)`
    returns the host-fixed state arrays and those rows' events. Returns
    the committed state, the flags, the per-row events, and the numbers
    of rows resolved at J = 128 and by the host fix."""
    out = run(None, jdo.J)
    state = [np.array(a) for a in out[:n_state]]
    packed, full = out[n_state], out[n_state + 1]
    flags = np.asarray(packed)[:Q].copy()
    ev = _events(packed, Q, full)
    rows = np.nonzero(flags == jdo.F_KERNEL)[0]
    n_esc = n_host = 0
    if len(rows):
        qv = np.zeros(Q, np.int32)
        qv[rows] = 1
        re = run(jnp.asarray(qv), 2 * jdo.J)
        rflags = np.asarray(re[n_state])[:Q]
        rev = _events(re[n_state], Q, re[n_state + 1])
        for r in rows:
            flags[r] = rflags[r]
            ev[r] = rev[r]
            if not rflags[r]:
                n_esc += 1
                for a, b in zip(state, re[:n_state]):
                    a[r] = np.asarray(b)[r]
    rows = np.nonzero(flags == jdo.F_KERNEL)[0]
    if len(rows):
        hstate, hev = host_fix(rows)
        for i, r in enumerate(rows):
            flags[r] = 0
            ev[r] = hev[i]
            n_host += 1
            for a, b in zip(state, hstate):
                a[r] = b[r]
    return state, flags, ev, n_esc, n_host


def jax_host_fix(cfg_j, queries, jg, jp, names, state):
    """host_fix for jax_step_final: the JAX engine's _host_fix of `rows`
    from the pre-step `state` (arrays named `names` on the group)."""
    def fix(rows):
        eng = jdo.DeviceOverlapEngine(cfg_j, queries, interpret=True)
        for n, a in zip(names, state):
            setattr(jg, n, jnp.asarray(a))
        eng._host_fix(jg, jp, [int(r) for r in rows], None)
        return ([np.asarray(getattr(jg, n)) for n in names],
                [sorted(eng.events[jg.qids[r]]) for r in rows])
    return fix


@pytest.mark.parametrize("err,k,w", [(0.12, 12, 5), (0.04, 12, 5),
                                     (0.04, 19, 10)],
                         ids=["0.12", "0.04", "wide-k19"])
def test_count_and_step_match_jax_through_convert(err, k, w):
    """At err 0.04 anchor windows run deeper than the JAX chain ring of
    64: rows the JAX step flags F_KERNEL and its engine resolves at a
    deeper ring or on the host, which the port resolves in one step. At
    k = 19 the index and query hashes ride int64 lanes through convert,
    the count pass and the step."""
    reads, queries = _small(err)
    cfg_t, cfg_j = _cfgs(k, w)
    Q = tdo.GROUP_Q
    jp = jdo._PartIndex(reads, k, w, 0, 2e-4, jdi.TILE_LADDER_SMALL,
                        jdi.N_IDX_SIZES_SMALL)
    jg = jdo._Group(list(range(len(queries))), queries, k, w, True)
    qrank = np.full(Q, -1, np.int32)
    for r, q in enumerate(queries):
        qrank[r] = jp.name_rank.get(q[0], -1)
    qbisect = np.zeros(Q, np.int32)

    jcnt, jleft, jocc = jdo._count_expanded(
        jp.ih, jg.qh, jg.qcnt, jg.n_slots, jp.mid_occ, mcrop=jg.count_crop())
    idx = convert.index_from_arrays(jp.ih, jp.irid, jp.ips, jp.mid_occ,
                                    device="cpu")
    arrays = {n: np.asarray(getattr(jg, n))
              for n in convert.GROUP_ARRAYS + convert.STATE_ARRAYS}
    g = convert.group_from_arrays(arrays, device="cpu")
    hdt = torch.int64 if 2 * k > 30 else torch.int32
    assert idx["ih"].dtype == g["qh"].dtype == hdt
    cnt, left, occ = tdo._count_expanded(idx["ih"], g["qh"], g["qcnt"],
                                         g["n_slots"], idx["mid_occ"],
                                         mcrop=jg.count_crop())
    assert np.array_equal(np_(cnt), np.asarray(jcnt))
    assert np.array_equal(np_(left), np.asarray(jleft))
    assert np.array_equal(np_(occ), np.asarray(jocc))

    nq = np_(cnt)[:len(queries)]
    A = next(a for a in tdo.A_BUCKETS if a >= nq.max())
    tst = tdo._make_static(cfg_t, jg.M, jg.M2, A, k)
    limbs5 = jnp.asarray(penalty_limbs(float(np.float32(k)), cfg_j.map.bw))
    pen = torch.from_numpy(gap_penalty_table(np.float32(k),
                                             cfg_t.map.bw))[None, :]
    jstate = [np.asarray(arrays[n]) for n in convert.STATE_ARRAYS]
    tstate = [g[n] for n in convert.STATE_ARRAYS]
    n_esc = n_host = 0
    # two consecutive steps: the second starts from a nonzero state
    for _ in range(2):
        def run(qvalid, jring):
            jst = jdo._make_static(cfg_j, Q, jg.M, jg.M2, A, k, True,
                                   jring=jring)
            return jdo._step(
                jp.irid, jp.ips, jp.seq_lens, jp.rid_rank, jp.mid_occ,
                jleft, jocc, jg.qps, jg.qcnt, jg.n_slots, jg.n_exp,
                jg.qlen, jnp.asarray(qrank), jnp.asarray(qbisect),
                jg.qvalid if qvalid is None else qvalid,
                *[jnp.array(a, copy=True) for a in jstate], limbs5, st=jst)

        jfin, jflags, jev, esc, host = jax_step_final(
            run, Q, jax_host_fix(cfg_j, queries, jg, jp,
                                 convert.STATE_ARRAYS, jstate))
        n_esc += esc
        n_host += host
        tout = tdo._step_impl(
            idx["irid"], idx["ips"], t32(jp.seq_lens), t32(jp.rid_rank),
            idx["mid_occ"], left, occ, g["qps"], g["qcnt"], g["n_slots"],
            g["n_exp"], g["qlen"], t32(qrank), t32(qbisect), g["qvalid"],
            *tstate, pen, tst)
        # the port scans whole windows: it never flags F_KERNEL, and its
        # rows equal the JAX engine's after the J escalation
        for a, b in zip(jfin, tout[:4]):       # lam lam2 avgk m_cnts
            assert np.array_equal(a, np_(b))
        tflags = np_(tout[4])[:Q]
        assert not (tflags & jdo.F_KERNEL).any()
        assert np.array_equal(jflags & ~jdo.F_KERNEL, tflags)
        assert (jflags[:len(queries)] == 0).sum() > len(queries) // 2
        assert jev == _events(np_(tout[4]), Q, np_(tout[5]))
        assert np_(tout[0]).sum() > 0
        jstate, tstate = jfin, list(tout[:4])
    if k == 12:
        assert (n_esc + n_host > 0) == (err < 0.1)


def test_rows_match_jax_engine_small():
    reads, queries = _small()
    cfg_t, cfg_j = _cfgs()
    rows_j = jdo.overlap_run_device2(list(reads), queries, cfg_j)
    eng = tdo.DeviceOverlapEngine(cfg_t, queries, device="cpu")
    rows_t = eng.run(list(reads))
    assert rows_t == rows_j
    assert eng.n_device_calls >= 1 and eng.n_host_fallback == 0


def test_rows_match_jax_host_filter_mode():
    rng = np.random.RandomState(3)
    genome = make_genome(rng, 15000)
    reads = sample_reads(rng, genome, 80, min_len=600, max_len=1500,
                         err=0.1, junk_frac=0.1)
    queries = reads[:16]
    cfg_t, cfg_j = _cfgs(filter_mode=True)
    want = joh.overlap_run(list(reads), queries, cfg_j)
    got = tdo.overlap_run_device2(list(reads), queries, cfg_t, device="cpu")
    assert got == want


def test_rows_match_jax_host_host_only_boundary():
    rng = np.random.RandomState(41)
    genome = make_genome(rng, 20000)
    reads = sample_reads(rng, genome, 90, min_len=600, max_len=1800,
                         err=0.12, junk_frac=0.1)
    queries = reads[:24]
    cfg_t, cfg_j = _cfgs()
    want = joh.overlap_run(list(reads), queries, cfg_j)
    eng = tdo.DeviceOverlapEngine(cfg_t, queries, device="cpu")
    eng.n_idx_sizes = (1 << 10,)     # the part passes the width ladder
    eng.max_index_entries = 1 << 10  # and the entries an index may hold
    assert eng.run(list(reads)) == want
    assert eng.n_host_only_parts == 1 and eng.n_hash_range_parts == 0
    assert eng.n_host_fallback == len(queries)


def test_geom_ok_is_the_literal_f64_comparison():
    rng = np.random.RandomState(1)
    for ratio in (0.4, 0.5, 0.25, 0.75, 0.3):
        tot = np.concatenate([rng.randint(1, 1 << 30, size=3000),
                              np.arange(1, 2000) * 5,
                              np.arange(1, 2000) * 4]).astype(np.int64)
        base = np.floor(tot.astype(np.float64) * ratio).astype(np.int64)
        for off in (-1, 0, 1):
            a = np.maximum(base + off, 1)
            want = a.astype(np.float64) >= tot.astype(np.float64) * ratio
            got = tdo._geom_ok(torch.from_numpy(a), torch.from_numpy(tot),
                               ratio)
            assert np.array_equal(np_(got), want), ratio


@pytest.mark.parametrize("mc", [16, 32, 64])
def test_count_crop_matches_jax(mc):
    rng = np.random.RandomState(7)
    Q, M, N = 8, 64, 4096
    ih = np.sort(rng.randint(0, 1 << 20, N).astype(np.int32))
    ih[-N // 8:] = np.iinfo(np.int32).max
    ih = np.sort(ih)
    qh = rng.randint(0, 1 << 20, (Q, M)).astype(np.int32)
    qcnt = rng.randint(1, 4, (Q, M)).astype(np.int32)
    n_slots = rng.randint(0, mc + 1, Q).astype(np.int32)
    want = jdo._count_expanded(jnp.asarray(ih), jnp.asarray(qh),
                               jnp.asarray(qcnt), jnp.asarray(n_slots),
                               jnp.int32(8), mcrop=mc)
    got = tdo._count_expanded(t32(ih), t32(qh), t32(qcnt), t32(n_slots),
                              torch.tensor(8, dtype=torch.int32), mcrop=mc)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), np_(b))

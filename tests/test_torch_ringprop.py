"""B3 / B4 plain versions (ops/ringprop on CPU tensors) vs the JAX
Pallas ring passes in interpret mode and the numpy chainsel spec."""

import numpy as np
import pytest
import torch
from torch_util import np_, t32

from longqc_tpu.ops.chainsel import INF_RANK, chain_ranks, compute_peaks
from longqc_tpu.ops.ringprop import minrank_pass as jax_minrank
from longqc_tpu.ops.ringprop import peak_pass as jax_peak
from longqc_tpu_torch.ops import chainsel as tcs
from longqc_tpu_torch.ops.ringprop import minrank_pass, peak_pass


def _forest(rng, n, J):
    f = rng.randint(1, 200, size=n).astype(np.int64)
    p = np.full(n, -1, np.int64)
    v = f.copy()
    for i in range(n):
        if i > 0 and rng.rand() < 0.85:
            p[i] = rng.randint(max(0, i - J), i)
            v[i] = max(f[i], v[p[i]])
    return f, p, v


def _batch(J, Q=8, A=512, seed=5):
    rng = np.random.RandomState(seed)
    fs = np.zeros((Q, A), np.int32)
    ps = np.full((Q, A), -1, np.int32)
    vs = np.zeros((Q, A), np.int32)
    owns = np.full((Q, A), INF_RANK, np.int32)
    ns, peaks, ranks = [], [], []
    for q in range(Q):
        n = rng.randint(1, A + 1)
        f, p, v = _forest(rng, n, J)
        fs[q, :n], ps[q, :n], vs[q, :n] = f, p, v
        peaks.append(compute_peaks(f, p, v))
        rank, order = chain_ranks(f, p, v, n, min_sc=30)
        ranks.append(rank)
        owns[q, order] = np.arange(len(order))
        ns.append(n)
    return fs, ps, vs, owns, ns, peaks, ranks


@pytest.mark.parametrize("J", [64, 128])
def test_peak_and_minrank_plain_match_pallas_and_spec(J):
    fs, ps, vs, owns, ns, peaks, ranks = _batch(J, seed=J)
    pk = np_(peak_pass(t32(fs), t32(vs), t32(ps), J=J))
    mr = np_(minrank_pass(t32(ps), t32(owns), J=J))
    jpk = np.asarray(jax_peak(fs.T, vs.T, ps.T, J=J, interpret=True)).T
    jmr = np.asarray(jax_minrank(ps.T, owns.T, J=J, interpret=True)).T
    assert np.array_equal(pk, jpk)
    assert np.array_equal(mr, jmr)
    for q, n in enumerate(ns):
        assert np.array_equal(pk[q, :n], peaks[q]), q
        assert np.array_equal(mr[q, :n], ranks[q]), q


def test_parents_outside_the_ring_read_as_empty_slots():
    # garbage parents (p >= i, or further back than J) of flagged rows:
    # both versions must still agree with the TPU kernels' ring semantics
    rng = np.random.RandomState(3)
    Q, A, J = 4, 256, 64
    fs = rng.randint(0, 50, (Q, A)).astype(np.int32)
    vs = fs + rng.randint(0, 3, (Q, A)).astype(np.int32)
    ps = rng.randint(-1, A, (Q, A)).astype(np.int32)
    owns = np.where(rng.rand(Q, A) < 0.2, rng.randint(0, 99, (Q, A)),
                    INF_RANK).astype(np.int32)
    pk = np_(peak_pass(t32(fs), t32(vs), t32(ps), J=J))
    mr = np_(minrank_pass(t32(ps), t32(owns), J=J))
    assert np.array_equal(pk, np.asarray(
        jax_peak(fs.T, vs.T, ps.T, J=J, interpret=True)).T)
    assert np.array_equal(mr, np.asarray(
        jax_minrank(ps.T, owns.T, J=J, interpret=True)).T)


def test_chainsel_copy_matches_jax_package():
    fs, ps, vs, _owns, ns, _pk, _rk = _batch(64, Q=4, seed=9)
    from longqc_tpu.ops.chainsel import select_chains as jsel
    for q, n in enumerate(ns):
        a = tcs.select_chains(fs[q], ps[q], vs[q], n, 3, 30)
        b = jsel(fs[q], ps[q], vs[q], n, 3, 30)
        assert [(s, i.tolist()) for s, i in a] == \
            [(s, i.tolist()) for s, i in b]
        assert torch.equal(torch.as_tensor(tcs.compute_peaks(
            fs[q, :n], ps[q, :n], vs[q, :n])), torch.as_tensor(
            compute_peaks(fs[q, :n], ps[q, :n], vs[q, :n])))

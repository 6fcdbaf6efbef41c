"""The schedules of the chunked B3 / B4 kernels (csrc/ringprop.cu),
replayed on the CPU.

A numpy port of each kernel's schedule, for one row: chunks of C
anchors (B3 forward, B4 backward from the last chunk), B3's state words
resolved by pointer-jumping rounds, B4's subtree minima by doubling
rounds with the early stop, B4's handoffs to earlier chunks through the
output row and a pending bitmask (first handoff stores, the rest take
the minimum after a barrier). Inside a round the threads run in a
random order and update in place, as the kernels let them. The replay
must equal the plain versions (ops/ringprop) and the JAX Pallas kernels
in interpret mode, exactly, and take at most ceil(log2 C) + 1 rounds a
chunk."""

import math

import numpy as np
import pytest
from torch_util import np_, t32

from longqc_tpu.ops.chainsel import INF_RANK
from longqc_tpu.ops.ringprop import minrank_pass as jax_minrank
from longqc_tpu.ops.ringprop import peak_pass as jax_peak
from longqc_tpu_torch.ops.ringprop import (INF32, minrank_pass_plain,
                                           peak_pass_plain)

GARBAGE = -987654       # what torch.empty may hold before a write


def peak_replay(f, v, p, J, C, rng):
    """lq_peak_kernel on one row -> (peak, rounds per chunk)."""
    A = len(f)
    out = np.full(A, GARBAGE, np.int64)
    rounds = []
    for c0 in range(0, A, C):
        gi = np.arange(c0, min(A, c0 + C))
        n = len(gi)
        pi = p[gi]
        walk = (v[gi] > f[gi]) & (pi >= 0) & (gi - pi <= J)
        # state word: peak + 1 >= 0 when final, -1 - local pointer else
        st = np.where(~walk, gi + 1, np.where(
            pi >= gi, 0, np.where(pi >= c0, -1 - (pi - c0),
                                  out[np.clip(pi, 0, A - 1)] + 1)))
        k = 0
        while (st < 0).any():
            for i in rng.permutation(n):
                if st[i] < 0:
                    st[i] = st[-1 - st[i]]
            k += 1
        rounds.append(k)
        out[gi] = st - 1
    return out, rounds


def minrank_replay(p, own, J, C, rng):
    """lq_minrank_kernel on one row -> (min-rank, rounds per chunk)."""
    A = len(p)
    r = np.full(A, GARBAGE, np.int64)
    mark = np.zeros(A, bool)
    nch = -(-A // C)
    rounds = []
    for s in range(nch):
        c0 = (nch - 1 - s) * C
        gi = np.arange(c0, min(A, c0 + C))
        n = len(gi)
        pi = p[gi]
        M = np.where(mark[gi], np.minimum(own[gi], r[gi]), own[gi])
        edge = (pi >= 0) & (pi < gi) & (gi - pi <= J)
        anc = np.where(edge & (pi >= c0), pi - c0, -1)
        hand = np.where(edge & (pi < c0), pi, -1)
        k = 0
        while ((anc >= 0) & (M != INF32)).any():
            nxt = np.full(n, -1)
            for i in rng.permutation(n):        # push in place
                a = anc[i]
                if a >= 0:
                    if M[i] < M[a]:
                        M[a] = min(M[a], M[i])
                    nxt[i] = anc[a]
            anc = nxt                           # jump after the barrier
            k += 1
        rounds.append(k)
        r[gi] = M
        lose = []
        for i in rng.permutation(n):
            hp = hand[i]
            if hp >= 0 and M[i] != INF32:
                if mark[hp]:
                    lose.append(i)
                else:
                    mark[hp] = True
                    r[hp] = M[i]
        for i in lose:                          # after the barrier
            r[hand[i]] = min(r[hand[i]], M[i])
    return r, rounds


def _rows(case, rng, Q, A, J):
    """(Q, A) f / v / p / own of one kind of row."""
    ii = np.arange(A)
    f = rng.randint(1, 200, (Q, A))
    v = f + (rng.rand(Q, A) < 0.8) * rng.randint(1, 40, (Q, A))
    p = np.full((Q, A), -1)
    own = np.full((Q, A), INF_RANK)
    for q in range(Q):
        if case == "path":              # one chain of depth A
            p[q] = ii - 1
            v[q] = f[q] + 1
            if q % 2:
                own[q, -1] = 7          # a single chain end
            else:
                own[q] = A - ii         # the deepest anchor is smallest
        elif case == "garbage":         # parents anywhere, p >= i too
            p[q] = rng.randint(-1, A, A)
            own[q] = np.where(rng.rand(A) < 0.2, rng.randint(0, 99, A),
                              INF_RANK)
        else:                           # chains of 10-300 links
            for i in range(1, A):
                if rng.rand() < 0.9:
                    d = 1 + rng.geometric(0.3)
                    if rng.rand() < 0.02:
                        d = rng.randint(1, i + 1)
                    p[q, i] = max(i - d, -1)
            if case == "engine":        # ranks at the peaks of chain ends
                ends = np.ones(A, bool)
                ends[p[q][p[q] >= 0]] = False
                pk = _peaks(f[q], v[q], p[q], J)
                own[q, np.unique(pk[ends])] = rng.permutation(
                    len(np.unique(pk[ends])))
            else:
                own[q] = np.where(rng.rand(A) < 0.3,
                                  rng.randint(0, 500, A), INF_RANK)
    return [a.astype(np.int32) for a in (f, v, p, own)]


def _peaks(f, v, p, J):
    pk = np_(peak_pass_plain(t32(f[None]), t32(v[None]), t32(p[None]),
                             J=J))[0]
    return np.where(pk >= 0, pk, np.arange(len(f)))


@pytest.mark.parametrize("C", [32, 4096])
@pytest.mark.parametrize("J", ["64", "A"])
@pytest.mark.parametrize("case", ["forest", "engine", "path", "garbage"])
def test_chunk_schedules_match_plain_and_pallas(case, J, C):
    Q, A = 4, 512
    J = A if J == "A" else int(J)
    rng = np.random.RandomState(len(case) * 31 + J + C)
    f, v, p, own = _rows(case, rng, Q, A, J)
    pk = np.stack([peak_replay(f[q], v[q], p[q], J, C, rng)[0]
                   for q in range(Q)])
    mr = np.stack([minrank_replay(p[q], own[q], J, C, rng)[0]
                   for q in range(Q)])
    assert np.array_equal(pk, np_(peak_pass_plain(t32(f), t32(v), t32(p),
                                                  J=J)))
    assert np.array_equal(mr, np_(minrank_pass_plain(t32(p), t32(own),
                                                     J=J)))
    assert np.array_equal(pk, np.asarray(
        jax_peak(f.T, v.T, p.T, J=J, interpret=True)).T)
    assert np.array_equal(mr, np.asarray(
        jax_minrank(p.T, own.T, J=J, interpret=True)).T)


@pytest.mark.parametrize("C", [16, 64, 256])
def test_rounds_stay_logarithmic_on_a_depth_a_path(C):
    # a single path p[i] = i - 1 crosses every chunk boundary; each chunk
    # still resolves in at most ceil(log2 C) + 1 rounds, and the value of
    # the deepest anchor reaches the root through every handoff
    A = 1024
    rng = np.random.RandomState(C)
    ii = np.arange(A)
    f = np.ones(A, np.int32)
    v = f + 1
    p = (ii - 1).astype(np.int32)
    own = (A - ii).astype(np.int32)
    pk, pr = peak_replay(f, v, p, A, C, rng)
    mr, mrr = minrank_replay(p, own, A, C, rng)
    assert (pk == 0).all() and (mr == 1).all()
    cap = math.ceil(math.log2(C)) + 1
    assert len(pr) == len(mrr) == A // C
    assert max(pr) <= cap and max(mrr) <= cap
    assert max(mrr) >= cap - 1          # the doubling does run that deep

"""B2 plain version (ops/chain_cuda.chain_dp_fill on CPU tensors), which
scans each anchor's whole admissible window, against the JAX Pallas
chain kernel in interpret mode (J-deep ring) and the host specs: f, p, v
exactly on every row the Pallas kernel leaves unflagged; on the rows it
flags (ring truncation), the chains built from the port's f, p, v equal
the JAX package's overlap_host.chain_dp (k = 12, where its f32 gap cost
agrees with f64), and a window deeper than 256 ages gets the host
spec's f, p, v."""

import numpy as np
import pytest
import torch
from torch_util import np_, t32

from longqc_tpu.engine import overlap_host as joh
from longqc_tpu.ops.chain_pallas import (chain_dp_batch_pallas,
                                         make_carry_pallas, penalty_limbs)
from longqc_tpu_torch.engine import overlap_host as toh
from longqc_tpu_torch.ops.chain import gap_penalty_table, window_depths
from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill

Q, BW, K, MAX_DIST, MAX_SKIP = 128, 500, 12, 10000, 25
MIN_CNT, MIN_SC = 3, 40


def _rows(rng, A, dense):
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aq = np.zeros((Q, A), np.int32)
    nb = np.zeros(Q, np.int32)
    for r in range(Q):
        if dense:
            # >J anchors inside max_dist with mostly invalid pairings:
            # the truncation regime of (AT)n reads (one row in four
            # shorter than any ring)
            n = rng.randint(20, 60) if r % 4 == 0 else \
                rng.randint(70, min(A, 200))
            pos = np.sort(rng.randint(0, 3000, n))
            q = rng.randint(0, 20000, n)
            d = rng.rand(n) < 0.2
            q[d] = np.clip(pos[d] + rng.randint(-50, 50, d.sum()), 0, None)
        else:
            n = rng.randint(40, A)
            grp = np.sort(rng.randint(0, rng.randint(1, 4), n))
            pos = np.sort(rng.randint(0, 20000, n))
            q = np.clip(pos - 5000 + rng.randint(0, 3, n)
                        * rng.randint(1, 400) + rng.randint(-40, 40, n),
                        0, None)
            axh[r, :n] = grp
        nb[r] = n
        axl[r, :n] = pos
        aq[r, :n] = q
    return axh, axl, aq, nb


def _jax(axh, axl, aq, nb, J):
    A = axh.shape[1]
    limbs = np.repeat(penalty_limbs(float(K), BW)[:, None], Q, axis=1)
    rbad = np.zeros((1, Q), np.int32)
    return chain_dp_batch_pallas(
        axh, axl, aq, np.full((Q, A), K, np.int32), nb, limbs, rbad,
        make_carry_pallas(Q, J), np.int32(0), J=J, max_dist=MAX_DIST, bw=BW,
        max_skip=MAX_SKIP, interpret=True)


def _port(axh, axl, aq, nb):
    pen = torch.from_numpy(gap_penalty_table(np.float32(K), BW))[None, :]
    f, p, v = chain_dp_fill(t32(axh), t32(axl), t32(aq),
                            torch.full(axh.shape, K, dtype=torch.int32),
                            t32(nb), pen, max_dist=MAX_DIST, bw=BW,
                            max_skip=MAX_SKIP)
    return np_(f), np_(p), np_(v)


def _host_row(axh, axl, aq, n):
    """A row as the host spec's (ax, ay) u64 anchors (span K)."""
    ax = (axh[:n].astype(np.uint64) << np.uint64(32)) | \
        axl[:n].astype(np.uint64)
    ay = (np.uint64(K) << np.uint64(32)) | aq[:n].astype(np.uint64)
    return ax, ay


def _depth(axh, axl, nb):
    return np_(window_depths(t32(axh), t32(axl), t32(nb), MAX_DIST))


@pytest.mark.parametrize("J", [64, 128])
@pytest.mark.parametrize("dense", [False, True], ids=["spread", "dense"])
def test_chain_fill_plain_matches_pallas(J, dense):
    rng = np.random.RandomState(J + dense)
    rows = _rows(rng, 256 if dense else 512, dense)
    axh, axl, aq, nb = rows
    jf, jp, jv, jfl = (np.asarray(a) for a in _jax(*rows, J)[:4])
    f, p, v = _port(*rows)
    flagged = jfl != 0
    clean = ~flagged
    assert clean.sum() > 0
    for a, b in ((jf, f), (jp, p), (jv, v)):
        np.testing.assert_array_equal(a[clean], b[clean])
    # the Pallas kernel's flags come from ring truncation alone: every
    # flagged row has an anchor whose window reaches J ages, so its
    # second max_skip pass never changed a row the ring held
    depth = _depth(axh, axl, nb).max(axis=1)
    assert (depth[flagged] >= J).all()
    if dense and J == 64:
        assert flagged.sum() > Q // 2        # the dense rows truncate
    if not dense:
        assert flagged.sum() < Q
    # flagged rows: the chains of the port's f, p, v are the JAX host
    # spec's
    for r in np.nonzero(flagged)[0]:
        n = int(nb[r])
        ax, ay = _host_row(axh[r], axl[r], aq[r], n)
        want = joh.chain_dp(ax, ay, MAX_DIST, BW, MAX_SKIP, MIN_CNT, MIN_SC)
        got = toh.chain_backtrack(f[r, :n], p[r, :n].astype(np.int64),
                                  v[r, :n], MIN_CNT, MIN_SC)
        assert [c[0] for c in got] == [c[0] for c in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[1], b[1])


def test_chain_fill_deep_window_matches_host_spec():
    """Repeat-dense rows whose admissible windows exceed 256 ages (the
    Pallas kernel flags them at its deepest ring, J = 256, and the JAX
    engine sends them to the host spec): the port's fill equals the
    host spec's f, p, v on every row."""
    rng = np.random.RandomState(7)
    R, A = 8, 640
    axh = np.zeros((R, A), np.int32)
    axl = np.zeros((R, A), np.int32)
    aq = np.zeros((R, A), np.int32)
    nb = rng.randint(400, A, R).astype(np.int32)
    for r in range(R):
        n = nb[r]
        pos = np.sort(rng.randint(0, 1500, n))
        q = rng.randint(0, 30000, n)
        d = rng.rand(n) < 0.3
        q[d] = np.clip(pos[d] + rng.randint(-30, 30, d.sum()), 0, None)
        axl[r, :n] = pos
        aq[r, :n] = q
    depth = _depth(axh, axl, nb).max(axis=1)
    assert (depth > 256).all()
    f, p, v = _port(axh, axl, aq, nb)
    for r in range(R):
        n = int(nb[r])
        hf, hp, hv = toh.chain_fill(*_host_row(axh[r], axl[r], aq[r], n),
                                    MAX_DIST, BW, MAX_SKIP)
        np.testing.assert_array_equal(f[r, :n], hf)
        np.testing.assert_array_equal(p[r, :n], hp)
        np.testing.assert_array_equal(v[r, :n], hv)
        assert (f[r, n:] == 0).all() and (p[r, n:] == -1).all()
    # parents deeper than any ring the JAX engine escalates to
    deep = (np.arange(A)[None, :] - p) > 256
    assert (deep & (p >= 0)).any()

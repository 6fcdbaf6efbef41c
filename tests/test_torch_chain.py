"""B2 plain version (ops/chain_cuda.chain_dp_fill on CPU tensors) vs
the JAX Pallas chain kernel in interpret mode: f, p, v, flags and the
carry exactly, at J = 64 and 128, including repeat-dense rows that
flag and chunked against monolithic calls."""

import numpy as np
import pytest
import torch
from torch_util import np_, t32

from longqc_tpu.ops.chain_pallas import (chain_dp_batch_pallas,
                                         make_carry_pallas, penalty_limbs)
from longqc_tpu_torch.ops.chain import gap_penalty_table, make_carry
from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill

Q, BW = 128, 500


def _rows(rng, A, dense):
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aq = np.zeros((Q, A), np.int32)
    nb = np.zeros(Q, np.int32)
    for r in range(Q):
        if dense:
            # >J anchors inside max_dist with mostly invalid pairings:
            # the truncation regime of (AT)n reads
            n = rng.randint(70, min(A, 200))
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


def _jax(axh, axl, aq, nb, J, c0=0, carry=None):
    A = axh.shape[1]
    limbs = np.repeat(penalty_limbs(12.0, BW)[:, None], Q, axis=1)
    rbad = np.zeros((1, Q), np.int32)
    return chain_dp_batch_pallas(
        axh, axl, aq, np.full((Q, A), 12, np.int32), nb, limbs, rbad,
        carry if carry is not None else make_carry_pallas(Q, J),
        np.int32(c0), J=J, max_dist=10000, bw=BW, max_skip=25,
        interpret=True)


def _port(axh, axl, aq, nb, J, c0=0, carry=None):
    A = axh.shape[1]
    pen = torch.from_numpy(gap_penalty_table(np.float32(12), BW))[None, :]
    return chain_dp_fill(t32(axh), t32(axl), t32(aq),
                         torch.full((Q, A), 12, dtype=torch.int32), t32(nb),
                         pen, carry if carry is not None else make_carry(Q, J),
                         c0, J=J, max_dist=10000, bw=BW, max_skip=25)


def _assert_same(j, p):
    f0, p0, v0, fl0, c0 = j
    f1, p1, v1, fl1, c1 = p
    assert np.array_equal(np.asarray(f0), np_(f1))
    assert np.array_equal(np.asarray(p0), np_(p1))
    assert np.array_equal(np.asarray(v0), np_(v1))
    assert np.array_equal(np.asarray(fl0), np_(fl1))
    for c in range(7):   # JAX carry rings are (J, Q)
        assert np.array_equal(np.asarray(c0[c]).T, np_(c1[0][c])), c
    assert np.array_equal(np.asarray(c0[7]).reshape(-1), np_(c1[1]))


@pytest.mark.parametrize("J", [64, 128])
@pytest.mark.parametrize("dense", [False, True], ids=["spread", "dense"])
def test_chain_fill_plain_matches_pallas(J, dense):
    rng = np.random.RandomState(J + dense)
    rows = _rows(rng, 256 if dense else 512, dense)
    j = _jax(*rows, J)
    p = _port(*rows, J)
    _assert_same(j, p)
    nflag = int(np.asarray(j[3]).sum())
    if dense and J == 64:
        assert nflag > Q // 2          # the dense rows truncate the ring
    if not dense:
        assert nflag < Q


def test_chain_fill_chunked_equals_monolithic():
    rng = np.random.RandomState(7)
    A, J, H = 512, 64, 256
    axh, axl, aq, nb = _rows(rng, A, False)
    mono = _port(axh, axl, aq, nb, J)
    _assert_same(_jax(axh, axl, aq, nb, J), mono)
    carry = make_carry(Q, J)
    parts = []
    for c0 in (0, H):
        sl = slice(c0, c0 + H)
        out = _port(axh[:, sl], axl[:, sl], aq[:, sl], nb, J, c0=c0,
                    carry=carry)
        carry = out[4]
        parts.append(out)
    for i in range(3):
        assert np.array_equal(np_(mono[i]),
                              np.concatenate([np_(o[i]) for o in parts], 1))
    assert np.array_equal(np_(mono[3]), np_(parts[0][3] | parts[1][3]))
    assert np.array_equal(np_(mono[4][0]), np_(carry[0]))

"""The CUDA kernels against their plain versions on the card (marked
`cuda`: they need a GPU and nvcc, and skip elsewhere). chip_smoke.py
runs the same comparisons at production shapes."""

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.ops import extend as ext
from longqc_tpu_torch.ops import ringprop as rp
from longqc_tpu_torch.ops import sketch_cuda as skc
from longqc_tpu_torch.ops.chain import (chain_dp_batch, gap_penalty_table,
                                        make_carry)
from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_sketch_kernel_matches_plain(dev):
    rng = np.random.RandomState(1)
    b = di._TileBuilder(16, 2048, 4)
    for i in range(200):
        s = "".join(rng.choice(list("ACGTN"), p=[.24, .24, .24, .24, .04],
                               size=rng.randint(50, 900)))
        b.add(i, s + "AT" * rng.randint(0, 60))
    t = b.tiles()[0]
    args = [di.to_device_words(a, dev) for a in
            (t.codes2, t.nmask, t.startmask, t.endmask)] + \
        [torch.from_numpy(a).to(dev) for a in (t.starts, t.gids)]
    k = skc.sketch_tiles(*args, W=2048, k=12, w=5)
    p = skc.sketch_tiles_plain(*args, W=2048, k=12, w=5)
    assert torch.equal(k["emit"], p["emit"])
    on = p["emit"] > 0
    for f in ("hash", "rid", "pos", "strand"):
        assert torch.equal(k[f][on], p[f][on])


def _anchor_rows(rng, Q, A, dense):
    """Sorted anchor rows: diagonal-clustered (`dense` False) or
    repeat-dense position bands with scattered query positions, the
    regime whose rows flag (ring truncation / max_skip disagreement)."""
    pos = np.sort(rng.randint(0, 800 if dense else 6000, (Q, A)), axis=1)
    q = pos + rng.randint(-60, 60, (Q, A))
    if dense:
        far = rng.rand(Q, A) < 0.7
        q[far] = rng.randint(0, 20000, far.sum())
    n = rng.randint(50, A, Q)
    return [torch.from_numpy(a.astype(np.int32)) for a in
            (pos, np.clip(q, 0, None), n)]


@pytest.mark.parametrize("tables", ["one", "per_row"])
@pytest.mark.parametrize("dense", [False, True], ids=["spread", "dense"])
@pytest.mark.parametrize("J", [64, 128, 256])
def test_chain_and_ringprop_kernels_match_plain(dev, J, dense, tables):
    rng = np.random.RandomState(J + dense)
    Q, A = 128, 512
    axl, aq, n = (t.to(dev) for t in _anchor_rows(rng, Q, A, dense))
    axh = torch.zeros((Q, A), dtype=torch.int32, device=dev)
    span = torch.full((Q, A), 12, dtype=torch.int32, device=dev)
    # the plain engine's one (1, bw+1) table (row stride 0), or a
    # distinct table per row (the HPC engine's per-row avg_qspan)
    avg = [12] if tables == "one" else [12 + r / 7 for r in range(Q)]
    pen = torch.from_numpy(np.stack([
        gap_penalty_table(np.float32(a), 500) for a in avg])).to(dev)
    ko = chain_dp_fill(axh, axl, aq, span, n, pen, make_carry(Q, J, dev), 0,
                       J=J)
    po = chain_dp_batch(axh, axl, aq, span, n, pen, make_carry(Q, J, dev), 0,
                        J=J)
    for a, b in zip(ko[:4], po[:4]):
        assert torch.equal(a, b)
    assert torch.equal(ko[4][0], po[4][0])
    assert torch.equal(ko[4][1], po[4][1])
    if dense:
        assert bool(ko[3].any())
    # two chunks through the carry equal the monolithic call
    c = make_carry(Q, J, dev)
    parts = []
    for lo, hi in ((0, 200), (200, A)):
        sl = [t[:, lo:hi].contiguous() for t in (axh, axl, aq, span)]
        out = chain_dp_fill(*sl, n, pen, c, lo, J=J)
        c = out[4]
        parts.append(out[:3])
    for j in range(3):
        assert torch.equal(torch.cat([parts[0][j], parts[1][j]], dim=1),
                           ko[j])
    assert torch.equal(c[0], ko[4][0]) and torch.equal(c[1], ko[4][1])
    f, p, v = ko[:3]
    assert torch.equal(rp.peak_pass(f, v, p, J=J),
                       rp.peak_pass_plain(f, v, p, J=J))
    own = torch.where(torch.rand((Q, A), device=dev) < 0.1,
                      torch.randint(0, 50, (Q, A), device=dev),
                      rp.INF32).int()
    assert torch.equal(rp.minrank_pass(p, own, J=J),
                       rp.minrank_pass_plain(p, own, J=J))


def _ext_pairs(rng, B, Lq, Lt):
    """Related pairs (10% substitutions, a deletion), unrelated pairs
    (Z-drop fires) and unequal lengths, some past the arrays' width."""
    q = rng.randint(0, 4, (B, Lq))
    t = q[:, :Lt].copy()
    sub = rng.rand(B, Lt) < 0.1
    t[sub] = rng.randint(0, 5, sub.sum())
    for b in range(0, B, 3):
        t[b] = rng.randint(0, 4, Lt)
    for b in range(1, B, 5):
        cut = rng.randint(0, Lt // 2)
        t[b, cut:] = np.concatenate([t[b, cut + 30:], rng.randint(0, 4, 30)])
    ql = rng.randint(Lq // 3, Lq + 20, B)
    tl = rng.randint(Lt // 3, Lt + 20, B)
    return [torch.from_numpy(a.astype(np.int32)) for a in (q, ql, t, tl)]


@pytest.mark.parametrize("W", [1, 15, 16, 32, 40, 63])
@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extend_kernel_matches_plain(dev, mode, W):
    rng = np.random.RandomState(W)
    q, ql, t, tl = (a.to(dev) for a in _ext_pairs(rng, 300, 700, 650))
    gap = {"gapo2": 24, "gape2": 1} if mode == "extd" else {}
    for zdrop in (100, 400):
        k = ext.extz_batch(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        p = ext.extz_batch_plain(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        for key in ext.KEYS:
            assert torch.equal(k[key], p[key]), key
        assert bool(k["zdropped"].any()) and not bool(k["zdropped"].all())
    with pytest.raises(ValueError):
        ext.extz_batch(q, ql, t, tl, W=64, **gap)

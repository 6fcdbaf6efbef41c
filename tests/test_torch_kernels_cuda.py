"""The CUDA kernels against their plain versions on the card (marked
`cuda`: they need a GPU and nvcc, and skip elsewhere), and sampleqc's
run on the card against its run on the CPU. chip_smoke.py runs the same
comparisons at production shapes."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch
from torch_util import (QC_JSON, SAMPLEQC_TABLES, compare_qc_json,
                        ont_sampleqc_reads, pb_sampleqc_reads)

from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.ops import extend as ext
from longqc_tpu_torch.ops import ringprop as rp
from longqc_tpu_torch.ops import sketch_cuda as skc
from longqc_tpu_torch.ops.chain import (chain_dp_batch, gap_penalty_table,
                                        window_depths)
from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _long_run_tile(rng, R, W, sep=4, p_n=.04):
    """Reads with N runs and (AT)n runs longer than the kernel's column
    chunk (ops/sketch_cuda.CHUNK), IUPAC-free random sequence between."""
    b = di._TileBuilder(R, W, sep)
    gid = 0
    while len(b.rows) < R:
        p = [(1 - p_n) / 4] * 4 + [p_n]
        s = "".join(rng.choice(list("ACGTN"), p=p,
                               size=rng.randint(50, min(W // 2, 9000))))
        if gid % 3 == 1:
            s += "AT" * rng.randint(100, 600)
        if gid % 4 == 2:
            p = rng.randint(0, len(s))
            s = s[:p] + "N" * rng.randint(150, 700) + s[p:]
        b.add(gid, s[:W])
        gid += 1
    return b.tiles()[0]


def _tile_args(t, dev):
    return [di.to_device_words(a, dev) for a in
            (t.codes2, t.nmask, t.startmask, t.endmask)] + \
        [torch.from_numpy(a).to(dev) for a in (t.starts, t.gids)]


def _assert_sketch_equals_plain(args, W, k, w):
    kr = skc.sketch_tiles(*args, W=W, k=k, w=w)
    p = skc.sketch_tiles_plain(*args, W=W, k=k, w=w)
    assert torch.equal(kr["emit"], p["emit"])
    on = p["emit"] > 0
    assert int(on.sum()) > 0
    for f in ("hash", "rid", "pos", "strand"):
        assert kr[f].dtype == p[f].dtype
        assert torch.equal(kr[f][on], p[f][on])
    return p


@pytest.mark.parametrize("R,W", [(16, 2048), (256, 8192), (32, 65536)])
def test_sketch_kernel_matches_plain(dev, R, W):
    rng = np.random.RandomState(W)
    args = _tile_args(_long_run_tile(rng, R, W), dev)
    for k, w in ((12, 5), (15, 10)):
        _assert_sketch_equals_plain(args, W, k, w)


@pytest.mark.parametrize("k,w", [(19, 10), (28, 5), (16, 32)])
@pytest.mark.parametrize("R,W", [(16, 2048), (256, 8192), (32, 65536)])
def test_sketch_u64_kernel_matches_plain(dev, R, W, k, w):
    """2k > 30: u64 k-mer registers and hashes, int64 hash output."""
    rng = np.random.RandomState(W + k)
    args = _tile_args(_long_run_tile(rng, R, W), dev)
    p = _assert_sketch_equals_plain(args, W, k, w)
    assert p["hash"].dtype == torch.int64
    assert int(p["hash"].max()) > 1 << 31


@pytest.mark.parametrize("k", [12, 19], ids=["u32", "u64"])
@pytest.mark.parametrize("w", [33, 40, 64, 65, 128, 129, 255])
def test_sketch_ring_kernel_matches_plain(dev, w, k):
    """w > 32: the ring is a circular buffer addressed at run time (64,
    128 or 256 slots), in wider chunks."""
    R, W = 64, 8192
    rng = np.random.RandomState(w + k)
    args = _tile_args(_long_run_tile(rng, R, W, sep=w - 1, p_n=.002), dev)
    _assert_sketch_equals_plain(args, W, k, w)


def _anchor_rows(rng, Q, A, dense):
    """Sorted anchor rows: diagonal-clustered (`dense` False) or
    repeat-dense position bands with scattered query positions, whose
    admissible windows run deeper than 256 ages."""
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
def test_chain_and_ringprop_kernels_match_plain(dev, dense, tables):
    rng = np.random.RandomState(5 + dense)
    Q, A = 128, 1024
    axl, aq, n = (t.to(dev) for t in _anchor_rows(rng, Q, A, dense))
    axh = torch.zeros((Q, A), dtype=torch.int32, device=dev)
    span = torch.full((Q, A), 12, dtype=torch.int32, device=dev)
    depth = window_depths(axh, axl, n, 10000).amax(dim=1)
    if dense:
        assert int((depth > 256).sum()) > Q // 2
    # the plain engine's one (1, bw+1) table (row stride 0), or a
    # distinct table per row (the HPC engine's per-row avg_qspan)
    avg = [12] if tables == "one" else [12 + r / 7 for r in range(Q)]
    pen = torch.from_numpy(np.stack([
        gap_penalty_table(np.float32(a), 500) for a in avg])).to(dev)
    ko = chain_dp_fill(axh, axl, aq, span, n, pen)
    po = chain_dp_batch(axh, axl, aq, span, n, pen)
    for a, b in zip(ko, po):
        assert torch.equal(a, b)
    f, p, v = ko
    # parents may lie any distance back: the passes run with J = A
    assert torch.equal(rp.peak_pass(f, v, p, J=A),
                       rp.peak_pass_plain(f, v, p, J=A))
    own = torch.where(torch.rand((Q, A), device=dev) < 0.1,
                      torch.randint(0, 50, (Q, A), device=dev),
                      rp.INF32).int()
    assert torch.equal(rp.minrank_pass(p, own, J=A),
                       rp.minrank_pass_plain(p, own, J=A))


def _hard_forest_rows(case, rng, Q, A):
    """(Q, A) f / v / p / own: a path of depth A (p[i] = i - 1, the
    deepest anchor smallest), garbage parents (anywhere in [-1, A)) or
    links up to 768 back (past J = 256)."""
    ii = np.arange(A)
    f = rng.randint(1, 200, (Q, A))
    v = f + (rng.rand(Q, A) < 0.8) * rng.randint(1, 40, (Q, A))
    own = np.where(rng.rand(Q, A) < 0.1, rng.randint(0, 5000, (Q, A)),
                   rp.INF32)
    if case == "path":
        p = np.broadcast_to(ii - 1, (Q, A))
        v = f + 1
        own[::2] = A - ii
    elif case == "garbage":
        p = rng.randint(-1, A, (Q, A))
    else:
        p = np.maximum(ii - rng.randint(1, 769, (Q, A)), -1)
    return [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
            for a in (f, v, p, own)]


@pytest.mark.parametrize("J", ["A", "256"])
@pytest.mark.parametrize("case", ["path", "garbage", "far"])
def test_ringprop_kernels_match_plain_on_hard_rows(dev, case, J):
    # rows longer than the kernels' 4096-anchor chunk and not a multiple
    # of it, so chains cross chunks and the last chunk is partial
    Q, A = 16, 10000
    J = A if J == "A" else int(J)
    f, v, p, own = (t.to(dev) for t in _hard_forest_rows(
        case, np.random.RandomState(len(case)), Q, A))
    assert torch.equal(rp.peak_pass(f, v, p, J=J),
                       rp.peak_pass_plain(f, v, p, J=J))
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


@pytest.mark.parametrize("W", [1, 15, 16, 32, 40, 63, 64, 255, 5000])
@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extend_kernel_matches_plain(dev, mode, W):
    """W <= 63 takes the one-warp body, wider W the block-per-pair body;
    W = 5000 lies past every pair (lengths up to 720), so its band is
    clamped per pair, while the plain version runs the full band."""
    from longqc_tpu_torch.ops import _ext
    rng = np.random.RandomState(W)
    q, ql, t, tl = (a.to(dev) for a in _ext_pairs(rng, 300, 700, 650))
    gap = {"gapo2": 24, "gape2": 1} if mode == "extd" else {}
    name = mode + ("_wide" if W > 63 else "")
    for zdrop in (100, 400):
        n0 = _ext.LAUNCHES[name]
        k = ext.extz_batch(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        assert _ext.LAUNCHES[name] == n0 + 1
        p = ext.extz_batch_plain(q, ql, t, tl, W=W, zdrop=zdrop, **gap)
        for key in ext.KEYS:
            assert torch.equal(k[key], p[key]), key
        assert bool(k["zdropped"].any()) and not bool(k["zdropped"].all())


@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extend_wide_band_in_device_memory(dev, mode, monkeypatch):
    """The wide body with its band in device memory (no shared memory
    allowed) and 7 blocks walking the 300 pairs."""
    from longqc_tpu_torch.ops import extend_cuda
    monkeypatch.setattr(extend_cuda, "SMEM_BYTES", 0)
    monkeypatch.setattr(extend_cuda, "WIDE_BLOCKS", 7)
    rng = np.random.RandomState(77)
    q, ql, t, tl = (a.to(dev) for a in _ext_pairs(rng, 300, 700, 650))
    gap = {"gapo2": 24, "gape2": 1} if mode == "extd" else {}
    for W in (64, 255, 5000):
        k = ext.extz_batch(q, ql, t, tl, W=W, zdrop=400, **gap)
        p = ext.extz_batch_plain(q, ql, t, tl, W=W, zdrop=400, **gap)
        for key in ext.KEYS:
            assert torch.equal(k[key], p[key]), (W, key)


@pytest.mark.parametrize("preset", ["ont-ligation", "pb-sequel"])
def test_sampleqc_card_run_equals_cpu_run(tmp_path, dev, preset):
    """Every stage on the card (kernels B1-B4, the chunk-QC torch ops, the
    fits) against the same run on the CPU: the tables byte-identical, the
    QC JSON within the fits' tolerance."""
    from longqc_tpu_torch.engine import pipeline
    from util_synth import write_fastq_file

    reads = (ont_sampleqc_reads() if preset == "ont-ligation"
             else pb_sampleqc_reads())
    fq = str(tmp_path / "in.fq")
    write_fastq_file(fq, reads)
    report = not pipeline.missing_report_modules()
    outs = {}
    for d in ("cpu", "cuda"):
        outs[d] = str(tmp_path / d)
        pipeline.run_sampleqc(fq, outs[d], preset, nsample=30,
                              device=dev if d == "cuda" else d,
                              report=report)
    tables = SAMPLEQC_TABLES + (["analysis/minimap2/spiked_in_control.txt"]
                                if preset == "pb-sequel" else [])
    for table in tables:
        assert filecmp.cmp(os.path.join(outs["cpu"], table),
                           os.path.join(outs["cuda"], table), shallow=False)
    with open(os.path.join(outs["cpu"], QC_JSON)) as f:
        want = json.load(f)
    with open(os.path.join(outs["cuda"], QC_JSON)) as f:
        compare_qc_json(json.load(f), want)

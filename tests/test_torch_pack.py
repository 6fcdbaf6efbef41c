"""Part tile packing (engine/device_index, ops/pack_cuda): the layout
record the host makes plus the plain twin of csrc/pack.cu give tiles
equal word for word to the JAX package's numpy packer, on ragged parts;
a numpy model of the kernel's lane rules (the segment search over a
row's table, the ballots, the end bit a read of no bases leaves on the
row before) gives the twin's words; a CPU engine run keeps the span
`part.pack` and counts no tile packed on the card. The kernel itself
runs in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from longqc_tpu.engine import device_index as jdi
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import device_overlap as tdo
from longqc_tpu_torch.io.pack import SEQ_NT4_SKETCH
from longqc_tpu_torch.ops import pack_cuda
from longqc_tpu_torch.ops.sketch_cuda import READS_PER_ROW
from torch_util import odd_bases
from util_synth import make_genome, sample_reads

FIELDS = ("codes2", "nmask", "startmask", "endmask", "starts", "gids",
          "used")


def _part(case):
    """(reads, w) of one ragged part; the ladder is TILE_LADDER_SMALL
    (16 x 2048, 4 x 8192, 1 x 32768; reads past 32,768 take a jumbo
    tile)."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case in ("w5", "w10"):
        lens = rng.randint(30, 2500, size=120)
        return [["r%d" % i, odd_bases(rng, n, odd=0), ""]
                for i, n in enumerate(lens)], int(case[1:])
    if case == "reads_per_row":
        # 2048-column rows of 10-20 bp reads: READS_PER_ROW cuts them
        lens = rng.randint(10, 21, size=5 * READS_PER_ROW + 7)
        return [["r%d" % i, odd_bases(rng, n, odd=0), ""]
                for i, n in enumerate(lens)], 5
    if case == "empty_rows":
        # three reads per level: most rows of each tile stay empty
        lens = [300, 1900, 40, 5000, 2100, 8000, 9000, 20000, 30000]
        return [["r%d" % i, odd_bases(rng, n, odd=0), ""]
                for i, n in enumerate(lens)], 5
    if case == "jumbo":
        lens = [1200, 40000, 700, 70000, 32768, 32769]
        return [["r%d" % i, odd_bases(rng, n, odd=0.01), ""]
                for i, n in enumerate(lens)], 10
    if case == "odd_bases":
        lens = rng.randint(1, 3000, size=60)
        return [["r%d" % i, odd_bases(rng, n, odd=0.2), ""]
                for i, n in enumerate(lens)], 5
    if case == "no_bases":
        # reads of no bases: first in a row (their end bit lies on the
        # row before, or on the tile's last column), between reads, in
        # runs, and a tile that ends on one
        lens = [0, 500, 0, 0, 1200, 2048, 0, 30, 1000, 0] + \
            list(rng.randint(0, 3, size=40)) + [0]
        return [["r%d" % i, odd_bases(rng, n, odd=0.05), ""]
                for i, n in enumerate(lens)], 5
    raise ValueError(case)


CASES = ("w5", "w10", "reads_per_row", "empty_rows", "jumbo", "odd_bases",
         "no_bases")


def _tiles(part, w):
    tiles, jumbo = di.pack_part_tiles(part, w, ladder=di.TILE_LADDER_SMALL)
    jtiles, jjumbo = jdi.pack_part_tiles(part, w,
                                         ladder=jdi.TILE_LADDER_SMALL)
    assert len(tiles) == len(jtiles) and len(jumbo) == len(jjumbo)
    return list(zip(tiles + jumbo, jtiles + jjumbo))


def _lane_model(raw, row_off, segs, R, W):
    """csrc/pack.cu's rules, a column a lane: each column's segment is
    the last of its row's (at most 64) whose first column is at or before
    it, found by the kernel's binary search; the last column of a row
    takes the end bit of the next row's first read when that read has no
    bases (row 0's: the last row's). Words by the ballots' bit order."""
    codes = np.zeros((R, W), np.uint8)
    amb = np.ones((R, W), bool)
    st = np.zeros((R, W), bool)
    en = np.zeros((R, W), bool)
    cols = np.arange(W)
    for r in range(R):
        a, n = row_off[r], min(row_off[r + 1] - row_off[r], 64)
        if n > 0:
            tab = segs[a:a + n]
            j = np.zeros(W, np.int64)
            step = 32
            while step:
                nxt = j + step
                ok = nxt < n
                ok[ok] = tab[nxt[ok], 0] <= cols[ok]
                j = np.where(ok, nxt, j)
                step >>= 1
            seg, base, ln, boff = (tab[j, i].astype(np.int64)
                                   for i in range(4))
            off = cols - base
            st[r] = cols == seg
            en[r] = off == ln - 1
            on = (off >= 0) & (off < ln)
            v = np.full(W, 4, np.int64)
            v[on] = SEQ_NT4_SKETCH[raw[boff[on] + off[on]]]
            amb[r] = v >= 4
            codes[r] = np.where(v < 4, v, 0)
        rn = (r + 1) % R
        b = row_off[rn]
        if row_off[rn + 1] > b and segs[b, 2] == 0:
            en[r, W - 1] = True
    return tuple(pack_cuda.packbits32(x) for x in (codes, amb, st, en))


@pytest.mark.parametrize("case", CASES)
def test_tiles_equal_the_jax_packer(case):
    """The layout record and the plain twin (a tile's lazy host words,
    and pack_words on CPU tensors) against longqc_tpu's packer."""
    part, w = _part(case)
    pairs = _tiles(part, w)
    for t, jt in pairs:
        for f in FIELDS:
            want = np.asarray(getattr(jt, f))
            assert np.array_equal(getattr(t, f), want), (case, f)
        assert t.n_reads == jt.n_reads
        assert t.raw.size == int(t.segs[:, 2].sum())
        got = pack_cuda.pack_words(torch.from_numpy(t.raw),
                                   torch.from_numpy(t.row_off),
                                   torch.from_numpy(t.segs), R=t.R, W=t.W)
        for f, g in zip(FIELDS, got):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy().view(np.uint32),
                                  np.asarray(getattr(jt, f))), (case, f)
    if case == "jumbo":
        assert sum(t.R == 1 and t.W >= di.JUMBO_W for t, _ in pairs) == 3
    if case == "reads_per_row":
        assert max(int(np.diff(t.row_off).max()) for t, _ in pairs) \
            == READS_PER_ROW
    if case == "empty_rows":
        assert all(int(np.diff(t.row_off)[-1]) == 0 for t, _ in pairs
                   if t.R > 1)


@pytest.mark.parametrize("case", CASES)
def test_kernel_lane_rules_equal_the_twin(case):
    part, w = _part(case)
    for t, _ in _tiles(part, w):
        got = _lane_model(t.raw, t.row_off, t.segs, t.R, t.W)
        for f, g, want in zip(FIELDS, got, t.words):
            assert np.array_equal(g, want), (case, f)


def test_non_ascii_raises_as_the_jax_packer():
    part = [["a", "ACGT" * 10, ""], ["b", "ACGTéACGT", ""]]
    with pytest.raises(UnicodeEncodeError):
        jdi.pack_part_tiles(part, 5, ladder=jdi.TILE_LADDER_SMALL)
    with pytest.raises(UnicodeEncodeError):
        di.pack_part_tiles(part, 5, ladder=di.TILE_LADDER_SMALL)


def test_cpu_engine_packs_aside_and_no_tile_on_the_card():
    rng = np.random.RandomState(11)
    genome = make_genome(rng, 20000)
    reads = sample_reads(rng, genome, 80, min_len=700, max_len=2200,
                         err=0.12, junk_frac=0.1)
    cfg = OverlapConfig(index=IndexOpt(k=12, w=5),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    eng = tdo.DeviceOverlapEngine(cfg, reads[:20], device="cpu")
    rows = eng.run(reads)
    assert rows
    by = eng.spans["by_name"]
    assert by["part.pack"]["n"] == 1 and by["index.tiles"]["n"] == 1
    assert eng.spans["counters"]["index.pack_tiles"] == 0
    assert eng.stats()["index_s"]["pack"] > 0

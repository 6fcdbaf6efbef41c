"""The warm-up rule of the chunked B1 kernel (csrc/sketch.cu), checked on
the CPU: the chunk plan (ops/sketch_cuda.chunk_plan, which the kernel's
wrapper uses) plus a Python port of the kernel's per-chunk recurrence,
run over [warm-up start, chunk end) for every chunk with the emissions
of the chunk's own columns summed, equal the unchunked recurrence and
sketch_tiles_plain, exactly, on tiles with (AT)n runs and N runs longer
than a chunk and reads shorter than the warm-up. The replay follows the
kernel's variants: 64-bit registers and the int64 sentinel for 2k > 30,
and for w > 32 the ring as a circular buffer addressed at run time, at
the chunk width the wrapper gives that variant."""

import numpy as np
import pytest
import torch
from torch_util import np_, rand_seq

from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.ops import sketch_cuda as skc

NOCOL = -(1 << 20)
RPR = 64


def _hash(key, mask):
    """hash64 of sketch.c on Python integers: with the 2k-bit mask
    re-applied, it equals the kernel's u32 arithmetic for 2k <= 30 and
    its u64 arithmetic above."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


class _ShiftRing:
    """The kernel's ring for w <= 32: slot 0 holds the newest push."""

    def __init__(self, w, sent):
        self.w = w
        self.slots = [(sent, 0, NOCOL)] * w

    def oldest_col(self):
        return self.slots[self.w - 1][2]

    def push(self, entry):
        self.slots = [entry] + self.slots[:self.w - 1]

    def newest_first(self):
        return list(self.slots)


class _CircularRing:
    """The kernel's ring for w > 32: a power-of-two buffer of WM >= w
    slots; a push writes slot (head + 1) mod WM and the entry pushed s
    pushes before the newest sits at (head - s) mod WM."""

    def __init__(self, w, sent):
        self.w = w
        self.wm = next(c for c in (64, 128, 256) if w <= c)
        self.buf = [(sent, 0, NOCOL)] * self.wm
        self.head = 0

    def _slot(self, s):
        return (self.head - s) & (self.wm - 1)

    def oldest_col(self):
        return self.buf[self._slot(self.w - 1)][2]

    def push(self, entry):
        self.head = (self.head + 1) & (self.wm - 1)
        self.buf[self.head] = entry

    def newest_first(self):
        return [self.buf[self._slot(s)] for s in range(self.w)]


def _run_chunk(row, plan, c0, c1, k, w, emit, rec):
    """One kernel thread: the recurrence from plan's s0 with a clean
    ring, adding the emissions decided at columns >= c0 and recording
    those columns."""
    codes, amb, sb, eb, starts, gids = row
    s0, seg, segst, k0, k1 = (int(x) for x in plan)
    mask = (1 << (2 * k)) - 1
    shift1 = 2 * (k - 1)
    SENT = (1 << 63) - 1 if skc.is_wide(k) else 0x7FFFFFFF
    curg = curs = 0
    if 0 <= seg < RPR:
        curg, curs = int(gids[seg]), int(starts[seg])
    lc = 0
    minh, miny, minc = SENT, 0, NOCOL
    ring = (_CircularRing if w > skc.REG_RING_W else _ShiftRing)(w, SENT)
    for j in range(s0, c1):
        c = int(codes[j])
        valid = not amb[j]
        mine = j >= c0
        if sb[j]:
            seg += 1
            segst = j
            curg = int(gids[seg]) if seg < RPR else 0
            curs = int(starts[seg]) if seg < RPR else 0
        if valid:
            k0 = ((k0 << 2) | c) & mask
            k1 = (k1 >> 2) | ((3 ^ c) << shift1)
        sym = valid and k0 == k1
        push = not sym
        l_new = (lc if sym else lc + 1) if valid else 0
        lc = l_new
        z = 0 if k0 < k1 else 1
        ih = _hash(min(k0, k1), mask) if (valid and not sym
                                            and l_new >= k) else SENT
        iy = ((j - curs) << 1) | z
        if mine:
            on = push and valid
            rec[j] = (ih, curg, j - curs, z) if on else (0, 0, 0, 0)
        evicted = False
        if push:
            evicted = ring.oldest_col() == minc
            ring.push((ih, iy, j))
        if push and l_new == w + k - 1 and minh != SENT and mine:
            for h, y, col in ring.newest_first()[1:]:
                if h == minh and y != miny:
                    emit[col] += 1
        cr = push and ih <= minh
        ce = push and not cr and evicted
        if mine and minh != SENT and ((cr and l_new >= w + k)
                                      or (ce and l_new >= w + k - 1)):
            emit[minc] += 1
        if ce:
            slots = ring.newest_first()
            nmh = min(e[0] for e in slots)
            nmc, nmy = NOCOL, 0
            for h, y, col in slots:
                if h == nmh and col > nmc:
                    nmc, nmy = col, y
            if mine and l_new >= w + k - 1 and nmh != SENT:
                for h, y, col in slots:
                    if h == nmh and y != nmy:
                        emit[col] += 1
            minh, miny, minc = nmh, nmy, nmc
        elif cr:
            minh, miny, minc = ih, iy, j
        if mine and eb[j] and minh != SENT and minc >= segst:
            emit[minc] += 1


def _tile(rng, R, W, w, lo=200, hi=900, with_n=0.01):
    """Reads with long (AT)n runs (symmetric k-mers for even k), N runs
    longer than a chunk, and reads shorter than the warm-up."""
    b = di._TileBuilder(R, W, max(w - 1, 1))
    gid = 0
    while len(b.rows) < R:
        kind = gid % 5
        s = rand_seq(rng, rng.randint(lo, hi), with_n=with_n)
        if kind == 1:
            p = rng.randint(0, len(s))
            s = s[:p] + "AT" * rng.randint(60, 200) + s[p:]
        elif kind == 2:
            p = rng.randint(0, len(s))
            s = s[:p] + "N" * rng.randint(70, 260) + s[p:]
        elif kind == 3:
            s = rand_seq(rng, rng.randint(3, 20))
        b.add(gid, s)
        gid += 1
    return b.tiles()[0]


# (k, w, chunk): 64-column chunks for the register-ring variants (half
# the kernel's, so more chunk borders fall into runs), the wrapper's own
# width for the run-time ring
CASES = [(12, 5, 64), (15, 5, 64), (12, 10, 64), (15, 10, 64),
         (19, 10, 64), (28, 5, 64),
         (12, 40, skc.chunk_width(40)), (19, 40, skc.chunk_width(40)),
         (12, 255, skc.chunk_width(255)), (19, 255, skc.chunk_width(255))]


@pytest.mark.parametrize("k,w,CH", CASES)
def test_chunked_recurrence_matches_unchunked_and_plain(k, w, CH):
    rng = np.random.RandomState(k * 10 + w)
    if w <= skc.REG_RING_W:
        R, W = 4, 2048
        tile = _tile(rng, R, W, w)
    else:       # sparse minimizers: longer reads with rarer Ns, wider rows
        R, W = 2, 8192
        tile = _tile(rng, R, W, w, lo=600, hi=2500, with_n=0.001)
    words = [di.to_device_words(a, "cpu") for a in
             (tile.codes2, tile.nmask, tile.startmask, tile.endmask)]
    ints = [torch.from_numpy(a) for a in (tile.starts, tile.gids)]
    plan = np_(skc.chunk_plan(*words[:3], W=W, k=k, w=w, chunk=CH))
    NC = W // CH
    assert plan.shape == (R, NC, 5)
    codes = np_(skc.unpack2(words[0], W))
    amb, sb, eb = (np_(skc.unpack1(x, W)) for x in words[1:])
    plain = {key: np_(v) for key, v in skc.sketch_tiles_plain(
        *words, *ints, W=W, k=k, w=w).items()}
    warm = []
    for r in range(R):
        row = (codes[r], amb[r], sb[r], eb[r], tile.starts[r], tile.gids[r])
        full_e = np.zeros(W, np.int64)
        full_rec = [None] * W
        _run_chunk(row, (0, -1, 0, 0, 0), 0, W, k, w, full_e, full_rec)
        chunk_e = np.zeros(W, np.int64)
        chunk_rec = [None] * W
        for c in range(NC):
            s0 = plan[r, c, 0]
            assert s0 <= c * CH
            warm.append(c * CH - s0)
            _run_chunk(row, plan[r, c], c * CH, (c + 1) * CH, k, w, chunk_e,
                       chunk_rec)
        np.testing.assert_array_equal(chunk_e, full_e)
        assert chunk_rec == full_rec
        np.testing.assert_array_equal(chunk_e, plain["emit"][r])
        on = chunk_e > 0
        assert on.sum() > (50 if w <= 40 else 20)
        for i, key in enumerate(("hash", "rid", "pos", "strand")):
            got = np.array([full_rec[j][i] for j in np.nonzero(on)[0]])
            np.testing.assert_array_equal(got, plain[key][r][on])
    if skc.is_wide(k):
        # int64 lanes: the plan's registers and some hashes pass 2^31
        assert plan.dtype == np.int64 and plain["hash"].dtype == np.int64
        assert plan[:, :, 3:].max() > 1 << 31
        assert plain["hash"].max() > 1 << 31
    else:
        assert plan.dtype == np.int32 and plain["hash"].dtype == np.int32
    # (AT)n runs (symmetric k-mers, no pushes, for even k) make some
    # warm-ups longer than a chunk
    assert max(warm) > CH if k % 2 == 0 and w <= skc.REG_RING_W \
        else max(warm) >= w + k


def test_plan_warm_up_start_counts_pushes():
    """s0 sits w+k pushes before the chunk: no push across an (AT)n run
    for even k, one push per N column, and the row start when fewer."""
    k, w, W, CH = 12, 5, 512, 64
    seq = "ACGTTGCA" * 8 + "AT" * 100 + "N" * 100 + "CAGGT" * 20
    packed = di.pack_single_rows([seq, "AT" * 200 + "CAGGT"], W)
    words = [di.to_device_words(a, "cpu") for a in packed[:3]]
    plan = np_(skc.chunk_plan(*words, W=W, k=k, w=w, chunk=CH))
    # chunks 2-3 start inside the (AT)n run (columns 64..263): the
    # warm-up reaches back before it
    assert plan[0, 2, 0] < 64 and plan[0, 3, 0] < 64
    # chunk 5 (column 320) starts inside the N run: w + k pushes back
    assert plan[0, 5, 0] == 320 - (w + k)
    # one read: segment 0 once the warm-up starts past its start bit
    assert plan[0, 0, 1] == -1 and (plan[0, 1:, 1] == 0).all()
    # a read opening with (AT)n: fewer than w + k pushes before the
    # chunks inside the run, which then warm up from the row start
    assert (plan[1, :6, 0] == 0).all()

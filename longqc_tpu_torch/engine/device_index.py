"""Device index build for the overlap engine (flat 1-D layout).

Torch port of longqc_tpu/engine/device_index.py:

  reads --host layout--> multi-read tiles (R, W; reads laid
      back-to-back in a row behind w-1 ambiguous separator bases): each
      tile's reads' bytes and where each read lies
    --per tile--> its 2-bit words made where it is sketched (on the card
      csrc/pack.cu, ops/pack_cuda) -> B1 sketch kernel
      (ops/sketch_cuda: per-column emit,
      hash, read id, local position, strand) -> duplicate-emission
      expansion -> single-key sort by hash => one sorted chunk
    --combine--> concatenate the chunks (each cropped to 3/8 of its
      slots, validated against its real entry count), sentinel-pad to
      the smallest fitting width of the ladder, one sort
    --mid_occ--> kth occurrence count over the sorted hash array
      (mm_idx_cal_max_occ, index.c:123-144)

Single-key sorting (hash only) is exact: within a hash run all entries
share the k-mer, and anchors that tie on the chain sort keys are
bit-identical duplicates (see engine/device_overlap).

Parts whose cropped chunks pass the top of the width ladder (2^26
slots, ~180 Mbp at w = 5; the reference's default part is -I 4G) take
the hash-range build instead, which the engine reads through the same
flat layout: each tile's crop is copied out as soon as it is made, so
the tile's full R*W storage is freed (a tile whose real entries pass
its crop is re-run and kept whole); range s of S owns the hashes
[s << (2k - lg S), (s + 1) << (2k - lg S)), S the least power of two
for which every range holds at most `range_max` entries (counted, not
assumed: minimizers favour small hashes, so the low ranges fill first
and S can come out double what a uniform spread needs); its slice of
every sorted
chunk is found by torch.searchsorted, the slices are concatenated and
sorted alone and written at the range's offset of one flat output,
sentinel-padded to the real count rounded up to PAD_TO. Every key's run
lies in one range, so mid_occ comes from the ranges' run lengths. The
JAX package stacks its ranges as shards of 8M entries because wider
programs stalled its TPU compiler; the flat array needs no stack, and
the engine's int32 search offsets hold up to INDEX_MAX entries. A part
raises IndexOverflowError (the engine computes it with the exact host
spec) only past `max_entries` real entries or when the reckoned bytes
of the build exceed the device's free memory.

Hash lanes are int32 for 2k <= 30 and int64 above
(`ops/sketch_cuda.hash_dtype`), each
with its dtype's max as the empty-slot sentinel (`infk`), which sorts
after every real hash; irid / ips are int32 either way.
"""

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from longqc_tpu_torch.io.pack import SEQ_NT4_SKETCH
from longqc_tpu_torch.ops.pack_cuda import (packbits32, pack_words,
                                            pack_words_plain)
from longqc_tpu_torch.ops.sketch_cuda import (READS_PER_ROW, hash_dtype,
                                              sketch_tiles)
from longqc_tpu_torch.tracing import count, span

# tile ladder: every level holds the same number of bases
TILE_LADDER = ((256, 8192), (32, 65536), (4, 524288))
JUMBO_W = 1 << 22          # single-row tiles for ultra-long reads
# index widths: a part pads to the smallest width that fits
N_IDX_SIZES = (1 << 21, 1 << 22, 1 << 23, 1 << 24, 1 << 25, 1 << 26)

# the hash-range build (parts past the top width)
RANGE_MAX = 1 << 26        # entries of one range, sorted at once
PAD_TO = 1 << 20           # its flat output pads to a multiple of this
INDEX_MAX = (1 << 31) - 1  # entries the engine's int32 offsets address
_RL_CAP = 1 << 16          # run lengths histogrammed below this

# small geometry for tests / tiny workloads (same code paths)
N_IDX_SIZES_SMALL = (1 << 12, 1 << 15, 1 << 17, 1 << 19, 1 << 21,
                     1 << 24)
TILE_LADDER_SMALL = ((16, 2048), (4, 8192), (1, 32768))


@dataclass
class Tile:
    """One multi-read tile: its reads' bytes and its layout (host arrays;
    the layout record of ops/pack_cuda). The words B1 reads are made from
    them where the tile is sketched (_run_tile); codes2, nmask,
    startmask and endmask give them on the host, made by the plain twin
    on first read."""
    R: int
    W: int
    raw: np.ndarray         # (n_bytes,) uint8, the reads' ASCII bytes
    row_off: np.ndarray     # (R + 1,) int32, row r's reads in segs
    segs: np.ndarray        # (n_reads, 4) int32 segment start, first base,
    #                         length, byte offset of each read
    starts: np.ndarray      # (R, READS_PER_ROW) int32 read start pos
    gids: np.ndarray        # (R, READS_PER_ROW) int32 global read id
    used: np.ndarray        # (R,) int32 row used width
    n_reads: int

    @cached_property
    def words(self):
        """(codes2, nmask, startmask, endmask) host uint32 words."""
        return pack_words_plain(self.raw, self.row_off, self.segs, self.R,
                                self.W)

    @property
    def codes2(self):       # (R, W//16) 2-bit codes
        return self.words[0]

    @property
    def nmask(self):        # (R, W//32) 1 = ambiguous/padding
        return self.words[1]

    @property
    def startmask(self):    # (R, W//32) 1 = segment start
        return self.words[2]

    @property
    def endmask(self):      # (R, W//32) 1 = read's last column
        return self.words[3]


class _TileBuilder:
    def __init__(self, R, W, sep):
        self.R, self.W, self.sep = R, W, sep
        self.rows = []          # list of list[(gid, seq)]
        self.cur = []
        self.cur_used = 0

    def add(self, gid, seq):
        need = len(seq) + (self.sep if self.cur else 0)
        if self.cur and (self.cur_used + need > self.W
                         or len(self.cur) >= READS_PER_ROW):
            self.rows.append(self.cur)
            self.cur = []
            self.cur_used = 0
            need = len(seq)
        self.cur.append((gid, seq))
        self.cur_used += need

    def flush(self):
        if self.cur:
            self.rows.append(self.cur)
            self.cur = []
            self.cur_used = 0

    def tiles(self):
        self.flush()
        return [self._pack(self.rows[off:off + self.R])
                for off in range(0, len(self.rows), self.R)]

    def _pack(self, rows):
        """One tile's layout and its reads' bytes, joined in tile order;
        no per-base work (the words are made from them by _run_tile)."""
        R, sep = self.R, self.sep
        starts = np.zeros((R, READS_PER_ROW), np.int32)
        gids = np.full((R, READS_PER_ROW), -1, np.int32)
        used = np.zeros(R, np.int32)
        row_off = np.zeros(R + 1, np.int32)
        seqs, segs = [], []
        at = 0
        for r, row in enumerate(rows):
            pos = 0
            for j, (gid, seq) in enumerate(row):
                # separators belong to the NEXT segment: a window ending
                # at a separator entry may only ever track entries of
                # the read the separators precede
                seg = pos
                if j > 0:
                    pos += sep
                segs.append((seg, pos, len(seq), at))
                seqs.append(seq)
                starts[r, j] = pos
                gids[r, j] = gid
                pos += len(seq)
                at += len(seq)
            used[r] = pos
            row_off[r + 1] = len(segs)
        row_off[len(rows) + 1:] = len(segs)
        raw = np.frombuffer(bytearray("".join(seqs), "ascii"), np.uint8)
        return Tile(R, self.W, raw, row_off,
                    np.asarray(segs, np.int32).reshape(-1, 4), starts, gids,
                    used, len(segs))


def pack_single_rows(seqs, W):
    """One read per row in the bit-packed tile layout (codes2, nmask,
    startmask, endmask, starts, gids) — the query group's packer (each
    lane is one read, gid = lane index)."""
    R = len(seqs)
    codes = np.zeros((R, W), np.uint8)
    amb = np.ones((R, W), bool)
    startb = np.zeros((R, W), bool)
    endb = np.zeros((R, W), bool)
    for r, s in enumerate(seqs):
        a = SEQ_NT4_SKETCH[np.frombuffer(s.encode("ascii"), np.uint8)]
        codes[r, :len(a)] = np.where(a < 4, a, 0)
        amb[r, :len(a)] = a >= 4
        startb[r, 0] = True
        endb[r, len(a) - 1] = True
    starts = np.zeros((R, READS_PER_ROW), np.int32)
    gids = np.zeros((R, READS_PER_ROW), np.int32)
    gids[:, 0] = np.arange(R, dtype=np.int32)
    return (packbits32(codes), packbits32(amb), packbits32(startb),
            packbits32(endb), starts, gids)


def pack_part_tiles(part, w, ladder=TILE_LADDER, jumbo_w=JUMBO_W):
    """Pack a part's reads into multi-read tiles (+ jumbo single-read
    tiles for reads longer than the ladder top). Returns
    (tiles, jumbo_tiles)."""
    sep = max(w - 1, 1)
    builders = [_TileBuilder(R, W, sep) for R, W in ladder]
    tops = [W for _R, W in ladder]
    jumbo = []
    for gid, r in enumerate(part):
        seq = r[1]
        for lvl, top in enumerate(tops):
            if len(seq) <= top:
                builders[lvl].add(gid, seq)
                break
        else:
            jw = jumbo_w
            while jw < len(seq):
                jw *= 2
            b = _TileBuilder(1, jw, sep)
            b.add(gid, seq)
            jumbo.extend(b.tiles())
    tiles = []
    for b in builders:
        tiles.extend(b.tiles())
    return tiles, jumbo


def to_device_words(a, device):
    """uint32 host words -> int32 tensor holding the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a).astype(np.uint32).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# tile -> sorted chunk


def infk(dtype):
    """Hash sentinel of a lane dtype: its max (INF32 on int32 lanes,
    int64 max on the wide-hash lanes)."""
    return torch.iinfo(dtype).max


def tile_flat(codes2, nmask, startmask, endmask, starts, gids, *, W, k, w):
    """Per-tile chunk: B1 sketch -> duplicate expansion -> single-key
    sort. Returns (ih, irid, ips) sorted by hash with the sentinel
    infk(hash_dtype(k)) on empty slots (R*W each) and n_exp_total. A
    row's expanded emissions never exceed its W columns (one emission
    per window), so no row needs re-running."""
    res = sketch_tiles(codes2, nmask, startmask, endmask, starts, gids,
                       W=W, k=k, w=w)
    INFH = infk(hash_dtype(k))
    c2 = res["emit"]
    h2 = torch.where(c2 > 0, res["hash"], INFH)
    p2 = (res["pos"] << 1) | res["strand"]
    eh, er, ep, n_exp_total = _expand_rows(h2, res["rid"], p2, c2, INFH)
    ih, irid, ips = sort_index(eh, er, ep)
    return ih, irid, ips, n_exp_total


def sort_index(eh, er, ep):
    """Single-key (hash) sort of flat (hash, rid, pos) chunks."""
    ih, order = torch.sort(eh)
    return ih, er[order], ep[order]


def _expand_rows(h2, r2, p2, c2, INFH):
    """Row-wise duplicate expansion: entry j of row r (multiplicity
    c2[r, j]) occupies output slots [wstart, wstart + c2) of the same
    row, wstart = exclusive row cumsum; the rest of the row holds INFH
    (the caller's sort moves it to the tail).

    Returns flattened (eh, er, ep) and n_exp_total (sum of per-row
    expanded counts)."""
    R, C = h2.shape
    ccum = torch.cumsum(c2, dim=1)
    n_exp_r = ccum[:, -1]
    wstart = ccum - c2
    cols = torch.arange(C, dtype=torch.int64,
                        device=h2.device).expand(R, C)
    # source column of every expanded slot: seed each entry's column at
    # its start slot, then forward-fill with a running max
    tgt = torch.where(c2 > 0, wstart, C).clamp(max=C).to(torch.int64)
    src = torch.full((R, C + 1), -1, dtype=torch.int64, device=h2.device)
    src.scatter_(1, tgt, cols)
    src = torch.cummax(src[:, :C], dim=1).values.clamp(min=0)
    on = cols < n_exp_r[:, None]
    eh = torch.where(on, torch.gather(h2, 1, src), INFH).reshape(-1)
    er = torch.where(on, torch.gather(r2, 1, src), 0).reshape(-1)
    ep = torch.where(on, torch.gather(p2, 1, src), 0).reshape(-1)
    return eh, er, ep, n_exp_r.sum()


class IndexOverflowError(RuntimeError):
    """The part is empty, holds more entries than the index may address,
    or its build would not fit the device's free memory. Callers fall
    back to the exact host index for the part."""


def _run_tile(t, k, w, device):
    """tile_flat of one tile, its words made on `device` from its bytes
    and layout (ops/pack_cuda.pack_words: on the card one launch of
    csrc/pack.cu, counted under index.pack_tiles; 0 on the CPU). Two
    uploads: the bytes, and the int32 layout with starts and gids."""
    device = torch.device(device)
    R, nr = t.R, t.R * READS_PER_ROW
    lay = torch.from_numpy(np.concatenate(
        [t.starts.ravel(), t.gids.ravel(), t.row_off,
         t.segs.ravel()])).to(device)
    starts, gids, row_off, segs = torch.split(
        lay, [nr, nr, R + 1, t.segs.size])
    words = pack_words(torch.from_numpy(t.raw).to(device), row_off,
                       segs.view(-1, 4), R=R, W=t.W)
    count("index.pack_tiles", int(device.type == "cuda"))
    return tile_flat(*words, starts.view(R, READS_PER_ROW),
                     gids.view(R, READS_PER_ROW), W=t.W, k=k, w=w)


def _merge_chunks(chunks, n_idx_sizes):
    """Concatenate the tiles' sorted chunks, sentinel-pad to the
    smallest fitting index width, sort once."""
    n_slots = sum(int(c[0].shape[0]) for c in chunks)
    n_idx = next(s for s in n_idx_sizes if n_slots <= s)
    dev = chunks[0][0].device
    ehs = [c[0] for c in chunks]
    ers = [c[1] for c in chunks]
    eps = [c[2] for c in chunks]
    if n_slots < n_idx:
        pad = n_idx - n_slots
        hdt = ehs[0].dtype
        ehs.append(torch.full((pad,), infk(hdt), dtype=hdt, device=dev))
        ers.append(torch.zeros(pad, dtype=torch.int32, device=dev))
        eps.append(torch.zeros(pad, dtype=torch.int32, device=dev))
    final = sort_index(torch.cat(ehs), torch.cat(ers), torch.cat(eps))
    return list(final), n_idx


def run_lengths(h):
    """Per-key run lengths (int64, in key order) of a sorted hash array
    that holds real entries only."""
    n = h.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=h.device)
    start = torch.ones(n, dtype=torch.bool, device=h.device)
    start[1:] = h[1:] != h[:-1]
    pos = torch.nonzero(start).squeeze(1)
    return torch.diff(pos, append=torch.full((1,), n, dtype=torch.int64,
                                             device=h.device))


def runlen_sorted(ih):
    """Ascending per-key occurrence counts (int64) of the sorted hash
    array (padded with its dtype's sentinel past the real entries) and
    n_keys; positions are int64, so any width is safe."""
    n_valid = int((ih != infk(ih.dtype)).sum())
    rl = run_lengths(ih[:n_valid])
    return torch.sort(rl).values, rl.shape[0]


def _mid_occ_device(ih, *, frac):
    """Occurrence threshold as a 0-d int32 tensor: the kth smallest
    per-key count + 1, kth = min(int((1 - frac) * n_keys), n_keys - 1)
    in f64 like the host spec; 1 for an empty part."""
    rl_sorted, n = runlen_sorted(ih)
    if n == 0:
        return torch.tensor(1, dtype=torch.int32, device=ih.device)
    kth = min(int((1.0 - frac) * n), n - 1)
    return (rl_sorted[kth] + 1).to(torch.int32)


class _RunHist:
    """The occurrence-count multiset of a part accumulated range by
    range (each key's run lies wholly in one range): a histogram of the
    counts below _RL_CAP and the exact counts at or above it."""

    def __init__(self, device):
        self.hist = torch.zeros(_RL_CAP + 1, dtype=torch.int64,
                                device=device)
        self.tails = []

    def add(self, sorted_h):
        rl = run_lengths(sorted_h)
        self.hist += torch.bincount(rl.clamp(max=_RL_CAP),
                                    minlength=_RL_CAP + 1)
        self.tails.append(rl[rl >= _RL_CAP])

    def mid_occ(self, frac):
        """mid_occ of the whole multiset, as _mid_occ_device."""
        dev = self.hist.device
        n = int(self.hist.sum())
        if n == 0:
            return torch.tensor(1, dtype=torch.int32, device=dev)
        kth = min(int((1.0 - frac) * n), n - 1)
        cum = torch.cumsum(self.hist, 0)
        v = int(torch.searchsorted(cum, torch.tensor([kth], device=dev),
                                   right=True)[0])
        if v >= _RL_CAP:
            tail = torch.sort(torch.cat(self.tails)).values
            v = int(tail[kth - int(cum[_RL_CAP - 1])])
        return torch.tensor(v + 1, dtype=torch.int32, device=dev)


def _mid_occ(ih, mid_occ_fixed, mid_occ_frac):
    if mid_occ_fixed:
        return torch.tensor(int(mid_occ_fixed), dtype=torch.int32,
                            device=ih.device)
    return _mid_occ_device(ih, frac=mid_occ_frac)


CROP_NUM, CROP_DEN = 3, 8
# bytes the build holds besides its chunks and output: per column of the
# widest tile (its bytes and words, B1 outputs, the expansion's int64
# temporaries, the chunk's sort; 85-87 measured on the card at k=12
# w=5) and per entry of one range's sort (the slices, sorted hashes,
# int64 order, the gathered payloads, the sort's scratch)
TILE_BYTES_PER_COLUMN = 160


def _crop_width(n):
    """3/8 of a chunk's n slots, rounded up to 1024 (all of a small
    chunk)."""
    crop = max((n * CROP_NUM) // CROP_DEN, min(n, 1024))
    return min(-(-crop // 1024) * 1024, n)


def _crop_chunk(c):
    """Slice a per-tile sorted chunk to 3/8 of its slots (real entries
    are the sorted prefix; typical minimizer density 2/(w+1) ~ 1/3 of
    columns). The caller validates the real count against the crop and
    keeps the full chunk when it does not fit."""
    n = c[0].shape[0]
    crop = _crop_width(n)
    if crop == n:
        return c, n
    return [a[:crop] for a in c], crop


def _crops_fit(w):
    """Whether the expected minimizer density 2/(w+1) lies within the
    3/8 crop (w >= 5); below, chunks stay whole."""
    return 2 * CROP_DEN <= CROP_NUM * (w + 1)


def _compact_width(t, w):
    """The hash-range build's crop of a tile: 3/8 of the columns its
    rows use (emissions never exceed them; rows end short of W), rounded
    up to 1024, at most R*W; all of it when crops do not fit w."""
    n = t.R * t.W
    if not _crops_fit(w):
        return n
    crop = int(t.used.sum()) * CROP_NUM // CROP_DEN + 1
    return min(-(-crop // 1024) * 1024, n)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reckon_bytes(tiles, k, w, range_max):
    """Device bytes the hash-range build of `tiles` holds at its peak:
    the compacted chunks, the flat output (at most their slots), the
    widest tile's transients and one range's sort."""
    eb = (8 if 2 * k > 30 else 4) + 8          # hash + irid + ips
    slots = sum(_compact_width(t, w) for t in tiles)
    widest = max(t.R * t.W for t in tiles)
    return (2 * slots * eb + widest * TILE_BYTES_PER_COLUMN
            + range_max * (4 * eb + 8))


def free_bytes(device):
    """Device bytes this process can still take: the card's free memory
    (torch.cuda.mem_get_info) plus what PyTorch's cache holds unused;
    None (no limit) on the CPU."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))


def _ladder_chunks(tiles, k, w, device):
    """Every tile's chunk, cropped after the one sync where its real
    entries fit the crop (the crops are views of the full chunks)."""
    results = [_run_tile(t, k, w, device) for t in tiles]
    # one sync per part: the real entry counts
    n_exp = torch.stack([r[3] for r in results]).cpu().tolist()
    chunks = []
    for r, n in zip(results, n_exp):
        c, crop = _crop_chunk(list(r[:3]))
        chunks.append(list(r[:3]) if n > crop else c)
    return chunks, n_exp


def _compact_chunks(tiles, k, w, device):
    """Every tile's chunk, its crop (_compact_width) copied out as soon
    as it is made so the tile's full R*W storage is freed; after the one
    sync, a tile whose real entries pass its crop is re-run and kept
    whole."""
    chunks, counts = [], []
    for t in tiles:
        r = _run_tile(t, k, w, device)
        crop = _compact_width(t, w)
        c = list(r[:3])
        if crop < c[0].shape[0]:
            c = [a[:crop].clone() for a in c]
        chunks.append(c)
        counts.append(r[3])
        del r
    n_exp = torch.stack(counts).cpu().tolist()
    for i, (t, n) in enumerate(zip(tiles, n_exp)):
        if n > chunks[i][0].shape[0]:
            chunks[i] = list(_run_tile(t, k, w, device)[:3])
    return chunks, n_exp


def _range_merge(chunks, k, n_real, range_max, mid_occ_fixed,
                 mid_occ_frac):
    """Hash-range merge of sorted chunks into one flat sorted index of
    PAD_TO-padded width. Returns ([ih, irid, ips], S, mid_occ)."""
    dev = chunks[0][0].device
    hdt = chunks[0][0].dtype
    kb = 2 * k
    lg_f = min(kb, 12)
    F = 1 << lg_f
    # F fine ranges; S ranges are runs of F / S of them. The last
    # boundary, 2^2k, lies past every hash and below the sentinel
    bnd = (torch.arange(F + 1, dtype=torch.int64) << (kb - lg_f)).to(
        device=dev, dtype=hdt)
    offs = torch.stack([torch.searchsorted(c[0], bnd) for c in chunks]
                       ).cpu()
    fine = (offs[:, 1:] - offs[:, :-1]).sum(0)
    if int(fine.sum()) != n_real:
        raise RuntimeError("hash ranges hold %d entries, the tiles %d"
                           % (int(fine.sum()), n_real))
    S = 1
    while S < F and int(fine.reshape(S, -1).sum(1).max()) > range_max:
        S *= 2
    cuts = offs[:, ::F // S].tolist()          # (chunks, S + 1)
    n_out = min(max(-(-n_real // PAD_TO), 1) * PAD_TO, INDEX_MAX)
    ih = torch.full((n_out,), infk(hdt), dtype=hdt, device=dev)
    irid = torch.zeros(n_out, dtype=torch.int32, device=dev)
    ips = torch.zeros(n_out, dtype=torch.int32, device=dev)
    hist = None if mid_occ_fixed else _RunHist(dev)
    at = 0
    for s in range(S):
        sl = [(c, row[s], row[s + 1]) for c, row in zip(chunks, cuts)
              if row[s + 1] > row[s]]
        n = sum(b - a for _c, a, b in sl)
        if n == 0:
            continue
        sh, order = torch.sort(torch.cat([c[0][a:b] for c, a, b in sl]))
        ih[at:at + n] = sh
        if hist is not None:
            hist.add(sh)
        del sh
        for i, out in ((1, irid), (2, ips)):
            out[at:at + n] = torch.cat([c[i][a:b] for c, a, b in sl])[order]
        at += n
    if hist is None:
        mo = torch.tensor(int(mid_occ_fixed), dtype=torch.int32, device=dev)
    else:
        mo = hist.mid_occ(mid_occ_frac)
    return [ih, irid, ips], S, mo


def pack_part(part, w, ladder=TILE_LADDER):
    """The build's host step (span `part.pack`): the part's tiles
    (multi-read, then jumbo), their layout and bytes; no device work, so
    it may run on a thread beside another part's."""
    with span("part.pack"):
        tiles, jumbo = pack_part_tiles(part, w, ladder=ladder)
    return tiles + jumbo


def build_device_index(part, k, w, *, device, ladder=TILE_LADDER,
                       n_idx_sizes=N_IDX_SIZES, mid_occ_fixed=0,
                       mid_occ_frac=2e-4, range_max=RANGE_MAX,
                       max_entries=INDEX_MAX, mem_free=None, on_chunk=None,
                       tiles=None):
    """Build the sorted device index for one part. Returns a dict with
    ih (hash_dtype(k)) / irid / ips (int32) flat tensors of width
    n_idx, mid_occ (0-d int32 tensor), n_tiles, n_real (real entries),
    n_ranges (the hash-range build's S; 0 when the part fit the width
    ladder) and reckoned_bytes (reckon_bytes of that build; 0 on the
    ladder); its steps are the spans `part.pack` (the tiles' layout and
    bytes), `index.tiles` (the tiles' words, B1, chunks) and
    `index.merge`. Raises
    IndexOverflowError for an empty part, past
    max_entries real entries, or when a part past the ladder would need
    more device bytes (reckon_bytes) than mem_free (default: what
    free_bytes reports). on_chunk(chunk, n_real), if given, sees every
    tile's final sorted chunk before the merge. tiles: the part's tiles
    from pack_part, packed ahead by the caller; None packs them here."""
    device = torch.device(device)
    if tiles is None:
        tiles = pack_part(part, w, ladder=ladder)
    if not tiles:
        raise IndexOverflowError("empty part")
    need = 0
    with span("index.tiles"):
        if sum(_crop_width(t.R * t.W) for t in tiles) <= n_idx_sizes[-1]:
            chunks, n_exp = _ladder_chunks(tiles, k, w, device)
        else:
            need = reckon_bytes(tiles, k, w, range_max)
            free = free_bytes(device) if mem_free is None else mem_free
            if free is not None and need > free:
                raise IndexOverflowError("the part's index build needs ~%d "
                                         "device bytes, %d are free"
                                         % (need, free))
            chunks, n_exp = _compact_chunks(tiles, k, w, device)
    n_real = sum(n_exp)
    if n_real > max_entries:
        raise IndexOverflowError("part of %d index entries exceeds %d"
                                 % (n_real, max_entries))
    if on_chunk is not None:
        for c, n in zip(chunks, n_exp):
            on_chunk(c, n)
    with span("index.merge"):
        if sum(int(c[0].shape[0]) for c in chunks) <= n_idx_sizes[-1]:
            final, n_idx = _merge_chunks(chunks, n_idx_sizes)
            mo = _mid_occ(final[0], mid_occ_fixed, mid_occ_frac)
            n_ranges = 0
        else:
            final, n_ranges, mo = _range_merge(chunks, k, n_real, range_max,
                                               mid_occ_fixed, mid_occ_frac)
            n_idx = int(final[0].shape[0])
        del chunks
        _sync(device)
    ih, irid, ips = final
    return {"ih": ih, "irid": irid, "ips": ips, "mid_occ": mo,
            "n_idx": n_idx, "n_tiles": len(tiles), "n_real": n_real,
            "n_ranges": n_ranges, "reckoned_bytes": need}

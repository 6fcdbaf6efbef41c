"""Device index build for the overlap engine (flat 1-D layout).

Torch port of longqc_tpu/engine/device_index.py:

  reads --host pack--> multi-read 2-bit tiles (R, W; reads laid
      back-to-back in a row behind w-1 ambiguous separator bases)
    --per tile--> B1 sketch kernel (ops/sketch_cuda: per-column emit,
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

The port keeps only the flat index. A part past the top of the width
ladder raises IndexOverflowError and is computed by the exact host
spec; N_IDX_SIZES tops out at 2^26 entries (0.8 GB of int32 triples,
a ~200 Mbp part at w = 5; with 2k > 30 the hashes ride int64 lanes,
512 MB of the then 1.07 GB), which an 80 GB card holds with room to
spare, so the JAX package's hash-range-sharded layout is not needed.

Hash lanes are int32 for 2k <= 30 and int64 above
(`ops/sketch_cuda.hash_dtype`), each
with its dtype's max as the empty-slot sentinel (`infk`), which sorts
after every real hash; irid / ips are int32 either way.
"""

from dataclasses import dataclass

import numpy as np
import torch

from longqc_tpu_torch.io.pack import SEQ_NT4_SKETCH
from longqc_tpu_torch.ops.ringprop import INF32
from longqc_tpu_torch.ops.sketch_cuda import (READS_PER_ROW, hash_dtype,
                                              sketch_tiles)

# single-pass encode tables: ASCII byte -> 2-bit code / ambiguity
_CODE_OF = np.where(SEQ_NT4_SKETCH < 4, SEQ_NT4_SKETCH, 0).astype(np.uint8)
_AMB_OF = SEQ_NT4_SKETCH >= 4

# tile ladder: every level holds the same number of bases
TILE_LADDER = ((256, 8192), (32, 65536), (4, 524288))
JUMBO_W = 1 << 22          # single-row tiles for ultra-long reads
# index widths: a part pads to the smallest width that fits
N_IDX_SIZES = (1 << 21, 1 << 22, 1 << 23, 1 << 24, 1 << 25, 1 << 26)

# small geometry for tests / tiny workloads (same code paths)
N_IDX_SIZES_SMALL = (1 << 12, 1 << 15, 1 << 17, 1 << 19, 1 << 21,
                     1 << 24)
TILE_LADDER_SMALL = ((16, 2048), (4, 8192), (1, 32768))


@dataclass
class Tile:
    """One packed multi-read tile (host arrays)."""
    R: int
    W: int
    codes2: np.ndarray      # (R, W//16) uint32, 2-bit codes
    nmask: np.ndarray       # (R, W//32) uint32, 1 = ambiguous/padding
    startmask: np.ndarray   # (R, W//32) uint32, 1 = segment start
    endmask: np.ndarray     # (R, W//32) uint32, 1 = read's last column
    starts: np.ndarray      # (R, READS_PER_ROW) int32 read start pos
    gids: np.ndarray        # (R, READS_PER_ROW) int32 global read id
    used: np.ndarray        # (R,) int32 row used width
    n_reads: int


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
        """Pack one tile: the python loop computes only the layout;
        encoding and mask fills are single vectorized passes."""
        R, W, sep = self.R, self.W, self.sep
        starts = np.zeros((R, READS_PER_ROW), np.int32)
        gids = np.full((R, READS_PER_ROW), -1, np.int32)
        used = np.zeros(R, np.int32)
        seqs, rposs, rlens = [], [], []
        start_cols, end_cols = [], []     # flat R*W scatter targets
        n_reads = 0
        for r, row in enumerate(rows):
            pos = 0
            for j, (gid, seq) in enumerate(row):
                if j > 0:
                    # separators belong to the NEXT segment: a window
                    # ending at a separator entry may only ever track
                    # entries of the read the separators precede
                    start_cols.append(r * W + pos)
                    pos += sep
                else:
                    start_cols.append(r * W)
                seqs.append(seq)
                rposs.append(r * W + pos)
                rlens.append(len(seq))
                starts[r, j] = pos
                gids[r, j] = gid
                pos += len(seq)
                end_cols.append(r * W + pos - 1)
                n_reads += 1
            used[r] = pos
        raw = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
        rlens = np.asarray(rlens, np.int32)
        cum = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(rlens)]).astype(np.int64)
        # ragged arange: flat tile index of every base of every read
        tgt = np.arange(cum[-1], dtype=np.int64)
        tgt += np.repeat(np.asarray(rposs, np.int64) - cum[:-1], rlens)
        codes = np.zeros(R * W, np.uint8)
        amb = np.ones(R * W, bool)          # padding counts as ambiguous
        codes[tgt] = _CODE_OF[raw]
        amb[tgt] = _AMB_OF[raw]
        startb = np.zeros(R * W, bool)
        startb[np.asarray(start_cols, np.int64)] = True
        endb = np.zeros(R * W, bool)
        endb[np.asarray(end_cols, np.int64)] = True
        return Tile(R, W, _packbits32(codes.reshape(R, W)),
                    _packbits32(amb.reshape(R, W)),
                    _packbits32(startb.reshape(R, W)),
                    _packbits32(endb.reshape(R, W)),
                    starts, gids, used, n_reads)


def _packbits32(arr):
    """Bit/2-bit packing into uint32 words, little-endian in the word.
    Boolean arrays pack 32/word; uint8 code arrays (0..3) 16/word."""
    if arr.dtype == np.uint8:
        R, W = arr.shape
        a = arr.reshape(R, W // 16, 16).astype(np.uint32)
        shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
        return (a << shifts).sum(axis=2, dtype=np.uint32)
    R, W = arr.shape
    a = arr.reshape(R, W // 32, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    return (a << shifts).sum(axis=2, dtype=np.uint32)


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
    return (_packbits32(codes), _packbits32(amb), _packbits32(startb),
            _packbits32(endb), starts, gids)


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
    """The part exceeds the largest index width. Callers fall back to
    the exact host index for the part."""


def _run_tile(t, k, w, device):
    dev = lambda a: to_device_words(a, device)  # noqa: E731
    return tile_flat(dev(t.codes2), dev(t.nmask), dev(t.startmask),
                     dev(t.endmask),
                     torch.from_numpy(t.starts).to(device),
                     torch.from_numpy(t.gids).to(device),
                     W=t.W, k=k, w=w)


def _merge_chunks(chunks, n_idx_sizes):
    """Concatenate the tiles' sorted chunks, sentinel-pad to the
    smallest fitting index width, sort once."""
    n_slots = sum(int(c[0].shape[0]) for c in chunks)
    n_idx = next((s for s in n_idx_sizes if n_slots <= s), None)
    if n_idx is None:
        raise IndexOverflowError(
            "part exceeds the largest index width")
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


def runlen_sorted(ih):
    """Ascending per-key occurrence counts of the sorted hash array
    (padded with its dtype's sentinel past the real entries) and n_keys:
    run starts compact to the front by sorting their positions; each
    run's length is the gap to the next start (or to n_valid for the
    last run)."""
    N = ih.shape[0]
    BIG = INF32                # past every position (N <= 2^26)
    idx = torch.arange(N, dtype=torch.int64, device=ih.device)
    valid = ih != infk(ih.dtype)
    prev = torch.cat([torch.full((1,), -1, dtype=ih.dtype,
                                 device=ih.device), ih[:-1]])
    is_start = valid & (ih != prev)
    n_keys = is_start.sum()
    n_valid = valid.sum()
    sp = torch.sort(torch.where(is_start, idx, BIG)).values
    nxt = torch.cat([sp[1:], torch.full((1,), BIG, dtype=torch.int64,
                                        device=ih.device)])
    rl = torch.where(sp != BIG, torch.minimum(nxt, n_valid) - sp, BIG)
    return torch.sort(rl).values, n_keys


def _mid_occ_device(ih, *, frac):
    """Occurrence threshold as a 0-d int32 tensor: the kth smallest
    per-key count + 1, kth = min(int((1 - frac) * n_keys), n_keys - 1)
    in f64 like the host spec; 1 for an empty part."""
    rl_sorted, n_keys = runlen_sorted(ih)
    n = int(n_keys)
    if n == 0:
        return torch.tensor(1, dtype=torch.int32, device=ih.device)
    kth = min(int((1.0 - frac) * n), n - 1)
    return (rl_sorted[kth] + 1).to(torch.int32)


def _mid_occ(ih, mid_occ_fixed, mid_occ_frac):
    if mid_occ_fixed:
        return torch.tensor(int(mid_occ_fixed), dtype=torch.int32,
                            device=ih.device)
    return _mid_occ_device(ih, frac=mid_occ_frac)


CROP_NUM, CROP_DEN = 3, 8


def _crop_chunk(c):
    """Slice a per-tile sorted chunk to 3/8 of its slots (real entries
    are the sorted prefix; typical minimizer density 2/(w+1) ~ 1/3 of
    columns). The caller validates the real count against the crop and
    keeps the full chunk when it does not fit."""
    n = c[0].shape[0]
    crop = max((n * CROP_NUM) // CROP_DEN, min(n, 1024))
    crop = min(-(-crop // 1024) * 1024, n)
    if crop == n:
        return c, n
    return [a[:crop] for a in c], crop


def build_device_index(part, k, w, *, device, ladder=TILE_LADDER,
                       n_idx_sizes=N_IDX_SIZES, mid_occ_fixed=0,
                       mid_occ_frac=2e-4):
    """Build the sorted device index for one part. Returns a dict with
    ih (hash_dtype(k)) / irid / ips (int32) tensors of width n_idx,
    mid_occ (0-d int32 tensor), n_idx and n_tiles. Raises
    IndexOverflowError when the part does not fit the largest width."""
    tiles, jumbo = pack_part_tiles(part, w, ladder=ladder)
    tiles = tiles + jumbo
    results = [_run_tile(t, k, w, device) for t in tiles]
    # one sync per part: the real entry counts
    n_exp = torch.stack([r[3] for r in results]).cpu().tolist() \
        if results else []
    chunks = []
    for r, n in zip(results, n_exp):
        c, crop = _crop_chunk(list(r[:3]))
        chunks.append(list(r[:3]) if n > crop else c)
    if not chunks:
        raise IndexOverflowError("empty part")
    final, n_idx = _merge_chunks(chunks, n_idx_sizes)
    mo = _mid_occ(final[0], mid_occ_fixed, mid_occ_frac)
    ih, irid, ips = final
    return {"ih": ih, "irid": irid, "ips": ips, "mid_occ": mo,
            "n_idx": n_idx, "n_tiles": len(tiles)}

"""Plain (w,k)-minimizer sketch, as torch tensor ops (frozen copy).

A copy of the port's plain sketch (minimap2-coverage sketch.c:76-142,
re-derived as per-position rules over the buffer-entry sequence), with
the base table and the per-read compaction it needs. The port runs its
own CUDA kernel (B1) on the timed path; this plain version is the
reference's, and it imports nothing of the port. It runs on whatever
device its tensors are on.
"""

import numpy as np
import torch

# sketch.c:8-25: A C G T (and U as T) -> 0..3, everything else 4
SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _cs in enumerate(["Aa", "Cc", "Gg", "TtUu"]):
    for _c in _cs:
        SEQ_NT4[ord(_c)] = _i

UMAX = torch.iinfo(torch.int64).max


def hash64(key, mask):
    """Invertible minimizer hash (sketch.c:27-37) on int64 lanes."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def _shift_left(a, d, fill):
    """a'[..., i] = a[..., i+d], filling the right edge with `fill`."""
    if d == 0:
        return a
    pad = torch.full_like(a[:, :d], fill)
    return torch.cat([a[:, d:], pad], dim=1)


def _shift_right(a, d, fill):
    """a'[..., i] = a[..., i-d], filling the left edge with `fill`."""
    if d == 0:
        return a
    pad = torch.full_like(a[:, :d], fill)
    return torch.cat([pad, a[:, :-d]], dim=1)


def _sliding_rightmost_min(x, w):
    """For each s: (value, index) of the rightmost minimum over the
    window [s-w+1, s] (out-of-range treated as +inf), by
    shift-and-combine doubling: O(log w) vector steps."""
    L = x.shape[-1]
    idx = torch.arange(L, dtype=torch.int64, device=x.device).expand_as(x)
    vals, idxs = x, idx
    span = 1
    while span < w:
        step = min(span, w - span)
        sv = _shift_right(vals, step, UMAX)
        si = _shift_right(idxs, step, -1)
        # current (vals) is the right/tie-preferred side
        take = sv < vals
        vals = torch.where(take, sv, vals)
        idxs = torch.where(take, si, idxs)
        span += step
    return vals, idxs


def _sketch_core(codes, lengths, *, w, k):
    """Batched minimizer sketch over padded (B, L) code tiles (plain
    mode: positions are read offsets, every span is k).

    Returns a dict of (B, L) tensors aligned to buffer-entry positions:
    emit (int32 emission count), hash (int64 bare hash; UMAX when
    ineligible), pos (int32 read position of the k-mer's last base),
    strand (int32), n_entries (B,)."""
    assert 0 < w < 256 and 0 < k <= 28
    dev = codes.device
    B, L = codes.shape
    i64 = torch.int64
    mask = (1 << (2 * k)) - 1
    c = codes.to(i64)
    pos = torch.arange(L, dtype=i64, device=dev)[None, :]
    in_read = pos < lengths.to(i64)[:, None]
    valid = (codes < 4) & in_read

    # k-mers roll over the valid-base subsequence: compact valid bases
    vcount = torch.cumsum(valid.to(i64), dim=1)   # 1-based valid rank
    n_valid = vcount[:, -1]
    pos_of_vrank = torch.argsort(torch.where(valid, pos, L + pos), dim=1)
    cval = torch.where(valid, c, torch.zeros_like(c))
    cv = torch.gather(cval, 1, pos_of_vrank)

    kf = torch.zeros((B, L), dtype=i64, device=dev)
    kr = torch.zeros((B, L), dtype=i64, device=dev)
    shift1 = 2 * (k - 1)
    for j in range(k):
        # base entering j steps before the current one (age 0 in the
        # low bits: kmer[0] = kmer[0]<<2 | c)
        sh = _shift_right(cv, j, 0)
        # before the first k bases the register is 0 (positions < j
        # read the zero fill, which must not enter kr as 3 ^ 0)
        present = pos >= j
        kf = kf | (sh << (2 * j))
        kr = kr | torch.where(present, ((3 ^ sh) & 3) << (shift1 - 2 * j),
                              torch.zeros_like(sh))
    kf = kf & mask
    kr = kr & mask
    vspace = pos < n_valid[:, None]
    sym = (kf == kr) & vspace
    strand_v = torch.where(kf < kr, 0, 1).to(torch.int32)
    kmin = torch.minimum(kf, kr)
    hash_v = hash64(kmin, mask)

    # back to read space: arr_r[i] = arr_v[vcount[i]-1] where valid
    vr = (vcount - 1).clamp(0, L - 1)
    sym_r = torch.gather(sym, 1, vr) & valid
    hash_r = torch.where(valid, torch.gather(hash_v, 1, vr),
                         torch.full_like(hash_v, UMAX))
    strand_r = torch.where(valid, torch.gather(strand_v, 1, vr),
                           torch.zeros_like(strand_v))

    is_S = in_read & ~sym_r
    inc = (valid & ~sym_r).to(i64)
    ambig = in_read & ~valid
    cum_inc = torch.cumsum(inc, dim=1)
    amb_cum = torch.where(ambig, cum_inc, torch.zeros_like(cum_inc))
    run_base = torch.cummax(amb_cum, dim=1).values
    l_r = cum_inc - run_base

    # compact S-space arrays
    s_rank = torch.cumsum(is_S.to(i64), dim=1)
    n_S = s_rank[:, -1]
    pos_of_srank = torch.argsort(torch.where(is_S, pos, L + pos), dim=1)

    def compact(arr):
        return torch.gather(arr, 1, pos_of_srank)

    eligible = valid & (l_r >= k)
    xs = compact(torch.where(eligible, hash_r,
                             torch.full_like(hash_r, UMAX)))
    rpos = pos.expand(B, L)
    ys_pos = compact(torch.where(valid, rpos, torch.zeros_like(rpos)))
    ys_strand = compact(strand_r)
    ls = compact(l_r)
    sarange = pos
    sspace = sarange < n_S[:, None]
    xs = torch.where(sspace, xs, torch.full_like(xs, UMAX))

    wx, widx = _sliding_rightmost_min(xs, w)

    # rule A: reigns and pushes
    valid_tracked = (wx != UMAX) & sspace
    widx_eff = torch.where(valid_tracked, widx, torch.full_like(widx, -1))
    reign_end = torch.full((B, L), -1, dtype=i64, device=dev)
    for d in range(w):
        hit = _shift_left(widx_eff, d, -1) == sarange
        reign_end = torch.maximum(
            reign_end, torch.where(hit, sarange + d,
                                   torch.full_like(reign_end, -1)))
    has_reign = reign_end >= 0
    e = reign_end
    e_next = (e + 1).clamp(0, L - 1)
    x_next = torch.gather(xs, 1, e_next)
    l_next = torch.gather(ls, 1, e_next)
    at_end = e == (n_S[:, None] - 1)
    final_push = has_reign & at_end
    replace_push = has_reign & ~at_end & (x_next <= xs) & (l_next >= w + k)
    disp_push = has_reign & ~at_end & (x_next > xs) & (l_next >= w + k - 1)
    emitA = (final_push | replace_push | disp_push) & (xs != UMAX)

    # rules B and C per offset d in [1, w-1]
    countB = torch.zeros((B, L), dtype=torch.int32, device=dev)
    countC = torch.zeros((B, L), dtype=torch.int32, device=dev)
    wx_prev = _shift_right(wx, 1, UMAX)
    widx_prev = _shift_right(widx, 1, -1)
    disp_step = ((widx_prev == sarange - w) & (xs > wx_prev)
                 & (wx_prev != UMAX) & sspace & (sarange >= 1))
    is_t0 = (ls == w + k - 1) & sspace
    n_s = n_S[:, None]
    for d in range(1, w):
        valid_off = (sarange + d) < n_s
        b_hit = (_shift_left(is_t0, d, False)
                 & (xs == _shift_left(wx, d - 1, UMAX))
                 & (_shift_left(widx, d - 1, -1) != sarange)
                 & (xs != UMAX) & valid_off)
        countB += b_hit.to(torch.int32)
        c_hit = (_shift_left(disp_step, d, False)
                 & (_shift_left(ls, d, 0) >= w + k - 1)
                 & (xs == _shift_left(wx, d, UMAX))
                 & (_shift_left(widx, d, -1) != sarange)
                 & (xs != UMAX) & valid_off)
        countC += c_hit.to(torch.int32)

    return {
        "emit": emitA.to(torch.int32) + countB + countC,
        "hash": xs,
        "pos": ys_pos.to(torch.int32),
        "strand": ys_strand,
        "n_entries": n_S,
    }




def _bucket(n):
    b = 256
    while b < n:
        b *= 2
    return b


def sketch_reads(reads, k, w, device="cpu", max_cells=1 << 23):
    """Per-read minimizers of [name, seq, ...] reads, in read order ->
    list of (hash u64, pos i64, strand i64) arrays in position order,
    with multiplicity (a minimizer emitted twice is listed twice)."""
    order = sorted(range(len(reads)), key=lambda i: len(reads[i][1]))
    out = [None] * len(reads)
    off = 0
    while off < len(order):
        L = _bucket(len(reads[order[off]][1]))
        sel = []
        while (off < len(order) and len(reads[order[off]][1]) <= L
               and (len(sel) + 1) * L <= max(max_cells, L)):
            sel.append(order[off])
            off += 1
        codes = np.full((len(sel), L), 4, np.uint8)
        lengths = np.zeros(len(sel), np.int32)
        for j, i in enumerate(sel):
            s = np.frombuffer(reads[i][1].encode("ascii"), np.uint8)
            codes[j, :len(s)] = SEQ_NT4[s]
            lengths[j] = len(s)
        res = _sketch_core(torch.from_numpy(codes).to(device),
                           torch.from_numpy(lengths).to(device), w=w, k=k)
        emit = res["emit"].cpu().numpy()
        hsh = res["hash"].cpu().numpy()
        pos = res["pos"].cpu().numpy()
        strand = res["strand"].cpu().numpy()
        for j, i in enumerate(sel):
            idx = np.nonzero(emit[j] > 0)[0]
            rep = np.repeat(idx, emit[j][idx])
            out[i] = (hsh[j][rep].astype(np.uint64),
                      pos[j][rep].astype(np.int64),
                      strand[j][rep].astype(np.int64))
    return out

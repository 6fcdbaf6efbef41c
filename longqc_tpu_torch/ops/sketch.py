"""(w,k)-minimizer sketch as batched tensor ops (the host spec's sketch).

Torch port of longqc_tpu/ops/sketch.py: the reference sketch
(minimap2-coverage sketch.c:76-142) re-derived as per-position rules
over the buffer-entry sequence (see that module's docstring for rules
A, B and C), validated against the faithful emulation in
tests/oracles/sketch_ref.py. It is also the plain version behind the
B1 sketch kernel (ops/sketch_cuda).

Hashes ride int64 lanes for every k (<= 28): each step of hash64
re-masks to 2k bits, so a wrap mod 2^64 leaves the masked value as the
reference's u64 arithmetic does, and every right shift acts on a
masked, non-negative value, so it is logical. The sentinel of an
ineligible entry is int64 max, above every 2k-bit hash. Under HPC
(homopolymer-compressed input with per-entry spans, ops/sketch_hpc) the
key is the packed hash << 8 | span, non-negative for k <= 27.
"""

import numpy as np
import torch

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


def _sketch_core(codes, lengths, *, w, k, positions=None, spans=None,
                 seg=None):
    """Batched minimizer sketch over padded (B, L) code tiles.

    positions/spans: optional (B, L) overrides for homopolymer-compressed
    input (codes then hold one entry per HPC run; positions = run end
    index in the original read, spans = windowed sum of the last <= k
    run lengths, sketch.c:92-104). Default (plain mode): positions =
    arange, span = k.

    seg: optional (B, L) int read-segment ids for multi-read packed rows
    (non-decreasing along each row; each segment opens with >= w-1
    ambiguous separator bases owned by that segment). Emission rules
    are gated so each segment sketches as a standalone read.

    Returns a dict of (B, L) tensors aligned to buffer-entry positions:
    emit (int32 emission count), hash (int64 bare hash, or the packed
    hash << 8 | span under HPC; UMAX when ineligible), pos (int32 read
    position of the k-mer's last base), strand (int32), n_entries (B,),
    and seg when given."""
    assert 0 < w < 256 and 0 < k <= (28 if spans is None else 27)
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

    if spans is None:
        eligible = valid & (l_r >= k)
        packed_r = hash_r
    else:
        span_r = spans.to(i64)
        eligible = valid & (l_r >= k) & (span_r < 256) & (span_r > 0)
        packed_r = (hash_r << 8) | (span_r & 0xFF)
    xs = compact(torch.where(eligible, packed_r,
                             torch.full_like(hash_r, UMAX)))
    rpos = pos.expand(B, L) if positions is None else positions.to(i64)
    ys_pos = compact(torch.where(valid, rpos, torch.zeros_like(rpos)))
    ys_strand = compact(strand_r)
    ls = compact(l_r)
    sarange = pos
    sspace = sarange < n_S[:, None]
    xs = torch.where(sspace, xs, torch.full_like(xs, UMAX))
    seg_s = None
    SEGX = 1 << 30
    if seg is not None:
        seg_s = torch.where(sspace, compact(seg.to(i64)),
                            torch.full_like(xs, SEGX))

    wx, widx = _sliding_rightmost_min(xs, w)

    # rule A: reigns and pushes
    valid_tracked = (wx != UMAX) & sspace
    widx_eff = torch.where(valid_tracked, widx, torch.full_like(widx, -1))
    reign_end = torch.full((B, L), -1, dtype=i64, device=dev)
    for d in range(w):
        hit = _shift_left(widx_eff, d, -1) == sarange
        if seg_s is not None:
            hit = hit & (_shift_left(seg_s, d, -1) == seg_s)
        reign_end = torch.maximum(
            reign_end, torch.where(hit, sarange + d,
                                   torch.full_like(reign_end, -1)))
    has_reign = reign_end >= 0
    e = reign_end
    e_next = (e + 1).clamp(0, L - 1)
    x_next = torch.gather(xs, 1, e_next)
    l_next = torch.gather(ls, 1, e_next)
    at_end = e == (n_S[:, None] - 1)
    if seg_s is not None:
        at_end = at_end | (torch.gather(seg_s, 1, e_next) != seg_s)
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
        if seg_s is not None:
            valid_off = valid_off & (_shift_left(seg_s, d, SEGX) == seg_s)
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

    out = {
        "emit": emitA.to(torch.int32) + countB + countC,
        "hash": xs,
        "pos": ys_pos.to(torch.int32),
        "strand": ys_strand,
        "n_entries": n_S,
    }
    if seg_s is not None:
        out["seg"] = seg_s
    return out


def sketch_batch(codes, lengths, *, w, k, positions=None, spans=None):
    """Sketch of a (B, L) code batch (see _sketch_core); HPC input
    passes its positions and spans."""
    return _sketch_core(codes, lengths, w=w, k=k, positions=positions,
                        spans=spans)


def sketch_to_lists(res, k=None, packed=False):
    """Host compaction of sketch_batch output into per-read
    (hash u64, pos, strand, span) numpy arrays in position order with
    multiplicity. Plain mode stores bare hashes (span == k, given as
    k); HPC output (packed=True) stores hash << 8 | span."""
    if not packed and k is None:
        raise ValueError("bare-hash sketch output needs k for spans")
    emit = res["emit"].cpu().numpy()
    hsh = res["hash"].cpu().numpy()
    pos = res["pos"].cpu().numpy()
    strand = res["strand"].cpu().numpy()
    out = []
    for b in range(emit.shape[0]):
        idx = np.nonzero(emit[b] > 0)[0]
        rep = np.repeat(idx, emit[b][idx])
        hh = hsh[b][rep]
        if packed:
            h, span = hh >> 8, hh & 0xFF
        else:
            h, span = hh, np.full(len(rep), k, np.int64)
        out.append((h.astype(np.uint64), pos[b][rep].astype(np.int64),
                    strand[b][rep].astype(np.int64), span.astype(np.int64)))
    return out

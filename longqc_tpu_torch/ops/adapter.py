"""Adapter search/trim: batched infix edit-distance DP (port of
longqc_tpu/ops/adapter).

Equivalent of the reference's edlib usage (lq_adapt.py:30,65):
`edlib.align(adapter, window, mode="HW", task='path')` — semi-global
alignment where the adapter must align fully but may start/end anywhere
in the window; identity = 1 - dist/alignment_length; reads with
identity > 0.75 are trimmed at the match boundary.

The distance scan runs as batched torch ops over (B, window) tiles on
the given device (a column-wise DP over the reads); the per-candidate
traceback
(tiny, only for reads beating the identity threshold's distance bound)
runs on host. Traceback prefers diagonal, then query-consuming,
then target-consuming moves; edlib's own tie-breaking may differ in
degenerate ties, which can only shift identity by O(1/len) around the
threshold. tests/test_adapter_ties.py pins this: distance and the
first-optimal end (tie-free, must equal edlib exactly) are checked
against an exhaustive oracle, our (start, align_len) choice is proven
to lie in the optimal-path set, and the worst-case identity spread
across optimal paths is measured and bounded.
"""

import numpy as np
import torch

from longqc_tpu_torch.io.pack import SEQ_NT4_SKETCH
from longqc_tpu_torch.ops._ext import require_device


def encode(seq):
    return SEQ_NT4_SKETCH[np.frombuffer(seq.encode("ascii"),
                                        dtype=np.uint8)].astype(np.int32)


def _hw_dist_batch(windows, win_lens, adp, m):
    """Infix DP: windows (B, Lw) int32 codes, win_lens (B,) and adp (m,)
    codes, int32 tensors of one device.

    Returns (best_dist, best_end) per read, int32 tensors; best_end =
    smallest end position achieving the minimum (edlib lists end
    locations in ascending order and the reference takes the first).
    A torch loop over the window's columns; each column's vertical
    dependency is a running minimum down the adapter.
    """
    B, Lw = windows.shape
    dev = windows.device
    big = 10**6
    ar = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    # boundary column D[i][.] before any target char: D[0]=0, D[i]=i
    # (query prefix unmatched costs insertions; target prefix is free)
    col = torch.arange(m + 1, dtype=torch.int32,
                       device=dev)[None, :].expand(B, m + 1).contiguous()
    best = torch.full((B,), big, dtype=torch.int32, device=dev)
    bend = torch.zeros((B,), dtype=torch.int32, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for j in range(Lw):
        tj = windows[:, j]
        # D[i][j] = min(D[i-1][j-1]+sub, D[i-1][j]+1, D[i][j-1]+1)
        sub = (adp[None, :] != tj[:, None]).to(torch.int32)
        diag = col[:, :-1] + sub              # from D[i-1][j-1]
        left = col[:, 1:] + 1                 # from D[i][j-1]
        base = torch.minimum(diag, left)      # (B, m) for i=1..m
        # vertical dependency D[i-1][j]+1 as a prefix minimum:
        # D[i][j] = min_{i' <= i} base[i'] + (i - i'), run on base[i] - i
        run = torch.cummin(base - ar, dim=1).values
        # also the pure-vertical path from D[0][j] = 0: cost i = ar+1
        col_j = torch.minimum(run + ar, ar + 1)
        col = torch.cat([zero, col_j], dim=1)
        d = col_j[:, m - 1]
        better = (d < best) & (j < win_lens)
        best = torch.where(better, d, best)
        bend = torch.where(better, j, bend)
    return best, bend


# running tally of threshold decisions that depend on which optimal
# path a traceback picks (i.e., the only regime where our result could
# differ from edlib's unknowable tie-break); zero on real adapter
# workloads — see tests/test_adapter_ties.py
TIE_STATS = {"candidates": 0, "ambiguous_identity": 0,
             "ambiguous_start": 0}


def hw_align_optrange(adp, window):
    """Bounds over ALL optimal HW alignments ending at the first
    optimal end: (dist, end, alen_min, alen_max, start_min, start_max).

    Computed by a forward DP over the optimal-path subgraph (O(mn), no
    enumeration): g(i, j) = min/max alignment columns and start bounds
    over optimal prefixes from any (0, start) to (i, j). Any correct
    traceback — edlib's included — reports an (start, align_len)
    inside these bounds, so when both identity bounds fall on the same
    side of the trim threshold the decision is exact regardless of
    edlib's tie-break."""
    m, n = len(adp), len(window)
    if n == 0:
        return None
    D = np.zeros((m + 1, n + 1), np.int32)
    D[:, 0] = np.arange(m + 1)
    for j in range(1, n + 1):
        tj = window[j - 1]
        for i in range(1, m + 1):
            c = 0 if adp[i - 1] == tj else 1
            D[i, j] = min(D[i - 1, j - 1] + c, D[i - 1, j] + 1,
                          D[i, j - 1] + 1)
    dist = int(D[m, 1:].min())
    end = int(np.argmin(D[m, 1:]))

    BIG = 1 << 30
    # forward bounds over prefixes that can extend to an optimal path;
    # restrict to the band of columns that can reach (m, end+1)
    amin = np.full((m + 1, n + 1), BIG, np.int64)
    amax = np.full((m + 1, n + 1), -BIG, np.int64)
    smin = np.full((m + 1, n + 1), BIG, np.int64)
    smax = np.full((m + 1, n + 1), -BIG, np.int64)
    amin[0, :] = amax[0, :] = 0
    smin[0, :] = smax[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(0, end + 2):
            best = D[i, j]
            cands = []
            if j > 0:
                c = 0 if adp[i - 1] == window[j - 1] else 1
                if best == D[i - 1, j - 1] + c:
                    cands.append((i - 1, j - 1))
                if best == D[i, j - 1] + 1:
                    cands.append((i, j - 1))
            if best == D[i - 1, j] + 1:
                cands.append((i - 1, j))
            for (pi, pj) in cands:
                if amin[pi, pj] == BIG:
                    continue
                amin[i, j] = min(amin[i, j], amin[pi, pj] + 1)
                amax[i, j] = max(amax[i, j], amax[pi, pj] + 1)
                smin[i, j] = min(smin[i, j], smin[pi, pj])
                smax[i, j] = max(smax[i, j], smax[pi, pj])
    return (dist, end, int(amin[m, end + 1]), int(amax[m, end + 1]),
            int(smin[m, end + 1]), int(smax[m, end + 1]))


def hw_align_host(adp, window):
    """Full infix DP + traceback on host -> (dist, start, end, align_len)
    or None if window shorter than 1."""
    m = len(adp)
    n = len(window)
    if n == 0:
        return None
    D = np.zeros((m + 1, n + 1), np.int32)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = 0
    for j in range(1, n + 1):
        tj = window[j - 1]
        for i in range(1, m + 1):
            c = 0 if adp[i - 1] == tj else 1
            D[i, j] = min(D[i - 1, j - 1] + c, D[i - 1, j] + 1,
                          D[i, j - 1] + 1)
    dist = int(D[m, 1:].min())
    end = int(np.argmin(D[m, 1:]))  # 0-based target index of last char
    # traceback from (m, end+1): prefer diag, then up (query), then left
    i, j = m, end + 1
    n_ops = 0
    while i > 0:
        n_ops += 1
        c = 0 if (j > 0 and adp[i - 1] == window[j - 1]) else 1
        if j > 0 and D[i, j] == D[i - 1, j - 1] + c:
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
    start = j
    # remaining leftward moves at i==0 are free (HW prefix)
    align_len = n_ops + 0
    # align_len counts M/I ops so far; add D ops (target-only) counted in
    # the loop via the else branch — already counted in n_ops.
    return dist, start, end, align_len


def adapter_dists(reads, adp, where, length=150, device="cuda"):
    """Device pass: min edit distance + end for each read's window.

    where: 'head' or 'tail' (first/last `length` bp).
    Reads shorter than 2*length are skipped (dist = big).
    Returns numpy (dists, ends, skipped_mask).
    """
    device = require_device(device)
    adp_codes = encode(adp)
    m = len(adp_codes)
    B = len(reads)
    windows = np.full((B, length), 4, np.int32)
    win_lens = np.zeros((B,), np.int32)
    skipped = np.zeros((B,), bool)
    for i, r in enumerate(reads):
        s = r[1]
        if len(s) < 2 * length:
            skipped[i] = True
            continue
        wseq = s[:length] if where == "head" else s[-length:]
        windows[i, :len(wseq)] = encode(wseq)
        win_lens[i] = len(wseq)
    dists, ends = _hw_dist_batch(torch.from_numpy(windows).to(device),
                                 torch.from_numpy(win_lens).to(device),
                                 torch.from_numpy(adp_codes).to(device), m)
    return dists.cpu().numpy(), ends.cpu().numpy(), skipped


def cut_adapter(reads, len_list=None, adp_t=None, adp_b=None, th=0.75,
                length=150, device="cuda"):
    """Adapter search + in-place trim, mirroring lq_adapt.cut_adapter.

    Returns ((iden5, n5, pos5), (iden3, n3, pos3)) per presence of
    adp_t/adp_b, same shapes as the reference (lq_adapt.py:80-103).
    """
    if not adp_t and not adp_b:
        return None

    def one_side(adp, where):
        iden_max = -1.0
        match_num = 0
        cut_pos = []
        dists, ends, skipped = adapter_dists(reads, adp, where, length,
                                             device)
        m = len(adp)
        # identity bound: identity = 1 - d/alen, alen <= m + d
        # => candidates need 1 - d/(m+d) > th  <=> d < m*(1-th)/th
        cand = (~skipped) & (dists < int(np.ceil(m * (1 - th) / th)) + 1)
        adp_codes = encode(adp)
        for i in np.nonzero(cand)[0]:
            r = reads[i]
            s = r[1]
            wseq = s[:length] if where == "head" else s[-length:]
            res = hw_align_host(adp_codes, encode(wseq))
            if res is None:
                continue
            dist, start, end, alen = res
            identity = 1.0 - float(dist / alen)
            # tie accounting: when every optimal path agrees on the
            # threshold comparison, the trim decision is exact for ANY
            # tie-break edlib could use. align_len always lies in
            # [m, m+d], so a straddle needs d in the narrow band where
            # 1-d/m <= th < 1-d/(m+d) — only then is the O(mn) range
            # DP run. Tail-start ambiguity (affects the cut position)
            # is sampled. Straddles are tallied in TIE_STATS (zero on
            # real adapter workloads, tests/test_adapter_ties.py).
            TIE_STATS["candidates"] += 1
            may_straddle = (1.0 - dist / max(m, 1) <= th
                            < 1.0 - dist / (m + dist))
            sample_start = (where == "tail" and identity > th
                            and TIE_STATS["candidates"] <= 200)
            if may_straddle or sample_start:
                rng_ = hw_align_optrange(adp_codes, encode(wseq))
                if rng_ is not None:
                    _d, _e, amin, amax, smin, smax = rng_
                    lo = 1.0 - float(_d / amin) if amin else 1.0
                    hi = 1.0 - float(_d / amax) if amax else 1.0
                    if (lo > th) != (hi > th):
                        TIE_STATS["ambiguous_identity"] += 1
                    if sample_start and smin != smax:
                        TIE_STATS["ambiguous_start"] += 1
            if identity > th:
                match_num += 1
                if identity > iden_max:
                    iden_max = identity
                if where == "head":
                    cut_pos.append(end)
                    r[1] = s[end + 1:]
                    if len(r) > 2 and r[2]:
                        r[2] = r[2][end + 1:]
                else:
                    cut = len(s) - length + start
                    cut_pos.append(length - start)
                    r[1] = s[:cut]
                    if len(r) > 2 and r[2]:
                        r[2] = r[2][:cut]
        return (iden_max, match_num, cut_pos)

    if adp_t and adp_b:
        t5 = one_side(adp_t, "head")
        t3 = one_side(adp_b, "tail")
        return (t5, t3)
    if adp_t:
        return one_side(adp_t, "head")
    return one_side(adp_b, "tail")

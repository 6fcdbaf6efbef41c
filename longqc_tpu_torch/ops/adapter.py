"""Adapter search/trim: batched infix edit-distance DP (port of
longqc_tpu/ops/adapter).

Equivalent of the reference's edlib usage (lq_adapt.py:30,65):
`edlib.align(adapter, window, mode="HW", task='path')` — semi-global
alignment where the adapter must align fully but may start/end anywhere
in the window; identity = 1 - dist/alignment_length; reads with
identity > 0.75 are trimmed at the match boundary.

The distance scan runs as batched torch ops over (B, window) tiles on
the given device (a column-wise DP over the reads). The traceback of the
candidates (reads beating the identity threshold's distance bound) runs
on the same device too: hw_align_batch aligns all candidate windows of
one side in one launch of csrc/adapter.cu on CUDA tensors, and on CPU
tensors runs its plain twin, the same DP by numpy over all windows at
once; both equal, field by field, the JAX package's per-candidate host
functions hw_align_host and hw_align_optrange (longqc_tpu/ops/adapter).
Traceback prefers diagonal, then query-consuming, then target-consuming
moves; edlib's own tie-breaking may differ in degenerate ties, which can
only shift identity by O(1/len) around the threshold. tests/test_adapter_ties.py
pins this: distance and the first-optimal end (tie-free, must equal
edlib exactly) are checked against an exhaustive oracle, our (start,
align_len) choice is proven to lie in the optimal-path set, and the
worst-case identity spread across optimal paths is measured and bounded.
"""

import numpy as np
import torch

from longqc_tpu_torch import tracing
from longqc_tpu_torch.io.pack import SEQ_NT4_SKETCH
from longqc_tpu_torch.ops import _ext
from longqc_tpu_torch.ops._ext import require_device
from longqc_tpu_torch.tracing import span


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


def _align_plain(adp, windows, win_lens):
    """hw_align_batch's plain twin, numpy over all windows at once: the
    DP column by column and down the adapter's rows, each cell's move and
    bounds over optimal paths, then every window's traceback in step."""
    C, Lw = windows.shape
    m = len(adp)
    n = win_lens.clip(0, Lw)
    BIG = 1 << 30
    ar = np.arange(C)
    # the column before, rows 0..m by windows: D, amin, amax, smin, smax
    col = [np.repeat(np.arange(m + 1)[:, None], C, 1) for _ in range(3)] \
        + [np.zeros((m + 1, C), np.int64) for _ in range(2)]
    moves = np.zeros((Lw + 1, m + 1, C), np.int8)
    best = np.full(C, BIG)
    bj = np.zeros(C, np.int64)
    bnd = np.zeros((4, C), np.int64)
    for j in range(1, Lw + 1):
        new = [np.empty_like(x) for x in col]
        for x, v in zip(new, (0, 0, 0, j, j)):
            x[0] = v
        for i in range(1, m + 1):
            pred = [[x[i - 1] for x in col], [x[i - 1] for x in new],
                    [x[i] for x in col]]          # diagonal, query, target
            cost = [pred[0][0] + (adp[i - 1] != windows[:, j - 1]),
                    pred[1][0] + 1, pred[2][0] + 1]
            d = np.minimum(np.minimum(cost[0], cost[1]), cost[2])
            on = [cst == d for cst in cost]
            new[0][i] = d
            for f, red, far in ((1, np.minimum, BIG), (2, np.maximum, -BIG),
                                (3, np.minimum, BIG), (4, np.maximum, -BIG)):
                acc = np.full(C, far)
                for o, p in zip(on, pred):
                    acc = np.where(o, red(acc, p[f]), acc)
                new[f][i] = acc + (f <= 2)
            moves[j, i] = np.where(on[0], 0, np.where(on[1], 1, 2))
        # the first column of row m's minimum over the window's columns
        up = (new[0][m] < best) & (j <= n)
        best = np.where(up, new[0][m], best)
        bj = np.where(up, j, bj)
        bnd = np.where(up, np.stack([x[m] for x in new[1:]]), bnd)
        col = new
    # traceback from (m, bj); at column 0 the rest of the way is query moves
    ii, jj, ops = np.full(C, m), bj.copy(), np.zeros(C, np.int64)
    for _ in range(m + Lw):
        on = (ii > 0) & (jj > 0)
        mo = moves[jj, ii, ar]
        ops += on
        ii = ii - (on & (mo != 2))
        jj = jj - (on & (mo != 1))
    out = np.stack([best, jj, bj - 1, ops + ii] + list(bnd)).astype(np.int32)
    out[:, n == 0] = -1
    return out


ALIGN_SCRATCH_BYTES = 1 << 28   # the kernel's warp slots (moves and strip
#                                 edges of one candidate each) take at most
#                                 this many bytes


def hw_align_batch(adp, windows, win_lens):
    """All candidate windows of one side against the adapter: adp (m,),
    windows (C, Lw) and win_lens (C,) int32 codes of one device -> (8, C)
    int32 rows dist, start, end, align_len (the JAX package's
    hw_align_host's) and amin, amax, smin, smax (its hw_align_optrange's
    bounds at (m, end + 1)) of the window's first win_lens[c] columns; -1
    throughout for a window of no columns (where both give None). CUDA
    tensors launch csrc/adapter.cu and count their windows under
    adapter.align_kernel, CPU tensors run the plain twin, _align_plain."""
    m = adp.shape[0] if adp.dim() == 1 else 0
    if m < 1 or windows.dim() != 2 or \
            tuple(win_lens.shape) != (windows.shape[0],):
        raise ValueError("hw_align_batch takes adp (m >= 1,), windows "
                         "(C, Lw) and win_lens (C,)")
    C, Lw = windows.shape
    if windows.device.type == "cpu":
        return torch.from_numpy(_align_plain(
            adp.numpy(), windows.numpy(), win_lens.numpy()))
    ins = [t.contiguous() for t in (adp, windows, win_lens)]
    _ext.require_cuda(*ins)
    adp, windows, win_lens = ins
    dev = windows.device
    out = torch.empty((8, C), dtype=torch.int32, device=dev)
    tracing.count("adapter.align_kernel", C)
    if C == 0:
        return out
    mv_bytes = -(-m // 32) * (Lw + 32) * 32
    edge_ints = 2 * 5 * (Lw + 1)
    nslot = min(C, max(1, ALIGN_SCRATCH_BYTES // (mv_bytes + 4 * edge_ints)))
    moves = torch.empty(nslot * mv_bytes, dtype=torch.uint8, device=dev)
    edges = torch.empty(nslot * edge_ints, dtype=torch.int32, device=dev)
    _ext.LAUNCHES["adapter_align"] += 1
    _ext.lib().adapter_align(adp, windows, win_lens, out, moves, edges,
                             nslot)
    return out


def _search_dp(reads, adp_codes, where, length, device):
    """The distance scan of one side: (dists, ends, skipped) as numpy,
    and the adapter, windows and window lengths as tensors of `device`
    (the candidates' windows are taken from them)."""
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
    a, w, wl = (torch.from_numpy(x).to(device)
                for x in (adp_codes, windows, win_lens))
    dists, ends = _hw_dist_batch(w, wl, a, m)
    return dists.cpu().numpy(), ends.cpu().numpy(), skipped, (a, w, wl)


def adapter_dists(reads, adp, where, length=150, device="cuda"):
    """Device pass: min edit distance + end for each read's window.

    where: 'head' or 'tail' (first/last `length` bp).
    Reads shorter than 2*length are skipped (dist = big).
    Returns numpy (dists, ends, skipped_mask).
    """
    device = require_device(device)
    return _search_dp(reads, encode(adp), where, length, device)[:3]


def cut_adapter(reads, len_list=None, adp_t=None, adp_b=None, th=0.75,
                length=150, device="cuda"):
    """Adapter search + in-place trim, mirroring lq_adapt.cut_adapter.

    Returns ((iden5, n5, pos5), (iden3, n3, pos3)) per presence of
    adp_t/adp_b, same shapes as the reference (lq_adapt.py:80-103).
    """
    if not adp_t and not adp_b:
        return None
    device = require_device(device)

    def one_side(adp, where):
        iden_max = -1.0
        match_num = 0
        cut_pos = []
        adp_codes = encode(adp)
        m = len(adp_codes)
        with span("adapter.dp"):
            dists, ends, skipped, (a, w, wl) = _search_dp(
                reads, adp_codes, where, length, device)
        # identity bound: identity = 1 - d/alen, alen <= m + d
        # => candidates need 1 - d/(m+d) > th  <=> d < m*(1-th)/th
        cand = (~skipped) & (dists < int(np.ceil(m * (1 - th) / th)) + 1)
        idx = np.nonzero(cand)[0]
        n_range = 0
        with span("adapter.align"):
            sel = torch.from_numpy(idx).to(device)
            aligned = hw_align_batch(a, w.index_select(0, sel),
                                     wl.index_select(0, sel)).cpu().numpy()
            for i, res in zip(idx, aligned.T.tolist()):
                dist, start, end, alen, amin, amax, smin, smax = res
                if dist < 0:        # a window of no columns
                    continue
                identity = 1.0 - float(dist / alen)
                # tie accounting: when every optimal path agrees on the
                # threshold comparison, the trim decision is exact for ANY
                # tie-break edlib could use. align_len always lies in
                # [m, m+d], so a straddle needs d in the narrow band where
                # 1-d/m <= th < 1-d/(m+d) — only there are the bounds over
                # the optimal paths read. Tail-start ambiguity (affects the
                # cut position) is sampled. Straddles are tallied in
                # TIE_STATS (zero on real adapter workloads,
                # tests/test_adapter_ties.py).
                TIE_STATS["candidates"] += 1
                may_straddle = (1.0 - dist / max(m, 1) <= th
                                < 1.0 - dist / (m + dist))
                sample_start = (where == "tail" and identity > th
                                and TIE_STATS["candidates"] <= 200)
                if may_straddle or sample_start:
                    n_range += 1
                    lo = 1.0 - float(dist / amin) if amin else 1.0
                    hi = 1.0 - float(dist / amax) if amax else 1.0
                    if (lo > th) != (hi > th):
                        TIE_STATS["ambiguous_identity"] += 1
                    if sample_start and smin != smax:
                        TIE_STATS["ambiguous_start"] += 1
                if identity > th:
                    r = reads[i]
                    s = r[1]
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
        tracing.count("adapter.candidates", len(idx))
        tracing.count("adapter.straddle_dp", n_range)
        return (iden_max, match_num, cut_pos)

    if adp_t and adp_b:
        t5 = one_side(adp_t, "head")
        t3 = one_side(adp_b, "tail")
        return (t5, t3)
    if adp_t:
        return one_side(adp_t, "head")
    return one_side(adp_b, "tail")

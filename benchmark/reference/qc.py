"""Plain sampleqc values: the reference the QC JSON and the mask table
are judged by.

NumPy and SciPy only, importing nothing of the port. It follows LongQC's
sampleqc (longQC.py:66-865) as the port states it:

  * the per-read table (sdust.c:211-217): length, masked length (the
    sdust recursion, a frozen copy of the port's Python spec), masked
    fraction, meanQ (lqutils.c:51-58), bases over Q7;
  * length statistics, N50 and the gamma fit (scipy, floc=0,
    lq_gamma.py:47-53); per-read GC (lq_gcfrac.py);
  * the adapter search (lq_adapt.py: edlib HW alignment of the adapter
    within the first / last 150 bp, identity = 1 - dist / alignment
    length, trimmed above 0.75), as one column-wise DP over all reads
    and a traceback per candidate that prefers diagonal, then query,
    then target moves;
  * the reservoir subsample (lq_utils.py:371-411, seed 7, the RNG reset
    every chunk of 0.5 GiB by sys.getsizeof accounting);
  * the coverage fits over the coverage rows (lq_coverage.py:68-655): a
    2-component GMM with a deterministic quantile start, a Normal +
    LogNormal mixture where coverage is low, the Xome-size estimate.

`dtype=np.float32` is the control: the fits and the GC statistics in
float32 instead of float64.
"""

import math
import sys

import numpy as np
from scipy.signal import argrelmax
from scipy.stats import gamma as scipy_gamma

from benchmark.reference.overlap import Q2P

ADAPTER_TH = 0.75
ADAPTER_LEN = 150
SUBSAMPLE_SEED = 7
CHUNK_BYTES = int(0.5 * 1024 ** 3)

# sdust.c:26-43: A C G T -> 0..3, everything else (U too) 4
SEQ_NT4_SDUST = np.full(256, 4, dtype=np.uint8)
for _i, _cs in enumerate(["Aa", "Cc", "Gg", "Tt"]):
    for _c in _cs:
        SEQ_NT4_SDUST[ord(_c)] = _i
SD_WLEN, SD_WTOT = 3, 64


# ---------------------------------------------------------------------------
# per-read table


def sdust_masked_length(seq, T=20, W=64):
    """Masked bases of one read by the symmetric DUST recursion
    (sdust.c:72-177)."""
    codes = SEQ_NT4_SDUST[np.frombuffer(seq.encode("ascii"), np.uint8)]
    res, P, win = [], [], []
    st = {"L": 0, "rw": 0, "rv": 0}
    cw = [0] * SD_WTOT
    cv = [0] * SD_WTOT

    def save_masked_regions(start):
        if not P or P[-1]["start"] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p["start"] <= f:
                saved = True
                res[-1] = (s, max(f, p["finish"]))
        if not saved:
            res.append((p["start"], p["finish"]))
        i = len(P) - 1
        while i >= 0 and P[i]["start"] < start:
            i -= 1
        del P[i + 1:]

    def shift_window(t):
        if len(win) >= W - SD_WLEN + 1:
            s = win.pop(0)
            cw[s] -= 1
            st["rw"] -= cw[s]
            if st["L"] > len(win):
                st["L"] -= 1
                cv[s] -= 1
                st["rv"] -= cv[s]
        win.append(t)
        st["L"] += 1
        st["rw"] += cw[t]
        cw[t] += 1
        st["rv"] += cv[t]
        cv[t] += 1
        if cv[t] * 10 > (T << 1):
            while True:
                s = win[len(win) - st["L"]]
                cv[s] -= 1
                st["rv"] -= cv[s]
                st["L"] -= 1
                if s == t:
                    break

    def find_perfect(start):
        c = list(cv)
        r = st["rv"]
        max_r = max_l = 0
        for i in range(len(win) - st["L"] - 1, -1, -1):
            t = win[i]
            r += c[t]
            c[t] += 1
            new_r, new_l = r, len(win) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j]["start"] >= i + start:
                    p = P[j]
                    if max_r == 0 or p["r"] * max_l > max_r * p["l"]:
                        max_r, max_l = p["r"], p["l"]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, {"start": i + start,
                                 "finish": len(win) + SD_WLEN - 1 + start,
                                 "r": new_r, "l": new_l})

    l = t = 0
    n = len(codes)
    for i in range(n + 1):
        b = int(codes[i]) if i < n else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & (SD_WTOT - 1)
            if l >= SD_WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                save_masked_regions(start)
                shift_window(t)
                if st["rw"] * 10 > st["L"] * T:
                    find_perfect(start)
        else:
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                save_masked_regions(start)
                start += 1
            l = t = 0
    return sum(e - s for s, e in res)


def read_table(reads, block=512, dtype=np.float64):
    """Per read: length, meanQ (phred histogram times q2p, in dtype),
    bases over Q7, GC count."""
    n = len(reads)
    lengths = np.zeros(n, np.int64)
    meanq = np.zeros(n, np.float64)
    nq7 = np.zeros(n, np.int64)
    ngc = np.zeros(n, np.int64)
    for b0 in range(0, n, block):
        hist = np.zeros((min(block, n - b0), 127), np.int64)
        for j, r in enumerate(reads[b0:b0 + block]):
            q = np.frombuffer(r[2].encode("ascii"), np.uint8).astype(
                np.int64) - 33
            hist[j] = np.bincount(np.clip(q, 0, 126), minlength=127)
            s = np.frombuffer(r[1].encode("ascii"), np.uint8)
            c = SEQ_NT4_SDUST[s]
            ngc[b0 + j] = int(((c == 1) | (c == 2)).sum())
            lengths[b0 + j] = len(s)
        s = hist.astype(dtype) @ Q2P.astype(dtype)
        ln = lengths[b0:b0 + len(hist)]
        meanq[b0:b0 + len(hist)] = dtype(-10.0) * np.log10(
            s / np.maximum(ln.astype(dtype), dtype(1.0)))
        nq7[b0:b0 + len(hist)] = hist[:, 8:].sum(axis=1)
    return {"length": lengths, "meanq": meanq, "nq7": nq7, "ngc": ngc}


def mask_row(read, table, i, masked=None):
    """The table's row of read i; masked length by the recursion when
    `masked` is None."""
    ml = sdust_masked_length(read[1]) if masked is None else masked
    ln = int(table["length"][i])
    return "%s\t%d\t%d\t%.3f\t%.3f\t%d" % (
        read[0], ml, ln, ml / ln if ln else 0.0, table["meanq"][i],
        int(table["nq7"][i]))


def n50(lengths):
    a = np.sort(np.asarray(lengths))[::-1]
    c = np.cumsum(a)
    return a[min(int(np.searchsorted(c, a.sum() / 2)), len(a) - 1)]


# ---------------------------------------------------------------------------
# adapter search


def _codes(seq):
    from benchmark.reference.sketch import SEQ_NT4
    return SEQ_NT4[np.frombuffer(seq.encode("ascii"), np.uint8)].astype(
        np.int32)


def hw_dp(adp, windows):
    """Infix edit-distance DP of adapter `adp` (m,) in each row of
    windows (B, n) -> D (B, m + 1, n + 1): D[:, 0, :] = 0 (the target
    prefix is free), D[:, i, 0] = i."""
    B, n = windows.shape
    m = len(adp)
    D = np.zeros((B, m + 1, n + 1), np.int32)
    D[:, :, 0] = np.arange(m + 1)
    ar = np.arange(1, m + 1, dtype=np.int32)
    for j in range(1, n + 1):
        sub = (adp[None, :] != windows[:, j - 1:j]).astype(np.int32)
        base = np.minimum(D[:, :-1, j - 1] + sub, D[:, 1:, j - 1] + 1)
        # the vertical term D[i-1][j] + 1 as a running minimum of
        # base[i'] + (i - i'), from D[0][j] = 0
        run = np.minimum.accumulate(base - ar[None, :], axis=1) + ar[None, :]
        D[:, 1:, j] = np.minimum(run, ar[None, :])
    return D


def hw_traceback(D, adp, window):
    """(dist, start, end, align_len) of the first optimal end
    (lq_adapt.py's edlib HW path; diagonal, then query, then target)."""
    m, n = len(adp), len(window)
    row = D[m, 1:n + 1]
    dist = int(row.min())
    end = int(np.argmin(row))
    i, j, n_ops = m, end + 1, 0
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
    return dist, j, end, n_ops


def adapter_side(seqs, adp, where, block=2048):
    """(max identity, trimmed reads, cut positions, trimmed seqs) of one
    side; reads shorter than 2 * 150 bp are skipped."""
    a = _codes(adp)
    m = len(a)
    bound = int(np.ceil(m * (1 - ADAPTER_TH) / ADAPTER_TH)) + 1
    iden_max, n_trim, pos = -1.0, 0, []
    out = list(seqs)
    idx = [i for i, s in enumerate(seqs) if len(s) >= 2 * ADAPTER_LEN]
    for b0 in range(0, len(idx), block):
        sel = idx[b0:b0 + block]
        win = np.stack([_codes(seqs[i][:ADAPTER_LEN] if where == "head"
                               else seqs[i][-ADAPTER_LEN:]) for i in sel])
        D = hw_dp(a, win)
        dist = D[:, m, 1:].min(axis=1)
        for r in np.nonzero(dist < bound)[0]:
            d, start, end, alen = hw_traceback(D[r], a, win[r])
            identity = 1.0 - float(d / alen)
            if identity > ADAPTER_TH:
                i = sel[r]
                n_trim += 1
                iden_max = max(iden_max, identity)
                if where == "head":
                    pos.append(end)
                    out[i] = seqs[i][end + 1:]
                else:
                    pos.append(ADAPTER_LEN - start)
                    out[i] = seqs[i][:len(seqs[i]) - ADAPTER_LEN + start]
    return iden_max, n_trim, pos, out


def adapter_stats(reads, adp5, adp3):
    """{side: (max identity, trimmed reads, mean cut position)}; the 3'
    search sees the reads after the 5' trim, as the chunk stage does."""
    seqs = [r[1] for r in reads]
    res = {}
    for side, adp, where in (("5", adp5, "head"), ("3", adp3, "tail")):
        if adp:
            iden, n, pos, seqs = adapter_side(seqs, adp, where)
            res[side] = (iden, n, float(np.mean(pos)) if pos else None)
    return res


# ---------------------------------------------------------------------------
# subsample


def subsample_names(reads, nsample):
    """Names of the reservoir sample, chunk by chunk as the reader yields
    them (size by sys.getsizeof of name, sequence and quality)."""
    chunks, cur, size = [], [], 0
    for r in reads:
        cur.append(r[0])
        size += (sys.getsizeof(r[0]) + sys.getsizeof(r[1])
                 + sys.getsizeof(r[2]))
        if size >= CHUNK_BYTES:
            chunks.append(cur)
            cur, size = [], 0
    chunks.append(cur)
    slots = [None] * nsample
    n_seqs = 0
    for chunk in chunks:
        h = np.random.RandomState(seed=SUBSAMPLE_SEED).uniform(
            size=len(chunk) + 1)
        for k, name in enumerate(chunk):
            n_seqs += 1
            d = n_seqs - 1 if n_seqs - 1 < nsample else int(h[k] * n_seqs)
            if d < nsample:
                slots[d] = name
    return [s for s in slots if s is not None]


# ---------------------------------------------------------------------------
# coverage fits


def _logsumexp(a):
    mx = a.max(axis=1, keepdims=True)
    return (mx + np.log(np.exp(a - mx).sum(axis=1, keepdims=True)))[:, 0]


def fit_gmm(x, dtype, n_comp=2, max_iter=100, tol=1e-3, reg=1e-6):
    """sklearn-style 1-D GMM EM from a quantile start."""
    x = np.asarray(x, np.float64)
    qs = np.linspace(0, 100, 2 * n_comp + 1)[1::2]
    mu = np.percentile(x, qs).astype(dtype)
    var = np.full(n_comp, max(np.var(x), 1e-6) / n_comp).astype(dtype)
    wgt = np.full(n_comp, 1.0 / n_comp).astype(dtype)
    x = x.astype(dtype)
    n = len(x)
    eps = 10 * np.finfo(dtype).eps
    half_log2pi = dtype(0.5 * np.log(2.0 * np.pi))
    it, dll, ll_prev = 0, np.inf, -np.inf
    while it < max_iter and abs(dll) > tol:
        lp = (-dtype(0.5) * (x[:, None] - mu[None, :]) ** 2 / var[None, :]
              - dtype(0.5) * np.log(var[None, :]) - half_log2pi
              + np.log(wgt)[None, :])
        norm = _logsumexp(lp)
        resp = np.exp(lp - norm[:, None])
        nk = resp.sum(axis=0) + eps
        mu_n = (resp * x[:, None]).sum(axis=0) / nk
        var_n = ((resp * (x[:, None] - mu_n[None, :]) ** 2).sum(axis=0)
                 / nk + dtype(reg))
        wgt = (nk / dtype(n)).astype(dtype)
        ll = norm.mean()
        dll = float(ll) - float(ll_prev)
        ll_prev, mu, var = ll, mu_n.astype(dtype), var_n.astype(dtype)
        it += 1
    return wgt, mu, var


def fit_norm_lognorm(x, mu_n, sd_n, mu_l, sd_l, dtype, max_iter=500,
                     tol=1e-15, tol_iters=10):
    """mixEM's Normal + LogNormal EM (em.py:16-88)."""
    x = np.asarray(x, np.float64).astype(dtype)
    logx = np.log(x)
    half_log2pi = dtype(0.5 * np.log(2.0 * np.pi))
    mu_n, sd_n, mu_l, sd_l = (dtype(v) for v in (mu_n, sd_n, mu_l, sd_l))
    w = np.array([0.5, 0.5], dtype)
    hist = np.full(tol_iters, -np.inf)
    it = 0
    while True:
        ll, old = hist[0], hist[tol_iters - 1]
        with np.errstate(invalid="ignore", divide="ignore"):
            converged = it >= tol_iters and (old - ll) / old <= tol
        if it > max_iter or converged or np.isnan(ll):
            break
        ln = (-(x - mu_n) ** 2 / (2 * sd_n ** 2) - np.log(sd_n)
              - half_log2pi)
        lg = (-(logx - mu_l) ** 2 / (2 * sd_l ** 2) - np.log(sd_l)
              - half_log2pi - logx)
        ld = np.stack([ln, lg], axis=1)
        resp = w[None, :] * np.exp(ld)
        resp = resp / resp.sum(axis=1, keepdims=True)
        ll_t = np.sum(resp * ld)
        wsum = resp.sum(axis=0)
        mu_n = (resp[:, 0] * x).sum() / wsum[0]
        sd_n = np.sqrt((resp[:, 0] * (x - mu_n) ** 2).sum() / wsum[0])
        mu_l = (resp[:, 1] * logx).sum() / wsum[1]
        sd_l = np.sqrt((resp[:, 1] * (logx - mu_l) ** 2).sum() / wsum[1])
        w = resp.mean(axis=0)
        hist = np.concatenate([[float(ll_t)], hist[:-1]])
        it += 1
    return w, [float(mu_n), float(mu_l)], [float(sd_n), float(sd_l)]


def _whole(x):
    """int(x) as text; "nan" where a float32 fit gave no number."""
    return str(int(x)) if np.isfinite(x) else "nan"


def coverage_stats(rows, control_rows, throughput, dtype=np.float64):
    """The QC JSON's Coverage_stats from the coverage rows (and, for
    PacBio, the spike-in rows), plus whether coverage is very low."""
    f = [r.split("\t") for r in rows if r]
    name = np.array([c[0] for c in f], object)
    qlen = np.array([int(c[1]) for c in f], np.int64)
    n_mbase = np.array([int(c[2]) for c in f], np.int64)
    med = np.array([c[4] for c in f], object)
    t1 = np.array([float(c[5]) for c in f], np.float64)
    cov = np.array([float(c[8]) for c in f], np.float64)
    control = []
    if control_rows is not None:
        cf = [r.split("\t") for r in control_rows if r]
        control = [c[0] for c in cf if float(c[5]) >= 0.5]
        keep = np.array([nm not in set(control) for nm in name], bool)
        name, qlen, n_mbase, med, t1, cov = (a[keep] for a in (
            name, qlen, n_mbase, med, t1, cov))
    n = len(name)
    unmapped_med = float((med == "0").sum()) / n
    th = np.percentile(cov, 85.0)
    if th == 0.0:
        th = np.percentile(cov, 100.0)
    nz = cov[cov.nonzero()]
    data = nz[nz < th]
    out = {"Estimated non-sense read fraction": unmapped_med}
    if control:
        out["Estimated spiked-in control read fraction"] = \
            len(control) / (len(control) + n)
    if data.size == 0:
        out["Mean_coverage"] = out["SD_coverage"] = "NA"
        out["Estimated crude Xome size"] = "N/A"
        return out, False
    wgt, mu, var = fit_gmm(data, dtype)
    c_i = int(np.argmax(wgt / var))
    mean_main, cov_main = float(mu[c_i]), float(var[c_i])
    ratio = n_mbase / qlen
    bins = np.arange(0, mean_main + 10 * np.sqrt(cov_main)
                     + mean_main / 10, mean_main / 10)
    hist, _ = np.histogram(ratio, bins=bins, density=True)
    low = True
    if len(hist) and hist.sum() != 0 and hist[0] / np.sum(hist) >= 0.01:
        low = not any(hist[i] > hist[0] / 5 for i in argrelmax(hist)[0])
    elif len(hist) and hist.sum() != 0:
        low = False
    min_l = max_l = None
    if unmapped_med >= 0.4:
        min_l = -1 * math.log(unmapped_med - 0.05)
        max_l = -1 * math.log(unmapped_med - 0.2)
    mode = None
    if low:
        i_bg, i_m = (0, 1) if c_i == 1 else (1, 0)
        w, mus, sds = fit_norm_lognorm(data, mu[i_bg], np.sqrt(var[i_bg]),
                                       np.log(mu[i_m]), 1.0, dtype)
        mode = float(np.exp(mus[1] - sds[1] ** 2))
        out["Mode_coverage"] = mode
        out["mu_coverage"] = mus[1]
        out["sigma_coverage"] = sds[1]
        m_size = _whole((throughput * (1.0 - unmapped_med)) / mode)
    else:
        out["Mean_coverage"] = mean_main
        out["SD_coverage"] = float(np.sqrt(cov_main))
        m_size = _whole((throughput * (1.0 - unmapped_med)) / mean_main)
    if unmapped_med >= 0.4:
        s1 = throughput * 0.9 * (1 - 0.05) / min_l
        s2 = throughput * 0.9 * (1 - 0.2) / max_l
        xome = "%s (e = %.1f%%), %d (e = 20%%), %d (e = 5%%)" % (
            m_size, unmapped_med * 100, s2, s1)
    else:
        xome = "%s (e = %.1f%%)" % (m_size, unmapped_med * 100)
    out["Estimated crude Xome size"] = xome
    very_low = (low and (mode or 0) < 6) or mean_main < 6
    return out, very_low


# ---------------------------------------------------------------------------
# the QC JSON


def qc_json(reads, table, rows, control_rows, adp5, adp3, dtype=np.float64,
            adapters=None):
    """The QC JSON that sampleqc writes (no report), from the reads, the
    per-read table and the coverage rows (adapters: adapter_stats's
    result, when already computed)."""
    lengths = table["length"]
    throughput = int(lengths.sum())
    gc = (table["ngc"] / np.maximum(lengths.astype(np.float64), 1.0)
          ).astype(dtype)
    alpha, _loc, beta = scipy_gamma.fit(lengths.astype(np.float64),
                                        floc=0.0)
    out = {
        "Yield": throughput,
        "Q7 bases": "%.2f%%" % (100 * int(table["nq7"].sum()) / throughput),
        "Longest_read": int(lengths.max()),
        "Num_of_reads": len(lengths),
        "Length_stats": {
            "gamma_params": [float(alpha), float(beta)],
            "Mean_read_length": float(np.mean(lengths)),
            "N50_read_length": float(n50(lengths)),
        },
        "GC_stats": {"Mean_GC_content": float(np.mean(gc)),
                     "SD_GC_content": float(np.std(gc))},
    }
    if adapters is None:
        adapters = adapter_stats(reads, adp5, adp3)
    for side, (iden, n, pos) in adapters.items():
        if iden >= ADAPTER_TH:
            out["Stats_for_adapter" + side] = {
                "Num_of_trimmed_reads_" + side: n,
                "Max_identity_adp" + side: iden,
                "Average_position_from_%s_end" % side: pos}
    out["Coverage_stats"], _ = coverage_stats(rows, control_rows,
                                              throughput, dtype)
    return out

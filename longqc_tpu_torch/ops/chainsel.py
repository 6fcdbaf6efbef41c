"""Array-parallel chain selection (backtracking without the walk).

The reference extracts chains from the DP arrays with a sequential
greedy pass (chain.c:82-124): ends are sorted by (peak score, peak
index) descending and each walks parent pointers, claiming unclaimed
anchors; anchors visited by later-rejected chains stay claimed. That
ownership rule has a closed form over the parent forest:

  * peak(i)  = i if f[i] == v[i] else peak(p[i])   (v is the running
    max of f along the path, so v is constant on the walk and the walk
    stops exactly at the first ancestor achieving it).
  * Each candidate chain is a unique peak of some end anchor (an anchor
    that is nobody's parent and has v >= min_sc); its priority rank is
    its position in the (score, peak) descending order.
  * min_rank(a) = min rank over peaks whose ancestor-or-self set
    contains a. Because ancestor sets are nested along any path,
    min_rank is non-increasing from peak toward root, so the anchors
    with min_rank == rank(c) form exactly the prefix of c's path that
    the greedy walk would claim — including the quirk that rejected
    chains keep their marks (every rank claims its prefix regardless
    of acceptance).

min_rank propagates to parents in one descending index sweep
(r[p[i]] = min(r[p[i]], r[i])); with the DP's ring-bounded parents
(i - p[i] <= J) it is also a streaming ring pass on device.

This module is the executable numpy spec of that reformulation,
validated against ops/chain.backtrack_chains; the device engine
(engine/device_overlap.py) runs the same math as fixed-shape jnp ops.
"""

import numpy as np

INF_RANK = np.int32(0x7FFFFFFF)


def compute_peaks(f, p, v):
    """peak[i] per the walk `while f[j] < v[j]: j = p[j]` (f == v holds
    at roots, so the walk always terminates in-range)."""
    n = len(f)
    peak = np.arange(n, dtype=np.int64)
    for i in range(n):
        if f[i] < v[i]:
            peak[i] = peak[p[i]]
    return peak


def chain_ranks(f, p, v, n, min_sc):
    """-> (rank_of_anchor, order) where order[c] = peak index of the
    rank-c chain (descending (score, peak)); rank_of_anchor[a] is
    min_rank(a) (INF_RANK when a is on no candidate chain's path)."""
    f = np.asarray(f[:n], np.int64)
    p = np.asarray(p[:n], np.int64)
    v = np.asarray(v[:n], np.int64)
    t = np.zeros(n, bool)
    t[p[p >= 0]] = True
    ends = np.nonzero(~t & (v >= min_sc))[0]
    peak = compute_peaks(f, p, v)
    peaks = np.unique(peak[ends])  # dedupe: duplicate peaks claim nothing
    if len(peaks) == 0:
        return np.full(n, INF_RANK, np.int64), peaks
    # descending (score, peak); scores are f[peak] == v[end]
    order = peaks[np.lexsort((-peaks, -f[peaks]))]
    rank = np.full(n, INF_RANK, np.int64)
    rank[order] = np.arange(len(order))
    for i in range(n - 1, -1, -1):
        if p[i] >= 0 and rank[i] < rank[p[i]]:
            rank[p[i]] = rank[i]
    return rank, order


def select_chains(f, p, v, n, min_cnt, min_sc):
    """Drop-in equivalent of ops/chain.backtrack_chains built from the
    rank arrays (used for equivalence testing)."""
    rank, order = chain_ranks(f, p, v, n, min_sc)
    if len(order) == 0:
        return []
    f64 = np.asarray(f[:n], np.int64)
    p64 = np.asarray(p[:n], np.int64)
    owners = {}
    for a in range(n):
        if rank[a] != INF_RANK:
            owners.setdefault(int(rank[a]), []).append(a)
    chains = []
    for c, pk in enumerate(order):
        owned = owners.get(c, [])
        if not owned:
            continue
        first = owned[0]
        stop = p64[first]
        score = int(f64[pk])
        if stop < 0:
            if len(owned) >= min_cnt:
                chains.append((score, np.array(owned, np.int64)))
        elif score - int(f64[stop]) >= min_sc:
            if len(owned) >= min_cnt:
                chains.append((score - int(f64[stop]),
                               np.array(owned, np.int64)))
    return chains

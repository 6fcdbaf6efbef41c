"""Reading the program's spans (longqc_tpu_torch/tracing.py) from the
window's jobs.

Each job's stats carry `spans` (per span name: n, wall_s, self_s,
cpu_s), for the whole job and for each engine run nested in it
(stats["overlap"], stats["spike_in"]), and, in the traced run,
`span_log`: every span's interval from every thread, in Unix-epoch ns.

The device's idle intervals are the complement of the union of the
device events' intervals (the union whose length trace.busy_union_s
gives; trace.py returns no intervals, so they are merged here by the
same rule). Span intervals are put on the device trace's clock by the
median offset between the main thread's spans and the profiler's own
`lq.<name>` ranges of them (0 where none match).
"""

import statistics


def fold(job, sub=None):
    """{name: {"n", "wall_s", "self_s", "cpu_s"}} of a job, or of the
    engine run stats[sub] inside it; None where it has none."""
    st = job.get("stats") or {}
    if sub is not None:
        st = st.get(sub) or {}
    return (st.get("spans") or {}).get("by_name")


def span_sum(jobs, names, what="wall_s", sub=None):
    """`what` of the spans named, summed over the jobs; None when no
    job ran any of them."""
    total = None
    for job in jobs:
        by = fold(job, sub)
        for n in names:
            if by and n in by:
                total = (total or 0.0) + by[n][what]
    return total


def offcpu_share(jobs, names):
    """100 * (wall - thread CPU) / wall of the spans named, over the
    jobs; None without them."""
    wall = span_sum(jobs, names)
    if not wall:
        return None
    return 100.0 * (wall - span_sum(jobs, names, "cpu_s")) / wall


def log_intervals(jobs, names, role=None, shift=0):
    """[(t0, t1)] ns of the span_log entries named (of `role`, if
    given), moved by `shift` ns; None when no job has a span_log."""
    logs = [j["stats"]["span_log"] for j in jobs
            if "span_log" in (j.get("stats") or {})]
    if not logs:
        return None
    return [(e["t0"] + shift, e["t1"] + shift) for log in logs for e in log
            if e["name"] in names and (role is None or e["role"] == role)]


def union(iv):
    """Sorted, disjoint intervals covering the same points."""
    out = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def intersect(a, b):
    """The intervals where both sets hold (each set unioned first)."""
    a, b = union(a), union(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length_s(iv):
    """Seconds covered by a set of ns intervals."""
    return sum(e - s for s, e in union(iv)) / 1e9


def idle_intervals(events, lo, hi):
    """Stretches of [lo, hi] (ns) with no device activity."""
    out, cur = [], lo
    for s, e in union([(s, e) for _n, s, e in events["dev"]]):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if s < e]


def range_offsets(log, cpu_events):
    """The main thread's spans of `log` (span_log entries) matched in
    order, name by name, with the profiler's `lq.<name>` ranges among
    `cpu_events` ([(name, start_ns, end_ns)]) -> ({name: [(range start -
    span start, range end - span end)]} ns, {name: [spans, ranges]} of
    the names whose counts differ, which are left unmatched)."""
    ours, theirs = {}, {}
    for e in log:
        if e["role"] == "main":
            ours.setdefault(e["name"], []).append((e["t0"], e["t1"]))
    for name, s, e in cpu_events:
        if name.startswith("lq."):
            theirs.setdefault(name[3:], []).append((s, e))
    matched, unmatched = {}, {}
    for name in set(ours) | set(theirs):
        a, b = sorted(ours.get(name, [])), sorted(theirs.get(name, []))
        if len(a) != len(b):
            unmatched[name] = [len(a), len(b)]
            continue
        matched[name] = [(b0 - a0, b1 - a1)
                         for (a0, a1), (b0, b1) in zip(a, b)]
    return matched, unmatched


def jobs_log(jobs):
    """The span_log entries of all the jobs."""
    return [e for j in jobs for e in (j.get("stats") or {}).get("span_log",
                                                                 ())]


def clock_shift_ns(jobs, events):
    """Median (profiler start - span start) over the main thread's spans
    matched with their `lq.<name>` ranges (range_offsets); 0 when none
    match."""
    matched, _ = range_offsets(jobs_log(jobs), events["cpu"])
    diffs = [d0 for offs in matched.values() for d0, _d1 in offs]
    return int(statistics.median(diffs)) if diffs else 0


def idle_inside_s(run, names, role="main"):
    """Device-idle seconds inside the spans named (of `role`), over the
    traced window's jobs; None without a span_log or device events."""
    ev = run.get("events")
    if not ev:
        return None
    shift = clock_shift_ns(run["jobs"], ev)
    iv = log_intervals(run["jobs"], names, role, shift)
    if iv is None:
        return None
    iv = union(iv)
    if not iv:
        return 0.0
    return length_s(intersect(iv, idle_intervals(ev, iv[0][0],
                                                 iv[-1][1])))

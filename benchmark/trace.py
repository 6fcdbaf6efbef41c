"""Reading the traced run: torch.profiler's events -> device time.

Device events are every activity the profiler records on the card
(kernels, copies, sets). From them: the union of their intervals (the
busy seconds), each name's summed device time (the kernels' totals, as
the repository's smoke run reads them), and the longest gaps between
device activity, each labelled by the CPU-side op that the host was in
when the gap began (the innermost torch op spanning that instant, else
the last one that ended before it; CUDA runtime calls are passed over).
"""

import numpy as np


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(ev, what + "_us")() * 1000


def read_events(prof):
    """-> {"dev": [(name, start_ns, end_ns)], "cpu": [(name, start_ns,
    end_ns)]} from a finished torch.profiler.profile."""
    dev, cpu = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if dur <= 0:
            continue
        item = (ev.name(), start, start + dur)
        if str(ev.device_type()).endswith("CUDA"):
            dev.append(item)
        else:
            cpu.append(item)
    return {"dev": dev, "cpu": cpu}


def busy_union_s(intervals):
    """Seconds covered by the union of (start, end) intervals in ns."""
    if not intervals:
        return 0.0
    iv = sorted(intervals)
    tot, cur_s, cur_e = 0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            tot += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    return (tot + cur_e - cur_s) / 1e9


def device_totals(events):
    """{name: device seconds} over the traced window."""
    tot = {}
    for name, s, e in events["dev"]:
        tot[name] = tot.get(name, 0.0) + (e - s) / 1e9
    return tot


def kernel_s(events, prefix):
    """Device seconds of the kernels whose name starts with prefix, or
    None when the trace holds none."""
    ts = [(e - s) for name, s, e in events["dev"] if name.startswith(prefix)]
    return sum(ts) / 1e9 if ts else None


def idle_gaps(events, t0_ns, t1_ns, top=10):
    """The `top` longest stretches of the window [t0, t1] (ns) with no
    device activity -> [(label, seconds)]."""
    iv = sorted((max(s, t0_ns), min(e, t1_ns)) for _n, s, e in events["dev"]
                if e > t0_ns and s < t1_ns)
    gaps, cur = [], t0_ns
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1_ns > cur:
        gaps.append((cur, t1_ns))
    gaps.sort(key=lambda g: g[0] - g[1])
    # the host's own ops: CUDA runtime calls (cudaMemcpyAsync, ...) only
    # say that the host talked to the card, not what it was doing
    cpu = [c for c in events["cpu"] if not c[0].startswith("cuda")]
    names = [c[0] for c in cpu]
    cs = np.array([c[1] for c in cpu], np.int64) if cpu else np.zeros(0)
    ce = np.array([c[2] for c in cpu], np.int64) if cpu else np.zeros(0)
    out = []
    for g0, g1 in gaps[:top]:
        label = "host"
        inside = np.nonzero((cs <= g0) & (ce > g0))[0]
        if len(inside):
            label = names[inside[np.argmax(cs[inside])]]
        else:
            before = np.nonzero(ce <= g0)[0]
            if len(before):
                label = "after " + names[before[np.argmax(ce[before])]]
        out.append((label, (g1 - g0) / 1e9))
    return out


def short_name(name, width=96):
    """A kernel's name without its argument list, cut to `width`."""
    return name.split("(")[0][:width] if "(" in name[1:] else name[:width]


def top_device_ops(events, top=10):
    tot = {}
    for name, s in device_totals(events).items():
        key = short_name(name)
        tot[key] = tot.get(key, 0.0) + s
    return sorted(tot.items(), key=lambda kv: -kv[1])[:top]

"""Checks of the port's spans (longqc_tpu_torch/tracing.py) against the
device trace, on the card, for benchmark cells.

    python3 tools/torch_span_check.py --seed N [--pairs 2] CELL [CELL ...]

For each cell: one traced run through the benchmark's harness (the
result line as `run.py --trace 1` prints it), and from its trace:

- clock agreement: per main-thread span, the larger distance of its
  start and end from the profiler's own `lq.<name>` range (matched in
  order, name by name), and the names whose counts differ;
- the 10 longest device-idle gaps, each with the harness's label and
  whether an `lq.` range below the job's top-level one spans its start;
- the share of device-idle time under a main-thread span below the
  job's top-level one;
- the spans a job records (their sum of `n`), the spans with the most
  wall time (count, wall and thread CPU seconds) and the job times;
- in a sampleqc cell whose reads hold control reads, per job the sample
  reads that the spike-in filter got wrong against
  benchmark/reference/spike_in.py (`correct` does not check them).

Then `--pairs` pairs of jobs of the cell's entry, untraced then traced
(the profiler on, as in a `--trace 1` run), their wall times: what the
tracing costs when on. With `--off-pairs N` only N pairs of untraced
jobs, with the span layer and with it stubbed out (no table opened, so
every span is a no-op): what the spans cost when tracing is off. One
JSON line per cell on standard output.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOP = {"sampleqc": "sampleqc", "overlap": "overlap"}


def gap_report(events, top, n=10):
    """The n longest idle gaps: (seconds, label, below_top)."""
    from benchmark import spans, trace
    allev = events["cpu"] + events["dev"]
    lo = min(s for _n, s, _e in allev)
    hi = max(e for _n, _s, e in allev)
    gaps = sorted(spans.idle_intervals(events, lo, hi),
                  key=lambda g: g[0] - g[1])[:n]
    labels = trace.idle_gaps(events, lo, hi, top=n)
    lq = [(s, e, name) for name, s, e in events["cpu"]
          if name.startswith("lq.") and name != "lq." + top]
    out = []
    for (g0, g1), (label, secs) in zip(gaps, labels):
        below = any(s <= g0 < e for s, e, _name in lq)
        out.append((round(secs, 6), label, below))
    return out


def clock_report(jobs, events):
    """Per main-thread span, the larger distance of its start and end
    from its `lq.<name>` range (benchmark/spans.range_offsets)."""
    from benchmark import spans
    matched, unmatched = spans.range_offsets(spans.jobs_log(jobs),
                                             events["cpu"])
    worst = {name: max(max(abs(a), abs(b)) for a, b in offs) / 1e6
             for name, offs in matched.items()}
    dist = [max(abs(a), abs(b)) for offs in matched.values()
            for a, b in offs]
    return {"matched": len(dist),
            "max_ms": max(dist) / 1e6 if dist else None,
            "median_ms": statistics.median(dist) / 1e6 if dist else None,
            "over_1ms": sum(d > 1_000_000 for d in dist),
            "worst_ms": sorted(worst.items(), key=lambda kv: -kv[1])[:5],
            "unmatched": unmatched}


def idle_cover(jobs, events, top):
    """Share of device-idle time (over the jobs' own stretch) under a
    main-thread span below the job's top-level one."""
    from benchmark import spans
    shift = spans.clock_shift_ns(jobs, events)
    tops = spans.log_intervals(jobs, (top,), "main", shift)
    names = {e["name"] for j in jobs for e in j["stats"].get("span_log", ())
             if e["role"] == "main"} - {top}
    under = spans.log_intervals(jobs, names, "main", shift)
    idle = spans.intersect(
        spans.idle_intervals(events, min(s for s, _e in tops),
                             max(e for _s, e in tops)), tops)
    tot = spans.length_s(idle)
    return {"idle_s": tot, "covered_s": spans.length_s(
        spans.intersect(idle, under)), "shift_ms": shift / 1e6}


def top_spans(jobs, n=15):
    """The n spans with the most wall time over the jobs: [name, count,
    wall s, thread CPU s]."""
    tot = {}
    for j in jobs:
        for name, v in j["stats"]["spans"]["by_name"].items():
            t = tot.setdefault(name, [0, 0.0, 0.0])
            t[0] += v["n"]
            t[1] += v["wall_s"]
            t[2] += v["cpu_s"]
    rows = sorted(([k] + v for k, v in tot.items()), key=lambda x: -x[2])
    return rows[:n]


def spike_in_report(state, jobs):
    """Per job, the reads of its sample that the spike-in filter got
    wrong against reference/spike_in.py (None: no control reads in the
    traffic)."""
    from benchmark import gen, harness
    from benchmark.reference import spike_in as si
    traffic = state["run"]["traffic"]
    if not traffic.get("control_share"):
        return None
    controls = si.control_names(state["reads"], gen.read_fasta_seq(
        os.path.join(harness.HERE, traffic["control_fasta"])))
    return {"controls": len(controls),
            "bad": [si.spike_in_bad(j, controls) for j in jobs]}


def check_cell(cell, seed, pairs, seconds):
    from benchmark import harness, trace
    captured = {"jobs": [], "times": []}
    read_events = trace.read_events

    def keep_events(prof):
        captured["events"] = read_events(prof)
        return captured["events"]

    def hook(entry):
        job, prepare = entry.job, entry.prepare

        def kept(run):
            captured["state"] = prepare(run)
            return captured["state"]

        def timed(state):
            t = time.time()
            out = job(state)
            captured["times"].append(time.time() - t)
            captured["jobs"].append({k: out.get(k) for k in
                                     ("stats", "rows", "control")})
            return out
        entry.prepare, entry.job = kept, timed

    trace.read_events = keep_events
    try:
        res = harness.run_cell(cell, seed, seconds, 1, device="cuda",
                               t_start=time.time(), entry_hook=hook)
    finally:
        trace.read_events = read_events
    kind = captured["state"]["run"]["traffic"]["entry"]
    top = TOP[kind]
    jobs, ev = captured["jobs"], captured["events"]
    out = {"cell": cell, "seed": seed, "result": res,
           "clock": clock_report(jobs, ev),
           "gaps": gap_report(ev, top),
           "idle_cover": idle_cover(jobs, ev, top),
           "lq_device_events": sum(1 for name, _s, _e in ev["dev"]
                                   if name.startswith("lq.")),
           "spans_per_job": [sum(v["n"] for v in
                                 j["stats"]["spans"]["by_name"].values())
                             for j in jobs],
           "traced_job_s": captured["times"],
           "top_spans": top_spans(jobs)}
    if kind == "sampleqc":
        out["spike_in"] = spike_in_report(captured["state"], jobs)
        # which reader and sdust recursion ran (native or Python)
        out["builds"] = {k: {n: jobs[0]["stats"][k].get(n)
                             for n in ("name", "error")}
                         for k in ("reader", "sdust")}
    if pairs:
        out["cost"] = job_cost(cell, seed, pairs)
    return out


@contextlib.contextmanager
def _no_table(stats=None, name=None):
    """tracing.run without a table: every span a no-op, no sums."""
    from longqc_tpu_torch import tracing
    scope = tracing.Scope()
    scope.fold = {"by_name": {}, "counters": {}}
    yield scope


def job_cost(cell, seed, pairs, off=False):
    """Wall seconds of the cell's jobs on the same inputs, in turns:
    untraced and traced, or (off) with and without the span layer; one
    window of the benchmark's harness, its check left out, whose one job
    runs the pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    from longqc_tpu_torch import tracing
    keys = ("spans_s", "no_spans_s") if off else ("untraced_s",
                                                  "traced_s")
    cost = {k: [] for k in keys}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def hook(entry):
        job = entry.job

        def pairs_job(state):
            run = tracing.run
            for _ in range(pairs):
                for second in (False, True):
                    prof = (profile(activities=acts) if second and not off
                            else None)
                    tracing.run = _no_table if second and off else run
                    torch.cuda.synchronize()
                    if prof is not None:
                        prof.__enter__()
                    t = time.time()
                    try:
                        out = job(state)
                        torch.cuda.synchronize()
                    finally:
                        tracing.run = run
                    dt = time.time() - t
                    if prof is not None:
                        prof.__exit__(None, None, None)
                    cost[keys[second]].append(dt)
            return out
        entry.job = pairs_job
        entry.reference = lambda state, variant=None: None
        entry.compare = lambda jobs, ref, state: {}

    harness.run_cell(cell, seed, 0, 0, device="cuda", entry_hook=hook)
    return cost


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--off-pairs", type=int, default=0)
    args = ap.parse_args(argv)
    from benchmark import harness
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: nothing checked", file=sys.stderr)
        return 2
    for i, cell in enumerate(args.cells):
        if args.off_pairs:
            out = {"cell": cell, "seed": args.seed + i,
                   "cost": job_cost(cell, args.seed + i, args.off_pairs,
                                    off=True)}
        else:
            out = check_cell(cell, args.seed + i, args.pairs, args.seconds)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

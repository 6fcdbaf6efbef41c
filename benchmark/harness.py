"""One run of one cell: inputs from the seed, warm-up, the measured
window, the traced readings, the check against the reference.

Everything a cell needs is found by name: the configuration in
configs/<config>.json, the traffic mix in traffic/<traffic>.json (whose
`entry` names entries/<entry>.py), and each per-layer metric in
metrics/<metric>.py. A later cell, mix or metric is a new file and a
new line in BENCHMARK.json.
"""

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run (the JAX
# package and JAX itself), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "longqc_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def module_path(kind, name):
    """benchmark/<kind>/<name>.py or, where there is none, the file of
    the longest leading dotted part of name: metrics/device.idle.py
    reads both device.idle.sampleqc and device.idle.overlap, which the
    manifest splits by the end-to-end metric each moves."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(HERE, kind, ".".join(parts[:n]) + ".py")
        if os.path.exists(path):
            return path
    return os.path.join(HERE, kind, name + ".py")


def load_module(kind, name):
    """The module of module_path(kind, name) (names may hold dots)."""
    path = module_path(kind, name)
    spec = importlib.util.spec_from_file_location(
        "benchmark_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def cell_of(manifest, name):
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit("no workload %r in BENCHMARK.json" % name)


def metrics_for(manifest, cell):
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    def ours(m):
        return "workloads" not in m or cell["name"] in m["workloads"]
    e2e = [m for m in manifest["end_to_end"] if ours(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell["name"] in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def cache_dirs():
    """The build and kernel caches inside the checkout, at fixed paths."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))


def log(*a):
    print("[%s]" % time.strftime("%H:%M:%S"), *a, file=sys.stderr,
          flush=True)


def run_cell(cell_name, seed, seconds, trace, *, device="cuda",
             t_start=None, manifest=None, config=None, traffic=None,
             workers=None, entry_hook=None):
    """One run -> the result dict (the last line's keys, and `checks`
    last). config / traffic override the files (tests); entry_hook(entry
    module) may wrap the entry's functions (the fault tests)."""
    import torch
    t_start = time.time() if t_start is None else t_start
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    cell = cell_of(manifest, cell_name)
    config = config or load_json(HERE, "configs", cell["config"] + ".json")
    traffic = traffic or load_json(HERE, "traffic",
                                   cell["traffic"] + ".json")
    entry = load_module("entries", traffic["entry"])
    if entry_hook:
        entry_hook(entry)
    e2e, layer = metrics_for(manifest, cell)
    on_card = torch.device(device).type == "cuda"

    from benchmark import gen
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = {"config": config, "traffic": traffic, "seed": int(seed),
               "device": device, "workdir": workdir,
               "workers": workers or int(traffic.get("check_workers", 1))}
        run["reads"] = gen.make_reads(seed, config, traffic)
        log("reads made: %d, %d bp" % (
            len(run["reads"]), sum(len(r[1]) for r in run["reads"])))
        state = entry.prepare(run)
        log("prepared")
        entry.warmup(state)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_start
        log("warmed up; set-up %.3f s" % setup_s)

        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.__enter__()
        jobs = []
        t0 = time.time()
        try:
            while True:
                jobs.append(entry.job(state))
                log("job %d done at %.3f s" % (len(jobs), time.time() - t0))
                if time.time() - t0 >= seconds:
                    break
            if on_card:
                torch.cuda.synchronize()
            window_s = time.time() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        bases = sum(j["bases"] for j in jobs)

        reading = {"jobs": jobs, "bases": bases, "window_s": window_s}
        result = {"metrics": {}, "device": _device(on_card, peak)}
        if trace:
            from benchmark import trace as tr
            ev = tr.read_events(prof)
            prof = None
            reading["events"] = ev
            reading["busy_s"] = tr.busy_union_s(
                [(s, e) for _n, s, e in ev["dev"]])
            result["device"].update(busy_s=reading["busy_s"],
                                    window_s=window_s)
            if ev["cpu"] or ev["dev"]:
                lo = min(s for _n, s, _e in ev["cpu"] + ev["dev"])
                hi = max(e for _n, _s, e in ev["cpu"] + ev["dev"])
                result["breakdown"] = {
                    "device_ops": [list(x) for x in tr.top_device_ops(ev)],
                    "idle_gaps": [list(x) for x in tr.idle_gaps(ev, lo, hi)]}
            for m in layer:
                v = load_module("metrics", m["name"]).read(reading)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
        else:
            for m in e2e:
                if m["name"] == "setup_s":
                    v = setup_s
                elif m["name"] == traffic["rate"]:
                    # input Mbp of all jobs over the window, the job that
                    # ran past its end included
                    v = bases / 1e6 / window_s
                else:
                    continue
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}

        # the check, once the window has closed and its readings are taken
        reading = None
        if on_card:
            torch.cuda.empty_cache()
        t1 = time.time()
        ref = entry.reference(state)
        numbers = entry.compare(jobs, ref, state)
        log("checked in %.3f s" % (time.time() - t1))
        limits = traffic["limits"]
        checks = {k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        result = {"correct": correct, "attempted": len(jobs), "failed": 0,
                  **result, "checks": checks}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _device(on_card, peak):
    import torch
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}

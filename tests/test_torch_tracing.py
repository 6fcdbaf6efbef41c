"""The port's span layer (longqc_tpu_torch/tracing.py): nesting and self
time, thread roles, CPU against wall time, agreement with
torch.profiler's own record of the `lq.*` ranges, the profiler gate,
and the legacy stats keys (`stage_s`, `phase_s`, `index_s`) read from
the spans of a CPU sampleqc and overlap run, and pinned to the steps
they timed before the spans (on a virtual clock that only those steps
advance)."""

import concurrent.futures as cf
import contextlib
import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_util import ont_sampleqc_reads, pb_sampleqc_reads

from benchmark.spans import range_offsets
from longqc_tpu_torch import tracing
from longqc_tpu_torch.cli import main
from longqc_tpu_torch.config import PRESETS, overlap_config_for_sample
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import device_overlap as do
from longqc_tpu_torch.engine import masking, pipeline
from longqc_tpu_torch.engine.overlap import overlap_run_device
from longqc_tpu_torch.tracing import span
from util_synth import write_fastq_file

# the legacy keys, as they were before the spans
STAGE_KEYS = {"chunk_loop", "adapter_sample_gc", "adapter", "mask",
              "mask_wait", "exclusion", "overlap", "spike_in", "analytics"}
PHASE_KEYS = {"stage", "part_wait", "index", "count", "step", "pull",
              "finalize"}
INDEX_KEYS = {"pack", "tiles", "merge"}


def _kineto(prof):
    """[(name, start_ns, end_ns)] of the profiler's CPU events."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            continue
        out.append((ev.name(), ev.start_ns(),
                    ev.start_ns() + ev.duration_ns()))
    return out


def _assert_agree(log, events):
    """Each main-thread span of `log` has its `lq.` range among the
    profiler's CPU events (benchmark/spans.range_offsets), and their
    edges agree within 0.2 ms at the median and within 1 ms for at least
    97 % of spans: a thread switch (the interpreter's, or the OS's on a
    loaded machine) between a range's stamp and the span's clock reading
    moves an edge by the switch."""
    matched, unmatched = range_offsets(log, events)
    assert matched and not unmatched
    dist = sorted(max(abs(d0), abs(d1))
                  for offs in matched.values() for d0, d1 in offs)
    assert dist[len(dist) // 2] < 200_000
    assert sum(d < 1_000_000 for d in dist) >= 0.97 * len(dist)


def _spin(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_nesting_self_time_and_nested_runs():
    outer, inner = {}, {}
    with tracing.run(outer, "top"):
        with span("a"):
            time.sleep(0.02)
            with span("b"):
                _spin(0.01)
            with tracing.run(inner):
                with span("b"):
                    _spin(0.005)
        tracing.count("things", 3)
        tracing.count("nothing", 0)
    by = outer["spans"]["by_name"]
    assert set(by) == {"top", "a", "b"}
    assert by["b"]["n"] == 2 and by["a"]["n"] == 1 and by["top"]["n"] == 1
    assert by["a"]["self_s"] == pytest.approx(
        by["a"]["wall_s"] - by["b"]["wall_s"], rel=1e-9)
    assert by["top"]["self_s"] == pytest.approx(
        by["top"]["wall_s"] - by["a"]["wall_s"], rel=1e-9)
    assert by["a"]["wall_s"] >= 0.035 and by["a"]["self_s"] >= 0.02
    for v in by.values():
        assert 0 <= v["cpu_s"] <= v["wall_s"]
    # the sleep is off the CPU
    assert by["a"]["wall_s"] - by["a"]["cpu_s"] >= 0.015
    assert outer["spans"]["counters"] == {"things": 3, "nothing": 0}
    # a nested run joins the caller's table and folds what it recorded
    assert list(inner["spans"]["by_name"]) == ["b"]
    assert inner["spans"]["by_name"]["b"]["n"] == 1
    assert "span_log" not in outer and "span_log" not in inner
    # outside a run nothing is recorded
    with span("lost"):
        tracing.count("lost")
    assert tracing._local.table is None


def test_threads_record_with_their_role():
    st = {}
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.run(st, "top"):
            def work(name):
                with span(name):
                    with span(name + ".inner"):
                        _spin(0.002)
                seen.append(threading.current_thread().name)

            with cf.ThreadPoolExecutor(max_workers=1) as pool:
                pool.submit(tracing.carry("mask", work), "m").result()
            t = threading.Thread(target=tracing.carry("part", work),
                                 args=("p",))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with span("main"):
                _spin(0.001)
    assert len(seen) == 2
    log = st["span_log"]
    role = {e["name"]: e["role"] for e in log}
    assert role == {"m": "mask", "m.inner": "mask", "p": "part",
                    "p.inner": "part", "main": "main", "top": "main"}
    ids = {e["name"]: e["id"] for e in log}
    parent = {e["name"]: e["parent"] for e in log}
    # the stack is per thread: a thread's first span has no parent
    assert parent["m"] is None and parent["p"] is None
    assert parent["m.inner"] == ids["m"] and parent["p.inner"] == ids["p"]
    assert parent["main"] == ids["top"]
    assert len(set(ids.values())) == len(log)
    for e in log:
        assert e["t0"] <= e["t1"] and 0 <= e["cpu"] <= e["t1"] - e["t0"]
    assert set(st["spans"]["by_name"]) == set(role)


def test_main_spans_agree_with_the_profilers_ranges():
    st = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.run(st, "top"):
            for i in range(3):
                with span("outer"):
                    torch.ones(1000).sum()
                    with span("inner"):
                        _spin(0.002)
    assert len(st["span_log"]) == 7
    _assert_agree(st["span_log"], _kineto(prof))


def test_profiler_ranges_only_under_the_profiler(monkeypatch):
    calls = []
    real = tracing._RANGE

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "_RANGE", counting)
    st = {}
    with tracing.run(st, "top"):
        with span("a"):
            pass
    assert calls == [] and "span_log" not in st
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.run(st, "top"):
            with span("a"):
                pass
            # spans of other threads never open a profiler range
            def other():
                with span("x"):
                    pass
            t = threading.Thread(target=tracing.carry("mask", other))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    # one range ahead of the first span's (tracing._warm)
    assert calls == ["start.top", "lq.top", "lq.a"]
    assert [e["name"] for e in st["span_log"]] == ["a", "x", "top"]


class _Steps:
    """A virtual clock for the span layer that only the timed steps
    move: each patched step advances its thread's clock (ns) by its own
    amount as it starts, and the advances are tallied by step, caller
    and whether the calling thread is the one that made this clock (the
    run's main thread). A legacy key then reads exactly the advances of
    the steps it timed before the spans, on the thread that timed them."""

    def __init__(self, mp):
        self._mp = mp
        self._local = threading.local()
        self._lock = threading.Lock()
        self._main = threading.get_ident()
        self.tally = {}     # (step, caller, on main) -> ns
        mp.setattr(tracing, "time", self)

    def time_ns(self):
        return getattr(self._local, "t", 0)

    thread_time_ns = time_ns

    def advance(self, name, ns, depth=2, callers=None):
        """A step `name` starts: called from the step's own frame,
        `depth` frames below its caller's."""
        caller = sys._getframe(depth).f_code.co_name
        if callers is None or caller in callers:
            self._local.t = self.time_ns() + ns
            key = (name, caller, threading.get_ident() == self._main)
            with self._lock:
                self.tally[key] = self.tally.get(key, 0) + ns

    def patch(self, obj, attr, name, ns, callers=None):
        real = getattr(obj, attr)

        def step(*args, **kwargs):
            self.advance(name, ns, callers=callers)
            return real(*args, **kwargs)
        self._mp.setattr(obj, attr, step)

    def progress(self, qi):
        """The engine's per-row callback: a step inside the commit."""
        self.advance("commit", 2_000_003, callers=("_commit_rows",))

    def _pulls(self):
        """_step_group's outputs pulled to the host through a step
        ("pull", by the caller of .cpu())."""
        real = do.DeviceOverlapEngine._step_group
        steps = self

        class Pulled:
            def __init__(self, t):
                self._t = t

            def cpu(self):
                steps.advance("pull", 2_300_003)
                return self._t.cpu()

        def step(*args, **kwargs):
            self.advance("step", 1_800_017)
            small, full = real(*args, **kwargs)
            return Pulled(small), full
        self._mp.setattr(do.DeviceOverlapEngine, "_step_group", step)

    def engine(self):
        """The overlap engine's timed steps, distinct amounts each."""
        E = do.DeviceOverlapEngine
        for obj, attr, name, ns, callers in (
                (do._Group, "__init__", "group", 1_000_003, None),
                (cf.Future, "result", "wait", 1_100_009,
                 ("_run", "_chunk_qc")),
                (do._PartIndex, "__init__", "part_init", 1_200_007, None),
                (di, "pack_part_tiles", "pack", 1_300_021, None),
                (di, "_ladder_chunks", "tiles", 1_400_017, None),
                (di, "_compact_chunks", "tiles", 1_400_017, None),
                (di, "_merge_chunks", "merge", 1_500_007, None),
                (di, "_range_merge", "merge", 1_500_007, None),
                (do._PartIndex, "build", "build", 1_600_033, None),
                (do, "_count_expanded", "count", 1_700_021, None),
                (E, "_unpack_pull", "unpack", 1_900_009, None),
                (E, "_host_fix", "host_fix", 2_100_001, None),
                (E, "_finalize", "finalize", 2_200_013, None)):
            self.patch(obj, attr, name, ns, callers)
        self._pulls()

    def pipeline(self):
        """The engine's steps and sampleqc's."""
        self.engine()
        for obj, attr, name, ns, callers in (
                (pipeline, "cut_adapter", "adapter", 3_000_017, None),
                (pipeline, "subsample_from_chunk", "subsample", 3_100_007,
                 ("_chunk_qc",)),
                (masking, "screen_reads", "screen", 3_200_003, None),
                (masking, "format_rows", "format", 3_300_001, None),
                (pipeline, "_exclude_masked", "exclusion", 3_400_013, None),
                (pipeline, "_analytics", "analytics", 3_500_017, None)):
            self.patch(obj, attr, name, ns, callers)

    def mark(self):
        with self._lock:
            return dict(self.tally)

    @staticmethod
    def since(now, then):
        return {k: v - then.get(k, 0) for k, v in now.items()
                if v != then.get(k, 0)}


def _s(tally, names, caller=None, main=None):
    """Seconds of the tallied advances of the steps named (from caller,
    on the main thread or not)."""
    return sum(v for (n, c, m), v in tally.items()
               if n in names and caller in (None, c)
               and main in (None, m)) / 1e9


def _expected_engine(t):
    """An engine run's phase_s and index_s, from its tally: what each
    key timed before the spans (`index`: the side thread's _PartIndex
    with its packing, and the build; `step`: the launches, their pulls
    to the host and the retries with theirs; `pull`: the first pull's
    unpacking; the commit in no key)."""
    phase = {"stage": _s(t, {"group"}),
             "part_wait": _s(t, {"wait"}, "_run"),
             "index": _s(t, {"part_init", "pack", "build", "tiles",
                             "merge"}),
             "count": _s(t, {"count"}),
             "step": _s(t, {"step", "pull"})
             + _s(t, {"unpack"}, "_pull_step"),
             "pull": _s(t, {"unpack"}, "_run_part"),
             "finalize": _s(t, {"finalize"})}
    if _s(t, {"host_fix"}):
        phase["host_fix"] = _s(t, {"host_fix"})
    index = {k: _s(t, {k}) for k in INDEX_KEYS if _s(t, {k})}
    return phase, index


def _assert_engine_keys(ov, tally):
    phase, index = _expected_engine(tally)
    assert set(ov["phase_s"]) - {"host_fix"} == PHASE_KEYS
    assert ov["phase_s"] == pytest.approx(phase, rel=1e-12, abs=1e-15)
    assert ov["index_s"] == pytest.approx(index, rel=1e-12, abs=1e-15)
    # the steps ran, and the commit went into no key
    assert min(phase[k] for k in ("stage", "index", "count", "step", "pull",
                                  "finalize")) > 0
    assert _s(tally, {"pull"}) > 0 and _s(tally, {"commit"}) > 0


@pytest.fixture(scope="module")
def sampleqc_runs(tmp_path_factory):
    """CPU sampleqc runs: ont-ligation under the profiler (CPU events),
    pb-sequel (the spike-in run) without it, on the steps' clock
    (_Steps) with each engine run's tally."""
    out = {}
    for kind, reads, preset, n in (
            ("ont", ont_sampleqc_reads(), "ont-ligation", 40),
            ("pb", pb_sampleqc_reads(), "pb-sequel", 30)):
        tmp = tmp_path_factory.mktemp(kind)
        fq = str(tmp / "in.fq")
        write_fastq_file(fq, reads)
        st = {}
        prof = (profile(activities=[ProfilerActivity.CPU]) if kind == "ont"
                else contextlib.nullcontext())
        with pytest.MonkeyPatch.context() as mp:
            steps = runs = None
            if kind == "pb":
                steps, runs = _Steps(mp), []
                steps.pipeline()
                real = pipeline.overlap_run

                def tallied(*args, **kwargs):
                    kwargs["progress"] = steps.progress
                    then = steps.mark()
                    try:
                        return real(*args, **kwargs)
                    finally:
                        runs.append(steps.since(steps.mark(), then))
                mp.setattr(pipeline, "overlap_run", tallied)
            with prof:
                pipeline.run_sampleqc(fq, str(tmp / "out"), preset,
                                      nsample=n, device="cpu", stats=st,
                                      report=False)
        out[kind] = {"kind": kind, "stats": st, "prof": prof,
                     "tally": steps and steps.mark(), "runs": runs}
    return out


@pytest.mark.parametrize("kind", ["ont", "pb"])
def test_sampleqc_legacy_keys_are_span_sums(sampleqc_runs, kind):
    """The legacy keys keep their key sets; on the steps' clock (pb),
    each holds exactly the steps it timed before the spans."""
    sampleqc_run = sampleqc_runs[kind]
    st = sampleqc_run["stats"]
    by = st["spans"]["by_name"]
    assert by["sampleqc"]["n"] == 1
    assert set(st["stage_s"]) == STAGE_KEYS
    runs = ["overlap"] + (["spike_in"] if kind == "pb" else [])
    for key in runs:
        ov = st[key]
        assert set(ov["phase_s"]) - {"host_fix"} == PHASE_KEYS
        # each engine run's spans are its own share of the run's
        for name, v in ov["spans"]["by_name"].items():
            assert v["n"] <= by[name]["n"]
    # HPC parts take the host spec's index: no tile packing, no merge
    assert set(st["overlap"]["index_s"]) == INDEX_KEYS
    if kind == "ont":
        assert st["spans"]["counters"]["adapter.candidates"] >= 25
        return
    assert st["spike_in"]["index_s"] == {}
    assert by["hpc.compress"]["n"] >= 2
    assert "span_log" not in st
    t, (t_ov, t_spike) = sampleqc_run["tally"], sampleqc_run["runs"]
    for key, tally in (("overlap", t_ov), ("spike_in", t_spike)):
        _assert_engine_keys(st[key], tally)

    def main_side(tally):
        return sum(v for (_n, _c, m), v in tally.items() if m) / 1e9
    want = {"adapter": _s(t, {"adapter"}),
            "adapter_sample_gc": _s(t, {"adapter", "subsample"}),
            "mask": _s(t, {"screen", "format"}),
            "mask_wait": _s(t, {"wait"}, "_chunk_qc"),
            "exclusion": _s(t, {"exclusion"}),
            "overlap": main_side(t_ov), "spike_in": main_side(t_spike),
            "analytics": _s(t, {"analytics"})}
    want["chunk_loop"] = want["adapter_sample_gc"] + want["mask_wait"]
    assert st["stage_s"] == pytest.approx(want, rel=1e-12, abs=1e-15)
    assert min(want.values()) > 0
    # the mask thread's steps are off the main thread, the part
    # thread's packing too
    assert _s(t, {"screen", "format"}, main=True) == 0
    assert _s(t, {"pack", "part_init"}, main=True) == 0


def test_sampleqc_threads_and_profiler_ranges(sampleqc_runs):
    sampleqc_run = sampleqc_runs["ont"]
    st = sampleqc_run["stats"]
    roles = {(e["name"], e["role"]) for e in st["span_log"]}
    assert {("mask.chunk", "mask"), ("mask.screen", "mask"),
            ("mask.host", "mask"), ("part.read", "part"),
            ("part.prep", "part"), ("part.pack", "part"),
            ("part.wait", "main"), ("adapter.align", "main")} <= roles
    _assert_agree(st["span_log"], _kineto(sampleqc_run["prof"]))


def test_overlap_run_legacy_keys_are_span_sums(monkeypatch):
    """phase_s and index_s of a direct overlap_run_device call hold
    exactly the steps each timed before the spans (_Steps)."""
    reads = ont_sampleqc_reads()
    cfg = overlap_config_for_sample(PRESETS["ont-ligation"])
    steps = _Steps(monkeypatch)
    steps.engine()
    st = {}
    rows = overlap_run_device(iter(reads), reads[:20], cfg, device="cpu",
                              stats=st, progress=steps.progress)
    assert len(rows) == 20 and st["engine"] == "device"
    assert set(st["index_s"]) == INDEX_KEYS
    _assert_engine_keys(st, steps.mark())
    by = st["spans"]["by_name"]
    assert by["overlap"]["n"] == 1
    assert by["overlap"]["wall_s"] >= sum(
        st["phase_s"][k] for k in ("count", "step", "pull", "finalize"))


@pytest.mark.parametrize("flags", [["-d"], ["-z", "-d"]], ids=["d", "z"])
def test_mmcov_host_spec_stats_carry_its_spans(tmp_path, capsys, flags):
    """mmcov's host-spec paths (-d, -z) open the run's table in
    overlap_run: `--stats` carries its spans, the HPC compression's
    (-H) among them."""
    reads = ont_sampleqc_reads()[:40]
    tf, qf = str(tmp_path / "t.fq"), str(tmp_path / "q.fq")
    write_fastq_file(tf, reads)
    write_fastq_file(qf, reads[:6])
    stats = str(tmp_path / "stats.json")
    assert main(["mmcov", "-H", "-k", "15", "-w", "10"] + flags
                + [str(tmp_path / "db"), "--device", "cpu", "--stats", stats,
                   tf, qf]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 6
    with open(stats) as f:
        st = json.load(f)
    assert st["engine"] == "host_spec" and "span_log" not in st
    by = st["spans"]["by_name"]
    assert by["overlap_host"]["n"] == 1
    assert by["hpc.compress"]["n"] >= 1
    assert by["overlap_host"]["wall_s"] >= by["hpc.compress"]["wall_s"]


@pytest.mark.cuda
def test_card_spans_agree_with_the_profilers_ranges():
    """On the card: a traced overlap run's main-thread spans and their
    `lq.*` ranges in the kineto trace (CPU and CUDA activities) agree
    (_assert_agree), and no `lq.*` range reaches the device's
    timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    reads = ont_sampleqc_reads()
    cfg = overlap_config_for_sample(PRESETS["ont-ligation"])
    overlap_run_device(iter(reads), reads[:20], cfg, device="cuda")
    st = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        overlap_run_device(iter(reads), reads[:20], cfg, device="cuda",
                           stats=st)
        torch.cuda.synchronize()
    dev = [ev.name() for ev in prof.profiler.kineto_results.events()
           if str(ev.device_type()).endswith("CUDA")]
    assert dev and not [n for n in dev if n.startswith("lq.")]
    _assert_agree(st["span_log"], _kineto(prof))

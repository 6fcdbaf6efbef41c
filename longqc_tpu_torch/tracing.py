"""Spans and counters of one run, on the clock of the device trace.

A top-level call (`run_sampleqc`, `overlap_run_device`, `overlap_run`)
opens the run's table with `run(stats, name)`; a call nested inside it
joins the caller's table. `span(name)` times a block and records:

- its name and its thread's role (`main`, `mask`, `part`, `prefetch`);
- the span it opened inside, on the same thread;
- its start and end from `time.time_ns()`, the Unix-epoch clock that
  torch.profiler's CPU events carry;
- its thread's CPU time from `time.thread_time_ns()`.

`count(name, n)` adds to a counter of the same table. A thread the run
starts records into the run's table through `carry(role, fn)`. Outside
any run, span() and count() do nothing.

When a call's `run` closes, what was recorded since it opened is folded
into stats["spans"]: {"by_name": {name: {"n", "wall_s", "self_s",
"cpu_s"}}, "counters": {name: n}}; self_s is wall minus the time the
span's children cover.

Tracing is on when torch.profiler is recording as the top-level call
starts (read once, on that thread). Then every span's interval, from
every thread, is kept in stats["span_log"] as {"name", "role", "id",
"parent", "t0", "t1", "cpu"} (ns), and each span of the main thread
also opens a profiler range "lq." + name (`_RANGE`), so the profiler's
trace names the program's spans; the span's clock readings are taken
inside its range. Off, only the sums are kept and no range is opened.

`_RANGE` is the profiler's CPU-op range, not record_function: kineto
copies a record_function range (a user annotation) onto the device's
timeline wherever kernels ran inside it, and the device's busy time is
read from that timeline.
"""

import contextlib
import itertools
import threading
import time

import torch

_local = threading.local()     # per thread: table, role, stack of spans
_NULL = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


class Table:
    """One run's spans and counters; `log` keeps every interval."""

    def __init__(self, log=False):
        self.log = [] if log else None
        self.sums = {}        # name -> [n, wall_ns, self_ns, cpu_ns]
        self.counters = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def _add(self, sp, t1, cpu):
        wall = t1 - sp.t0
        with self._lock:
            s = self.sums.setdefault(sp.name, [0, 0, 0, 0])
            s[0] += 1
            s[1] += wall
            s[2] += wall - sp.child
            s[3] += cpu
            if self.log is not None:
                self.log.append({"name": sp.name, "role": _local.role,
                                 "id": sp.id, "parent": sp.parent,
                                 "t0": sp.t0, "t1": t1, "cpu": cpu})

    def count(self, name, n):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def mark(self):
        """What has been recorded so far, for fold()."""
        with self._lock:
            return ({k: list(v) for k, v in self.sums.items()},
                    dict(self.counters))

    def fold(self, since=None):
        """The sums recorded after `since` (a mark; None: all)."""
        sums0, counters0 = since or ({}, {})
        with self._lock:
            by_name = {}
            for k, v in self.sums.items():
                v0 = sums0.get(k, (0, 0, 0, 0))
                if v[0] > v0[0]:
                    by_name[k] = {"n": v[0] - v0[0],
                                  "wall_s": (v[1] - v0[1]) / 1e9,
                                  "self_s": (v[2] - v0[2]) / 1e9,
                                  "cpu_s": (v[3] - v0[3]) / 1e9}
            counters = {k: v - counters0.get(k, 0)
                        for k, v in self.counters.items()
                        if k not in counters0 or v != counters0[k]}
        return {"by_name": by_name, "counters": counters}


class _Span:
    __slots__ = ("tab", "name", "id", "parent", "t0", "child", "c0", "rf")

    def __init__(self, tab, name):
        self.tab = tab
        self.name = name

    def __enter__(self):
        stack = _local.stack
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        self.id = next(self.tab._ids)
        self.child = 0
        self.rf = None
        stack.append(self)
        # the clock readings inside the profiler's range, and the CPU
        # reading inside the wall one, so cpu <= wall
        if self.tab.log is not None and _local.role == "main":
            self.rf = _RANGE("lq." + self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        cpu = time.thread_time_ns() - self.c0
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += t1 - self.t0
        self.tab._add(self, t1, cpu)
        return False


def span(name):
    """Context manager: one span of the current run (no-op outside)."""
    tab = getattr(_local, "table", None)
    return _NULL if tab is None else _Span(tab, name)


def count(name, n=1):
    """Add n to the current run's counter `name` (no-op outside)."""
    tab = getattr(_local, "table", None)
    if tab is not None:
        tab.count(name, n)


@contextlib.contextmanager
def _bound(tab, role):
    prev = (getattr(_local, "table", None), getattr(_local, "role", None),
            getattr(_local, "stack", None))
    _local.table, _local.role, _local.stack = tab, role, []
    try:
        yield
    finally:
        _local.table, _local.role, _local.stack = prev


def carry(role, fn):
    """fn, to run on another thread, recording into the calling thread's
    run (if any) under `role`."""
    tab = getattr(_local, "table", None)

    def bound(*args, **kwargs):
        with _bound(tab, role):
            return fn(*args, **kwargs)
    return bound


class Scope:
    """A call's view of its run: `fold` (set when the call's run closes)
    holds what was recorded while it was open."""

    fold = None


def _warm(name):
    """Open and close one profiler range, "start.<name>", outside the
    `lq.` names: a thread's first range under a profiler returns well
    after it began (~1.4 ms on an H100 host), which would move the first
    span's start off its range's. In the trace it marks the run's start."""
    rf = _RANGE("start." + (name or "run"))
    rf.__enter__()
    rf.__exit__(None, None, None)


@contextlib.contextmanager
def run(stats=None, name=None):
    """Open the run's table on a top-level call (and, named, its own
    top-level span), or join the caller's. Yields a Scope. On close,
    the call's fold goes to stats["spans"] and, on a traced top-level
    call, the intervals to stats["span_log"]."""
    tab = getattr(_local, "table", None)
    top = tab is None
    with contextlib.ExitStack() as stack:
        if top:
            tab = Table(log=torch.autograd._profiler_enabled())
            stack.enter_context(_bound(tab, "main"))
            if tab.log is not None:
                _warm(name)
        scope = Scope()
        since = tab.mark()
        try:
            if top and name:
                with span(name):
                    yield scope
            else:
                yield scope
        finally:
            scope.fold = tab.fold(since)
            if stats is not None:
                stats["spans"] = scope.fold
                if top and tab.log is not None:
                    stats["span_log"] = list(tab.log)


def legacy(fold, keys):
    """{key: summed wall_s of its span names} for each key of `keys`
    ({key: names}) whose spans ran."""
    by_name = fold["by_name"]
    out = {}
    for key, names in keys.items():
        got = [by_name[n]["wall_s"] for n in names if n in by_name]
        if got:
            out[key] = sum(got, 0.0)
    return out

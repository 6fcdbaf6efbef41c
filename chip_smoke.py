#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (longqc_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, so the script exits nonzero and never
prints the final result line):
  1. environment: card name and power limit, torch / CUDA / nvcc /
     triton, the compiler variables of the environment; no CUDA
     device -> fail
  2. build the five kernels (B1 sketch, B2 chain fill, B3 peak,
     B4 min-rank, B5 extension, with its one-warp body for W <= 63 and
     its wide body, strips of 64 columns a warp, for wider bands), the
     adapter alignment and the tile packing from longqc_tpu_torch/csrc,
     the port's FASTA/FASTQ reader
     (csrc/fastx_native.cpp, g++ -O3) and its sdust recursion
     (csrc/sdust_native.cpp); the registers, stack frame and spills of
     every B1 and B5 instance and of the tile packing (one more `nvcc
     -Xptxas -v` each of csrc/sketch.cu, csrc/extend.cu and csrc/pack.cu
     alone, beside the build)
  3. B1-B4 against their plain PyTorch versions on the card, at
     production shapes, with exact equality (tolerance 0: all outputs
     are integers): B1 on 256 x 8192 and 32 x 65536 tiles of reads with
     (AT)n and N runs longer than its column chunk, in its four
     variants: u32 hashes (k=12 w=5), u64 hashes (k=19 w=10, int64
     hashes past 2^31 present), and on the 256 x 8192 tile the run-time
     ring (w=40 and w=255) with u32 (k=12) and u64 (k=19) hashes; B2
     twice (with the
     one gap-penalty table of the plain engine, row stride 0, and with
     one table per row, as the HPC engine gives it) on rows whose
     windows run deeper than 256 ages, with the ages each anchor scans;
     B3 / B4 with no window limit (J = A), as the engine calls them, on
     B2's output (Q=128 A=8192) and on Q=128 A=65536 synthetic forests
     (depth-A paths, chains across B3 / B4's chunks, garbage parents,
     parents past J) with J = A and J = 256; both times and each
     kernel's bound printed; then at the wide rungs' shapes (rows past
     the engine's top anchor rung, checked after phase 15): B3 / B4 on
     far forests at Q x A = 16 x 2^21 (B4's pending mask in device
     memory) and 64 x 2^19, B2 at 64 x 2^19 (row 0 against its plain
     version), the plain versions run on CPU tensors in side processes
     from phase 4 on; then the tile packing (csrc/pack.cu) at the index
     ladder's three tile shapes and a jumbo tile (256 x 8192, 32 x
     65536, 4 x 524288, 1 x 4,194,304; tests/torch_util.pack_tile: reads
     of no bases, of every ASCII byte, with N, lower case, U and IUPAC
     bases, rows cut by READS_PER_ROW, an empty last row): its four word
     arrays against the plain twin, exact; the kernel alone, with the
     tile's two uploads, and the twin timed, the bound (bytes); the peak
     device bytes a column of a tile's build step (the words, B1, the
     chunk) against the index's reckoning, TILE_BYTES_PER_COLUMN
  4. small end to end: the engine's rows on the card equal the port's
     host spec (overlap_host.overlap_run), at k=12 w=5 and, so that the
     run-time-ring B1 variants run on a path, at w=40 with k=12 and
     k=19
  5. realistic `mmcov` run through longqc_tpu_torch.cli.main at the
     ont-ligation sample configuration (k=12 w=5 -p 160 -q 160 -l 0):
     10 Mbp genome, 20,000 target reads of 1-8 kbp (~9x), 5,000
     queries; the reader (native, else fail) and its parse seconds,
     kernel launch counts (step calls = B2 launches), retry steps,
     flag counts, host-fixed rows (<= 5%) and 32 random queries' rows
     against the host spec; B3 / B4 launches by anchor rung and their
     summed bound; then one more run of the same command under
     torch.profiler for each kernel's total device time on the path;
     then the engine once more on the same data with the width ladder
     capped below the part, so that its index takes the hash-range
     build with at least 4 ranges: all 5,000 rows must equal the first
     run's, with no host-only part
  6. B5, the banded extension (ops/extend.extz_batch), on 8,192 pairs
     of 500-4,000 bp (10 Mbp genome, err 0.12, 20% unrelated pairs so
     Z-drop fires; zdrop=400, scores 2/-4/4/2, extd adds 24/1) at W=63
     and 31 (the one-warp wavefront, two and one columns a lane) and
     W=64 and 255 (the wide body), and on the
     first 1,024 pairs at W=5,000, past every pair, where the wide body
     clamps each pair's band: extz and extd kernels against their plain
     version (the full band) on the same tensors, all eight outputs
     exact; 16 short pairs against the full-DP host reference
  6b. the adapter search's alignment kernel (csrc/adapter.cu) at a
     sampleqc job of ont-ligation's shapes (1,850 windows of 150 columns
     at the 28 bp 5' adapter, 3,700 at the 18 bp 3' one, every kind of
     tests/torch_util.adapter_windows): all eight fields against the
     plain twin (ops/adapter.hw_align_batch on CPU tensors) on every
     window; the kernel's time, the plain twin's on the same windows, the
     bound
  7. the HPC spike-in-control filter run through cli.main
     (mmcov -H -k 15 -w 10 -c 1 -l 0 --filter) against the Sequel
     control reference of the port (longqc_tpu_torch/refs/): 5,000
     queries of 1-8 kbp,
     100 of them from the (unrolled) control; the reader (native, else
     fail), B2-B4 launch counts (B3 / B4 by anchor rung), host-fixed
     rows (<= 5%), the filter marking every control-derived query and
     no other, and the rows of every control-derived query and 32
     random others against the host spec
  8. the pb-hifi fast preset through cli.main (mmcov -k 19 -w 10 -p 80
     -q 160 -l 0: wide hashes on int64 lanes, the u64 B1): 10 Mbp
     genome, 6,000 target reads of 10-20 kbp (~9x), err 0.01, 5,000
     queries; checks and prints as phase 5, the u32 B1 not launched
  9. a part of the reference's size through cli.main at phase 5's
     settings (default -I 4G, so one part): 230,000 target reads of
     1-8 kbp (~1.03 Gbp, ~9.4x of a 110 Mbp genome), err 0.12, 5,000
     queries (made by a side process, on the CPU, from the start of the
     script on); the part must take the hash-range build on the card (0
     host-only parts, 1 hash-range part), host-fixed rows <= 5%; then
     one more build_device_index over the same part, checked apart from
     the merge code: ih non-decreasing, its real entries the sum of the
     tiles' emission counts, the (rid, pos) multiset of 4,096 sampled
     hashes equal to the tiles' chunks', mid_occ the kth count of
     torch.unique_consecutive over ih, index.pack_tiles its tiles; its
     peak device memory and its seconds (host layout, the tiles' words
     plus B1 plus chunks, the merge) printed
 10. the port's sampleqc through cli.main on the card (default -n 5000;
     with --no-report, and saying so, where matplotlib or jinja2 is not
     installed, so the figures and the HTML are not drawn there):
     10a. ont-ligation on phase 5's 20,000 target reads written as one
     FASTQ, the preset's 5' adapter planted on 2,000 of them;
     10b. pb-sequel on phase 7's 5,000 queries (100 from the control),
     the spike-in filter run against the port's Sequel control.
     Each: rc 0; Num_of_reads and Yield; B1-B4 launched; the reader and
     the sdust recursion native; host-fixed rows <= 5%; one mask-table
     row per read, 256 random ones equal to the Python sdust recursion
     plus meanQ and nQ7 recomputed on the host; one 9-column coverage
     row per sampled read, 32 random ones equal to the host spec; the 8
     figures and the HTML unless not drawn; the stage seconds, the
     overlap's phase_s, host-fixed rows and peak device memory printed.
     10a: the 5' adapter statistics (and the 3' ones, when they pass
     the identity threshold) equal a cut_adapter run with CPU tensors on
     the same reads (a side process beside phases 10a-14, checked after
     phase 14); the card's run aligned every candidate with the
     adapter_align kernel, one launch an adapter.align span; the mask
     stage and the adapter DP run once more,
     each alone on the card and timed, the mask rows equal to the run's.
     10b: every control-derived sampled read is marked in the spike-in
     table
 11. `sampleqc -d -x pb-sequel` through cli.main on phase 10b's reads:
     the checks of phase 10; one npz part per (k, w) spec; the coverage
     and spike-in tables and the QC JSON equal 10b's; the part's arrays
     (dtypes too) equal a fresh overlap_host.build_index on the card;
     the prefetch thread's seconds and the join wait printed, and the
     prefetch's seconds alone on the card
 12. on the first 2,000 of phase 5's targets and its first 200 queries,
     at phase 5's settings, through cli.main: `mmcov -d` dump only (one
     npz part, nothing printed), then the cached run (the host spec),
     its rows equal to the device engine's; `mmcov -z` from the cache:
     the rows unchanged, the [z] lines descending and summing to the
     device engine's m_cnts; then `mmcov -H -k 17 -w 10 -c 1 -l 0
     --filter` against the Sequel control on the 200 queries and 20 of
     phase 7's control-derived reads: the device engine rejects HPC with
     k > 15, so the batched chainer runs, B2 (and no other kernel)
     launched, every row equal to the host spec's; seconds, B2 launches
     and host-chained rows printed; then the batched-chainer path
     called directly (overlap_host.overlap_run with DeviceChainer as its
     chain_many) at phase 5's settings on the 2,000 targets and 200
     queries, a configuration the device engine takes: B2 (and no other
     kernel) launched, every row equal to the device engine's
 13. `runqc sequel` (20,000 ZMWs of 1-4 subreads split by adapters,
     low-quality and control scraps; BAM records of 12 bp placeholder
     sequences, the QC reading names and tags alone) and `runqc rs2`
     (an sts.csv of 50,000 ZMWs and an sts.xml) through cli.main on run
     folders written here (--no-report where matplotlib is missing):
     Num_of_reads, Throughput, Longest_read, the productivity and the
     Sequel control throughput equal what the writer planted; `runqc
     minion` where h5py is installed, else one line saying it did not
     run
 14. the part pipeline, at phase 5's settings: `mmcov -I 30M` through
     cli.main on phase 5's targets (3
     parts, each read and packed on the engine's side thread while the
     previous one steps): 32 random rows equal to the host spec at -I
     30M; peak device memory at most 1.1 x phase 5's (one device build
     live at a time); the parts, phase_s (`index`, `part_wait`, `step`)
     and the wall printed
 15. rows past the top anchor rung (262,144) through cli.main at phase
     5's settings, on the ont-ultralong cell's reads: 800 of 10-290 kbp
     (7.5x of a 16 Mbp genome, no junk; made by a side process from
     phase 4 on); queries the 96 longest and 32 others: no host-fixed
     row, at least half the rows stepped at the wide rungs, B4 launched
     past 2^20 anchors; the rows of the longest, the 48th longest and
     the shortest query equal the benchmark's plain reference
     (benchmark/reference/overlap.rows_for, in the side process on CPU
     tensors); the wide-row counters and B3 / B4 launches by rung
     printed
The side processes use the CPU only and are stopped when the script
stops. Kernel launch counts are reset just before each path (phase 4's three
runs, phases 5, 6, 7, 8, 9, 10a, 10b, 11, phase 12's two batched-chainer
runs, 14, 15) and read just after it. Each
kernel's bound is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its integer operations
(counted from this run's data) over 67 T/s, the card's 32-bit rate
outside the tensor cores. The line before the last but one is
{"kernels": [...]}, the line before the last the card's name and power
limit, the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""

import gc
import io
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

HERE = os.path.dirname(os.path.abspath(__file__))
N_QUERIES = 5000        # the sampleqc default -n

# the two all-vs-sample runs through cli.main
ONT_RUN = dict(
    phase="phase 5", k=12, w=5, p=160, q=160, seed=2024, n_targets=20000,
    min_len=1000, max_len=8000, err=0.12, junk=0.1, prefix="",
    kernels=("sketch", "chain", "peak", "minrank", "pack_tile"),
    range_rerun=True)
HIFI_RUN = dict(
    phase="phase 8", k=19, w=10, p=80, q=160, seed=1919, n_targets=6000,
    min_len=10000, max_len=20000, err=0.01, junk=0.02, prefix="hifi_",
    kernels=("sketch_u64", "chain", "peak", "minrank", "pack_tile"))
# phase 9: a part of at least 1 Gbp at phase 5's settings
BIG_RUN = dict(
    phase="phase 9", k=12, w=5, p=160, q=160, seed=909, genome=110_000_000,
    n_targets=230_000, min_len=1000, max_len=8000, err=0.12, junk=0.1,
    min_bp=1_000_000_000,
    kernels=("sketch", "chain", "peak", "minrank", "pack_tile"))
N_SAMPLED_HASHES = 4096

B1 = ("longqc_tpu_torch/csrc/sketch.cu",
      "longqc_tpu/ops/sketch_pallas.py:285")
SOURCES = {
    "sketch": B1, "sketch_u64": B1, "sketch_ring": B1, "sketch_ring_u64": B1,
    "chain": ("longqc_tpu_torch/csrc/chain.cu",
              "longqc_tpu/ops/chain_pallas.py:262"),
    "peak": ("longqc_tpu_torch/csrc/ringprop.cu",
             "longqc_tpu/ops/ringprop.py:34"),
    "minrank": ("longqc_tpu_torch/csrc/ringprop.cu",
                "longqc_tpu/ops/ringprop.py:34"),
    "extz": ("longqc_tpu_torch/csrc/extend.cu",
             "longqc_tpu/ops/extend_pallas.py:192"),
    "extd": ("longqc_tpu_torch/csrc/extend.cu",
             "longqc_tpu/ops/extend_pallas.py:192"),
    "extz_wide": ("longqc_tpu_torch/csrc/extend.cu",
                  "longqc_tpu/ops/extend.py:31"),
    "extd_wide": ("longqc_tpu_torch/csrc/extend.cu",
                  "longqc_tpu/ops/extend.py:31"),
    "adapter_align": ("longqc_tpu_torch/csrc/adapter.cu",
                      "none (the host traceback, longqc_tpu/ops/adapter.py "
                      "hw_align_host, hw_align_optrange)"),
    "pack_tile": ("longqc_tpu_torch/csrc/pack.cu",
                  "none (the host packer, longqc_tpu/engine/"
                  "device_index.py _TileBuilder._pack)"),
}
HPC_KERNELS = ("chain", "peak", "minrank")
# CUDA kernel symbol prefix -> kernel name (the profiler's key); the B1
# variants are told apart by their template arguments (b1_variant)
SYMBOLS = {"lq_chain": "chain", "lq_peak": "peak", "lq_minrank": "minrank",
           "lq_pack": "pack_tile"}
HBM_BYTES_S = 3.35e12   # H100 SXM device memory
INT_OPS_S = 67e12       # 32-bit operations outside the tensor cores
# integer operations of the function per unit of work (see PERF.md)
OPS_PER_COLUMN = 30     # B1, plus 2 per ring slot (counted alike for
#                         32- and 64-bit hash words)
OPS_PER_AGE = 20        # B2, per predecessor the reference visits
OPS_PER_CELL = {"extz": 12, "extd": 18}   # B5, per band cell
OPS_PER_ALIGN_CELL = 20  # adapter_align, per DP cell
# phase 6b: (adapter length, windows) of a sampleqc job of ont-ligation
ADAPTER_RUNS = ((28, 1850), (18, 3700))
# phase 3's tile packing: (R, W) of the index ladder's levels and a jumbo
PACK_SHAPES = ((256, 8192), (32, 65536), (4, 524288), (1, 1 << 22))


def log(*a):
    print(*a, flush=True)


# side processes (CPU only, beside the card's phases): name -> function
# of the work directory; `python3 chip_smoke.py --side NAME WORKDIR`
SIDE = {}
_SIDE_PROCS = []


def side_start(name, workdir):
    """Start SIDE[name](workdir) in a process of its own."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--side", name, workdir])
    _SIDE_PROCS.append(proc)
    return proc


def side_wait(proc, what):
    if proc.wait() != 0:
        raise AssertionError("%s: its side process exited %d"
                             % (what, proc.returncode))


def side_stop():
    """Stop every side process still running (after a failure)."""
    for proc in _SIDE_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call over `reps` calls (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    tb, to = nbytes / HBM_BYTES_S, ops / INT_OPS_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def require_equal(name, a, b):
    err = max_abs(a, b)
    if err != 0 or a.shape != b.shape:
        raise AssertionError("%s: kernel differs from its plain version "
                             "(max |diff| %d)" % (name, err))
    return err


def b1_variant(symbol):
    """LAUNCHES name of a B1 instance from its kernel symbol, demangled
    (`lq_sketch_chunks_kernel<unsigned long, 16, false>`) or mangled
    (`...kernelImLi16ELb0EE...`); None for any other symbol."""
    m = re.search(r"lq_sketch_chunks_kernel<unsigned (int|long), (\d+)",
                  symbol)
    if m:
        u64, wm = m.group(1) == "long", int(m.group(2))
    else:
        m = re.search(r"lq_sketch_chunks_kernelI([jm])Li(\d+)E", symbol)
        if not m:
            return None
        u64, wm = m.group(1) == "m", int(m.group(2))
    return ("sketch" + ("_ring" if wm > 32 else "")
            + ("_u64" if u64 else ""))


def ptxas_resources(path, key):
    """Registers, stack frame and spill bytes of every kernel instance
    of one CUDA source, from `nvcc -Xptxas -v` on that file alone with
    the extension's flags: {key(symbol): {...}} for each symbol that
    `key` maps (to None: left out)."""
    from longqc_tpu_torch.ops import _ext
    with tempfile.TemporaryDirectory(prefix="longqc_ptxas_") as tmp:
        out = subprocess.run(
            [_ext.nvcc_path(), "-std=c++17", "-Xptxas=-v", "-c", path, "-o",
             os.path.join(tmp, "k.o")] + _ext.CUDA_FLAGS,
            capture_output=True, text=True)
    if out.returncode != 0:
        raise AssertionError("nvcc -Xptxas -v failed: %s" % out.stderr[-2000:])
    res, cur = {}, None
    for line in out.stderr.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = key(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            res.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res.setdefault(cur, {})["registers"] = int(m.group(1))
    return res


def log_resources(what, res, n):
    """Print each instance's resources; fail unless there are n, each
    with all four numbers."""
    if len(res) != n or not all(len(v) == 4 for v in res.values()):
        raise AssertionError("expected %d %s instances in ptxas' output, "
                             "got %s" % (n, what, sorted(res)))
    for (name, arg), v in sorted(res.items()):
        log("%s %s, %s: %d registers, %d bytes stack frame, spills %d / %d "
            "bytes (stores / loads)"
            % (what, name, arg, v["registers"], v["stack"],
               v["spill_stores"], v["spill_loads"]))


def sketch_resources():
    """Every B1 instance's resources: {(variant, ring slots): {...}},
    printed."""
    from longqc_tpu_torch.ops import _ext

    def key(sym):
        wm = re.search(r"Li(\d+)E", sym)
        name = b1_variant(sym)
        return (name, int(wm.group(1))) if wm and name else None

    res = ptxas_resources(os.path.join(_ext.CSRC, "sketch.cu"), key)
    log_resources("B1", {(n, "%d ring slots" % wm): v
                         for (n, wm), v in res.items()}, 12)
    return res


def pack_resources():
    """The tile packing kernel's resources, printed."""
    from longqc_tpu_torch.ops import _ext
    res = ptxas_resources(
        os.path.join(_ext.CSRC, "pack.cu"),
        lambda sym: ("pack_tile", "one column a thread")
        if "lq_pack_tile_kernel" in sym else None)
    log_resources("pack", res, 1)
    return res


def extend_variant(symbol):
    """(LAUNCHES name, instance) of a B5 kernel symbol (mangled): the
    one-warp body `lq_extend_kernel<CPL, DUAL>` -> ("extz" / "extd",
    "CPL columns a lane"), the wide body `lq_extend_wide_kernel<G, DUAL>`
    -> ("extz_wide" / "extd_wide", "strips of 64 G columns, G warps");
    None for any other symbol."""
    m = re.search(r"lq_extend_kernelILi(\d+)ELb([01])E", symbol)
    if m:
        return ("extd" if m.group(2) == "1" else "extz",
                "%s columns a lane" % m.group(1))
    m = re.search(r"lq_extend_wide_kernelILi(\d+)ELb([01])E", symbol)
    if m:
        return ("extd_wide" if m.group(2) == "1" else "extz_wide",
                "strips of %d columns, %s warps" % (64 * int(m.group(1)),
                                                    m.group(1)))
    return None


def extend_resources():
    """Every B5 instance's resources (the one-warp body at one and two
    columns a lane, the wide body at one, two and four warps a pair;
    extz and extd each), printed."""
    from longqc_tpu_torch.ops import _ext
    res = ptxas_resources(os.path.join(_ext.CSRC, "extend.cu"),
                          extend_variant)
    log_resources("B5", res, 12)
    return res


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def synth_part(rng, n, lo, hi):
    """Reads with N runs and (AT)n stretches (symmetric k-mers), many
    longer than B1's column chunk (ops/sketch_cuda.CHUNK)."""
    reads = []
    for i in range(n):
        s = "".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi)))
        if i % 7 == 3:
            p = rng.randint(0, len(s) - 40)
            s = s[:p] + "N" * rng.randint(1, 700) + s[p + 30:]
        if i % 11 == 5:
            p = rng.randint(0, len(s) // 2)
            s = s[:p] + "AT" * rng.randint(20, 900) + s[p:]
        reads.append(["s%05d" % i, s[:hi]])
    return reads


def check_sketch(dev, k, w, tiles=((256, 8192, 200, 3000),
                                  (32, 65536, 4000, 20000))):
    """The B1 variant that (k, w) selects against the plain version on
    tiles of (R, W, shortest, longest read); times, and the bound, of
    the first tile."""
    import torch
    from longqc_tpu_torch.engine import device_index as di
    from longqc_tpu_torch.ops import _ext
    from longqc_tpu_torch.ops import sketch_cuda as skc

    rng = random.Random(5)
    name = skc.kernel_name(k, w)
    chunk = skc.chunk_width(w)
    hbytes = 8 if skc.is_wide(k) else 4
    first = None
    for R, W, lo, hi in tiles:
        b = di._TileBuilder(R, W, max(w - 1, 1))
        gid = 0
        while len(b.rows) < R:
            for r in synth_part(rng, 64, lo, hi):
                b.add(gid, r[1])
                gid += 1
        n_run = sum(1 for row in b.rows[:R] for _, sq in row
                    if "N" * (chunk + 1) in sq or "AT" * (chunk // 2 + 1) in sq)
        tile = b.tiles()[0]
        words = [di.to_device_words(a, dev) for a in
                 (tile.codes2, tile.nmask, tile.startmask, tile.endmask)]
        ints = [torch.from_numpy(a).to(dev) for a in (tile.starts, tile.gids)]
        args = words + ints
        kern = skc.sketch_tiles(*args, W=W, k=k, w=w)
        plain = skc.sketch_tiles_plain(*args, W=W, k=k, w=w)
        torch.cuda.synchronize()
        err = require_equal("%s emit %dx%d" % (name, R, W), kern["emit"],
                            plain["emit"])
        on = plain["emit"] > 0
        for f in ("hash", "rid", "pos", "strand"):
            if kern[f].dtype != plain[f].dtype:
                raise AssertionError("%s %s: %s, plain %s" % (
                    name, f, kern[f].dtype, plain[f].dtype))
            err = max(err, require_equal("%s %s %dx%d" % (name, f, R, W),
                                         kern[f][on], plain[f][on]))
        if not int(on.sum()):
            raise AssertionError("%s %dx%d: no emission" % (name, R, W))
        n_big = 0
        if skc.is_wide(k):
            n_big = int((kern["hash"][on] > 1 << 31).sum())
            if kern["hash"].dtype != torch.int64 or not n_big:
                raise AssertionError("%s: no int64 hash above 2^31" % name)
        ms = cuda_ms(lambda: skc.sketch_tiles(*args, W=W, k=k, w=w), 5)
        pms = cuda_ms(lambda: skc.sketch_tiles_plain(*args, W=W, k=k, w=w),
                      2)
        b_ms, b_by = bound(nbytes(*args) + R * W * (4 * 4 + hbytes),
                           R * W * (OPS_PER_COLUMN + 2 * w))
        # the wrapper's two parts: the chunk plan (tensor ops) and the
        # kernel launch alone on that plan
        plan_ms = cuda_ms(lambda: skc.chunk_plan(*args[:3], W=W, k=k, w=w,
                                                 chunk=chunk), 5)
        plan = skc.chunk_plan(*args[:3], W=W, k=k, w=w, chunk=chunk)
        outs = [torch.zeros((R, W), dtype=kern[f].dtype, device=dev)
                for f in ("emit", "hash", "rid", "pos", "strand")]
        lib = _ext.lib()
        k_ms = cuda_ms(lambda: lib.sketch_rows(*args, plan, *outs, W, k, w,
                                               chunk), 5)
        log("B1 %s k=%d w=%d %dx%d: equal (%d emissions, %d hashes above "
            "2^31; %d reads with an N or (AT)n run longer than the "
            "%d-column chunk); wrapper %.3f ms (plan %.3f ms, kernel alone "
            "%.3f ms), plain %.3f ms, bound %.4f ms (%s), library_ms null"
            % (name, k, w, R, W, int(plain["emit"].sum()), n_big, n_run,
               chunk, ms, plan_ms, k_ms, pms, b_ms, b_by))
        if first is None:
            first = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                         bound_by=b_by, kernel_alone_ms=k_ms, plan_ms=plan_ms,
                         shape="%dx%d k=%d w=%d" % (R, W, k, w))
        else:
            first["max_abs_err"] = max(first["max_abs_err"], err)
            sfx = "_%dx%d" % (R, W)
            first.update({"ms" + sfx: ms, "plain_ms" + sfx: pms,
                          "bound_ms" + sfx: b_ms,
                          "kernel_alone_ms" + sfx: k_ms})
    return name, first


def check_sketch_variants(dev):
    """Phase 3's B1 runs: {LAUNCHES name: result}; the run-time ring's
    w = 255 times ride under keys suffixed _w255."""
    out = {}
    for k, w in ((12, 5), (19, 10)):
        name, r = check_sketch(dev, k, w)
        out[name] = r
    for k in (12, 19):
        name, r = check_sketch(dev, k, 40, tiles=((256, 8192, 200, 3000),))
        _, r255 = check_sketch(dev, k, 255, tiles=((256, 8192, 200, 3000),))
        r["max_abs_err"] = max(r["max_abs_err"], r255["max_abs_err"])
        r.update({key + "_w255": r255[key] for key in
                  ("ms", "plain_ms", "bound_ms", "kernel_alone_ms")})
        out[name] = r
    return out


def check_pack(dev):
    """Phase 3's tile packing: csrc/pack.cu (ops/pack_cuda.pack_words) at
    PACK_SHAPES against its plain twin, all four word arrays exact, one
    launch a tile; the kernel alone on resident inputs, with the tile's
    two uploads (its bytes and its int32 layout, as
    engine/device_index._run_tile makes them), and the twin on the
    host, timed; the bound (bytes); the peak device bytes a column of
    _run_tile (the words, B1, the chunk) at k=12 w=5, which must stay
    within the index's reckoning, TILE_BYTES_PER_COLUMN. Returns
    {"pack_tile": results}, the first shape's numbers unsuffixed and
    the others' suffixed _<R>x<W>."""
    import numpy as np
    import torch
    from torch_util import pack_tile
    from longqc_tpu_torch.engine import device_index as di
    from longqc_tpu_torch.ops import _ext, pack_cuda

    rng = np.random.RandomState(23)
    out = {"max_abs_err": 0}
    for i, (R, W) in enumerate(PACK_SHAPES):
        t = pack_tile(rng, R, W)
        host = [torch.from_numpy(a) for a in (t.raw, t.row_off, t.segs)]
        lay = np.concatenate([t.starts.ravel(), t.gids.ravel(), t.row_off,
                              t.segs.ravel()])
        ins = [a.to(dev) for a in host]
        _ext.reset_launches()
        got = pack_cuda.pack_words(*ins, R=R, W=W)
        torch.cuda.synchronize()
        if _ext.LAUNCHES["pack_tile"] != 1:
            raise AssertionError("pack_tile %dx%d: %d launches" % (
                R, W, _ext.LAUNCHES["pack_tile"]))
        t0 = time.time()
        plain = pack_cuda.pack_words_plain(t.raw, t.row_off, t.segs, R, W)
        plain_ms = (time.time() - t0) * 1e3
        for name, g, p in zip(("codes2", "nmask", "startmask", "endmask"),
                              got, plain):
            out["max_abs_err"] = max(out["max_abs_err"], require_equal(
                "pack_tile %s %dx%d" % (name, R, W), g.cpu(),
                torch.from_numpy(p.view(np.int32))))
        ms = cuda_ms(lambda: pack_cuda.pack_words(*ins, R=R, W=W), 20)

        def uploaded():
            lay_d = torch.from_numpy(lay).to(dev)
            n = lay.size - t.segs.size
            return pack_cuda.pack_words(torch.from_numpy(t.raw).to(dev),
                                        lay_d[n - R - 1:n],
                                        lay_d[n:].view(-1, 4), R=R, W=W)
        up_ms = cuda_ms(uploaded, 5)
        b_ms, by = bound(nbytes(*ins, *got), 0)
        del got
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        r = di._run_tile(t, 12, 5, dev)
        torch.cuda.synchronize()
        per_col = (torch.cuda.max_memory_allocated(dev) - held) / (R * W)
        del r
        log("pack_tile %dx%d (%d reads, %d bytes, %d rows used, %d reads "
            "in the fullest): equal; kernel %.4f ms, with the uploads %.4f "
            "ms, plain twin %.1f ms; bound %.2f us (%s), %.0fx; the tile's "
            "build step (words, B1, chunk) %.1f peak bytes a column (the "
            "reckoning's %d)" % (
                R, W, t.n_reads, t.raw.size,
                int((np.diff(t.row_off) > 0).sum()),
                int(np.diff(t.row_off).max()), ms, up_ms, plain_ms,
                b_ms * 1e3, by, ms / b_ms, per_col,
                di.TILE_BYTES_PER_COLUMN))
        if per_col > di.TILE_BYTES_PER_COLUMN:
            raise AssertionError("a %dx%d tile's build step peaks at %.1f "
                                 "bytes a column, past the reckoning's %d"
                                 % (R, W, per_col,
                                    di.TILE_BYTES_PER_COLUMN))
        sfx = "" if i == 0 else "_%dx%d" % (R, W)
        out.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "bound_ms" + sfx: b_ms, "upload_ms" + sfx: up_ms,
                    "bytes_per_column" + sfx: per_col})
        if i == 0:
            out.update({"bound_by": by, "shape": "%d x %d" % (R, W)})
    return {"pack_tile": out}


def rand_anchor_rows(rng, Q, A):
    """Anchor rows shaped like the engine's: sorted target positions in
    a few (rid, rev) groups, clustered diagonals, repeat-dense runs,
    and (one row in eight) (AT)n-like runs whose pairings are mostly
    invalid, so the scans reach back past 256 ages."""
    import numpy as np
    axh = np.zeros((Q, A), np.int32)
    axl = np.zeros((Q, A), np.int32)
    aq = np.zeros((Q, A), np.int32)
    nb = np.zeros(Q, np.int32)
    for r in range(Q):
        n = rng.randint(A // 2, A + 1)
        nb[r] = n
        # target reads of 40-400 anchors each, sorted by (rid, pos)
        grp = np.sort(rng.randint(0, max(1, n // rng.randint(40, 400)), n))
        pos = rng.randint(0, 8000, n)
        if r % 8 == 0:      # repeat-dense: many anchors per position band
            pos = rng.randint(0, 1000, n)
        pos = pos[np.lexsort((pos, grp))]
        diag = rng.randint(0, 3, n) * rng.randint(1, 400)
        q = pos + diag + rng.randint(-40, 40, n)
        if r % 8 == 4:      # (AT)n-like: scattered query positions
            n = nb[r] = min(A, rng.randint(600, 1200))
            pos = np.sort(rng.randint(0, 1500, n))
            grp = np.zeros(n, np.int64)
            q = rng.randint(0, 30000, n)
            near = rng.rand(n) < 0.3
            q[near] = pos[near] + rng.randint(-30, 30, int(near.sum()))
        axh[r, :n] = grp
        axl[r, :n] = pos
        aq[r, :n] = np.clip(q, 0, None)
    return axh, axl, aq, nb


def chain_pieces(axh, nb, fill):
    """B2's split of rows sorted by x_hi, for the log: segments (runs of
    one x_hi) a row, min / median / max, the longest segment, the
    kernel's pieces a row (P) and, from its counters (PieceCounts) over
    one call of fill(), the non-empty pieces and the longest piece."""
    import numpy as np
    import torch
    from longqc_tpu_torch.ops.chain_cuda import count_pieces, pieces_per_row
    Q, A = axh.shape
    x, n = axh.cpu().numpy(), nb.cpu().numpy()
    segs, longest = [], 0
    for r in range(Q):
        xr = x[r, :int(n[r])]
        b = np.concatenate([[0], np.flatnonzero(xr[1:] != xr[:-1]) + 1,
                            [len(xr)]])
        segs.append(len(b) - 1)
        longest = max(longest, int(np.diff(b).max()) if len(xr) else 0)
    P = pieces_per_row(Q, torch.cuda.get_device_properties(
        axh.device).multi_processor_count)
    with count_pieces() as pc:
        fill()
    pieces, row_span, piece_span = next(iter(pc.sums.values())).tolist()
    return ("segments a row %d / %d / %d (min / median / max), longest %d "
            "anchors; P = %d pieces a row, %d non-empty, longest piece %d "
            "of the longest row's %d anchors"
            % (min(segs), int(np.median(segs)), max(segs), longest, P,
               pieces, piece_span, row_span))


def check_chain_ringprop(dev, k, bw=500):
    import numpy as np
    import torch
    from longqc_tpu_torch.ops.chain import chain_dp_batch, gap_penalty_table
    from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill
    from longqc_tpu_torch.ops import ringprop as rp

    Q, A = 128, 8192
    rng = np.random.RandomState(3)
    axh, axl, aq, nb = (torch.from_numpy(a).to(dev)
                        for a in rand_anchor_rows(rng, Q, A))
    span = torch.full((Q, A), k, dtype=torch.int32, device=dev)
    # the plain engine's one table (row stride 0), then one table per
    # row fitted to distinct mean spans (the HPC engine's)
    tables = {"one table": torch.from_numpy(
        gap_penalty_table(np.float32(k), bw)[None]).to(dev),
        "per-row tables": torch.from_numpy(np.stack([
            gap_penalty_table(np.float32(k + r / 7), bw)
            for r in range(Q)])).to(dev)}
    out = {}
    for tab, pen in tables.items():
        def kern():
            return chain_dp_fill(axh, axl, aq, span, nb, pen, bw=bw)
        fk, pk, vk = kern()
        t = time.time()
        fp, pp, vp, scan = chain_dp_batch(axh, axl, aq, span, nb, pen, bw=bw,
                                          return_scan=True)
        torch.cuda.synchronize()
        pms = (time.time() - t) * 1e3
        err = 0
        for nm, a, b in (("f", fk, fp), ("p", pk, pp), ("v", vk, vp)):
            err = max(err, require_equal("chain %s %s" % (tab, nm), a, b))
        ms = cuda_ms(kern, 3)
        log("B2 chain Q=%d A=%d, %s: %s" % (Q, A, tab,
                                           chain_pieces(axh, nb, kern)))
        row_max = scan.amax(dim=1)
        b_ms, b_by = bound(nbytes(axh, axl, aq, span, nb, pen) + 3 * Q * A * 4,
                           int(scan.long().sum()) * OPS_PER_AGE)
        log("B2 chain Q=%d A=%d, %s: equal; ages scanned per anchor: max "
            "%d, total %d; > 64 ages: %d rows, %d anchors; > 256 ages: %d "
            "rows, %d anchors; kernel %.3f ms, plain %.3f ms, bound %.4f ms "
            "(%s)" % (Q, A, tab, int(row_max.max()), int(scan.long().sum()),
                      int((row_max > 64).sum()), int((scan > 64).sum()),
                      int((row_max > 256).sum()), int((scan > 256).sum()),
                      ms, pms, b_ms, b_by))
        if not (row_max > 256).any():
            raise AssertionError("no B2 row scans past 256 ages")
        prev = out.get("chain", {}).get("max_abs_err", 0)
        out["chain"] = dict(max_abs_err=max(err, prev), ms=ms, plain_ms=pms,
                            bound_ms=b_ms, bound_by=b_by,
                            shape="Q=%d A=%d (%s)" % (Q, A, tab))
    f, p, v = fk, pk, vk
    # parents lie any distance back: no window limit, as the engine;
    # own ranks at chain ends (anchors nobody points at), random order
    g = torch.Generator(device="cpu").manual_seed(9)
    on = torch.arange(A, device=dev)[None, :] < nb[:, None].long()
    child = (p >= 0) & on
    is_par = torch.zeros((Q, A + 1), dtype=torch.bool, device=dev)
    is_par.scatter_(1, torch.where(child, p, A).long(), True)
    ends = on & ~is_par[:, :A]
    ranks = torch.randint(0, 4096, (Q, A), generator=g).to(dev).int()
    own = torch.where(ends, ranks, rp.INF32).int()
    check_ringprop("B2's output", f, v, p, own, A, out, "")

    # Q=128 A=65536 synthetic forests: depth-A paths, chains across
    # chunks, garbage parents, parents past J; with J = A and J = 256
    f, v, p, own = (torch.from_numpy(a).to(dev)
                    for a in ringprop_forests(np.random.RandomState(8), Q,
                                              65536))
    for J, sfx in ((65536, "_A65536"), (256, "_A65536_J256")):
        check_ringprop("synthetic forests", f, v, p, own, J, out, sfx)
    return out


def ringprop_forests(rng, Q, A):
    """(Q, A) int32 f, v, p, own: rows 0 and 1 a path of depth A (p[i] =
    i - 1); then by row mod 3 forests of chains (links mostly under 20
    back, 2 % anywhere back), garbage parents (anywhere in [-1, A), p >=
    i too), and links up to 768 back (past J = 256). own: a rank at the
    peak of each chain end, as the engine's (row 1: one rank, at the
    root), on the garbage rows 20 % of anchors, and on row 0 every
    anchor, the deepest smallest."""
    import numpy as np
    ii = np.arange(A)
    f = rng.randint(1, 200, (Q, A))
    v = f + (rng.rand(Q, A) < 0.8) * rng.randint(1, 40, (Q, A))
    d = 1 + rng.geometric(0.15, (Q, A))
    far = rng.rand(Q, A) < 0.02
    d[far] = rng.randint(1, A, int(far.sum()))
    p = np.where(rng.rand(Q, A) < 0.9, ii - d, -1)
    kind = np.arange(Q) % 3
    p[kind == 1] = rng.randint(-1, A, (int((kind == 1).sum()), A))
    p[kind == 2] = ii - rng.randint(1, 769, (int((kind == 2).sum()), A))
    p[:2] = ii - 1
    v[:2] = f[:2] + 1
    p = np.maximum(p, -1)
    # peaks of chain ends (where the ranks go) by the walk itself
    walk = (v > f) & (p >= 0) & (p < ii)
    peak = np.where(walk, -1, ii)
    rows = np.arange(Q)[:, None]
    for i in range(A):
        w = walk[:, i]
        peak[w, i] = peak[w, p[w, i]]
    ends = np.ones((Q, A), bool)
    qq, jj = np.nonzero(p >= 0)
    ends[qq, p[qq, jj]] = False
    own = np.full((Q, A + 1), 0x7FFFFFFF, np.int64)
    at = np.where(ends & (peak >= 0), peak, A)
    own[rows, at] = rng.randint(0, 1 << 20, (Q, A))
    own = own[:, :A]
    garb = (kind == 1) & (np.arange(Q) >= 2)
    own[garb] = np.where(rng.rand(int(garb.sum()), A) < 0.2,
                         rng.randint(0, 99, (int(garb.sum()), A)), 0x7FFFFFFF)
    own[0] = A - ii
    return [a.astype(np.int32) for a in (f, v, p, own)]


def check_ringprop(what, f, v, p, own, J, out, sfx, plain_cpu=None):
    """B3 and B4 against their plain versions on (Q, A) rows, exact;
    times and bounds into out[name] as ms / plain_ms / bound_ms, each
    key suffixed with `sfx`. plain_cpu: {name: (output, ms)} of the
    plain versions run on the CPU (a side process) in place of a run on
    the card here; their ms go to plain_cpu_ms."""
    import torch
    from longqc_tpu_torch.ops import ringprop as rp

    Q, A = f.shape
    for name in ("peak", "minrank"):
        if name == "peak":
            args, n_arrays = (f, v, p), 4
            kern, plain = rp.peak_pass, rp.peak_pass_plain
        else:
            args, n_arrays = (p, own), 3
            kern, plain = rp.minrank_pass, rp.minrank_pass_plain
        got = kern(*args, J=J)
        if plain_cpu:
            want, pms = plain_cpu[name]
        else:
            t = time.time()
            want = plain(*args, J=J)
            torch.cuda.synchronize()
            pms = (time.time() - t) * 1e3
        err = require_equal("%s %s J=%d" % (name, what, J), got, want)
        ms = cuda_ms(lambda: kern(*args, J=J), 5)
        b_ms, b_by = bound(n_arrays * Q * A * 4, 0)
        log("%s %s Q=%d A=%d J=%d (%s): equal; kernel %.4f ms, plain %.3f "
            "ms%s, bound %.4f ms (%s)" % (
                "B3" if name == "peak" else "B4", name, Q, A, J, what, ms,
                pms, " (CPU)" if plain_cpu else "", b_ms, b_by))
        o = out.setdefault(name, {})
        o["max_abs_err"] = max(err, o.get("max_abs_err", 0))
        o.update({"ms" + sfx: ms, "bound_ms" + sfx: b_ms,
                  ("plain_cpu_ms" if plain_cpu else "plain_ms") + sfx: pms})
        if not sfx:
            o.update(bound_by=b_by, shape="Q=%d A=%d" % (Q, A))


# the wide rungs' shapes (rows past the engine's top anchor rung, stepped
# on fewer lanes: Q x A = 128 x 2^18 at most): B3 and B4 on far forests
# at 16 x 2^21 (B4's pending mask in device memory, past 2^20 anchors)
# and 64 x 2^19, B2 at 64 x 2^19. Their plain versions are loops over
# the anchors (~0.2 ms an anchor on the card, launch-bound): they run on
# CPU tensors in side processes from phase 4 on (WIDE_SIDES), and the
# card's outputs are held against them after phase 15
WIDE_RINGPROP = ((16, 1 << 21), (64, 1 << 19))
WIDE_CHAIN = (64, 1 << 19)
WIDE_CHAIN_ROW = 0      # B2's plain version on this (repeat-dense) row
# side process -> (Q, A, plain versions it runs)
WIDE_SIDES = {"wide-peak-21": WIDE_RINGPROP[0] + (("peak",),),
              "wide-minrank-21": WIDE_RINGPROP[0] + (("minrank",),),
              "wide-19": WIDE_RINGPROP[1] + (("peak", "minrank", "chain"),)}


def wide_plain(workdir, Q, A, names):
    """The plain versions `names` at (Q, A) on CPU tensors, each with
    its inputs into workdir/wide_<name>_QxA.npz (side process): B3 /
    B4 on far forests with J = A, B2 on row WIDE_CHAIN_ROW of
    rand_anchor_rows."""
    import numpy as np
    import torch
    from longqc_tpu_torch.ops import ringprop as rp
    from longqc_tpu_torch.ops.chain import chain_dp_batch, gap_penalty_table
    torch.set_num_threads(1)
    tag = "%dx%d" % (Q, A)
    if "peak" in names or "minrank" in names:
        f, v, p, own = ringprop_forests(np.random.RandomState(Q), Q, A)
        ts = {n: torch.from_numpy(a) for n, a in zip("fvp", (f, v, p))}
        ts["own"] = torch.from_numpy(own)
    for name in names:
        t = time.time()
        if name == "peak":
            ins = ("f", "v", "p")
            out = rp.peak_pass_plain(*(ts[n] for n in ins), J=A)
        elif name == "minrank":
            ins = ("p", "own")
            out = rp.minrank_pass_plain(*(ts[n] for n in ins), J=A)
        else:
            axh, axl, aq, nb = rand_anchor_rows(np.random.RandomState(5), Q,
                                                A)
            ts = dict(axh=axh, axl=axl, aq=aq, nb=nb)
            ins = tuple(ts)
            r = slice(WIDE_CHAIN_ROW, WIDE_CHAIN_ROW + 1)
            out = chain_dp_batch(
                *(torch.from_numpy(a[r]) for a in (axh, axl, aq)),
                torch.full((1, A), 12, dtype=torch.int32),
                torch.from_numpy(nb[r]), torch.from_numpy(
                    gap_penalty_table(np.float32(12), 500)[None]),
                bw=500, return_scan=True)
        ms = (time.time() - t) * 1e3
        outs = {name: out} if name != "chain" else dict(zip("fpv", out[:3]),
                                                        scan=out[3])
        np.savez(os.path.join(workdir, "wide_%s_%s.npz" % (name, tag)),
                 ms=ms, **{n: np.asarray(ts[n]) for n in ins},
                 **{n: o.numpy() for n, o in outs.items()})


def check_wide_rungs(dev, workdir, procs, out):
    """Phase 3 at the wide rungs' shapes, after phase 15: B3 / B4 at
    WIDE_RINGPROP and B2 at WIDE_CHAIN on the card against the side
    processes' (procs) plain versions, exact (B2 on row
    WIDE_CHAIN_ROW); the kernels' times and bounds into out with the
    suffix _QxA."""
    import numpy as np
    import torch
    from longqc_tpu_torch.ops.chain import gap_penalty_table
    from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill

    def load(name, Q, A):
        return np.load(os.path.join(workdir, "wide_%s_%dx%d.npz"
                                    % (name, Q, A)))
    t = time.time()
    for proc in procs:
        side_wait(proc, "the wide rungs' plain versions on the CPU")
    log("phase 3, the wide rungs: plain versions on the CPU, waited %.1f s"
        % (time.time() - t))
    for Q, A in WIDE_RINGPROP:
        pk, mr = load("peak", Q, A), load("minrank", Q, A)
        f, v, p = (torch.from_numpy(pk[n]).to(dev) for n in "fvp")
        own = torch.from_numpy(mr["own"]).to(dev)
        plain = {n: (torch.from_numpy(d[n]).to(dev), float(d["ms"]))
                 for n, d in (("peak", pk), ("minrank", mr))}
        check_ringprop("far forests", f, v, p, own, A, out,
                       "_%dx%d" % (Q, A), plain_cpu=plain)
        del f, v, p, own, plain
    Q, A = WIDE_CHAIN
    d = load("chain", Q, A)
    axh, axl, aq, nb = (torch.from_numpy(d[n]).to(dev)
                        for n in ("axh", "axl", "aq", "nb"))
    span = torch.full((Q, A), 12, dtype=torch.int32, device=dev)
    pen = torch.from_numpy(gap_penalty_table(np.float32(12), 500)[None]).to(
        dev)

    def kern():
        return chain_dp_fill(axh, axl, aq, span, nb, pen, bw=500)
    r = WIDE_CHAIN_ROW
    err = 0
    for nm, got in zip("fpv", kern()):
        err = max(err, require_equal("chain %dx%d row %d %s" % (Q, A, r, nm),
                                     got[r:r + 1],
                                     torch.from_numpy(d[nm]).to(dev)))
    ms = cuda_ms(kern, 3)
    log("B2 chain Q=%d A=%d: %s" % (Q, A, chain_pieces(axh, nb, kern)))
    b_ms, _ = bound(nbytes(axh, axl, aq, span, nb, pen) + 3 * Q * A * 4, 0)
    scan = d["scan"]
    log("B2 chain Q=%d A=%d: row %d (%d anchors, ages scanned per anchor: "
        "max %d, total %d) equal its plain version (CPU, %.1f ms); kernel "
        "%.3f ms, bound %.4f ms (bytes; the other rows' ages not counted)"
        % (Q, A, r, int(d["nb"][r]), int(scan.max()), int(scan.sum()),
           float(d["ms"]), ms, b_ms))
    o = out["chain"]
    o["max_abs_err"] = max(err, o["max_abs_err"])
    sfx = "_%dx%d" % (Q, A)
    o.update({"ms" + sfx: ms, "bound_ms" + sfx: b_ms,
              "plain_cpu_ms" + sfx + "_row%d" % r: float(d["ms"])})


def log_rungs(phase, rungs, path_bound):
    for name in ("peak", "minrank"):
        log("%s %s launches by anchor rung A: %s; summed bound %.4f ms"
            % (phase, name, json.dumps(rungs.get(name, {})),
               path_bound.get(name, 0.0)))


def ringprop_rungs(launches_by_shape):
    """{name: {A: launches}} of B3 / B4 and the path's summed bound (ms)
    from _ext.LAUNCH_SHAPES."""
    rungs, bnd = {}, {}
    for (name, Q, A), n in sorted(launches_by_shape.items()):
        rungs.setdefault(name, {})[A] = n
        bnd[name] = bnd.get(name, 0.0) + n * bound(
            (4 if name == "peak" else 3) * Q * A * 4, 0)[0]
    return rungs, bnd


# ---------------------------------------------------------------------------
# phases 4 and 5


def small_end_to_end(dev, k=12, w=5, err=0.12):
    """150 reads of a 30 kbp genome, 40 of them queries: the engine's
    rows on the card against the host spec. Returns the launch counts
    of the engine's run (the B1 variant of (k, w) must be among them)."""
    import numpy as np
    import torch
    from util_synth import make_genome, sample_reads
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine
    from longqc_tpu_torch.ops import _ext
    from longqc_tpu_torch.ops.sketch_cuda import kernel_name

    rng = np.random.RandomState(11)
    genome = make_genome(rng, 30000)
    reads = sample_reads(rng, genome, 150, min_len=700, max_len=2200,
                         err=err, junk_frac=0.1)
    queries = reads[:40]
    cfg = OverlapConfig(index=IndexOpt(k=k, w=w),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rows_host = oh.overlap_run(list(reads), queries, cfg, device=dev)
    torch.cuda.synchronize()
    _ext.reset_launches()
    eng = DeviceOverlapEngine(cfg, queries, device=dev)
    rows_dev = eng.run(list(reads))
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    bad = [i for i, (a, b) in enumerate(zip(rows_host, rows_dev)) if a != b]
    if bad or len(rows_dev) != len(rows_host):
        raise AssertionError("small end to end k=%d w=%d: %d rows differ "
                             "from the host spec" % (k, w, len(bad)))
    covered = sum(1 for r in rows_dev if r.split("\t")[3] != "0")
    log("small end to end k=%d w=%d err=%.2f: %d rows equal the host spec "
        "(%d with reliable regions, %d step calls, %d host-fixed); "
        "launches %s" % (k, w, err, len(rows_dev), covered,
                         eng.n_device_calls, eng.n_host_fallback, launches))
    b1 = kernel_name(k, w)
    if set(n for n in launches if n.startswith("sketch")) != {b1}:
        raise AssertionError("small end to end k=%d w=%d must sketch with "
                             "%s only: %s" % (k, w, b1, launches))
    if not covered or eng.n_host_fallback:
        raise AssertionError("small end to end k=%d w=%d: %d covered rows, "
                             "%d host-fixed" % (k, w, covered,
                                                eng.n_host_fallback))
    return launches


def write_fastq(path, reads):
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write("@%s\n%s\n+\n%s\n" % (name, seq, qual))


def check_reader(stats, phase):
    """The port's own native reader parsed the inputs; print its build
    and parse seconds (fail otherwise)."""
    rd = stats["reader"]
    log("%s reader %s; parse_s %s; build %s (%.2f s); error %s"
        % (phase, rd["name"], json.dumps({k: round(v, 3) for k, v in
                                          rd["parse_s"].items()}),
           rd["cmd"], rd["build_s"], rd["error"]))
    if rd["name"] != "native":
        raise AssertionError("%s: the inputs were not parsed by the native "
                             "reader (%s)" % (phase, rd["error"]))
    return rd


def kernel_device_ms(argv, kernels):
    """Total device milliseconds per kernel over one more run of `argv`,
    from torch.profiler's key_averages (fails unless it shows device
    time for exactly `kernels`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from longqc_tpu_torch import cli

    with redirect_stdout(io.StringIO()):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cli.main(argv)
            torch.cuda.synchronize()
    tot = {}
    for ev in prof.key_averages():
        name = b1_variant(ev.key) or next(
            (n for p, n in SYMBOLS.items() if p in ev.key), None)
        if name:
            tot[name] = tot.get(name, 0.0) + ev.device_time_total / 1e3
    if set(tot) != set(kernels) or not all(tot.values()):
        raise AssertionError("the profiler must show device time for %s "
                             "and no other kernel of the port: %s"
                             % (kernels, tot))
    return tot


def realistic_mmcov(dev, workdir, run):
    """One all-vs-sample run (ONT_RUN or HIFI_RUN) through cli.main.
    Returns (launches, device ms per kernel, B3 / B4 rungs and bound, the
    target reads, the run's peak device memory)."""
    import numpy as np
    import torch
    from util_synth import make_genome_fast, sample_reads_fast
    from longqc_tpu_torch import cli
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig, parse_num
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.ops import _ext

    phase, k, w = run["phase"], run["k"], run["w"]
    t = time.time()
    rng = np.random.RandomState(run["seed"])
    genome = make_genome_fast(rng, 10_000_000)
    targets = sample_reads_fast(rng, genome, run["n_targets"],
                                min_len=run["min_len"],
                                max_len=run["max_len"], err=run["err"],
                                junk_frac=run["junk"])
    n_q = N_QUERIES
    queries = targets[:n_q]
    tname = run["prefix"] + "targets.fq"
    qname = run["prefix"] + "queries.fq"
    tpath = os.path.join(workdir, tname)
    qpath = os.path.join(workdir, qname)
    stats_path = os.path.join(workdir, run["prefix"] + "stats.json")
    write_fastq(tpath, targets)
    write_fastq(qpath, queries)
    tbp = sum(len(r[1]) for r in targets)
    log("%s data: %d targets of %d-%d bp (%d bp, %.2fx of 10 Mbp), err "
        "%.2f, junk %.2f, %d queries, made in %.1f s"
        % (phase, run["n_targets"], run["min_len"], run["max_len"], tbp,
           tbp / 1e7, run["err"], run["junk"], n_q, time.time() - t))

    argv = ["mmcov", "-k", str(k), "-w", str(w), "-p", str(run["p"]), "-q",
            str(run["q"]), "-l", "0", "--device", str(dev), "--stats",
            stats_path, tpath, qpath]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    buf = io.StringIO()
    t = time.time()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(_ext.LAUNCHES)
    rungs, path_bound = ringprop_rungs(_ext.LAUNCH_SHAPES)
    peak_mem = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError("mmcov returned %d" % rc)
    with open(stats_path) as f:
        stats = json.load(f)
    rows = buf.getvalue().rstrip("\n").split("\n")
    log("mmcov %s" % " ".join(argv[:-2] + [tname, qname]))
    log("%s mmcov wall %.2f s; phase_s %s" % (
        phase, wall, json.dumps({key: round(v, 3)
                                 for key, v in stats["phase_s"].items()})))
    log("step calls %d, retry steps %d, F_KERNEL rows %d, flag counts "
        "%s, host-fixed rows %d, host-only parts %d" % (
            stats["device_calls"], stats["retry_steps"],
            stats["flag_counts"].get("1", 0), stats["flag_counts"],
            stats["host_fixed_rows"], stats["host_only_parts"]))
    log("kernel launches %s; max_memory_allocated %d bytes (%.2f GB)"
        % (launches, peak_mem, peak_mem / 1e9))
    log_rungs(phase, rungs, path_bound)
    check_reader(stats, phase)
    if len(rows) != n_q:
        raise AssertionError("mmcov printed %d rows for %d queries"
                             % (len(rows), n_q))
    for name in run["kernels"]:
        if not launches.get(name):
            raise AssertionError("kernel %s was not launched by the "
                                 "mmcov run" % name)
    if set(launches) != set(run["kernels"]):
        raise AssertionError("%s must launch %s and no other kernel: %s"
                             % (phase, run["kernels"], launches))
    if stats["host_only_parts"]:
        raise AssertionError("%s: %d parts fell to the host path"
                             % (phase, stats["host_only_parts"]))
    if launches["chain"] != stats["device_calls"]:
        raise AssertionError("%d step calls but %d B2 launches"
                             % (stats["device_calls"], launches["chain"]))
    if stats["host_fixed_rows"] > 0.05 * n_q:
        raise AssertionError("host-fixed rows %d exceed 5%% of %d queries"
                             % (stats["host_fixed_rows"], n_q))
    covered = sum(1 for r in rows if r.split("\t")[3] != "0")
    log("rows with reliable regions: %d / %d" % (covered, n_q))
    cfg = OverlapConfig(
        index=IndexOpt(k=k, w=w, batch_size=parse_num("4G")),
        map=MapOpt(min_score_med=run["p"], min_score_good=run["q"],
                   min_chain_score=40),
        flt=FltOpt(min_ovlp=0, min_coverage=3))
    if run.get("range_rerun"):
        range_rerun(dev, cfg, targets, queries, rows, stats)

    # 32 random queries against the port's host spec over the same
    # targets (the host spec's tensor sketch runs on the card too)
    pick = sorted(random.Random(7).sample(range(n_q), 32))
    t = time.time()
    want = oh.overlap_run(iter(targets), [queries[i] for i in pick], cfg,
                          device=dev)
    bad = [i for i, r in zip(pick, want) if rows[i] != r]
    if bad:
        raise AssertionError("%d of 32 sampled rows differ from the host "
                             "spec (first: query %d)" % (len(bad), bad[0]))
    log("32 sampled rows equal the host spec (host spec %.1f s)"
        % (time.time() - t))

    t = time.time()
    dev_ms = kernel_device_ms(argv, run["kernels"])
    log("%s device time per kernel (torch.profiler, one more run, "
        "%.1f s): %s" % (phase, time.time() - t, json.dumps(
            {key: round(v, 3) for key, v in sorted(dev_ms.items())})))
    return launches, dev_ms, (rungs, path_bound), targets, peak_mem


def range_rerun(dev, cfg, targets, queries, rows, stats,
                n_idx_sizes=(1 << 21,), range_max=1 << 23):
    """The engine once more on phase 5's data with the width ladder
    capped below the part (and ranges of 2^23 entries), so that its
    index takes the hash-range build: every row must equal the flat
    run's."""
    import torch
    from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine

    eng = DeviceOverlapEngine(cfg, queries, device=dev)
    eng.n_idx_sizes = n_idx_sizes
    eng.range_max = range_max
    t = time.time()
    rows2 = eng.run(iter(targets))
    torch.cuda.synchronize()
    wall = time.time() - t
    st = eng.stats()
    bad = sum(1 for a, b in zip(rows, rows2) if a != b)
    log("phase 5, hash-range build: wall %.2f s; index %.3f s (flat run "
        "%.3f s), split %s (flat run %s); ranges per part %s; host-only "
        "parts %d, hash-range parts %d, host-fixed rows %d; %d of %d rows "
        "differ from the flat run" % (
            wall, st["phase_s"]["index"], stats["phase_s"]["index"],
            json.dumps({key: round(v, 3) for key, v in st["index_s"].items()}),
            json.dumps({key: round(v, 3)
                        for key, v in stats["index_s"].items()}),
            st["part_ranges"], st["host_only_parts"], st["hash_range_parts"],
            st["host_fixed_rows"], bad, len(rows)))
    if bad or len(rows2) != len(rows):
        raise AssertionError("the hash-range build changed %d rows" % bad)
    if st["host_only_parts"] or st["hash_range_parts"] != 1 or \
            min(st["part_ranges"]) < 4:
        raise AssertionError("phase 5's rerun must build its one part by "
                             "hash range in at least 4 ranges: %s" % st)


# ---------------------------------------------------------------------------
# phase 6: B5 banded extension


def extension_pairs(rng, genome, n, lo, hi, err, unrelated):
    """(B, L) int32 query / target codes and (B,) lengths of pairs that
    start at one genome point (an extension from a seed), each side of
    lo..hi bp and mutated on its own (substitution / deletion /
    insertion at err * 0.5 / 0.25 / 0.25, as util_synth's reads); a
    share `unrelated` of the targets is random sequence."""
    import numpy as np
    code = np.full(256, 4, np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    g = code[np.frombuffer(genome.encode("ascii"), np.uint8)]

    def mutate(seq):
        r = rng.random_sample(len(seq))
        seq = seq.copy()
        sub = r < err * 0.5
        seq[sub] = rng.randint(0, 4, int(sub.sum()))
        rep = np.ones(len(seq), np.int64)
        rep[(r >= err * 0.5) & (r < err * 0.75)] = 0
        rep[(r >= err * 0.75) & (r < err)] = 2
        return np.repeat(seq, rep)[:hi]

    qs, ts = [], []
    for _ in range(n):
        lq, lt = rng.randint(lo, hi + 1, 2)
        s = rng.randint(0, len(g) - max(lq, lt))
        qs.append(mutate(g[s:s + lq]))
        if rng.random_sample() < unrelated:
            ts.append(rng.randint(0, 4, lt).astype(np.uint8))
        else:
            ts.append(mutate(g[s:s + lt]))

    def pad(seqs):
        a = np.full((n, max(len(x) for x in seqs)), 4, np.int32)
        for i, x in enumerate(seqs):
            a[i, :len(x)] = x
        return a, np.array([len(x) for x in seqs], np.int32)

    return pad(qs) + pad(ts)


# (W, pairs) of phase 6: the one-warp body at W = 63 (two columns a
# lane) and 31 (one), the wide body at W = 64 (the JAX default), 255 and
# 5,000 (past every pair: clamped)
EXT_RUNS = ((63, 8192), (31, 8192), (64, 8192), (255, 8192), (5000, 1024))


def check_extend(dev, zdrop=400):
    """B5 through its entry point (ops/extend.extz_batch) on CUDA
    tensors, extz and extd at each (W, pairs) of EXT_RUNS; then each
    against the plain version on the same tensors, and short pairs
    against the host reference. Returns (results by LAUNCHES name, the
    first W of each body unsuffixed and the others suffixed _W<W>;
    launch counts of the entry-point calls)."""
    import numpy as np
    import torch
    from util_synth import make_genome_fast
    from longqc_tpu_torch.ops import _ext
    from longqc_tpu_torch.ops import extend as ext
    from longqc_tpu_torch.ops.extend_cuda import NARROW_W

    modes = {"extz": {}, "extd": {"gapo2": 24, "gape2": 1}}
    B = max(b for _w, b in EXT_RUNS)
    rng = np.random.RandomState(31)
    t = time.time()
    genome = make_genome_fast(rng, 10_000_000)
    pairs = [torch.from_numpy(a).to(dev) for a in extension_pairs(
        rng, genome, B, 500, 4000, 0.12, 0.2)]
    q, _ql, tg, _tl = pairs
    log("extension data: %d pairs, codes %s + %s int32 (%d bytes), made "
        "in %.1f s" % (B, tuple(q.shape), tuple(tg.shape),
                       4 * (q.numel() + tg.numel()), time.time() - t))

    def args(b):
        return [a[:b] for a in pairs]

    def run(m, W, b):
        return ext.extz_batch(*args(b), W=W, zdrop=zdrop, **modes[m])

    torch.cuda.synchronize()
    _ext.reset_launches()
    kern = {(m, W): run(m, W, b) for W, b in EXT_RUNS for m in modes}
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    out = {}
    for W, b in EXT_RUNS:
        for m, gap in modes.items():
            name = m if W <= NARROW_W else m + "_wide"
            if not launches.get(name):
                raise AssertionError("kernel %s was not launched by "
                                     "extz_batch" % name)
            got = kern[(m, W)]
            qb, qlb, tgb, tlb = args(b)
            t = time.time()
            plain = ext.extz_batch_plain(qb, qlb, tgb, tlb, W=W, zdrop=zdrop,
                                         **gap)
            torch.cuda.synchronize()
            pms = (time.time() - t) * 1e3
            err = 0
            for key in ext.KEYS:
                err = max(err, require_equal("%s W=%d %s" % (m, W, key),
                                             got[key], plain[key]))
            n_drop = int(got["zdropped"].sum())
            # Z-drop must fire (on the unrelated pairs) but not on every
            # pair; past every pair (W = 5,000) it need not fire
            if n_drop >= b or (n_drop == 0 and W <= 255):
                raise AssertionError("%s W=%d: %d of %d pairs Z-dropped"
                                     % (m, W, n_drop, b))
            ms = cuda_ms(lambda: run(m, W, b), 3)
            mean_max = float(got["max"].double().mean())
            # band cells the data needs: every target column up to the
            # end (or, Z-dropped, up to the best cell) times the band
            # rows that hold query indices
            cols = torch.where(got["zdropped"].bool(),
                               got["max_t"].long() + 1, tlb.long())
            rows_b = torch.clamp(qlb.long(), max=2 * W + 1)
            cells = int((cols.clamp(min=0) * rows_b).sum())
            b_ms, b_by = bound(nbytes(qb, qlb, tgb, tlb)
                               + sum(nbytes(v) for v in got.values()),
                               cells * OPS_PER_CELL[m])
            log("B5 %s B=%d W=%d zdrop=%d: equal in all 8 outputs (%d "
                "Z-dropped, mean max %.1f); kernel %.3f ms, plain %.3f ms, "
                "bound %.4f ms (%s, %d band cells)"
                % (name, b, W, zdrop, n_drop, mean_max, ms, pms, b_ms, b_by,
                   cells))
            if name not in out:
                out[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 shape="B=%d L<=%d W=%d"
                                 % (b, qb.shape[1], W))
            else:
                sfx = "_W%d" % W
                o = out[name]
                o["max_abs_err"] = max(o["max_abs_err"], err)
                o.update({"ms" + sfx: ms, "plain_ms" + sfx: pms,
                          "bound_ms" + sfx: b_ms})

    # short pairs against the full-DP host reference (numpy loops)
    sq, sql, st, stl = extension_pairs(rng, genome, 16, 150, 400, 0.12, 0.2)
    t = time.time()
    W = EXT_RUNS[0][0]
    for m, gap in modes.items():
        res = ext.extz_batch(*(torch.from_numpy(a).to(dev)
                               for a in (sq, sql, st, stl)),
                             W=W, zdrop=zdrop, **gap)
        res = {key: v.cpu().numpy() for key, v in res.items()}
        for b in range(len(sql)):
            want = ext.extz_host(sq[b, :sql[b]], st[b, :stl[b]], w=W,
                                 zdrop=zdrop, **gap)
            keys = ["max", "max_q", "max_t", "mte", "mte_q"]
            if want["mqe"] > ext.NEG_INF:
                keys += ["mqe", "mqe_t"]
            for key in keys:
                if int(res[key][b]) != want[key]:
                    raise AssertionError("%s pair %d: %s %d, host %d" % (
                        m, b, key, int(res[key][b]), want[key]))
    log("B5 extz / extd: 16 short pairs equal the host reference (%.1f s)"
        % (time.time() - t))
    return out, launches


def check_adapter_align(dev):
    """Phase 6b: hw_align_batch on CUDA tensors at each (m, windows) of
    ADAPTER_RUNS, against its plain twin on the same windows, both timed.
    Returns {"adapter_align": results}, the first run's numbers unsuffixed
    and the second's suffixed _m<m>."""
    import numpy as np
    import torch
    from torch_util import adapter_codes, adapter_windows
    from longqc_tpu_torch.ops.adapter import hw_align_batch

    rng = np.random.RandomState(619)
    out = {"max_abs_err": 0}
    for run, (m, C) in enumerate(ADAPTER_RUNS):
        adp = adapter_codes(m)
        wins, lens = adapter_windows(rng, adp, C, 150)
        host = [torch.from_numpy(a) for a in (adp, wins, lens)]
        ins = [t.to(dev) for t in host]
        got = hw_align_batch(*ins)
        t = time.time()
        plain = hw_align_batch(*host)
        plain_ms = (time.time() - t) * 1e3
        require_equal("adapter_align m=%d" % m, got.cpu(), plain)
        ms = cuda_ms(lambda: hw_align_batch(*ins), 20)
        b_ms, by = bound(nbytes(*ins) + 8 * 4 * C,
                         OPS_PER_ALIGN_CELL * C * m * 150)
        sfx = "" if run == 0 else "_m%d" % m
        out.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "bound_ms" + sfx: b_ms})
        if run == 0:
            out.update({"bound_by": by, "shape": "%d windows x 150, m=%d"
                        % (C, m)})
        log("adapter_align m=%d, %d windows of 150: %.4f ms (bound %.2f us, "
            "%s), plain twin %.0f ms on the same windows; equal" % (
                m, C, ms, b_ms * 1e3, by, plain_ms))
    return {"adapter_align": out}


# ---------------------------------------------------------------------------
# phase 7: the HPC spike-in-control filter run

N_CONTROL = 100         # control-derived queries of the filter run (2%)
CONTROL = "longqc_tpu_torch/refs/Sequel_control_reference.fasta"


def hpc_filter_run(dev, workdir):
    import numpy as np
    import torch
    from util_synth import make_genome_fast, sample_reads_fast
    from longqc_tpu_torch import cli
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig, parse_num
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.io.fastx import iter_fastx
    from longqc_tpu_torch.ops import _ext

    t = time.time()
    ctl_path = os.path.join(HERE, CONTROL)
    control = [[n, s, q or ""] for n, s, q in iter_fastx(ctl_path)]
    if len(control) != 1:
        raise AssertionError("%s holds %d records" % (CONTROL, len(control)))
    rng = np.random.RandomState(4242)
    genome = make_genome_fast(rng, 10_000_000)
    queries = sample_reads_fast(rng, genome, N_QUERIES - N_CONTROL,
                                min_len=1000, max_len=8000, err=0.12,
                                junk_frac=0.1)
    # control reads run around the circular control: unrolled copies
    ctl = sample_reads_fast(rng, control[0][1] * 3, N_CONTROL,
                            min_len=1000, max_len=8000, err=0.12)
    ctl_at = sorted(random.Random(11).sample(range(N_QUERIES), N_CONTROL))
    for i, (at, r) in enumerate(zip(ctl_at, ctl)):
        queries.insert(at, ["control%03d" % i] + r[1:])
    qpath = os.path.join(workdir, "hpc_queries.fq")
    write_fastq(qpath, queries)
    log("HPC filter data: control %d bp, %d queries (%d bp) of which %d "
        "from the control, made in %.1f s" % (
            len(control[0][1]), len(queries),
            sum(len(r[1]) for r in queries), N_CONTROL, time.time() - t))

    stats_path = os.path.join(workdir, "hpc_stats.json")
    argv = ["mmcov", "-H", "-k", "15", "-w", "10", "-c", "1", "-l", "0",
            "--filter", "--device", str(dev), "--stats", stats_path,
            ctl_path, qpath]
    torch.cuda.synchronize()
    _ext.reset_launches()
    buf = io.StringIO()
    t = time.time()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(_ext.LAUNCHES)
    rungs, path_bound = ringprop_rungs(_ext.LAUNCH_SHAPES)
    if rc != 0:
        raise AssertionError("mmcov -H returned %d" % rc)
    with open(stats_path) as f:
        stats = json.load(f)
    rows = buf.getvalue().rstrip("\n").split("\n")
    log("mmcov %s" % " ".join(argv[:-2] + [CONTROL, "hpc_queries.fq"]))
    log("mmcov -H wall %.2f s; phase_s %s" % (
        wall, json.dumps({k: round(v, 3)
                          for k, v in stats["phase_s"].items()})))
    log("step calls %d, retry steps %d, F_KERNEL rows %d, flag counts "
        "%s, host-fixed rows %d, host-only parts %d; kernel launches %s" % (
            stats["device_calls"], stats["retry_steps"],
            stats["flag_counts"].get("1", 0), stats["flag_counts"],
            stats["host_fixed_rows"], stats["host_only_parts"], launches))
    log_rungs("phase 7", rungs, path_bound)
    check_reader(stats, "phase 7")
    if len(rows) != len(queries):
        raise AssertionError("mmcov -H printed %d rows for %d queries"
                             % (len(rows), len(queries)))
    for name in HPC_KERNELS:
        if not launches.get(name):
            raise AssertionError("kernel %s was not launched by the "
                                 "HPC filter run" % name)
    if stats["host_fixed_rows"] > 0.05 * len(queries):
        raise AssertionError("host-fixed rows %d exceed 5%% of %d queries"
                             % (stats["host_fixed_rows"], len(queries)))
    marked = [i for i, r in enumerate(rows) if r.split("\t")[3] != "0"]
    n_ctl = len(set(marked) & set(ctl_at))
    log("the filter marks %d queries: %d of the %d control-derived, %d "
        "others" % (len(marked), n_ctl, N_CONTROL, len(marked) - n_ctl))
    if n_ctl != N_CONTROL or len(marked) != n_ctl:
        raise AssertionError("the filter must mark the %d control-derived "
                             "queries and no other" % N_CONTROL)

    # every control-derived query and 32 random others against the
    # port's HPC host spec
    others = sorted(set(range(len(queries))) - set(ctl_at))
    pick = sorted(ctl_at + random.Random(7).sample(others, 32))
    cfg = OverlapConfig(
        index=IndexOpt(k=15, w=10, is_hpc=True, batch_size=parse_num("4G")),
        map=MapOpt(min_score_med=80, min_score_good=160,
                   min_chain_score=40),
        flt=FltOpt(min_ovlp=0, min_coverage=1), filter_mode=True)
    t = time.time()
    want = oh.overlap_run(iter(control), [queries[i] for i in pick], cfg,
                          device=dev)
    bad = [i for i, r in zip(pick, want) if rows[i] != r]
    if bad:
        raise AssertionError("%d of %d sampled HPC rows differ from the "
                             "host spec (first: query %d)"
                             % (len(bad), len(pick), bad[0]))
    log("%d sampled HPC rows (%d control-derived) equal the host spec "
        "(host spec %.1f s)" % (len(pick), N_CONTROL, time.time() - t))
    return launches, (rungs, path_bound), queries


# ---------------------------------------------------------------------------
# phase 9: a part of the reference's size (-I 4G)


def write_fasta(path, reads):
    with open(path, "w") as f:
        for r in reads:
            f.write(">%s\n%s\n" % (r[0], r[1]))


class ChunkSample:
    """on_chunk hook of build_device_index: sums the tiles' emission
    counts and keeps every chunk entry whose hash is among `hashes`
    (sorted, on the card), apart from the merge code."""

    def __init__(self, hashes):
        self.hashes = hashes
        self.n_exp = []
        self.parts = []

    def __call__(self, chunk, n):
        self.n_exp.append(n)
        self.parts.append(entries_of(chunk, self.hashes))

    def triples(self):
        import torch
        return sorted_triples([torch.cat(a) for a in zip(*self.parts)])


def entries_of(arrays, hashes):
    """(h, rid, pos) of the entries of a sorted (ih, irid, ips) whose
    hash is one of `hashes`."""
    import torch
    ih = arrays[0]
    lo = torch.searchsorted(ih, hashes)
    cnt = torch.searchsorted(ih, hashes, right=True) - lo
    start = torch.repeat_interleave(lo, cnt)
    base = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    at = start + torch.arange(int(cnt.sum()), device=ih.device) - base
    return [a[at] for a in arrays]


def sorted_triples(arrays):
    import numpy as np
    h, r, p = (a.cpu().numpy().astype(np.int64) for a in arrays)
    order = np.lexsort((p, r, h))
    return h[order], r[order], p[order]


def big_part_data(workdir):
    """Phase 9's part (BIG_RUN) written to workdir: big_targets.fa and
    big_queries.fq (its first N_QUERIES reads); the seconds taken in
    big_data.json. Run in a side process from the start of the script
    (`--side big-data`), beside the card's phases 2-8."""
    import numpy as np
    from util_synth import make_genome_fast, sample_reads_fast
    run = BIG_RUN
    t = time.time()
    rng = np.random.RandomState(run["seed"])
    genome = make_genome_fast(rng, run["genome"])
    targets = sample_reads_fast(rng, genome, run["n_targets"],
                                min_len=run["min_len"],
                                max_len=run["max_len"], err=run["err"],
                                junk_frac=run["junk"])
    del genome
    write_fasta(os.path.join(workdir, "big_targets.fa"), targets)
    write_fastq(os.path.join(workdir, "big_queries.fq"),
                targets[:N_QUERIES])
    with open(os.path.join(workdir, "big_data.json"), "w") as f:
        json.dump({"seconds": time.time() - t}, f)


def big_part_run(dev, workdir, data_proc):
    """Phase 9: mmcov through cli.main on a >= 1 Gbp part (made by the
    side process data_proc), then one more build_device_index over the
    same part, checked apart from the merge code. Returns the mmcov
    run's launch counts."""
    import numpy as np
    import torch
    from longqc_tpu_torch import cli, tracing
    from longqc_tpu_torch.engine import device_index as di
    from longqc_tpu_torch.io.fastx import iter_fastx
    from longqc_tpu_torch.ops import _ext

    run = BIG_RUN
    phase, k, w = run["phase"], run["k"], run["w"]
    t = time.time()
    side_wait(data_proc, "%s's data" % phase)
    tpath = os.path.join(workdir, "big_targets.fa")
    qpath = os.path.join(workdir, "big_queries.fq")
    stats_path = os.path.join(workdir, "big_stats.json")
    with open(os.path.join(workdir, "big_data.json")) as f:
        made_s = json.load(f)["seconds"]
    waited = time.time() - t
    targets = [[n, sq, ""] for n, sq, _q in iter_fastx(tpath)]
    tbp = sum(len(r[1]) for r in targets)
    log("%s data: %d targets of %d-%d bp (%d bp, %.2fx of %d bp), err "
        "%.2f, junk %.2f, %d queries, made in %.1f s by a side process "
        "beside phases 2-8 (waited %.1f s; read back in %.1f s)"
        % (phase, len(targets), run["min_len"], run["max_len"], tbp,
           tbp / run["genome"], run["genome"], run["err"], run["junk"],
           N_QUERIES, made_s, waited, time.time() - t - waited))
    if len(targets) != run["n_targets"]:
        raise AssertionError("%s: %d targets read back, %d written"
                             % (phase, len(targets), run["n_targets"]))
    if tbp < run["min_bp"]:
        raise AssertionError("%s: the part holds %d bp, under %d"
                             % (phase, tbp, run["min_bp"]))

    argv = ["mmcov", "-k", str(k), "-w", str(w), "-p", str(run["p"]), "-q",
            str(run["q"]), "-l", "0", "--device", str(dev), "--stats",
            stats_path, tpath, qpath]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    buf = io.StringIO()
    t = time.time()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(_ext.LAUNCHES)
    rungs, path_bound = ringprop_rungs(_ext.LAUNCH_SHAPES)
    peak_mem = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError("mmcov returned %d" % rc)
    with open(stats_path) as f:
        stats = json.load(f)
    rows = buf.getvalue().rstrip("\n").split("\n")
    log("mmcov %s" % " ".join(argv[:-2] + ["big_targets.fa",
                                           "big_queries.fq"]))
    log("%s mmcov wall %.2f s; phase_s %s; index_s %s" % (
        phase, wall, json.dumps({key: round(v, 3)
                                 for key, v in stats["phase_s"].items()}),
        json.dumps({key: round(v, 3) for key, v in stats["index_s"].items()})))
    log("step calls %d, retry steps %d, flag counts %s, host-fixed rows %d, "
        "host-only parts %d, hash-range parts %d (ranges %s)" % (
            stats["device_calls"], stats["retry_steps"], stats["flag_counts"],
            stats["host_fixed_rows"], stats["host_only_parts"],
            stats["hash_range_parts"], stats["part_ranges"]))
    log("kernel launches %s; max_memory_allocated %d bytes (%.2f GB)"
        % (launches, peak_mem, peak_mem / 1e9))
    log_rungs(phase, rungs, path_bound)
    check_reader(stats, phase)
    if len(rows) != N_QUERIES:
        raise AssertionError("mmcov printed %d rows for %d queries"
                             % (len(rows), N_QUERIES))
    if set(launches) != set(run["kernels"]):
        raise AssertionError("%s must launch %s and no other kernel: %s"
                             % (phase, run["kernels"], launches))
    if stats["host_only_parts"] or stats["hash_range_parts"] != 1:
        raise AssertionError("%s: the part must be built by hash range on "
                             "the card" % phase)
    if launches["chain"] != stats["device_calls"]:
        raise AssertionError("%d step calls but %d B2 launches"
                             % (stats["device_calls"], launches["chain"]))
    if stats["host_fixed_rows"] > 0.05 * N_QUERIES:
        raise AssertionError("host-fixed rows %d exceed 5%% of %d queries"
                             % (stats["host_fixed_rows"], N_QUERIES))
    covered = sum(1 for r in rows if r.split("\t")[3] != "0")
    log("rows with reliable regions: %d / %d" % (covered, N_QUERIES))
    del buf, rows

    # the index once more, checked apart from the merge code
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(9)
    hashes = torch.unique(torch.randint(0, 1 << (2 * k),
                                        (N_SAMPLED_HASHES,),
                                        generator=gen)).to(dev)
    sample = ChunkSample(hashes.to(torch.int32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.time()
    build = {}
    with tracing.run(build):
        idx = di.build_device_index(targets, k, w, device=dev,
                                    on_chunk=sample)
    torch.cuda.synchronize()
    build_wall = time.time() - t
    build_peak = torch.cuda.max_memory_allocated() - held
    ih = idx["ih"]
    n_real = int((ih != di.infk(ih.dtype)).sum())
    log("%s index build: %d tiles, %d real entries in a flat width of %d, "
        "%d hash ranges, mid_occ %d; %.2f s (%s); peak device memory %d "
        "bytes above the %d held before (%.2f GB, %.2f bytes per target "
        "base); the build's reckoning %d bytes"
        % (phase, idx["n_tiles"], n_real, idx["n_idx"], idx["n_ranges"],
           int(idx["mid_occ"]), build_wall,
           json.dumps({key: round(v["wall_s"], 3) for key, v in
                       build["spans"]["by_name"].items()}),
           build_peak, held, build_peak / 1e9, build_peak / tbp,
           idx["reckoned_bytes"]))
    if idx["n_ranges"] < 2:
        raise AssertionError("%s: the index was not built by hash range"
                             % phase)
    packed = build["spans"]["counters"].get("index.pack_tiles", 0)
    log("%s: index.pack_tiles %d of %d tiles" % (phase, packed,
                                                   idx["n_tiles"]))
    if packed != idx["n_tiles"]:
        raise AssertionError("%s: %d tiles packed on the card, %d built"
                             % (phase, packed, idx["n_tiles"]))
    if not bool((ih[1:] >= ih[:-1]).all()):
        raise AssertionError("%s: ih is not sorted" % phase)
    if n_real != sum(sample.n_exp) or n_real != idx["n_real"]:
        raise AssertionError("%s: %d real entries, the tiles emitted %d"
                             % (phase, n_real, sum(sample.n_exp)))
    want = sample.triples()
    got = sorted_triples(entries_of([ih, idx["irid"], idx["ips"]],
                                    sample.hashes))
    same = all(np.array_equal(a, b) for a, b in zip(want, got))
    log("%d sampled hashes: %d entries in the tiles' chunks, %d in the "
        "index, multisets %s" % (len(hashes), len(want[0]), len(got[0]),
                                 "equal" if same else "DIFFER"))
    if not same or not len(want[0]):
        raise AssertionError("%s: sampled entries differ" % phase)
    counts = torch.unique_consecutive(ih[:n_real], return_counts=True)[1]
    n_keys = counts.numel()
    kth = min(int((1.0 - 2e-4) * n_keys), n_keys - 1)
    mo = int(torch.kthvalue(counts.cpu(), kth + 1).values) + 1
    log("mid_occ %d; kth (%d of %d keys) of torch.unique_consecutive's "
        "counts + 1: %d" % (int(idx["mid_occ"]), kth, n_keys, mo))
    if mo != int(idx["mid_occ"]):
        raise AssertionError("%s: mid_occ differs" % phase)
    return launches


# ---------------------------------------------------------------------------
# phase 10: the port's sampleqc through cli.main

N_ADAPTER = 2000        # phase 10a's reads with the 5' adapter planted
N_SAMPLED_ROWS = 32     # coverage rows held against the host spec
N_MASK_ROWS = 256       # mask-table rows recomputed on the host


def read_fastq(path):
    from longqc_tpu_torch.io.fastx import iter_fastx
    return [[n, s, q] for n, s, q in iter_fastx(path)]


def host_mask_row(read):
    """The sdust table's row of one read, recomputed on the host: the
    Python sdust recursion, meanQ as the C loop sums it, nQ7."""
    from longqc_tpu_torch.ops.quality import mean_q_host
    from longqc_tpu_torch.ops.sdust import sdust_masked_length
    name, seq, qual = read
    ml = sdust_masked_length(seq)
    nq7 = sum(1 for c in qual if ord(c) - 33 > 7)
    return "%s\t%d\t%d\t%.3f\t%.3f\t%d" % (
        name, ml, len(seq), ml / len(seq) if seq else 0.0,
        mean_q_host(qual), nq7)


def sampleqc_run(dev, workdir, tag, reads, preset, missing, extra=()):
    """`sampleqc -x preset` (plus the flags in extra) on `reads` through
    cli.main on the card, and the checks every phase-10 run shares.
    Returns (launches, the output directory, the QC JSON, the stats, the
    sampled reads)."""
    import torch
    from longqc_tpu_torch import cli
    from longqc_tpu_torch import config as C
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.ops import _ext

    phase = "phase %s" % tag
    fq = os.path.join(workdir, "sampleqc_%s.fq" % tag)
    out = os.path.join(workdir, "sampleqc_%s" % tag)
    stats_path = os.path.join(workdir, "sampleqc_%s.json" % tag)
    write_fastq(fq, reads)
    argv = ["sampleqc", "-x", preset, "-o", out, "--device", str(dev),
            "--stats", stats_path] + (["--no-report"] if missing else []) \
        + list(extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    t = time.time()
    rc = cli.main(argv + [fq])
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(_ext.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError("%s: sampleqc returned %d" % (phase, rc))
    with open(stats_path) as f:
        stats = json.load(f)
    with open(os.path.join(out, "QC_vals_longQC_sampleqc.json")) as f:
        qc = json.load(f)
    ov = stats["overlap"]
    log("sampleqc -x %s -o %s --device %s --stats %s%s%s %s" % (
        preset, os.path.basename(out), dev, os.path.basename(stats_path),
        " --no-report" if missing else "", "".join(" " + a for a in extra),
        os.path.basename(fq)))
    log("%s sampleqc wall %.2f s; stage_s %s" % (phase, wall, json.dumps(
        {k: round(v, 3) for k, v in stats["stage_s"].items()})))
    log("%s overlap phase_s %s; step calls %d, retry steps %d, host-fixed "
        "rows %d, host-only parts %d" % (
            phase, json.dumps({k: round(v, 3)
                               for k, v in ov["phase_s"].items()}),
            ov["device_calls"], ov["retry_steps"], ov["host_fixed_rows"],
            ov["host_only_parts"]))
    if "spike_in" in stats:
        sp = stats["spike_in"]
        log("%s spike-in run phase_s %s; host-fixed rows %d" % (
            phase, json.dumps({k: round(v, 3)
                               for k, v in sp["phase_s"].items()}),
            sp["host_fixed_rows"]))
    log("%s kernel launches %s; max_memory_allocated %d bytes (%.2f GB); "
        "reader %s, sdust recursion %s" % (
            phase, launches, peak_mem, peak_mem / 1e9,
            stats["reader"]["name"], stats["sdust"]["name"]))
    log("%s QC JSON: %s" % (phase, json.dumps(qc)))
    for key in ("reader", "sdust"):
        if stats[key]["name"] != "native":
            raise AssertionError("%s: the %s was not the native one (%s)"
                                 % (phase, key, stats[key]["error"]))
    for name in ("sketch", "chain", "peak", "minrank"):
        if not launches.get(name):
            raise AssertionError("%s: kernel %s was not launched by the "
                                 "sampleqc run" % (phase, name))
    if ov["host_fixed_rows"] > 0.05 * N_QUERIES:
        raise AssertionError("%s: host-fixed rows %d exceed 5%%"
                             % (phase, ov["host_fixed_rows"]))
    n_bp = sum(len(r[1]) for r in reads)
    if qc["Num_of_reads"] != len(reads) or qc["Yield"] != n_bp:
        raise AssertionError("%s: Num_of_reads %d / Yield %d, want %d / %d"
                             % (phase, qc["Num_of_reads"], qc["Yield"],
                                len(reads), n_bp))

    # the mask table: one row per input read; sampled rows recomputed
    with open(os.path.join(out, "analysis", "longqc_sdust.txt")) as f:
        mask_rows = f.read().splitlines()
    if len(mask_rows) != len(reads):
        raise AssertionError("%s: %d mask rows for %d reads"
                             % (phase, len(mask_rows), len(reads)))
    t = time.time()
    pick = random.Random(5).sample(range(len(reads)), N_MASK_ROWS)
    bad = [i for i in pick if mask_rows[i] != host_mask_row(reads[i])]
    if bad:
        raise AssertionError("%s: %d of %d mask rows differ from the host "
                             "(first: read %d: %r vs %r)" % (
                                 phase, len(bad), N_MASK_ROWS, bad[0],
                                 mask_rows[bad[0]],
                                 host_mask_row(reads[bad[0]])))
    masked = sum(1 for r in mask_rows if r.split("\t")[1] != "0")
    log("%s mask table: %d rows, %d with masked bases; %d sampled rows "
        "equal the host recomputation (%.1f s)" % (
            phase, len(mask_rows), masked, N_MASK_ROWS, time.time() - t))

    # the coverage table: a 9-column row per sampled read, in the
    # subsample's order; sampled rows against the host spec
    sampled = read_fastq(os.path.join(out, "analysis", "subsample.fastq"))
    with open(os.path.join(out, "analysis", "minimap2",
                           "coverage_out.txt")) as f:
        rows = f.read().splitlines()
    if len(rows) != len(sampled) or \
            any(len(r.split("\t")) != 9 for r in rows) or \
            [r.split("\t")[0] for r in rows] != [r[0] for r in sampled]:
        raise AssertionError("%s: the coverage table must hold one 9-column "
                             "row per sampled read (%d rows, %d sampled)"
                             % (phase, len(rows), len(sampled)))
    pick = sorted(random.Random(7).sample(range(len(sampled)),
                                          N_SAMPLED_ROWS))
    cfg = C.overlap_config_for_sample(C.PRESETS[preset])
    t = time.time()
    want = oh.overlap_run(iter(reads), [sampled[i] for i in pick], cfg,
                          device=dev)
    bad = [i for i, r in zip(pick, want) if rows[i] != r]
    if bad:
        raise AssertionError("%s: %d of %d sampled coverage rows differ "
                             "from the host spec (first: %d)"
                             % (phase, len(bad), N_SAMPLED_ROWS, bad[0]))
    log("%s coverage table: %d rows; %d sampled rows equal the host spec "
        "(%.1f s)" % (phase, len(rows), N_SAMPLED_ROWS, time.time() - t))

    figs = sorted(os.listdir(os.path.join(out, "figs")))
    html = os.path.exists(os.path.join(out, "web_summary.html"))
    if missing:
        log("%s: %s missing on this machine: the 8 figures and the HTML "
            "report were not drawn (--no-report); %d figures, HTML %s"
            % (phase, " and ".join(missing), len(figs), html))
        if figs or html:
            raise AssertionError("%s: --no-report drew a report" % phase)
    elif len(figs) != 8 or not html:
        raise AssertionError("%s: %d figures, HTML %s" % (phase, len(figs),
                                                          html))
    return launches, out, qc, stats, sampled


def sampleqc_ont(dev, workdir, targets, missing):
    """Phase 10a: ont-ligation sampleqc on phase 5's target reads, the
    5' adapter planted on N_ADAPTER of them; cut_adapter with CPU
    tensors on the same reads started in a side process (its statistics
    checked by check_adapter_recheck); then the mask stage and the
    adapter DP once more, each alone on the card (in the run the mask
    stage shares the interpreter with the adapter search), the mask rows
    against the run's table. Returns (launches, the re-check's handle)."""
    import torch
    from longqc_tpu_torch import config as C
    from longqc_tpu_torch.engine.masking import mask_table_rows
    from longqc_tpu_torch.ops.adapter import adapter_dists

    preset = C.PRESETS["ont-ligation"]
    step = len(targets) // N_ADAPTER
    reads = [[n, preset.adp5 + s, "5" * len(preset.adp5) + q]
             if i % step == 0 else [n, s, q]
             for i, (n, s, q) in enumerate(targets)]
    launches, out, qc, stats, _ = sampleqc_run(dev, workdir, "10a", reads,
                                               "ont-ligation", missing)
    cnt = stats["spans"]["counters"]
    n_align = stats["spans"]["by_name"]["adapter.align"]["n"]
    log("phase 10a adapter alignment: %d adapter_align launches, %d "
        "adapter.align spans, %d of %d candidates aligned on the card, %d "
        "read the bounds over optimal paths" % (
            launches.get("adapter_align", 0), n_align,
            cnt["adapter.align_kernel"], cnt["adapter.candidates"],
            cnt["adapter.straddle_dp"]))
    if launches.get("adapter_align", 0) != n_align or \
            cnt["adapter.align_kernel"] != cnt["adapter.candidates"]:
        raise AssertionError("phase 10a: cut_adapter did not align every "
                             "candidate with the adapter_align kernel")
    # cut_adapter on CPU tensors over the same reads (the run's input
    # file), in a side process beside phases 10a-14; checked at the end
    recheck = (side_start("adapters", workdir),
               qc.get("Stats_for_adapter5", {}),
               qc.get("Stats_for_adapter3", {}))

    torch.cuda.synchronize()
    t = time.time()
    rows = mask_table_rows(reads, device=dev)
    torch.cuda.synchronize()
    t_mask = time.time() - t
    t = time.time()
    for adp, where in ((preset.adp5, "head"), (preset.adp3, "tail")):
        adapter_dists(reads, adp, where, C.ADAPTER_SEARCH_LENGTH,
                      device=dev)
    t_dp = time.time() - t
    st = stats["stage_s"]
    log("phase 10a stages alone on the card: mask table %.2f s (%.2f s in "
        "the run, beside the adapter search), adapter DP at both ends %.2f "
        "s (the adapter search %.2f s in the run)" % (
            t_mask, st["mask"], t_dp, st["adapter"]))
    with open(os.path.join(out, "analysis", "longqc_sdust.txt")) as f:
        if f.read().splitlines() != rows:
            raise AssertionError("phase 10a: the mask stage alone gives "
                                 "other rows than the run")
    return launches, recheck


def adapter_recheck(workdir):
    """cut_adapter on CPU tensors over phase 10a's input reads ->
    adapters.json (`--side adapters`)."""
    import numpy as np
    import torch
    from longqc_tpu_torch import config as C
    from longqc_tpu_torch.io.fastx import iter_fastx
    from longqc_tpu_torch.ops.adapter import cut_adapter
    torch.set_num_threads(2)
    preset = C.PRESETS["ont-ligation"]
    t = time.time()
    reads = [[n, sq, q] for n, sq, q in
             iter_fastx(os.path.join(workdir, "sampleqc_10a.fq"))]
    t5, t3 = cut_adapter(reads, adp_t=preset.adp5, adp_b=preset.adp3,
                         th=C.ADAPTER_IDENTITY_THRESHOLD,
                         length=C.ADAPTER_SEARCH_LENGTH, device="cpu")
    with open(os.path.join(workdir, "adapters.json"), "w") as f:
        json.dump({"t5": [float(t5[0]), int(t5[1]), float(np.mean(t5[2]))],
                   "t3": [float(t3[0]), int(t3[1])],
                   "seconds": time.time() - t}, f)


def check_adapter_recheck(workdir, recheck):
    """Phase 10a's adapter statistics against the side process's
    cut_adapter on CPU tensors."""
    from longqc_tpu_torch import config as C
    proc, got5, got3 = recheck
    t = time.time()
    side_wait(proc, "phase 10a's cut_adapter on CPU tensors")
    with open(os.path.join(workdir, "adapters.json")) as f:
        r = json.load(f)
    (ident5, n5, pos5), (ident3, n3) = r["t5"], r["t3"]
    want5 = {"Num_of_trimmed_reads_5": n5, "Max_identity_adp5": ident5,
             "Average_position_from_5_end": pos5}
    log("phase 10a adapters: 5' %s, 3' %s; cut_adapter on CPU tensors: "
        "5' %s, 3' trimmed %d, max identity %.4f (%.1f s in a side "
        "process beside phases 10a-14, waited %.1f s)" % (
            json.dumps(got5), json.dumps(got3), json.dumps(want5), n3,
            ident3, r["seconds"], time.time() - t))
    if got5 != want5 or n5 < N_ADAPTER:
        raise AssertionError("phase 10a: the 5' adapter statistics differ "
                             "from cut_adapter's on CPU tensors")
    if ident3 >= C.ADAPTER_IDENTITY_THRESHOLD and (
            got3.get("Num_of_trimmed_reads_3") != n3
            or got3.get("Max_identity_adp3") != ident3):
        raise AssertionError("phase 10a: the 3' adapter statistics differ "
                             "from cut_adapter's on CPU tensors")


def sampleqc_pb(dev, workdir, queries, missing):
    """Phase 10b: pb-sequel sampleqc on phase 7's queries (100 from the
    Sequel control of the port's refs/): every control-derived sampled
    read is marked by the spike-in filter run."""
    launches, out, qc, _, sampled = sampleqc_run(
        dev, workdir, "10b", queries, "pb-sequel", missing)
    with open(os.path.join(out, "analysis", "minimap2",
                           "spiked_in_control.txt")) as f:
        rows = [r.split("\t") for r in f.read().splitlines()]
    marked = {r[0] for r in rows if float(r[5]) >= 0.5}
    ctl = {r[0] for r in sampled if r[0].startswith("control")}
    log("phase 10b spike-in table: %d rows; %d marked, %d of the %d "
        "control-derived sampled reads, %d others; control fraction %s"
        % (len(rows), len(marked), len(marked & ctl), len(ctl),
           len(marked - ctl), qc["Coverage_stats"].get(
               "Estimated spiked-in control read fraction")))
    if len(rows) != len(sampled) or not ctl or not ctl <= marked:
        raise AssertionError("phase 10b: every control-derived sampled "
                             "read must be marked by the filter run")
    return launches


# ---------------------------------------------------------------------------
# phase 11: sampleqc -d, the index prefetch beside the chunk-QC loop


def qc_json_equal(got, want):
    """Two QC JSON dicts: the same keys in the same order, integers and
    strings equal, floats equal except those of the coverage fits
    (Coverage_stats), within rel 1e-9 (the EM fits' summation order)."""
    def walk(a, b, path):
        if type(a) is not type(b):
            return False
        if isinstance(b, dict):
            return list(a) == list(b) and all(
                walk(a[k], b[k], path + "/" + k) for k in b)
        if isinstance(b, list):
            return len(a) == len(b) and all(
                walk(x, y, path) for x, y in zip(a, b))
        if isinstance(b, float) and path.startswith("/Coverage_stats"):
            return abs(a - b) <= 1e-9 * abs(b)
        return a == b
    return walk(got, want, "")


def sampleqc_db(dev, workdir, reads, missing):
    """Phase 11: phase 10b's sampleqc once more with -d. Its tables and
    QC JSON must equal 10b's, its one npz part per (k, w) spec a fresh
    build_index on the card; then the prefetch alone on the card, timed.
    Returns the launch counts of the run."""
    import filecmp
    import numpy as np
    from longqc_tpu_torch import config as C
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.engine import pipeline

    phase = "phase 11"
    launches, out, qc, stats, _ = sampleqc_run(
        dev, workdir, "11", reads, "pb-sequel", missing, extra=["-d"])
    ref = os.path.join(workdir, "sampleqc_10b")
    mm2 = os.path.join("analysis", "minimap2")
    for table in (os.path.join(mm2, "coverage_out.txt"),
                  os.path.join(mm2, "spiked_in_control.txt")):
        if not filecmp.cmp(os.path.join(out, table),
                           os.path.join(ref, table), shallow=False):
            raise AssertionError("%s: %s differs from phase 10b's"
                                 % (phase, table))
    with open(os.path.join(ref, "QC_vals_longQC_sampleqc.json")) as f:
        if not qc_json_equal(qc, json.load(f)):
            raise AssertionError("%s: the QC JSON differs from phase 10b's"
                                 % phase)
    cfg = C.overlap_config_for_sample(C.PRESETS["pb-sequel"])
    k, w = cfg.index.k, cfg.index.w
    npz = sorted(f for f in os.listdir(os.path.join(out, mm2))
                 if f.endswith(".npz"))
    if npz != ["t_db_longqc_k%d_w%d.part0000.npz" % (k, w)]:
        raise AssertionError("%s: npz parts %s, want one for (k, w) = "
                             "(%d, %d)" % (phase, npz, k, w))
    pf = stats["prefetch"]
    t = time.time()
    got = oh.MinimizerIndex.load(os.path.join(out, mm2, npz[0]))
    want = oh.build_index(reads, k, w, device=dev)
    for key in ("h", "rid", "ps", "seq_lens"):
        a, b = getattr(got, key), getattr(want, key)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("%s: the npz part's %s differs from a "
                                 "fresh build_index" % (phase, key))
    if got.names != want.names:
        raise AssertionError("%s: the npz part's names differ" % phase)
    t_check = time.time() - t
    # the prefetch alone on the card: the same spec into a fresh prefix
    fq = os.path.join(workdir, "sampleqc_11.fq")
    alone = pipeline._IndexPrefetcher(
        fq, [(k, w, os.path.join(workdir, "prefetch_alone"))],
        cfg.index.batch_size, dev)
    t = time.time()
    alone.start()
    alone.join()
    t_alone = time.time() - t
    log("%s: the tables and the QC JSON equal phase 10b's; npz parts %s "
        "(%d entries) equal a fresh build_index on the card (%.1f s); "
        "prefetch thread %.2f s beside the chunk-QC loop, join wait %.3f "
        "s; the prefetch alone on the card %.2f s"
        % (phase, npz, len(got.h), t_check, pf["thread_s"],
           pf["join_wait_s"], t_alone))
    return launches


# ---------------------------------------------------------------------------
# phase 12: mmcov -d, mmcov -z and the batched chainer

N_DB_TARGETS = 2000     # phase 5's targets of phase 12 (host spec runs)
N_DB_QUERIES = 200
N_CHAINER_CONTROL = 20  # phase 7's control-derived reads of the -k 17 run


def run_cli(argv):
    """cli.main(argv) -> (stdout, stderr, seconds); fails unless rc 0."""
    import torch
    from contextlib import redirect_stderr
    from longqc_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t = time.time()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError("%s returned %d" % (" ".join(argv[:2]), rc))
    return out.getvalue(), err.getvalue(), time.time() - t


def mmcov_db_z_chainer(dev, workdir, targets, queries7):
    """Phase 12 on the first N_DB_TARGETS of phase 5's targets (its first
    N_DB_QUERIES queries) at phase 5's settings: `mmcov -d` dump only,
    then the cached run (the host spec), whose rows must equal the device
    engine's; `mmcov -z` from the cache: the rows unchanged, the [z]
    lines descending, summing to the device engine's m_cnts; then `mmcov
    -H -k 17 -w 10 -c 1 -l 0 --filter` (the device engine rejects HPC
    with k > 15) against the Sequel control on the queries plus
    N_CHAINER_CONTROL of phase 7's control-derived reads: the batched
    chainer with B2, every row equal to the host spec's; then the
    batched-chainer path called directly at phase 5's settings on the
    same targets and queries: B2 alone, rows equal to the device
    engine's. Returns the launch counts of the two batched-chainer
    runs."""
    import numpy as np
    import torch
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig, parse_num
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine
    from longqc_tpu_torch.engine.overlap import DeviceChainer
    from longqc_tpu_torch.io.fastx import iter_fastx
    from longqc_tpu_torch.ops import _ext

    phase = "phase 12"
    tg, qs = targets[:N_DB_TARGETS], targets[:N_DB_QUERIES]
    tpath = os.path.join(workdir, "db_targets.fq")
    qpath = os.path.join(workdir, "db_queries.fq")
    write_fastq(tpath, tg)
    write_fastq(qpath, qs)
    run = ONT_RUN
    base = ["mmcov", "-k", str(run["k"]), "-w", str(run["w"]), "-p",
            str(run["p"]), "-q", str(run["q"]), "-l", "0", "--device",
            str(dev)]
    prefix = os.path.join(workdir, "db12")
    out, _, t_dump = run_cli(base + ["-d", prefix, tpath])
    parts = sorted(f for f in os.listdir(workdir) if f.startswith("db12."))
    if out or parts != ["db12.part0000.npz"]:
        raise AssertionError("%s: the dump wrote %s and printed %d bytes"
                             % (phase, parts, len(out)))
    out, _, t_cached = run_cli(base + ["-d", prefix, tpath, qpath])
    rows_cached = out.rstrip("\n").split("\n")
    cfg = OverlapConfig(
        index=IndexOpt(k=run["k"], w=run["w"], batch_size=parse_num("4G")),
        map=MapOpt(min_score_med=run["p"], min_score_good=run["q"],
                   min_chain_score=40),
        flt=FltOpt(min_ovlp=0, min_coverage=3))
    t = time.time()
    eng = DeviceOverlapEngine(cfg, qs, device=dev)
    rows_dev = eng.run(iter(tg))
    torch.cuda.synchronize()
    t_dev = time.time() - t
    if rows_cached != rows_dev:
        bad = [i for i, (a, b) in enumerate(zip(rows_cached, rows_dev))
               if a != b]
        raise AssertionError("%s: the cached host-spec run gives %d rows, "
                             "%d differ from the device engine's (first: "
                             "%s)" % (phase, len(rows_cached), len(bad),
                                      bad[:1]))
    # the device engine's m_cnts, summed over every query
    m_sum = 0
    for g in eng.groups:
        mc, n_exp = g.m_cnts.cpu().numpy(), g.n_exp.cpu().numpy()
        for r, qi in enumerate(g.qids):
            if qi in eng.host_state:
                m_sum += int(eng.host_state[qi].m_cnts.sum())
            else:
                m_sum += int(mc[r, :n_exp[r]].astype(np.int64).sum())
    out, err, t_z = run_cli(base + ["-z", "-d", prefix, tpath, qpath])
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in err.splitlines()
              if ln.startswith("[z] minimizer ")]
    if out.rstrip("\n").split("\n") != rows_cached:
        raise AssertionError("%s: -z changed the rows" % phase)
    if counts != sorted(counts, reverse=True) or sum(counts) != m_sum \
            or not m_sum:
        raise AssertionError("%s: the [z] lines (%d, summing to %d) must "
                             "be descending and sum to the queries' m_cnts "
                             "(%d)" % (phase, len(counts), sum(counts),
                                       m_sum))
    covered = sum(1 for r in rows_cached if r.split("\t")[3] != "0")
    log("%s: %d targets (%d bp), %d queries: mmcov -d dump %.2f s, cached "
        "run (host spec) %.2f s, its %d rows (%d with reliable regions) "
        "equal the device engine's (%.2f s, %d host-fixed); -z %.2f s: %d "
        "[z] lines, descending, summing to %d, the queries' m_cnts; rows "
        "unchanged" % (phase, len(tg), sum(len(r[1]) for r in tg), len(qs),
                       t_dump, t_cached, len(rows_cached), covered, t_dev,
                       eng.n_host_fallback, t_z, len(counts), m_sum))

    # the batched chainer: -H with k > 15
    ctl = [r for r in queries7 if r[0].startswith("control")]
    qc = qs + ctl[:N_CHAINER_CONTROL]
    cpath = os.path.join(workdir, "chainer_queries.fq")
    write_fastq(cpath, qc)
    stats_path = os.path.join(workdir, "chainer_stats.json")
    ctl_path = os.path.join(HERE, CONTROL)
    argv = ["mmcov", "-H", "-k", "17", "-w", "10", "-c", "1", "-l", "0",
            "--filter", "--device", str(dev), "--stats", stats_path,
            ctl_path, cpath]
    _ext.reset_launches()
    out, _, t_ch = run_cli(argv)
    launches = dict(_ext.LAUNCHES)
    rows = out.rstrip("\n").split("\n")
    with open(stats_path) as f:
        stats = json.load(f)
    fcfg = OverlapConfig(
        index=IndexOpt(k=17, w=10, is_hpc=True, batch_size=parse_num("4G")),
        map=MapOpt(min_score_med=80, min_score_good=160,
                   min_chain_score=40),
        flt=FltOpt(min_ovlp=0, min_coverage=1), filter_mode=True)
    control = [[n, s, q or ""] for n, s, q in iter_fastx(ctl_path)]
    t = time.time()
    want = oh.overlap_run(control, qc, fcfg, device=dev)
    t_host = time.time() - t
    marked = sum(1 for r in rows[len(qs):] if r.split("\t")[3] != "0")
    log(" ".join(argv[:-3] + ["chainer_stats.json", CONTROL,
                              "chainer_queries.fq"]))
    log("%s batched chainer: %.2f s, engine %s, B2 launches %s, B2 calls "
        "%d, device rows %d, host-chained rows %d; %d of %d control reads "
        "marked; host spec %.2f s" % (
            phase, t_ch, stats["engine"], launches, stats["b2_calls"],
            stats["device_rows"], stats["host_fallback_rows"], marked,
            len(qc) - len(qs), t_host))
    if stats["engine"] != "batched_chainer" or set(launches) != {"chain"} \
            or launches["chain"] != stats["b2_calls"] \
            or not launches["chain"]:
        raise AssertionError("%s: the -k 17 run must take the batched "
                             "chainer and launch B2 (and nothing else)"
                             % phase)
    if rows != want:
        bad = [i for i, (a, b) in enumerate(zip(rows, want)) if a != b]
        raise AssertionError("%s: %d of %d batched-chainer rows differ from "
                             "the host spec (first: %s)"
                             % (phase, len(bad), len(want), bad[:1]))

    # the batched-chainer path on a configuration the device engine takes
    chainer = DeviceChainer(dev)
    _ext.reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    rows_plain = oh.overlap_run(iter(tg), qs, cfg, device=dev,
                                chain_many=chainer)
    torch.cuda.synchronize()
    t_plain = time.time() - t
    launches_plain = dict(_ext.LAUNCHES)
    log("%s batched chainer at phase 5's settings: %.2f s (device engine "
        "%.2f s), B2 launches %s, B2 calls %d, device rows %d, host-chained "
        "rows %d; %d rows" % (phase, t_plain, t_dev, launches_plain,
                              chainer.n_calls, chainer.n_device,
                              chainer.n_host_fallback, len(rows_plain)))
    if set(launches_plain) != {"chain"} or \
            launches_plain["chain"] != chainer.n_calls:
        raise AssertionError("%s: the batched chainer at phase 5's "
                             "settings must launch B2 (and nothing else)"
                             % phase)
    if rows_plain != rows_dev:
        bad = [i for i, (a, b) in enumerate(zip(rows_plain, rows_dev))
               if a != b]
        raise AssertionError("%s: %d of %d batched-chainer rows differ "
                             "from the device engine's (first: %s)"
                             % (phase, len(bad), len(rows_dev), bad[:1]))
    return launches, launches_plain


# ---------------------------------------------------------------------------
# phase 13: runqc on run folders written here

N_SEQUEL_ZMW = 20000
N_SEQUEL_CONTROL = 200
N_RS_ROWS = 50000
N_ONT_FILES = 200


def bam_bytes(header, records):
    """An unaligned BAM (one gzip member; BGZF is multi-member gzip) of
    records (name, tags): each record's 12 bp sequence and its 0xFF
    qualities packed with numpy. The platform QC reads names and tags
    alone."""
    import gzip
    import struct
    import numpy as np

    seq = np.array([0x12, 0x48] * 6, np.uint8)[:6].tobytes()  # ACGTACG...
    qual = b"\xff" * 12
    ht = header.encode()
    out = [b"BAM\x01", struct.pack("<i", len(ht)), ht, struct.pack("<i", 0)]
    for name, tags in records:
        nb = name.encode() + b"\x00"
        data = struct.pack("<iiBBHHHiiii", -1, -1, len(nb), 0, 4680, 0, 4,
                           12, -1, -1, 0) + nb + seq + qual + tags
        out.append(struct.pack("<i", len(data)) + data)
    return gzip.compress(b"".join(out), compresslevel=1)


def write_sequel_run(d, rng):
    """A Sequel run folder: N_SEQUEL_ZMW ZMWs of 1-4 subreads (0.5-15
    kbp) split by 45 bp adapters, low-quality scraps before or after on
    ~30 %, ~5 % with low-quality scraps alone; N_SEQUEL_CONTROL control
    ZMWs; an sts.xml. -> the planted values."""
    import struct
    import numpy as np

    tag = {c: b"szAN" + b"scA" + c.encode() for c in "AL"}
    ctl_tag = b"szAC" + b"scAF"
    sn = b"snBf" + struct.pack("<I4f", 4, 5.0, 6.0, 7.0, 8.0)
    subs, scraps, hq = [], [], []
    for z in range(N_SEQUEL_ZMW):
        pos = 0
        if rng.rand() < 0.3 or z % 20 == 0:
            ln = int(rng.randint(50, 800))
            scraps.append(("m1/%d/%d_%d" % (z, pos, pos + ln), tag["L"]))
            pos += ln
        if z % 20 == 0:
            continue                      # low-quality scraps alone
        start = pos
        for i in range(int(rng.randint(1, 5))):
            if i:
                scraps.append(("m1/%d/%d_%d" % (z, pos, pos + 45), tag["A"]))
                pos += 45
            ln = int(rng.randint(500, 15000))
            subs.append(("m1/%d/%d_%d" % (z, pos, pos + ln), sn))
            pos += ln
        hq.append(pos - start + 1)
        if rng.rand() < 0.3:
            ln = int(rng.randint(50, 800))
            scraps.append(("m1/%d/%d_%d" % (z, pos, pos + ln), tag["L"]))
    ctl = 0
    for z in range(N_SEQUEL_ZMW, N_SEQUEL_ZMW + N_SEQUEL_CONTROL):
        ln = int(rng.randint(1000, 4000))
        scraps.append(("m1/%d/0_%d" % (z, ln), ctl_tag))
        ctl += ln + 1
    with open(os.path.join(d, "m1.subreads.bam"), "wb") as f:
        f.write(bam_bytes("@RG\tID:a\tDS:READTYPE=SUBREAD;Ipd:CodecV1\n",
                          subs))
    with open(os.path.join(d, "m1.scraps.bam"), "wb") as f:
        f.write(bam_bytes("@RG\tID:a\tDS:READTYPE=SCRAP;Ipd:CodecV1\n",
                          scraps))
    prod = [int(rng.randint(1000, 9000)) for _ in range(3)]
    pipe = "http://pacificbiosciences.com/PacBioPipelineStats.xsd"
    base = "http://pacificbiosciences.com/PacBioBaseDataModel.xsd"
    with open(os.path.join(d, "m1.sts.xml"), "w") as f:
        f.write('<?xml version="1.0"?>\n<PipeStats xmlns="%s" xmlns:b="%s">'
                "<ProdDist><b:BinCounts>%s</b:BinCounts><b:BinLabels>"
                "<b:BinLabel>Empty</b:BinLabel><b:BinLabel>Productive"
                "</b:BinLabel><b:BinLabel>Other</b:BinLabel></b:BinLabels>"
                "</ProdDist></PipeStats>" % (pipe, base, "".join(
                    "<b:BinCount>%d</b:BinCount>" % p for p in prod)))
    return {"Num_of_reads": len(hq), "Throughput": int(sum(hq)),
            "Longest_read": int(max(hq)), "Throughput(Control)": ctl,
            "Productivity": dict(zip(("P0", "P1", "P2"), prod)),
            "records": len(subs) + len(scraps)}


def write_rs_run(d, rng):
    """An RS-II run folder: an sts.csv of N_RS_ROWS ZMWs (extra columns,
    in another order than the QC reads them) and an sts.xml. -> the
    planted values."""
    import numpy as np

    n = N_RS_ROWS
    score = ["%.4f" % v for v in rng.uniform(0.0, 0.95, n)]
    start = rng.randint(0, 2000, n)
    # no HQ region on half of the ZMWs the QC leaves out (ReadScore <=
    # 0.1), as on a real run
    low = np.array([float(v) <= 0.1 for v in score])
    hq_len = np.where(low & (rng.rand(n) < 0.5), 0,
                      rng.randint(100, 30000, n))
    with open(os.path.join(d, "m1.sts.csv"), "w") as f:
        f.write("Zmw,Productivity,NumBases,HQRegionStart,HQRegionEnd,"
                "ReadScore,SnrA\n")
        for i in range(n):
            f.write("%d,%d,%d,%d,%d,%s,%.2f\n" % (
                i, int(hq_len[i] > 0), start[i] + hq_len[i] + 300, start[i],
                start[i] + hq_len[i], score[i], 7.5))
    prod = [int(rng.randint(1000, 9000)) for _ in range(3)]
    ns = "http://pacificbiosciences.com/PipelineStats/PipeStats.xsd"
    with open(os.path.join(d, "m1.sts.xml"), "w") as f:
        f.write('<?xml version="1.0"?>\n<Report xmlns="%s"><ProdDist>%s'
                "<BinLabel>Empty</BinLabel><BinLabel>Productive</BinLabel>"
                "<BinLabel>Other</BinLabel></ProdDist></Report>" % (
                    ns, "".join("<BinCount>%d</BinCount>" % p
                                for p in prod)))
    vals = hq_len[~low]
    return {"Num_of_reads": len(vals), "Throughput": int(vals.sum()),
            "Longest_read": int(vals.max()),
            "Productivity": dict(zip(("P0", "P1", "P2"), prod))}


def write_ont_run(d, rng):
    """N_ONT_FILES single-read fast5 files (h5py). -> the planted
    values."""
    import h5py
    import numpy as np

    rate, mx = 4000, 0
    for i in range(N_ONT_FILES):
        with h5py.File(os.path.join(d, "read_%d.fast5" % i), "w") as f:
            g = f.create_group("/UniqueGlobalKey/channel_id")
            g.attrs["channel_number"] = str(int(rng.randint(1, 513)))
            g.attrs["sampling_rate"] = float(rate)
            ct = f.create_group("/UniqueGlobalKey/context_tags")
            ct.attrs["flowcell_type"] = np.bytes_("FLO-MIN106")
            ct.attrs["sequencing_kit"] = np.bytes_("SQK-LSK109")
            s, dur = int(rng.randint(0, 3000)), int(rng.randint(5, 600))
            r = f.create_group("Raw/Reads/Read_%d" % i)
            r.attrs["start_time"] = s * rate
            r.attrs["duration"] = dur * rate
            mx = max(mx, s + dur)
    return {"Sequencing time in seconds": mx, "Flowcell": "FLO-MIN106",
            "Sequencing kit": "SQK-LSK109"}


def runqc_runs(workdir):
    """Phase 13: `runqc sequel`, `runqc rs2` and, where h5py is
    installed, `runqc minion` through cli.main on run folders written
    here (--no-report where matplotlib is missing); the QC JSON's counts
    must equal what the writer planted."""
    import importlib.util
    import numpy as np

    no_plot = importlib.util.find_spec("matplotlib") is None
    rng = np.random.RandomState(1313)
    runs = [("sequel", write_sequel_run, "QC_vals_sequel.json"),
            ("rs2", write_rs_run, "QC_vals_rs.json")]
    if importlib.util.find_spec("h5py") is not None:
        runs.append(("minion", write_ont_run, "QC_vals_minion.json"))
    else:
        log("phase 13: runqc minion not run: h5py is not installed here, "
            "so no fast5 file can be written or read")
    for platform, write, json_name in runs:
        d = os.path.join(workdir, "run_" + platform)
        os.makedirs(d)
        t = time.time()
        planted = write(d, rng)
        t_write = time.time() - t
        out = os.path.join(workdir, "runqc_" + platform)
        argv = ["runqc", "-o", out] + (["--no-report"] if no_plot else []) \
            + [platform, d]
        _, _, secs = run_cli(argv)
        with open(os.path.join(out, json_name)) as f:
            qc = json.load(f)
        figs = os.listdir(os.path.join(out, "fig"))
        log("runqc -o runqc_%s%s %s run_%s (planted %s, written in %.1f "
            "s): %.2f s; %d figures; QC JSON %s" % (
                platform, " --no-report" if no_plot else "", platform,
                platform, json.dumps(planted), t_write, secs, len(figs),
                json.dumps(qc)))
        for key, val in planted.items():
            if key != "records" and qc[key] != val:
                raise AssertionError("phase 13: runqc %s %s = %r, planted "
                                     "%r" % (platform, key, qc[key], val))
        if bool(figs) == no_plot:
            raise AssertionError("phase 13: runqc %s drew %d figures"
                                 % (platform, len(figs)))


# ---------------------------------------------------------------------------
# phase 14: the part pipeline

PIPELINE_PARTS = "30M"  # 14's -I: phase 5's 90 Mbp of targets in 3 parts
PEAK_SLACK = 1.10       # 14's peak memory against phase 5's


def ont_cfg(batch_size):
    """Phase 5's settings (mmcov -k 12 -w 5 -p 160 -q 160 -l 0) at -I
    batch_size."""
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig, parse_num

    run = ONT_RUN
    return OverlapConfig(
        index=IndexOpt(k=run["k"], w=run["w"],
                       batch_size=parse_num(batch_size)),
        map=MapOpt(min_score_med=run["p"], min_score_good=run["q"],
                   min_chain_score=40),
        flt=FltOpt(min_ovlp=0, min_coverage=3))


def part_pipeline_run(dev, workdir, targets, peak5):
    """Phase 14: `mmcov -I 30M` through cli.main on phase 5's targets and
    queries: 3 parts, each read and packed on the side thread while the
    previous one steps; 32 random rows against the host spec at the same
    -I; the peak device memory at most PEAK_SLACK x phase 5's (one device
    build live at a time). Returns the launches."""
    import torch
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.ops import _ext

    phase = "phase 14"
    run = ONT_RUN
    stats_path = os.path.join(workdir, "pipeline_stats.json")
    argv = ["mmcov", "-k", str(run["k"]), "-w", str(run["w"]), "-p",
            str(run["p"]), "-q", str(run["q"]), "-l", "0", "-I",
            PIPELINE_PARTS, "--device", str(dev), "--stats", stats_path,
            os.path.join(workdir, "targets.fq"),
            os.path.join(workdir, "queries.fq")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    out, _, wall = run_cli(argv)
    launches = dict(_ext.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = out.rstrip("\n").split("\n")
    with open(stats_path) as f:
        st = json.load(f)
    n_parts = len(st["part_ranges"])
    log("mmcov %s targets.fq queries.fq" % " ".join(argv[1:-4]))
    log("%s: %d parts (%d packed on the side thread): wall %.2f s; "
        "phase_s %s; index_s %s; step calls %d, host-fixed rows %d, "
        "host-only parts %d; max_memory_allocated %d bytes (%.2f GB; phase "
        "5's %.2f GB); kernel launches %s" % (
            phase, n_parts, st["parts_packed_aside"], wall,
            json.dumps({k: round(v, 3) for k, v in st["phase_s"].items()}),
            json.dumps({k: round(v, 3) for k, v in st["index_s"].items()}),
            st["device_calls"], st["host_fixed_rows"], st["host_only_parts"],
            peak, peak / 1e9, peak5 / 1e9, launches))
    if len(rows) != N_QUERIES or n_parts < 3 or \
            st["parts_packed_aside"] != n_parts or st["host_only_parts"]:
        raise AssertionError("%s: %d rows, %d parts, %d packed aside, %d "
                             "host-only" % (phase, len(rows), n_parts,
                                            st["parts_packed_aside"],
                                            st["host_only_parts"]))
    for name in run["kernels"]:
        if not launches.get(name):
            raise AssertionError("%s: kernel %s was not launched"
                                 % (phase, name))
    if peak > PEAK_SLACK * peak5:
        raise AssertionError("%s: peak device memory %d passes phase 5's %d "
                             "by more than 10%%: two device builds were "
                             "live at once" % (phase, peak, peak5))
    queries = targets[:N_QUERIES]
    pick = sorted(random.Random(14).sample(range(N_QUERIES), 32))
    t = time.time()
    want = oh.overlap_run(iter(targets), [queries[i] for i in pick],
                          ont_cfg(PIPELINE_PARTS), device=dev)
    bad = [i for i, r in zip(pick, want) if rows[i] != r]
    if bad:
        raise AssertionError("%s: %d of 32 sampled rows differ from the "
                             "host spec (first: query %d)"
                             % (phase, len(bad), bad[0]))
    log("%s: 32 sampled rows equal the host spec at -I %s (host spec "
        "%.1f s)" % (phase, PIPELINE_PARTS, time.time() - t))
    return launches


# ---------------------------------------------------------------------------
# phase 15: rows past the top anchor rung


# the ont-ultralong cell's reads (800 of 10-290 kbp, 7.5x of 16 Mbp; no
# junk here): ~3.8 anchors a base at k = 12 against the 120 Mbp part, so
# rows past ~70 kbp step at the wide rungs and rows past ~276 kbp at
# 2^21 (B4's pending mask in device memory on the path). Queries: the
# n_long longest reads and n_other others, so groups mix wide and
# ladder rows
UL_RUN = dict(phase="phase 15", k=12, w=5, p=160, q=160, seed=1515,
              genome=16_000_000, n_targets=800, min_len=10000,
              max_len=290000, err=0.12, junk=0.0, n_long=96, n_other=32)
UL_CHECK = (0, 47, -1)  # queries by length: the rows held to the reference


def ul_cfg():
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig, parse_num
    run = UL_RUN
    return OverlapConfig(
        index=IndexOpt(k=run["k"], w=run["w"], batch_size=parse_num("4G")),
        map=MapOpt(min_score_med=run["p"], min_score_good=run["q"],
                   min_chain_score=40),
        flt=FltOpt(min_ovlp=0, min_coverage=3))


def ul_data(workdir):
    """Phase 15's reads (UL_RUN) as ul_targets.fq and ul_queries.fq,
    then the rows of the UL_CHECK queries by the benchmark's plain
    reference (benchmark/reference/overlap.rows_for, CPU tensors) into
    ul_rows.json (side process from phase 4 on)."""
    import numpy as np
    import torch
    from util_synth import make_genome_fast, sample_reads_fast
    from benchmark.reference import overlap as ref_ov
    torch.set_num_threads(2)
    run = UL_RUN
    rng = np.random.RandomState(run["seed"])
    reads = sample_reads_fast(rng, make_genome_fast(rng, run["genome"]),
                              run["n_targets"], min_len=run["min_len"],
                              max_len=run["max_len"], err=run["err"],
                              junk_frac=run["junk"])
    by_len = sorted(range(len(reads)), key=lambda i: -len(reads[i][1]))
    picked = by_len[:run["n_long"]] + sorted(random.Random(15).sample(
        by_len[run["n_long"]:], run["n_other"]))
    queries = [reads[i] for i in picked]
    for name, rs in (("ul_targets.fq", reads), ("ul_queries.fq", queries)):
        write_fastq(os.path.join(workdir, name + ".part"), rs)
    for name in ("ul_targets.fq", "ul_queries.fq"):
        os.rename(os.path.join(workdir, name + ".part"),
                  os.path.join(workdir, name))
    q_by_len = sorted(range(len(queries)),
                      key=lambda i: -len(queries[i][1]))
    pick = [q_by_len[i] for i in UL_CHECK]
    cfg = ul_cfg()
    m, f = cfg.map, cfg.flt
    ov = dict(k=run["k"], w=run["w"], max_gap=m.max_gap, bw=m.bw,
              max_skip=m.max_chain_skip, min_cnt=m.min_cnt,
              min_chain_score=m.min_chain_score, min_score_med=run["p"],
              min_score_good=run["q"], mid_occ_frac=m.mid_occ_frac,
              max_overhang=f.max_overhang, min_ratio=f.min_ratio,
              min_cov=f.min_coverage, covt=cfg.covt)
    t = time.time()
    rows, _ = ref_ov.rows_for(reads, queries, pick, ov)
    with open(os.path.join(workdir, "ul_rows.json"), "w") as fh:
        json.dump({"pick": pick, "rows": [rows[i] for i in pick],
                   "seconds": time.time() - t}, fh)


def ultralong_run(dev, workdir, proc):
    """Phase 15: UL_RUN's queries against its reads through cli.main
    (`mmcov`, phase 5's settings): no host-fixed row, at least half the
    rows stepped at the wide rungs, B4 launched past 2^20 anchors; the
    UL_CHECK rows equal the benchmark's plain reference (the side
    process proc). Returns the launches, the B3 / B4 launches by rung
    and their summed bound."""
    import torch
    from longqc_tpu_torch import cli
    from longqc_tpu_torch.ops import _ext

    run = UL_RUN
    phase = run["phase"]
    tpath, qpath = (os.path.join(workdir, "ul_%s.fq" % n)
                    for n in ("targets", "queries"))
    while not os.path.exists(qpath):
        if proc.poll() is not None:
            side_wait(proc, "%s's data" % phase)
            raise AssertionError("%s: no data" % phase)
        time.sleep(1)
    stats_path = os.path.join(workdir, "ul_stats.json")
    argv = ["mmcov", "-k", str(run["k"]), "-w", str(run["w"]), "-p",
            str(run["p"]), "-q", str(run["q"]), "-l", "0", "--device",
            str(dev), "--stats", stats_path, tpath, qpath]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    buf = io.StringIO()
    t = time.time()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(_ext.LAUNCHES)
    rungs, path_bound = ringprop_rungs(_ext.LAUNCH_SHAPES)
    peak_mem = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError("%s: mmcov returned %d" % (phase, rc))
    with open(stats_path) as f:
        stats = json.load(f)
    rows = buf.getvalue().rstrip("\n").split("\n")
    ctr = stats["spans"]["counters"]
    n = run["n_long"] + run["n_other"]
    log("mmcov %s ul_targets.fq ul_queries.fq" % " ".join(argv[1:-2]))
    log("%s: %d reads of %d-%d bp, ~%.1fx of %d bp; queries the %d longest "
        "and %d others: wall %.2f s; phase_s %s; step calls %d, retry "
        "steps %d, host-fixed rows %d; wide rows %d (slots %d, anchors "
        "%d); kernel launches %s; max_memory_allocated %.2f GB" % (
            phase, run["n_targets"], run["min_len"], run["max_len"],
            run["n_targets"] * (run["min_len"] + run["max_len"]) / 2
            / run["genome"], run["genome"], run["n_long"], run["n_other"],
            wall, json.dumps({k: round(v, 3) for k, v in
                                             stats["phase_s"].items()}),
            stats["device_calls"], stats["retry_steps"],
            stats["host_fixed_rows"], ctr.get("step.wide_rows", 0),
            ctr.get("step.wide_slots", 0), ctr.get("step.wide_anchors", 0),
            launches, peak_mem / 1e9))
    log_rungs(phase, rungs, path_bound)
    if len(rows) != n:
        raise AssertionError("%s: %d rows for %d queries"
                             % (phase, len(rows), n))
    if stats["host_fixed_rows"] or stats["host_only_parts"]:
        raise AssertionError("%s: %d host-fixed rows, %d host-only parts"
                             % (phase, stats["host_fixed_rows"],
                                stats["host_only_parts"]))
    if 2 * ctr.get("step.wide_rows", 0) < n:
        raise AssertionError("%s: %d of %d rows at the wide rungs"
                             % (phase, ctr.get("step.wide_rows", 0), n))
    if not any(A > (1 << 20) for A in rungs.get("minrank", {})):
        raise AssertionError("%s: B4 never launched past 2^20 anchors"
                             % phase)
    if launches["chain"] != stats["device_calls"]:
        raise AssertionError("%s: %d step calls but %d B2 launches"
                             % (phase, stats["device_calls"],
                                launches["chain"]))
    t = time.time()
    side_wait(proc, "%s's reference" % phase)
    with open(os.path.join(workdir, "ul_rows.json")) as f:
        want = json.load(f)
    bad = [i for i, r in zip(want["pick"], want["rows"]) if rows[i] != r]
    if bad:
        raise AssertionError("%s: %d of %d rows differ from the plain "
                             "reference (first: query %d)"
                             % (phase, len(bad), len(want["pick"]), bad[0]))
    log("%s: the rows of the queries %s (by length, ranks %s from the "
        "longest) equal the plain reference (%.1f s on CPU tensors in a "
        "side process, waited %.1f s)" % (phase, want["pick"],
                                          list(UL_CHECK), want["seconds"],
                                          time.time() - t))
    return launches, rungs, path_bound


def main():
    t_all = time.time()
    if not os.path.isdir(os.path.join(HERE, "longqc_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (longqc_tpu_torch/ not found)")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))

    # --- phase 1: environment
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                         "false")
    card = card_line()
    log("card: %s" % card)
    from longqc_tpu_torch.ops import _ext
    try:
        import triton
        tri = triton.__version__
    except ImportError:
        tri = "not importable"
    log("python %s; torch %s; torch.version.cuda %s; nvcc %s; triton %s"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           _ext.nvcc_path(), tri))
    log("environment CC %r CXX %r CXXFLAGS %r CFLAGS %r; g++ %s" % (
        os.environ.get("CC"), os.environ.get("CXX"),
        os.environ.get("CXXFLAGS"), os.environ.get("CFLAGS"),
        subprocess.run(["g++", "--version"], capture_output=True,
                       text=True).stdout.splitlines()[0]))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # phase 9's part is made by a side process from here on
    workdir = tempfile.mkdtemp(prefix="longqc_smoke_")
    try:
        run_phases(dev, workdir, {"big-data": side_start("big-data",
                                                         workdir)}, t_all)
    finally:
        side_stop()
        shutil.rmtree(workdir, ignore_errors=True)


def run_phases(dev, workdir, sides, t_all):
    """Phases 2-15 and the result lines; sides: the side processes by
    name."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from longqc_tpu_torch.ops import _ext

    # --- phase 2: build; every B1 and B5 instance's resources beside it
    t = time.time()
    with ThreadPoolExecutor(3) as pool:
        res_futures = (pool.submit(sketch_resources),
                       pool.submit(extend_resources),
                       pool.submit(pack_resources))
        mod = _ext.lib(verbose=True)
        log("built %s in %.1f s" % (os.path.relpath(mod.__file__, HERE),
                                    time.time() - t))
        resources, ext_resources, pack_res = (f.result()
                                              for f in res_futures)
    log("B1, B5 and tile packing resources read beside the build (%.1f s "
        "in all)" % (time.time() - t))
    from longqc_tpu_torch.io import native
    if not native.available():
        raise AssertionError("the port's FASTA/FASTQ reader did not build: "
                             "%s" % native.BUILD["error"])
    log("built the reader: %s (%.2f s)" % (native.BUILD["cmd"],
                                          native.BUILD["build_s"]))
    from longqc_tpu_torch.ops import sdust
    if sdust.sdust_impl() != "native":
        raise AssertionError("the port's sdust recursion did not build: %s"
                             % sdust.NATIVE_BUILD["error"])
    log("built the sdust recursion: %s (%.2f s)" % (
        sdust.NATIVE_BUILD["cmd"], sdust.NATIVE_BUILD["build_s"]))

    # --- phase 3: kernels vs plain versions
    t = time.time()
    res = check_sketch_variants(dev)
    log("phase 3, B1: %.1f s" % (time.time() - t))
    t = time.time()
    res.update(check_pack(dev))
    log("phase 3, tile packing: %.1f s" % (time.time() - t))
    res.update(check_chain_ringprop(dev, 12))
    # phase 15's data and the wide rungs' plain versions, on the CPU
    # beside phases 4-15
    for name in ("ul-data",) + tuple(WIDE_SIDES):
        sides[name] = side_start(name, workdir)

    # --- phase 4: small end to end; at w = 40 the run-time-ring B1
    # variants sketch the index tiles and the queries
    small_end_to_end(dev)
    ring_launches = {}
    for k in (12, 19):
        ring_launches.update(small_end_to_end(dev, k=k, w=40, err=0.04))

    # --- phase 5: realistic mmcov run; phase 6: B5; phase 7: HPC filter;
    # phase 8: the pb-hifi fast preset
    t = time.time()
    launches, dev_ms, rungs5, targets5, peak5 = realistic_mmcov(
        dev, workdir, ONT_RUN)
    log("phase 5 %.1f s" % (time.time() - t))
    t = time.time()
    ext_res, ext_launches = check_extend(dev)
    res.update(ext_res)
    launches.update(ext_launches)
    log("phase 6 %.1f s" % (time.time() - t))
    t = time.time()
    res.update(check_adapter_align(dev))
    log("phase 6b %.1f s" % (time.time() - t))
    t = time.time()
    hpc_launches, rungs7, queries7 = hpc_filter_run(dev, workdir)
    log("phase 7 %.1f s" % (time.time() - t))
    t = time.time()
    launches8, dev_ms8, rungs8, _, _ = realistic_mmcov(dev, workdir,
                                                          HIFI_RUN)
    log("phase 8 %.1f s" % (time.time() - t))
    t = time.time()
    launches9 = big_part_run(dev, workdir, sides["big-data"])
    log("phase 9 %.1f s" % (time.time() - t))
    # phase 10: the port's sampleqc on phase 5's and phase 7's reads
    from longqc_tpu_torch.engine.pipeline import \
        missing_report_modules
    missing = missing_report_modules()
    log("phase 10: the report stage's modules %s" % (
        "are all installed" if not missing else
        "missing here: %s (figures and HTML not drawn)"
        % ", ".join(missing)))
    t = time.time()
    launches10a, recheck10a = sampleqc_ont(dev, workdir, targets5, missing)
    targets12 = targets5[:N_DB_TARGETS]
    log("phase 10a %.1f s" % (time.time() - t))
    t = time.time()
    launches10b = sampleqc_pb(dev, workdir, queries7, missing)
    log("phase 10b %.1f s" % (time.time() - t))
    # phase 11: sampleqc -d; phase 12: mmcov -d / -z and the batched
    # chainer; phase 13: runqc
    t = time.time()
    launches11 = sampleqc_db(dev, workdir, queries7, missing)
    log("phase 11 %.1f s" % (time.time() - t))
    t = time.time()
    launches12, launches12_plain = mmcov_db_z_chainer(dev, workdir,
                                                      targets12, queries7)
    log("phase 12 %.1f s" % (time.time() - t))
    t = time.time()
    runqc_runs(workdir)
    log("phase 13 %.1f s" % (time.time() - t))
    # phase 14: the part pipeline
    t = time.time()
    launches14 = part_pipeline_run(dev, workdir, targets5, peak5)
    del targets5
    log("phase 14 %.1f s" % (time.time() - t))
    check_adapter_recheck(workdir, recheck10a)
    # phase 15: rows past the top anchor rung; then phase 3 at the wide
    # rungs' shapes against the side processes' plain versions
    t = time.time()
    launches15, *rungs15 = ultralong_run(dev, workdir, sides["ul-data"])
    log("phase 15 %.1f s" % (time.time() - t))
    t = time.time()
    check_wide_rungs(dev, workdir, [sides[n] for n in WIDE_SIDES], res)
    log("phase 3 at the wide rungs %.1f s" % (time.time() - t))

    log("total %.1f s" % (time.time() - t_all))
    # each kernel's launches on its own path: phase 5, the u64 B1's
    # phase 8, the run-time-ring B1s' small runs at w = 40, B5's phase 6
    launches["sketch_u64"] = launches8["sketch_u64"]
    launches["adapter_align"] = launches10a["adapter_align"]
    for name in ("sketch_ring", "sketch_ring_u64"):
        launches[name] = ring_launches[name]
    kernels = []
    for name, (src, rep) in SOURCES.items():
        r = res[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_us": r["bound_ms"] * 1e3, "bound_by": r["bound_by"],
                 "library_ms": None, "shape": r["shape"]}
        entry.update({key: val for key, val in r.items()
                      if key.startswith(("ms_", "plain_ms_", "bound_ms_",
                                         "plain_cpu_ms_", "kernel_alone_ms",
                                         "plan_ms", "upload_ms",
                                         "bytes_per_column"))})
        if name.startswith("sketch"):
            entry["resources"] = {
                "%d slots" % wm: v for (n, wm), v in sorted(resources.items())
                if n == name}
        if name.startswith("ext"):
            entry["resources"] = {
                arg: v for (n, arg), v in sorted(ext_resources.items())
                if n == name}
        if name == "pack_tile":
            entry["resources"] = {arg: v for (n, arg), v in pack_res.items()}
        if name in ONT_RUN["kernels"]:
            entry["device_ms_phase5"] = dev_ms[name]
        if name in HIFI_RUN["kernels"]:
            entry["launches_phase8"] = launches8[name]
            entry["device_ms_phase8"] = dev_ms8[name]
        if name in BIG_RUN["kernels"]:
            entry["launches_phase9"] = launches9[name]
        for phase, l10 in (("phase10a", launches10a),
                           ("phase10b", launches10b),
                           ("phase11", launches11),
                           ("batched_chainer", launches12),
                           ("plain_chainer", launches12_plain),
                           ("phase14", launches14),
                           ("phase15", launches15)):
            if name in l10:
                entry["launches_" + phase] = l10[name]
        if name in HPC_KERNELS:
            entry["launches_hpc_filter"] = hpc_launches[name]
        for phase, (rungs, path_bound) in (("phase5", rungs5),
                                           ("hpc_filter", rungs7),
                                           ("phase8", rungs8),
                                           ("phase15", rungs15)):
            if name in rungs:
                entry["launches_by_A_" + phase] = rungs[name]
                entry["path_bound_ms_" + phase] = path_bound[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


SIDE.update({"big-data": big_part_data, "adapters": adapter_recheck,
             "ul-data": ul_data})
SIDE.update({name: (lambda args: lambda workdir: wide_plain(workdir, *args))(
    args) for name, args in WIDE_SIDES.items()})

if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        sys.path.insert(0, HERE)
        sys.path.insert(0, os.path.join(HERE, "tests"))
        _parent = os.getppid()

        def _orphaned():          # the script was killed: stop too
            while os.getppid() == _parent:
                time.sleep(1)
            os._exit(1)
        import threading
        threading.Thread(target=_orphaned, daemon=True).start()
        SIDE[sys.argv[2]](sys.argv[3])
    else:
        main()

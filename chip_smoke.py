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
     its block-per-pair body for wider bands) from
     longqc_tpu_torch/csrc, the port's FASTA/FASTQ reader
     (csrc/fastx_native.cpp, g++ -O3) and its sdust recursion
     (csrc/sdust_native.cpp); the registers, stack frame and spills of
     every B1 instance (one more `nvcc -Xptxas -v` of csrc/sketch.cu
     alone)
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
     kernel's bound printed
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
     (the one-warp body) and W=64 and 255 (the wide body), and on the
     first 1,024 pairs at W=5,000, past every pair, where the wide body
     clamps each pair's band: extz and extd kernels against their plain
     version (the full band) on the same tensors, all eight outputs
     exact; 16 short pairs against the full-DP host reference
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
     queries; the part must take the hash-range build on the card (0
     host-only parts, 1 hash-range part), host-fixed rows <= 5%; then
     one more build_device_index over the same part, checked apart from
     the merge code: ih non-decreasing, its real entries the sum of the
     tiles' emission counts, the (rid, pos) multiset of 4,096 sampled
     hashes equal to the tiles' chunks', mid_occ the kth count of
     torch.unique_consecutive over ih; its peak device memory and its
     seconds (host packing, B1 plus chunks, the merge) printed
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
     the same reads; the mask stage and the adapter DP run once more,
     each alone on the card and timed, the mask rows equal to the run's.
     10b: every control-derived sampled read is marked in the spike-in
     table
Kernel launch counts are reset just before each path (phase 4's three
runs, phases 5, 6, 7, 8, 9, 10a, 10b) and read just after it. Each
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
    kernels=("sketch", "chain", "peak", "minrank"), range_rerun=True)
HIFI_RUN = dict(
    phase="phase 8", k=19, w=10, p=80, q=160, seed=1919, n_targets=6000,
    min_len=10000, max_len=20000, err=0.01, junk=0.02, prefix="hifi_",
    kernels=("sketch_u64", "chain", "peak", "minrank"))
# phase 9: a part of at least 1 Gbp at phase 5's settings
BIG_RUN = dict(
    phase="phase 9", k=12, w=5, p=160, q=160, seed=909, genome=110_000_000,
    n_targets=230_000, min_len=1000, max_len=8000, err=0.12, junk=0.1,
    min_bp=1_000_000_000, kernels=("sketch", "chain", "peak", "minrank"))
N_SAMPLED_HASHES = 4096

B1 = ("longqc_tpu_torch/csrc/sketch.cu",
      "longqc_tpu/ops/sketch_pallas.py:312")
SOURCES = {
    "sketch": B1, "sketch_u64": B1, "sketch_ring": B1, "sketch_ring_u64": B1,
    "chain": ("longqc_tpu_torch/csrc/chain.cu",
              "longqc_tpu/ops/chain_pallas.py:293"),
    "peak": ("longqc_tpu_torch/csrc/ringprop.cu",
             "longqc_tpu/ops/ringprop.py:116"),
    "minrank": ("longqc_tpu_torch/csrc/ringprop.cu",
                "longqc_tpu/ops/ringprop.py:137"),
    "extz": ("longqc_tpu_torch/csrc/extend.cu",
             "longqc_tpu/ops/extend_pallas.py:192"),
    "extd": ("longqc_tpu_torch/csrc/extend.cu",
             "longqc_tpu/ops/extend_pallas.py:192"),
    "extz_wide": ("longqc_tpu_torch/csrc/extend.cu",
                  "longqc_tpu/ops/extend_pallas.py:192"),
    "extd_wide": ("longqc_tpu_torch/csrc/extend.cu",
                  "longqc_tpu/ops/extend_pallas.py:192"),
}
HPC_KERNELS = ("chain", "peak", "minrank")
# CUDA kernel symbol prefix -> kernel name (the profiler's key); the B1
# variants are told apart by their template arguments (b1_variant)
SYMBOLS = {"lq_chain": "chain", "lq_peak": "peak", "lq_minrank": "minrank"}
HBM_BYTES_S = 3.35e12   # H100 SXM device memory
INT_OPS_S = 67e12       # 32-bit operations outside the tensor cores
# integer operations of the function per unit of work (see PERF.md)
OPS_PER_COLUMN = 30     # B1, plus 2 per ring slot (counted alike for
#                         32- and 64-bit hash words)
OPS_PER_AGE = 20        # B2, per predecessor the reference visits
OPS_PER_CELL = {"extz": 12, "extd": 18}   # B5, per band cell


def log(*a):
    print(*a, flush=True)


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


def sketch_resources():
    """Registers, stack frame and spill bytes of every B1 instance, from
    `nvcc -Xptxas -v` on csrc/sketch.cu alone with the extension's
    flags. {(variant, ring slots): {...}}, printed."""
    from longqc_tpu_torch.ops import _ext
    src = os.path.join(_ext.CSRC, "sketch.cu")
    with tempfile.TemporaryDirectory(prefix="longqc_ptxas_") as tmp:
        out = subprocess.run(
            [_ext.nvcc_path(), "-std=c++17", "-Xptxas=-v", "-c", src, "-o",
             os.path.join(tmp, "sketch.o")] + _ext.CUDA_FLAGS,
            capture_output=True, text=True)
    if out.returncode != 0:
        raise AssertionError("nvcc -Xptxas -v failed: %s" % out.stderr[-2000:])
    res, cur = {}, None
    for line in out.stderr.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            sym = m.group(1)
            wm = re.search(r"Li(\d+)E", sym)
            cur = (b1_variant(sym), int(wm.group(1))) if wm else None
            continue
        if cur is None or cur[0] is None:
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
    if len(res) != 12 or not all(len(v) == 4 for v in res.values()):
        raise AssertionError("expected 12 B1 instances in ptxas' output, "
                             "got %s" % sorted(res))
    for (name, wm), v in sorted(res.items()):
        log("B1 %s, %d ring slots: %d registers, %d bytes stack frame, "
            "spills %d / %d bytes (stores / loads)"
            % (name, wm, v["registers"], v["stack"], v["spill_stores"],
               v["spill_loads"]))
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


def check_ringprop(what, f, v, p, own, J, out, sfx):
    """B3 and B4 against their plain versions on (Q, A) rows, exact;
    times and bounds into out[name] as ms / plain_ms / bound_ms, each
    key suffixed with `sfx`."""
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
        t = time.time()
        want = plain(*args, J=J)
        torch.cuda.synchronize()
        pms = (time.time() - t) * 1e3
        err = require_equal("%s %s J=%d" % (name, what, J), got, want)
        ms = cuda_ms(lambda: kern(*args, J=J), 5)
        b_ms, b_by = bound(n_arrays * Q * A * 4, 0)
        log("%s %s Q=%d A=%d J=%d (%s): equal; kernel %.4f ms, plain %.3f "
            "ms, bound %.4f ms (%s)" % ("B3" if name == "peak" else "B4",
                                        name, Q, A, J, what, ms, pms, b_ms,
                                        b_by))
        o = out.setdefault(name, {})
        o["max_abs_err"] = max(err, o.get("max_abs_err", 0))
        o.update({"ms" + sfx: ms, "plain_ms" + sfx: pms,
                  "bound_ms" + sfx: b_ms})
        if not sfx:
            o.update(bound_by=b_by, shape="Q=%d A=%d" % (Q, A))


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
    target reads)."""
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
    return launches, dev_ms, (rungs, path_bound), targets


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


# (W, pairs) of phase 6: the one-warp body at W = 63, the wide body at
# W = 64 (the JAX default), 255 and 5,000 (past every pair: clamped)
EXT_RUNS = ((63, 8192), (64, 8192), (255, 8192), (5000, 1024))


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


def big_part_run(dev, workdir):
    """Phase 9: mmcov through cli.main on a >= 1 Gbp part, then one more
    build_device_index over the same part, checked apart from the merge
    code. Returns the mmcov run's launch counts."""
    import numpy as np
    import torch
    from util_synth import make_genome_fast, sample_reads_fast
    from longqc_tpu_torch import cli
    from longqc_tpu_torch.engine import device_index as di
    from longqc_tpu_torch.ops import _ext

    run = BIG_RUN
    phase, k, w = run["phase"], run["k"], run["w"]
    t = time.time()
    rng = np.random.RandomState(run["seed"])
    genome = make_genome_fast(rng, run["genome"])
    targets = sample_reads_fast(rng, genome, run["n_targets"],
                                min_len=run["min_len"],
                                max_len=run["max_len"], err=run["err"],
                                junk_frac=run["junk"])
    del genome
    queries = targets[:N_QUERIES]
    tpath = os.path.join(workdir, "big_targets.fa")
    qpath = os.path.join(workdir, "big_queries.fq")
    stats_path = os.path.join(workdir, "big_stats.json")
    write_fasta(tpath, targets)
    write_fastq(qpath, queries)
    tbp = sum(len(r[1]) for r in targets)
    log("%s data: %d targets of %d-%d bp (%d bp, %.2fx of %d bp), err "
        "%.2f, junk %.2f, %d queries, made in %.1f s"
        % (phase, run["n_targets"], run["min_len"], run["max_len"], tbp,
           tbp / run["genome"], run["genome"], run["err"], run["junk"],
           N_QUERIES, time.time() - t))
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
    idx = di.build_device_index(targets, k, w, device=dev, on_chunk=sample)
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
           json.dumps({key: round(v, 3) for key, v in idx["build_s"].items()}),
           build_peak, held, build_peak / 1e9, build_peak / tbp,
           idx["reckoned_bytes"]))
    if idx["n_ranges"] < 2:
        raise AssertionError("%s: the index was not built by hash range"
                             % phase)
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


def sampleqc_run(dev, workdir, tag, reads, preset, missing):
    """`sampleqc -x preset` on `reads` through cli.main on the card, and
    the checks every phase-10 run shares. Returns (launches, the output
    directory, the QC JSON, the stats, the sampled reads)."""
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
            "--stats", stats_path] + (["--no-report"] if missing else [])
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
    log("sampleqc -x %s -o %s --device %s --stats %s%s %s" % (
        preset, os.path.basename(out), dev, os.path.basename(stats_path),
        " --no-report" if missing else "", os.path.basename(fq)))
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
    5' adapter planted on N_ADAPTER of them; the adapter statistics
    against cut_adapter with CPU tensors on the same reads; then the
    mask stage and the adapter DP once more, each alone on the card (in
    the run the mask stage shares the interpreter with the adapter
    search), the mask rows against the run's table."""
    import numpy as np
    import torch
    from longqc_tpu_torch import config as C
    from longqc_tpu_torch.engine.masking import mask_table_rows
    from longqc_tpu_torch.ops.adapter import adapter_dists, cut_adapter

    preset = C.PRESETS["ont-ligation"]
    step = len(targets) // N_ADAPTER
    reads = [[n, preset.adp5 + s, "5" * len(preset.adp5) + q]
             if i % step == 0 else [n, s, q]
             for i, (n, s, q) in enumerate(targets)]
    launches, out, qc, stats, _ = sampleqc_run(dev, workdir, "10a", reads,
                                               "ont-ligation", missing)
    t = time.time()
    t5, t3 = cut_adapter([list(r) for r in reads], adp_t=preset.adp5,
                         adp_b=preset.adp3,
                         th=C.ADAPTER_IDENTITY_THRESHOLD,
                         length=C.ADAPTER_SEARCH_LENGTH, device="cpu")
    got5 = qc.get("Stats_for_adapter5", {})
    got3 = qc.get("Stats_for_adapter3", {})
    want5 = {"Num_of_trimmed_reads_5": t5[1], "Max_identity_adp5": t5[0],
             "Average_position_from_5_end": float(np.mean(t5[2]))}
    log("phase 10a adapters: 5' %s, 3' %s; cut_adapter on CPU tensors: "
        "5' %s, 3' trimmed %d, max identity %.4f (%.1f s)" % (
            json.dumps(got5), json.dumps(got3), json.dumps(want5), t3[1],
            t3[0], time.time() - t))
    if got5 != want5 or t5[1] < N_ADAPTER:
        raise AssertionError("phase 10a: the 5' adapter statistics differ "
                             "from cut_adapter's on CPU tensors")
    if t3[0] >= C.ADAPTER_IDENTITY_THRESHOLD and (
            got3.get("Num_of_trimmed_reads_3") != t3[1]
            or got3.get("Max_identity_adp3") != t3[0]):
        raise AssertionError("phase 10a: the 3' adapter statistics differ "
                             "from cut_adapter's on CPU tensors")

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
    return launches


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

    # --- phase 2: build
    t = time.time()
    mod = _ext.lib(verbose=True)
    log("built %s in %.1f s" % (os.path.relpath(mod.__file__, HERE),
                                time.time() - t))
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
    t = time.time()
    resources = sketch_resources()
    log("B1 resources read in %.1f s" % (time.time() - t))

    # --- phase 3: kernels vs plain versions
    t = time.time()
    res = check_sketch_variants(dev)
    log("phase 3, B1: %.1f s" % (time.time() - t))
    res.update(check_chain_ringprop(dev, 12))

    # --- phase 4: small end to end; at w = 40 the run-time-ring B1
    # variants sketch the index tiles and the queries
    small_end_to_end(dev)
    ring_launches = {}
    for k in (12, 19):
        ring_launches.update(small_end_to_end(dev, k=k, w=40, err=0.04))

    # --- phase 5: realistic mmcov run; phase 6: B5; phase 7: HPC filter;
    # phase 8: the pb-hifi fast preset
    workdir = tempfile.mkdtemp(prefix="longqc_smoke_")
    try:
        t = time.time()
        launches, dev_ms, rungs5, targets5 = realistic_mmcov(dev, workdir,
                                                             ONT_RUN)
        log("phase 5 %.1f s" % (time.time() - t))
        t = time.time()
        ext_res, ext_launches = check_extend(dev)
        res.update(ext_res)
        launches.update(ext_launches)
        log("phase 6 %.1f s" % (time.time() - t))
        t = time.time()
        hpc_launches, rungs7, queries7 = hpc_filter_run(dev, workdir)
        log("phase 7 %.1f s" % (time.time() - t))
        t = time.time()
        launches8, dev_ms8, rungs8, _ = realistic_mmcov(dev, workdir,
                                                        HIFI_RUN)
        log("phase 8 %.1f s" % (time.time() - t))
        t = time.time()
        launches9 = big_part_run(dev, workdir)
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
        launches10a = sampleqc_ont(dev, workdir, targets5, missing)
        del targets5
        log("phase 10a %.1f s" % (time.time() - t))
        t = time.time()
        launches10b = sampleqc_pb(dev, workdir, queries7, missing)
        log("phase 10b %.1f s" % (time.time() - t))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log("total %.1f s" % (time.time() - t_all))
    # each kernel's launches on its own path: phase 5, the u64 B1's
    # phase 8, the run-time-ring B1s' small runs at w = 40, B5's phase 6
    launches["sketch_u64"] = launches8["sketch_u64"]
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
                                         "kernel_alone_ms", "plan_ms"))})
        if name.startswith("sketch"):
            entry["resources"] = {
                "%d slots" % wm: v for (n, wm), v in sorted(resources.items())
                if n == name}
        if name in ONT_RUN["kernels"]:
            entry["device_ms_phase5"] = dev_ms[name]
        if name in HIFI_RUN["kernels"]:
            entry["launches_phase8"] = launches8[name]
            entry["device_ms_phase8"] = dev_ms8[name]
        if name in BIG_RUN["kernels"]:
            entry["launches_phase9"] = launches9[name]
        for phase, l10 in (("phase10a", launches10a),
                           ("phase10b", launches10b)):
            if name in l10:
                entry["launches_" + phase] = l10[name]
        if name in HPC_KERNELS:
            entry["launches_hpc_filter"] = hpc_launches[name]
        for phase, (rungs, path_bound) in (("phase5", rungs5),
                                           ("hpc_filter", rungs7),
                                           ("phase8", rungs8)):
            if name in rungs:
                entry["launches_by_A_" + phase] = rungs[name]
                entry["path_bound_ms_" + phase] = path_bound[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

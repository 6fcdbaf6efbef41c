"""sampleqc pipeline orchestration (command_sample equivalent; port of
longqc_tpu/engine/pipeline).

Reproduces the reference's sampleqc flow (longQC.py:66-865) as named
stages, in the JAX package's order:
  1. chunk QC: chunked streaming of the input with per-chunk masking
     (sdust table), adapter search, reservoir subsampling and GC
     accumulation; with -d, the index prefetch on a thread beside it
     (target parts grouped, each part's host index persisted as npz);
  2. sample exclusion: highly-masked sampled reads are replaced;
  3. overlap: the all-vs-sample run (engine/overlap, kernels B1-B4);
  4. spike-in: the PacBio spike-in-control filter run;
  5. analytics: length, GC, coverage fits -> the QC JSON;
  6. report: the 8 figures and the HTML report.
Every stage runs its torch work on the given device (default the card;
no stage drops to the CPU on its own). The tables are read into numpy
columns, so the QC values need neither pandas nor matplotlib; the
report stage needs matplotlib and jinja2, which `report=False` skips.

Known divergence from the reference: its adapter trimming mutates reads
inside a pickled pool-worker copy, so the main-process stream (and the
-c trim output) is effectively untrimmed; here -c writes genuinely
trimmed copies while the analysis stream stays untrimmed to match the
reference's downstream inputs.
"""

import concurrent.futures as cf
import copy
import dataclasses
import importlib.util
import json
import logging
import os
from collections import OrderedDict

import numpy as np

from longqc_tpu_torch import config as C
from longqc_tpu_torch import tracing
from longqc_tpu_torch.engine import overlap_host as oh
from longqc_tpu_torch.engine.masking import MaskAccumulator
from longqc_tpu_torch.engine.overlap import overlap_run_device as overlap_run
from longqc_tpu_torch.io import native
from longqc_tpu_torch.io.fastx import (guess_format, open_seq_chunk,
                                       iter_fastx, reader_name, write_fastq,
                                       FORMAT_BAM, FORMAT_SAM, FORMAT_FASTA,
                                       FORMAT_FAST5, FORMAT_UNKNOWN)
from longqc_tpu_torch.io.sampling import subsample_from_chunk
from longqc_tpu_torch.io.stats import get_N50
from longqc_tpu_torch.ops import sdust
from longqc_tpu_torch.ops._ext import require_device
from longqc_tpu_torch.ops.adapter import cut_adapter
from longqc_tpu_torch.ops.distfit import estimate_gamma_dist
from longqc_tpu_torch.ops.gc import GCAccumulator
from longqc_tpu_torch.report import plots
from longqc_tpu_torch.report.coverage import CoverageAnalytics, \
    read_table_rows
from longqc_tpu_torch.report.html import render_report, enc_b64_str
from longqc_tpu_torch.tracing import span

logger = logging.getLogger(__name__)

CONTROL_REFS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "refs")
# what the report stage imports (figures, HTML)
REPORT_MODULES = ("matplotlib", "jinja2")


def _control_ref_path(sequel):
    name = ("Sequel_control_reference.fasta" if sequel
            else "RS2_control_reference.fasta")
    return os.path.abspath(os.path.join(CONTROL_REFS_DIR, name))


def missing_report_modules():
    """The report stage's modules that are not installed."""
    return [m for m in REPORT_MODULES if importlib.util.find_spec(m) is None]


class _Paths:
    """The output layout of one run (the reference's names)."""

    def __init__(self, out_dir, suffix):
        self.sfx = ("_" + suffix) if suffix else ""
        self.analysis = os.path.join(out_dir, "analysis")
        self.mm2 = os.path.join(self.analysis, "minimap2")
        self.figs = os.path.join(out_dir, "figs")
        self.logs = os.path.join(out_dir, "logs")
        self.cov = os.path.join(self.mm2, "coverage_out%s.txt" % self.sfx)
        self.control = os.path.join(self.mm2,
                                    "spiked_in_control%s.txt" % self.sfx)
        self.sample = os.path.join(self.analysis,
                                   "subsample%s.fastq" % self.sfx)
        self.short_sample = os.path.join(
            self.analysis, "short_subsample%s.fastq" % self.sfx)
        self.json = os.path.join(out_dir,
                                 "QC_vals_longQC_sampleqc%s.json" % self.sfx)
        self.html = os.path.join(out_dir, "web_summary%s.html" % self.sfx)
        self.log = os.path.join(self.logs,
                                "log_longQC_sampleqc%s.txt" % self.sfx)

    def fig(self, tag):
        return os.path.join(self.figs, "fig_longQC_sampleqc_%s%s.png"
                            % (tag, self.sfx))


def run_sampleqc(input_path, out_dir, preset_name, *, nsample=5000,
                 transcript=False, suffix=None, trim_out=None,
                 adp5=None, adp3=None, fast=False, mem=0.5,
                 index_size="4G", short=False, db=False, ncpu=4,
                 force_pb=None, force_sequel=None, force_ont=None,
                 device="cuda", report=True, stats=None):
    """Run sample QC. Returns the JSON dict of QC values.

    db: the -d/--db flag: group the target reads into index parts and
    build and persist each part's host index (npz) on a thread beside
    the chunk-QC loop; the overlap then runs from those parts (not for
    BAM / FAST5 input, as in the reference).
    ncpu: advisory host-thread budget (-p; the reference spends these on
    subprocess pools; here stages are in-process device programs).
    force_pb/force_sequel/force_ont: the hidden expert flags
    (longQC.py:942-947) overriding the preset's platform markers.
    device: the torch device of every stage (default the card; raises
    when there is none).
    report: draw the 8 figures and render the HTML (needs matplotlib and
    jinja2); False stops after the QC JSON.
    stats: a dict that receives the run's spans (`spans`: per span name
    its count and its wall, self and thread CPU seconds, and the run's
    counters; longqc_tpu_torch/tracing.py names them), each stage's
    seconds read from those spans (`stage_s`; within the chunk loop,
    `mask` ran on a worker thread beside `adapter_sample_gc`, and
    `mask_wait` is what the loop waited), the overlap engine's counters
    and spans (`overlap`, `spike_in`), which reader and sdust recursion
    ran (`reader`, `sdust`) and, with db, the prefetch thread's seconds,
    the overlap's wait to join it and its parts (`prefetch`). When
    torch.profiler is recording as the call starts, `span_log` holds
    every span's interval from every thread, on the profiler's clock.
    """
    if not os.path.exists(input_path):
        raise FileNotFoundError(input_path)
    if not 0 < nsample <= C.MAX_N_SAMPLE:
        raise ValueError("n_sample out of range")
    if os.path.exists(out_dir):
        raise FileExistsError("output path %s already exists" % out_dir)
    missing = missing_report_modules() if report else []
    if missing:
        raise ImportError("the report stage needs %s (not installed); run "
                          "with report=False (--no-report) for the QC JSON "
                          "alone" % ", ".join(missing))
    device = require_device(device)
    stats = {} if stats is None else stats
    try:
        with tracing.run(stats, "sampleqc") as scope:
            return _sampleqc(input_path, out_dir, preset_name, nsample,
                             transcript, suffix, trim_out, adp5, adp3,
                             fast, mem, index_size, short, db, force_pb,
                             force_sequel, device, report, stats)
    finally:
        stats["stage_s"] = tracing.legacy(scope.fold, STAGE_SPANS)
        if "prefetch" in stats:
            stats["prefetch"].update(tracing.legacy(scope.fold,
                                                    PREFETCH_SPANS))


# stats["stage_s"] and stats["prefetch"]: each key's span names
STAGE_SPANS = {"chunk_loop": ("stage.chunk_loop",),
               "adapter_sample_gc": ("chunk.adapter_sample_gc",),
               "adapter": ("chunk.adapter",), "mask": ("mask.chunk",),
               "mask_wait": ("chunk.mask_wait",),
               "exclusion": ("stage.exclusion",),
               "overlap": ("stage.overlap",),
               "spike_in": ("stage.spike_in",),
               "analytics": ("stage.analytics",),
               "report": ("stage.report",)}
PREFETCH_SPANS = {"thread_s": ("prefetch.run",),
                  "join_wait_s": ("prefetch.join",)}


def _sampleqc(input_path, out_dir, preset_name, nsample, transcript, suffix,
              trim_out, adp5, adp3, fast, mem, index_size, short, db,
              force_pb, force_sequel, device, report, stats):
    preset = C.PRESETS[preset_name]
    if force_pb or force_sequel:
        # reference semantics: the preset table only SETS these markers
        # (longQC.py:174-214), so expert flags are additive; --ont has
        # no live effect in the reference either (":474" is commented)
        preset = dataclasses.replace(
            preset, pb=preset.pb or bool(force_pb),
            sequel=preset.sequel or bool(force_sequel))
    adp5 = adp5 or preset.adp5
    adp3 = adp3 or preset.adp3

    paths = _Paths(out_dir, suffix)
    for d in (paths.mm2, paths.figs, paths.logs):
        os.makedirs(d, exist_ok=True)

    fh = logging.FileHandler(paths.log, "w")
    fh.setFormatter(logging.Formatter(
        "%(module)s:%(asctime)s:%(lineno)d:%(levelname)s:%(message)s"))
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(fh)
    try:
        file_format_code = guess_format(input_path)
        if file_format_code in (FORMAT_UNKNOWN, FORMAT_SAM):
            raise ValueError("unsupported input format")
        fastx_path = input_path
        if file_format_code in (FORMAT_BAM, FORMAT_FAST5):
            fastx_path = os.path.join(
                paths.analysis, "converted_seq_file%s.fastq" % paths.sfx)
        logger.info("sampleqc started: %s preset=%s device=%s", input_path,
                    preset_name, device)

        prefetcher = None
        if db and file_format_code not in (FORMAT_BAM, FORMAT_FAST5):
            prefetcher = _IndexPrefetcher.for_sample(
                input_path, preset, fast, index_size, short, paths, device)
            prefetcher.start()
            logger.info("index prefetch started (-d): %d spec(s)",
                        len(prefetcher.specs))

        with span("stage.chunk_loop"):
            cq = _chunk_qc(input_path, file_format_code, fastx_path, paths,
                           suffix, nsample, mem, adp5, adp3, trim_out,
                           device)
        # which FASTA/FASTQ reader and which sdust recursion ran
        stats["reader"] = dict(native.BUILD, name=reader_name())
        stats["sdust"] = dict(sdust.NATIVE_BUILD, name=sdust.sdust_impl())

        with span("stage.exclusion"):
            mask = MaskTable(cq["mask_path"])
            s_reads, ss_reads, s_n_seqs = _exclude_masked(
                cq["s_reads"], mask, input_path, file_format_code, short,
                paths)

        with span("stage.overlap"):
            targets = (fastx_path if file_format_code in
                       (FORMAT_BAM, FORMAT_FAST5) else input_path)
            rows = _overlap(targets, s_reads, ss_reads, preset, fast,
                            index_size, short, device, paths, stats,
                            prefetcher)

        with span("stage.spike_in"):
            control_rows = (_spike_in(s_reads, ss_reads, preset, short,
                                      device, paths, stats)
                            if preset.pb else None)

        with span("stage.analytics"):
            qc = _analytics(cq, mask, rows, control_rows, preset,
                            transcript, adp5, adp3, device)
            with open(paths.json, "w") as f:
                json.dump(qc["json"], f, indent=4)

        if report:
            with span("stage.report"):
                _report(cq, mask, qc, preset, suffix, paths, s_n_seqs,
                        file_format_code, adp5, adp3, transcript)
        logger.info("finished all processes.")
    finally:
        root_logger_cleanup(fh)
    return qc["json"]


# ---------------------------------------------------------------------------
# stage 1: chunk QC


def _chunk_qc(input_path, file_format_code, fastx_path, paths, suffix,
              nsample, mem, adp5, adp3, trim_out, device):
    """Stream the input in chunks: the mask table, the adapter search,
    the reservoir sample and the GC accumulation.

    The reference overlaps its chunk stages with worker pools:
    adapter-cut and subsample ride Pool(2).apply_async
    (longQC.py:280,314-341) and sdust a Pool of <= 10 subprocesses
    (lq_mask.py:41,110). Same overlap here with threads: the next
    chunk's parse prefetches on a reader thread while the current chunk
    computes, and the masking stage (device screen + exact host
    recursion for flagged reads, on the device passed to the
    accumulator) runs on the `mask` thread concurrently with the adapter
    search / reservoir sampling / GC stages."""
    lm = MaskAccumulator(paths.analysis, suffix=suffix or "", device=device)
    lg = GCAccumulator(chunk_size=150, device=device)
    cq = {"num_trim5": 0, "num_trim3": 0, "max_iden_adp5": 0.0,
          "max_iden_adp3": 0.0, "adp_pos5": [], "adp_pos3": [], "lg": lg,
          "mask_path": lm.get_outfile_path()}
    cum_n_seq = 0
    s_reads = []
    n_seqs = n_bases = 0
    chunk_n = 0
    mask_chunk = tracing.carry("mask", lm.add_chunk)

    chunk_iter = _prefetch_iter(open_seq_chunk(
        input_path, file_format_code,
        chunk_size=int(mem * 1024 ** 3), is_upper=True))
    try:
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            for (reads, n_seqs, n_bases) in chunk_iter:
                if file_format_code in (FORMAT_BAM, FORMAT_FAST5):
                    write_fastq(fastx_path, reads, is_chunk=True)
                logger.info("chunk %d: %d reads", chunk_n, len(reads))
                with span("chunk.adapter_sample_gc"):
                    mask_fut = pool.submit(mask_chunk, reads)
                    with span("chunk.adapter"):
                        if adp5 or adp3:
                            _adapter_chunk(reads, adp5, adp3, trim_out,
                                           device, cq)
                    with span("chunk.subsample"):
                        s_reads = subsample_from_chunk(
                            reads, cum_n_seq, s_reads, nsample,
                            s_seed=C.SUBSAMPLE_SEED)
                    with span("chunk.gc"):
                        lg.add_batch(_pack(reads))
                with span("chunk.mask_wait"):
                    mask_fut.result()
                chunk_n += 1
                cum_n_seq = n_seqs
    finally:
        lm.close()
    logger.info("parsed input. #seqs:%d #bases:%d", n_seqs, n_bases)
    cq["s_reads"] = s_reads
    return cq


def _adapter_chunk(reads, adp5, adp3, trim_out, device, cq):
    """The adapter search of one chunk; trims copies of the reads (the
    analysis stream stays untrimmed) and adds to the tallies in cq."""
    trim_reads = ([copy.copy(r) for r in reads] if trim_out else reads)
    work = trim_reads if trim_out else \
        [list(r) for r in reads]  # search copies: stream stays
    res = cut_adapter(work, adp_t=adp5, adp_b=adp3,
                      th=C.ADAPTER_IDENTITY_THRESHOLD,
                      length=C.ADAPTER_SEARCH_LENGTH, device=device)
    if adp5 and adp3:
        t5, t3 = res
    elif adp5:
        t5, t3 = res, None
    else:
        t5, t3 = None, res
    if trim_out:
        write_fastq(trim_out, work, is_chunk=True)
    for side, t in (("5", t5), ("3", t3)):
        if t:
            if t[0] > cq["max_iden_adp" + side]:
                cq["max_iden_adp" + side] = t[0]
            cq["num_trim" + side] += t[1]
            cq["adp_pos" + side].extend(t[2])


# ---------------------------------------------------------------------------
# stage 2: sample exclusion


class MaskTable:
    """The 6 columns of the sdust table (sdust.c:211-217) as numpy
    arrays: name, masked length, length, masked fraction, meanQ, nQ7."""

    def __init__(self, path):
        cols = read_table_rows(path)
        self.name = np.array(cols[0], dtype=object)
        self.masked = np.array(cols[1], dtype=np.int64)
        self.length = np.array(cols[2], dtype=np.int64)
        self.frac = np.array(cols[3], dtype=np.float64)
        self.meanq = np.array(cols[4], dtype=np.float64)
        self.nq7 = np.array(cols[5], dtype=np.int64)


def _exclude_masked(s_reads, mask, input_path, file_format_code, short,
                    paths):
    """Replace sampled reads that the mask rules exclude (longQC.py:
    372-404) and write the subsample. -> (s_reads, short reads, number
    of sampled reads)."""
    exclude = mask.name[(mask.length > C.MASK_EXCLUDE_LEN_1)
                        & (mask.frac > C.MASK_EXCLUDE_FRAC_1)].tolist()
    exclude += mask.name[(mask.length > C.MASK_EXCLUDE_LEN_2)
                         & (mask.frac > C.MASK_EXCLUDE_FRAC_2)].tolist()

    s_reads = [r for r in s_reads if r != 0]
    ng_set = set(exclude)
    ng_idx = [i for i, r in enumerate(s_reads) if r[0] in ng_set]
    if ng_idx:
        logger.info("replacing %d masked sampled reads", len(ng_idx))
        for r in s_reads:
            ng_set.add(r[0])
        temp = [0] * len(ng_idx)
        j = 0
        for (reads, cn, _cb) in open_seq_chunk(
                input_path, file_format_code,
                chunk_size=int(0.1 * 1024 ** 3)):
            subsample_from_chunk(reads, j, temp, len(ng_idx),
                                 elist=ng_set, s_seed=C.SUBSAMPLE_SEED)
            j = cn
            if len([t for t in temp if t]) >= len(ng_idx):
                break
        if len([t for t in temp if t]) < len(ng_idx):
            logger.warning("replacement failed; dropping masked samples")
            for i in ng_idx:
                s_reads[i] = 0
            s_reads = [r for r in s_reads if r]
        else:
            for i, t in enumerate(temp):
                s_reads[ng_idx[i]] = t

    s_n_seqs = len([r for r in s_reads if r])
    ss_reads = []
    if short:
        # -b/--short: reads under the length threshold map with a more
        # sensitive setting and are merged back (longQC.py:107-112,
        # 409-415, 528-550)
        ss_reads = [r for r in s_reads
                    if r and len(r[1]) < C.SHORT_LENGTH_THRESHOLD]
        s_reads = [r for r in s_reads
                   if r and len(r[1]) >= C.SHORT_LENGTH_THRESHOLD]
        if ss_reads:
            write_fastq(paths.short_sample, ss_reads)
    write_fastq(paths.sample, s_reads)
    logger.info("subsample written: %d reads", s_n_seqs)
    return s_reads, ss_reads, s_n_seqs


# ---------------------------------------------------------------------------
# stages 3 and 4: the overlap and the spike-in filter run


def _overlap(targets, s_reads, ss_reads, preset, fast, index_size, short,
             device, paths, stats, prefetcher=None):
    """All reads against the sample -> the coverage rows (written). With
    a prefetcher (-d), its parts and npz caches."""
    cfg = C.overlap_config_for_sample(preset, fast=fast,
                                      index_size=index_size)
    logger.info("overlap computation started")
    parts = cache = None
    if prefetcher is not None:
        with span("prefetch.join"):
            parts = prefetcher.join()
        # its seconds (thread_s, join_wait_s) are added from the spans
        stats["prefetch"] = {"parts": len(parts),
                             "caches": [p for _k, _w, p in prefetcher.specs]}
        cache = prefetcher.cache_for(cfg.index.k, cfg.index.w)
        logger.info("index prefetch joined: %d part(s)", len(parts))
    stats["overlap"] = {}
    rows = overlap_run(_read_stream(targets), s_reads, cfg, device=device,
                       stats=stats["overlap"], parts=parts,
                       index_cache=cache)
    if short and ss_reads:
        scfg = C.overlap_config_for_sample(preset, fast=fast,
                                           index_size=index_size,
                                           short=True)
        scache = (prefetcher.cache_for(scfg.index.k, scfg.index.w)
                  if prefetcher is not None else None)
        stats["overlap_short"] = {}
        rows = rows + overlap_run(_read_stream(targets), ss_reads, scfg,
                                  device=device,
                                  stats=stats["overlap_short"],
                                  parts=parts, index_cache=scache)
    with open(paths.cov, "w") as f:
        f.write("\n".join(rows) + "\n")
    logger.info("overlap computation finished")
    return rows


def _spike_in(s_reads, ss_reads, preset, short, device, paths, stats):
    """The PacBio spike-in-control filter run against the port's control
    reference -> its rows (written), or None without a reference."""
    ref_path = _control_ref_path(preset.sequel)
    control_reads = [[n, s, "!" * len(s)]
                     for n, s, _q in iter_fastx(ref_path)] \
        if os.path.exists(ref_path) else []
    if not control_reads:
        return None
    fcfg = C.overlap_config_for_filter()
    stats["spike_in"] = {}
    control_rows = overlap_run(list(control_reads), s_reads, fcfg,
                               device=device, stats=stats["spike_in"])
    if short and ss_reads:
        control_rows = control_rows + overlap_run(
            list(control_reads), ss_reads, fcfg, device=device)
    with open(paths.control, "w") as f:
        f.write("\n".join(control_rows) + "\n")
    return control_rows


# ---------------------------------------------------------------------------
# stage 5: analytics


def _analytics(cq, mask, rows, control_rows, preset, transcript, adp5,
               adp3, device):
    """Length, GC and coverage statistics -> {"json": the QC JSON dict,
    and what the report stage draws from}."""
    nonsense_err = C.NONSENSE_READ_ERROR_THRESHOLD
    nonsense_warn = C.NONSENSE_READ_WARN_THRESHOLD
    if preset.pb:
        nonsense_err = C.NONSENSE_READ_ERROR_THRESHOLD_PB
        nonsense_warn = C.NONSENSE_READ_WARN_THRESHOLD_PB
    gc_read_mean, gc_read_sd = cq["lg"].read_mean_sd()
    q7 = int(np.sum(mask.nq7))
    lengths = mask.length
    throughput = int(np.sum(lengths))
    longest = int(np.max(lengths))
    mean_len = float(np.mean(lengths))
    n50 = float(get_N50(lengths))
    g_a, g_b = estimate_gamma_dist(lengths)
    interval = n50 / 2 if n50 < 3000 else 3000.0

    lc = CoverageAnalytics(rows, is_transcript=bool(transcript),
                           control_filtering=control_rows, device=device)
    lc.check_length_coverage(interval=interval)

    very_low_coverage_mode = False
    if lc.is_no_coverage():
        pass
    elif ((transcript and float(lc.get_logn_mode() or 0)
           < C.VERY_LOW_COVERAGE_THRESHOLD)
          or (lc.is_low_coverage() and float(lc.get_logn_mode() or 0)
              < C.VERY_LOW_COVERAGE_THRESHOLD)
          or (lc.get_mean() is not None
              and float(lc.get_mean()) < C.VERY_LOW_COVERAGE_THRESHOLD)):
        very_low_coverage_mode = True
        if preset.pb:
            nonsense_err = C.NONSENSE_READ_ERROR_THRESHOLD_VERY_LOW_COV
            nonsense_warn = C.NONSENSE_READ_WARN_THRESHOLD_VERY_LOW_COV

    tobe_json = {
        "Yield": throughput,
        "Q7 bases": "%.2f%%" % (100 * q7 / throughput),
        "Longest_read": longest,
        "Num_of_reads": len(lengths),
        "Length_stats": {
            "gamma_params": [float(g_a), float(g_b)],
            "Mean_read_length": mean_len,
            "N50_read_length": n50,
        },
        "GC_stats": {
            "Mean_GC_content": float(gc_read_mean),
            "SD_GC_content": float(gc_read_sd),
        },
    }
    iden5, iden3 = cq["max_iden_adp5"], cq["max_iden_adp3"]
    if adp5 and iden5 >= C.ADAPTER_IDENTITY_THRESHOLD:
        tobe_json["Stats_for_adapter5"] = {
            "Num_of_trimmed_reads_5": cq["num_trim5"],
            "Max_identity_adp5": iden5,
            "Average_position_from_5_end": float(np.mean(cq["adp_pos5"])),
        }
    if adp3 and iden3 >= C.ADAPTER_IDENTITY_THRESHOLD:
        tobe_json["Stats_for_adapter3"] = {
            "Num_of_trimmed_reads_3": cq["num_trim3"],
            "Max_identity_adp3": iden3,
            "Average_position_from_3_end": float(np.mean(cq["adp_pos3"])),
        }
    cov_stats = {"Estimated non-sense read fraction":
                 float(lc.get_unmapped_med_frac())}
    if lc.get_control_frac():
        cov_stats["Estimated spiked-in control read fraction"] = \
            float(lc.get_control_frac())
    if transcript or lc.is_low_coverage():
        cov_stats["Mode_coverage"] = float(lc.get_logn_mode())
        cov_stats["mu_coverage"] = float(lc.get_logn_mu())
        cov_stats["sigma_coverage"] = float(lc.get_logn_sigma())
    elif lc.is_no_coverage():
        cov_stats["Mean_coverage"] = "NA"
        cov_stats["SD_coverage"] = "NA"
    else:
        cov_stats["Mean_coverage"] = float(lc.get_mean())
        cov_stats["SD_coverage"] = float(lc.get_sd())
    cov_stats["Estimated crude Xome size"] = str(
        lc.calc_xome_size(throughput))
    tobe_json["Coverage_stats"] = cov_stats
    return {"json": tobe_json, "lc": lc, "q7": q7, "lengths": lengths,
            "throughput": throughput, "longest": longest,
            "mean_len": mean_len, "n50": n50, "gamma": (g_a, g_b),
            "interval": interval, "nonsense": (nonsense_warn, nonsense_err),
            "very_low_cov": very_low_coverage_mode}


# ---------------------------------------------------------------------------
# stage 6: report


def _report(cq, mask, qc, preset, suffix, paths, s_n_seqs,
            file_format_code, adp5, adp3, transcript):
    """The 8 figures and the HTML report."""
    lc, n50 = qc["lc"], qc["n50"]
    adp_pos5, adp_pos3 = cq["adp_pos5"], cq["adp_pos3"]
    plots.plot_unmasked_gc_frac(cq["lg"], fp=paths.fig("gcfrac"))
    plots.plot_qscore_dist(mask.meanq, mask.length,
                           interval=n50 / 2 if n50 < 3000 else 3000,
                           fp=paths.fig("average_qv"))
    plots.plot_masked_fraction(mask.frac, fp=paths.fig("masked_region"))
    g_a, g_b = qc["gamma"]
    plots.plot_length_dist(paths.fig("length"), qc["lengths"], g_a, g_b,
                           qc["longest"], qc["mean_len"], n50,
                           bool(preset.pb))
    lc.plot_coverage_dist(paths.fig("coverage"))
    lc.plot_unmapped_frac_terminal(
        paths.fig("terminal_analysis"),
        adp5_pos=(float(np.mean(adp_pos5))
                  if adp5 and adp_pos5 and np.mean(adp_pos5) > 0 else None),
        adp3_pos=(float(np.mean(adp_pos3))
                  if adp3 and adp_pos3 and np.mean(adp_pos3) > 0 else None))
    lc.plot_qscore_dist(paths.fig("olp_qv"))
    lc.plot_length_vs_coverage(paths.fig("coverage_over_read_length"),
                               interval=qc["interval"])
    nonsense_warn, nonsense_err = qc["nonsense"]
    root = _build_root_dict(
        qc["json"], lc, preset, suffix, paths.fig, s_n_seqs,
        qc["throughput"], qc["q7"], qc["lengths"], qc["mean_len"], n50,
        qc["longest"], file_format_code, adp5, adp3, cq["max_iden_adp5"],
        cq["max_iden_adp3"], cq["num_trim5"], cq["num_trim3"], adp_pos5,
        adp_pos3, nonsense_warn, nonsense_err, qc["very_low_cov"],
        transcript)
    render_report(root, paths.html)


class _IndexPrefetcher:
    """The -d/--db flow: stream the target reads, group them into index
    parts, and build and persist each part's host MinimizerIndex as npz,
    on a thread beside the chunk-QC loop (the reference's
    `LqExec(minimap2-coverage -d tempdb)`, longQC.py:266-277; the cache
    format is npz instead of MMI), in the run's `prefetch` spans. The
    indexes sketch on the given device."""

    def __init__(self, input_path, specs, batch_size, device):
        self.input_path = input_path
        self.specs = specs            # [(k, w, cache_prefix), ...]
        self.batch_size = batch_size
        self.device = device
        self.parts = None
        self.error = None
        self.seconds = None           # the thread's wall time (its span)
        self._thread = None

    @classmethod
    def for_sample(cls, input_path, preset, fast, index_size, short, paths,
                   device):
        """One spec per distinct (k, w) of the run: the main overlap's
        and, with -b, the short reads' one."""
        cfgs = [C.overlap_config_for_sample(preset, fast=fast,
                                            index_size=index_size)]
        if short:
            cfgs.append(C.overlap_config_for_sample(
                preset, fast=fast, index_size=index_size, short=True))
        specs = []
        for cfg in cfgs:
            k, w = cfg.index.k, cfg.index.w
            if (k, w) not in [s[:2] for s in specs]:
                specs.append((k, w, os.path.join(
                    paths.mm2, "t_db_longqc%s_k%d_w%d" % (paths.sfx, k, w))))
        return cls(input_path, specs, cfgs[0].index.batch_size, device)

    def start(self):
        import threading
        self._thread = threading.Thread(
            target=tracing.carry("prefetch", self._run), daemon=True)
        self._thread.start()

    def _run(self):
        with tracing.run() as scope, span("prefetch.run"):
            try:
                with span("prefetch.read"):
                    parts = list(oh.iter_index_parts(
                        _read_stream(self.input_path), self.batch_size))
                for k, w, prefix in self.specs:
                    for i, part in enumerate(parts):
                        path = "%s.part%04d.npz" % (prefix, i)
                        if not os.path.exists(path):
                            with span("prefetch.build"):
                                index = oh.build_index(part, k, w,
                                                       device=self.device)
                            with span("prefetch.save"):
                                index.save(path)
                self.parts = parts
            except Exception as e:  # surfaced on join()
                self.error = e
        self.seconds = scope.fold["by_name"]["prefetch.run"]["wall_s"]

    def join(self):
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.parts

    def cache_for(self, k, w):
        for kk, ww, prefix in self.specs:
            if (kk, ww) == (k, w):
                return prefix
        return None


def _prefetch_iter(gen, depth=1):
    """Run a generator on a reader thread with a bounded queue: the
    next chunk parses while the current one computes (the kt_pipeline
    read stage, kthread.c:129-158)."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    DONE = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(DONE)
        except BaseException as e:   # surfaced on the consumer side
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def root_logger_cleanup(fh):
    logging.getLogger().removeHandler(fh)
    fh.close()


def _pack(reads):
    from longqc_tpu_torch.io.pack import pack_reads
    return pack_reads(reads)


def _read_stream(path):
    for name, seq, qual in iter_fastx(path):
        yield [name, seq.upper(), qual if qual else "!" * len(seq)]


def _build_root_dict(tobe_json, lc, preset, suffix, figp, s_n_seqs,
                     throughput, q7, lengths, mean_len, n50, longest,
                     file_format_code, adp5, adp3, iden5, iden3,
                     num_trim5, num_trim3, adp_pos5, adp_pos3,
                     nonsense_warn, nonsense_err, very_low_cov, transcript):
    root = {}
    root["suffix"] = (" - " + suffix) if suffix else ""
    stats = OrderedDict()
    stats["Sample name"] = suffix if suffix else "-"
    stats["Yield"] = throughput
    stats["Number of reads"] = len(lengths)
    if preset.sequel or file_format_code == FORMAT_FASTA:
        stats["Q7 bases"] = "-"
    else:
        stats["Q7 bases"] = "%.3f%%" % (100 * q7 / throughput)
    stats["Longest read"] = longest
    if lc.get_unmapped_med_frac():
        stats["Estimated non-sense read fraction"] = \
            "%.3f" % lc.get_unmapped_med_frac()
    if lc.get_control_frac():
        stats["Estimated spiked-in control read fraction"] = \
            "%.3f" % lc.get_control_frac()
    root["stats"] = stats

    if ((adp5 and iden5 >= C.ADAPTER_IDENTITY_THRESHOLD)
            or (adp3 and iden3 >= C.ADAPTER_IDENTITY_THRESHOLD)):
        ad = OrderedDict()
        if adp5 and iden5 >= C.ADAPTER_IDENTITY_THRESHOLD:
            ad["Number of trimmed reads in 5'"] = num_trim5
            ad["Max seq identity for the adapter in 5'"] = "%.3f" % iden5
            ad["Average trimmed length in 5'"] = \
                "%.3f" % float(np.mean(adp_pos5))
        if adp3 and iden3 >= C.ADAPTER_IDENTITY_THRESHOLD:
            ad["Number of trimmed reads in 3'"] = num_trim3
            ad["Max seq identity for the adapter in 3'"] = "%.3f" % iden3
            ad["Average trimmed length in 3'"] = \
                "%.3f" % float(np.mean(adp_pos3))
        root["ad"] = ad

    root["rl"] = {"name": enc_b64_str(figp("length")),
                  "stats": OrderedDict([
                      ("Mean read length", "%.3f" % mean_len),
                      ("N50", "%.3f" % n50)])}
    root["rq"] = {"name": enc_b64_str(figp("average_qv"))}

    rc_stats = OrderedDict([("Number of sampled reads", s_n_seqs)])
    if lc.is_no_coverage():
        rc_stats["Mean per read coverage"] = "N/A"
        rc_stats["S.D. per read coverage"] = "N/A"
    elif transcript or lc.is_low_coverage():
        rc_stats["Mode of per read coverage"] = "%.3f" % lc.get_logn_mode()
        rc_stats["mu of per read coverage"] = "%.3f" % lc.get_logn_mu()
        rc_stats["sigma of per read coverage"] = \
            "%.3f" % lc.get_logn_sigma()
    else:
        rc_stats["Mean per read coverage"] = "%.3f" % lc.get_mean()
        rc_stats["S.D. per read coverage"] = "%.3f" % lc.get_sd()
    rc_stats["Crude estimated Xome size"] = lc.calc_xome_size(throughput)
    root["rc"] = {
        "cov_plot_name": enc_b64_str(figp("coverage")),
        "cov_over_len_plot_name":
            enc_b64_str(figp("coverage_over_read_length")),
        "cov_ovlp_qv_plot_name": enc_b64_str(figp("olp_qv")),
        "stats": rc_stats,
    }
    root["gc"] = {"name": enc_b64_str(figp("gcfrac")),
                  "stats": OrderedDict([
                      ("Mean per read GC content", "%.3f %%"
                       % (100.0 * tobe_json["GC_stats"]["Mean_GC_content"])),
                      ("s.d. per read GC content", "%.3f %%"
                       % (100.0 * tobe_json["GC_stats"]["SD_GC_content"]))])}
    root["fr"] = {"name": enc_b64_str(figp("terminal_analysis"))}
    root["sc"] = {"name": enc_b64_str(figp("masked_region"))}

    warns = OrderedDict()
    errors = OrderedDict()
    if not preset.sequel and file_format_code == 2:
        fq7 = q7 / throughput
        if C.Q7_ERROR_FRACTION < fq7 <= C.Q7_WARN_FRACTION:
            warns["Low Q7"] = "This value should be higher than 65%."
        elif fq7 <= C.Q7_ERROR_FRACTION:
            errors["Too low Q7"] = ("This value should be higher than 50%. "
                                    "Ideally, higher than 65%.")
    if lc.is_no_coverage():
        errors["Coverage estimation failure"] = (
            "Coverage estimation cannot be made. No or very little "
            "coverage data exists.")
    elif very_low_cov:
        if lc.is_low_coverage():
            warns["Low coverage"] = \
                "Coverage of data looks to be very low/skewed."
        else:
            warns["Low coverage"] = "Coverage of data looks to be very low."
        e_zero = lc.get_expected_zero_rate()
        adj_e = lc.get_unmapped_med_frac() - e_zero[1]
        if nonsense_warn <= adj_e < nonsense_err:
            warns["High non-sense read fraction"] = (
                "This value should be lower than %.2f%%."
                % ((nonsense_warn + e_zero[1]) * 100))
        elif adj_e >= nonsense_err:
            errors["Too high non-sense read fraction"] = (
                "This value should not be higher than %.2f%%."
                % ((nonsense_err + e_zero[1]) * 100))
    else:
        umf = lc.get_unmapped_med_frac()
        if nonsense_warn <= umf < nonsense_err:
            warns["High non-sense read fraction"] = (
                "This value should be lower than %d%%."
                % int(nonsense_warn * 100))
        elif umf >= nonsense_err:
            errors["Too high non-sense read fraction"] = (
                "This value should not be higher than %d%%."
                % int(nonsense_err * 100))
    if num_trim5 and not preset.pb:
        if num_trim5 / len(lengths) <= C.ADAPTER_TRIM5_WARN_FRACTION:
            warns["Low number of adapter hits in 5'"] = (
                "This value should be higher than 30% if adapter "
                "sequences were not removed.")
    for e in lc.get_errors():
        errors[e[0]] = e[1]
    for w_ in lc.get_warnings():
        warns[w_[0]] = w_[1]
    root["warns"] = warns
    root["errors"] = errors
    if preset.pb:
        root["pb"] = True
    if preset.sequel:
        root["sequel"] = True
    return root

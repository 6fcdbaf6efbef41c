"""PacBio Sequel platform QC (port of longqc_tpu/platform/sequel.py;
cf. lq_sequel.py:17-379).

Reconstructs per-ZMW polymerase reads from scraps.bam + subreads.bam
fragments (start, end, class), computes HQ length/fraction + adapter
counts, control throughput from control scraps, productivity from
sts.xml; the QC JSON and, with report, length/adapter figures. Reads
the BAMs with the port's own reader (io/bam; no pysam).
"""

import json
import logging
import os
import re
import xml.etree.ElementTree as et
from operator import itemgetter

import numpy as np

from longqc_tpu_torch.io.bam import BamReader
from longqc_tpu_torch.io.stats import get_N50, get_NXX
from longqc_tpu_torch.ops.distfit import estimate_gamma_dist
from longqc_tpu_torch.platform import check_report_modules
from longqc_tpu_torch.report.plots import plot_polread_lengths, pyplot

logger = logging.getLogger(__name__)

SEQUEL_NS = "http://pacificbiosciences.com/PacBioBaseDataModel.xsd"
PIPE_NS = "http://pacificbiosciences.com/PacBioPipelineStats.xsd"


def get_readtype(header_text):
    """READTYPE from the @RG DS field (lq_sequel.py:17-23)."""
    for line in header_text.splitlines():
        if not line.startswith("@RG"):
            continue
        m = re.search(r"READTYPE=([A-Z]+)", line)
        if m:
            return m.group(1)
    return None


def set_scrap(zmws, bam, snr):
    """Collect scrap fragments; -> control throughput
    (lq_sequel.py:25-56)."""
    control_throughput = 0
    for r in bam:
        if not r.has_tag("sz") or not r.has_tag("sc"):
            continue
        if r.get_tag("sz") == "N":
            parts = r.name.split("/")
            zmw = parts[1]
            s, e = parts[2].split("_")
            zmws.setdefault(zmw, []).append((int(s), int(e),
                                             r.get_tag("sc")))
        elif r.get_tag("sz") == "C":
            parts = r.name.split("/")
            s, e = parts[2].split("_")
            if r.get_tag("sc") == "F":
                control_throughput += int(e) - int(s) + 1
    return control_throughput


def set_subreads(zmws, bam, snr):
    for r in bam:
        parts = r.name.split("/")
        zmw = parts[1]
        s, e = parts[2].split("_")
        zmws.setdefault(zmw, []).append((int(s), int(e), "S"))
        if r.has_tag("sn"):
            for i, f in enumerate(r.get_tag("sn")):
                snr[i].append(f)


def construct_polread(frags):
    """Rebuild one ZMW's polymerase read from (start, end, class)
    fragments -> (qual_cigar, type_cigar, hq_len, total_len,
    has_subread, n_adapters).

    Walks the fragments in coordinate order keeping one open
    high-quality window: subread (S) and adapter (A) fragments extend
    it, a low-quality fragment (L) flushes it, and coordinate gaps
    between fragments are emitted as G ops and charged against an open
    window. Behavior matches the reference ZMW reconstruction
    (lq_sequel.py:76-137); held against the JAX function in
    tests/test_torch_platform.py.
    """
    prev_end = 0
    hq_open = hq_close = -1
    has_subread = False
    n_adapters = 0
    total = 0
    hq_len = 0
    qual_ops, type_ops = [], []
    for start, end, cls in sorted(frags, key=itemgetter(0, 1)):
        if prev_end != 0 and prev_end != start:
            gap = start - prev_end - 1
            if hq_open >= 0:
                hq_len -= gap
            qual_ops.append("%dG" % gap)
            type_ops.append("%dG" % gap)
            total += gap
        prev_end = end
        if cls == "L":
            if hq_open >= 0:
                hq_len += hq_close - hq_open
                qual_ops.append("%dH" % (hq_close - hq_open + 1))
                hq_open = hq_close = -1
            qual_ops.append("%dL" % (end - start + 1))
        else:
            if hq_open < 0:
                hq_open = start
            hq_close = end
            if cls == "S":
                has_subread = True
            elif cls == "A":
                n_adapters += 1
        total += end - start
        type_ops.append("%d%s" % (end - start + 1, cls))
    if hq_open >= 0:
        hq_len += hq_close - hq_open
        qual_ops.append("%dH" % (hq_close - hq_open + 1))
    if hq_len > 0:
        hq_len += 1
    total += 1
    return ("".join(qual_ops), "".join(type_ops), hq_len, total,
            has_subread, n_adapters)


def parse_sts_xml(filepath, ns=SEQUEL_NS):
    tree = et.parse(filepath)
    root = tree.getroot()
    bc = root.findall("./{%s}ProdDist/{%s}BinCounts" % (PIPE_NS, ns))
    bl = root.findall("./{%s}ProdDist/{%s}BinLabels" % (PIPE_NS, ns))
    p0 = p1 = p2 = 0
    for i, c in enumerate(bl[0]):
        if "BinLabel" in c.tag:
            if "Empty" in c.text:
                p0 = int(bc[0][i].text)
            elif "Productive" in c.text:
                p1 = int(bc[0][i].text)
            elif "Other" in c.text:
                p2 = int(bc[0][i].text)
    return [p0, p1, p2]


def _find_paths(d):
    sub = scr = xml = None
    if not os.path.isdir(d):
        return None, None, None
    for i in os.listdir(d):
        p = os.path.join(d, i)
        if p.endswith(".scraps.bam"):
            scr = p
        elif p.endswith(".subreads.bam"):
            sub = p
        elif p.endswith(".sts.xml"):
            xml = p
    return sub, scr, xml


def run_platformqc(data_path, output_path, *, suffix=None, b_width=1000,
                   report=True):
    """Sequel run QC -> the QC JSON dict (1 when a BAM is missing).
    report: draw the two figures (needs matplotlib); False writes the
    QC JSON alone."""
    check_report_modules(report)
    sfx = ("_" + suffix) if suffix else ""
    os.makedirs(os.path.join(output_path, "log"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "fig"), exist_ok=True)
    log_path = os.path.join(output_path, "log",
                            "log_sequel_platformqc%s.txt" % sfx)
    fig_path = os.path.join(output_path, "fig",
                            "fig_sequel_platformqc_length%s.png" % sfx)
    fig_path_bar = os.path.join(output_path, "fig",
                                "fig_sequel_platformqc_adapter%s.png" % sfx)
    json_path = os.path.join(output_path, "QC_vals_sequel%s.json" % sfx)

    fh = logging.FileHandler(log_path, "w")
    logger.addHandler(fh)
    try:
        logger.info("Started sequel platform QC for %s" % data_path)
        sub_p, scr_p, xml_file = _find_paths(data_path)
        if not xml_file:
            p0 = p1 = p2 = None
        else:
            p0, p1, p2 = parse_sts_xml(xml_file)
        if not (sub_p and scr_p):
            logger.error("Platform QC failed due to missing bam files")
            return 1

        zmws = {}
        snr = [[], [], [], []]
        scrap_bam = BamReader(scr_p)
        control_throughput = 0
        if get_readtype(scrap_bam.header_text) == "SCRAP":
            control_throughput = set_scrap(zmws, scrap_bam, snr)
        else:
            logger.error("the given scrap file has incorrect header.")
        sub_bam = BamReader(sub_p)
        if get_readtype(sub_bam.header_text) == "SUBREAD":
            set_subreads(zmws, sub_bam, snr)
        else:
            logger.error("the given subread file has incorrect header.")

        hr_fraction, tot_lengths, hr_lengths = [], [], []
        ad_num_stat = {}
        for v in zmws.values():
            rec = construct_polread(v)
            if rec[4]:
                hr_fraction.append(rec[2] / rec[3])
                tot_lengths.append(rec[3])
                hr_lengths.append(rec[2])
                ad_num_stat[rec[5]] = ad_num_stat.get(rec[5], 0) + 1

        a, b = estimate_gamma_dist(hr_lengths)
        _max = int(np.max(hr_lengths))
        _mean = float(np.mean(hr_lengths))
        _n50 = float(get_N50(hr_lengths))
        _n90 = float(get_NXX(hr_lengths, 90))

        tobe_json = {
            "Productivity": {"P0": p0, "P1": p1, "P2": p2},
            "Throughput": int(np.sum(hr_lengths)),
            "Throughput(Control)": int(control_throughput),
            "Longest_read": _max,
            "Num_of_reads": len(hr_lengths),
            "polread_gamma_params": [float(a), float(b)],
            "Mean_polread_length": _mean,
            "N50_polread_length": _n50,
            "Mean_HQ_fraction": float(np.mean(hr_fraction)),
            "Adapter_observation": {str(k): v
                                    for k, v in ad_num_stat.items()},
        }
        with open(json_path, "w") as f:
            json.dump(tobe_json, f, indent=4)

        if report:
            _plot_adapters(fig_path_bar, ad_num_stat)
            plot_polread_lengths(fig_path, hr_lengths, tot_lengths, a, b,
                                 _max, _mean, _n50, _n90, b_width)
        logger.info("Finished all processes.")
    finally:
        logger.removeHandler(fh)
        fh.close()
    return tobe_json


def _plot_adapters(fig_path, ad_num_stat):
    """ZMWs by their number of adapters."""
    plt = pyplot()
    left = list(range(min(ad_num_stat), max(ad_num_stat) + 1))
    height = [ad_num_stat.get(i, 0) for i in left]
    plt.bar(left, height)
    plt.savefig(fig_path, bbox_inches="tight")
    plt.close()

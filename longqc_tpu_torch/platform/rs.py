"""PacBio RS-II platform QC (port of longqc_tpu/platform/rs.py; cf.
lq_rs.py:93-223).

Parses the run's sts.csv (per-ZMW table) into numpy columns and its
sts.xml (productivity bins), computes HQ-region length statistics with
a gamma fit, and writes the QC JSON and, with report, two figures.
"""

import csv
import json
import logging
import os
import xml.etree.ElementTree as et

import numpy as np

from longqc_tpu_torch.io.stats import get_N50, get_NXX
from longqc_tpu_torch.ops.distfit import estimate_gamma_dist
from longqc_tpu_torch.platform import check_report_modules
from longqc_tpu_torch.report.plots import (boxplot_by_bin,
                                           plot_polread_lengths, pyplot)

logger = logging.getLogger(__name__)

RS_NS = "http://pacificbiosciences.com/PipelineStats/PipeStats.xsd"
STS_COLUMNS = ("ReadScore", "HQRegionStart", "HQRegionEnd", "NumBases")


def parse_sts_xml(filepath, ns=RS_NS):
    """-> [P0, P1, P2] productivity bin counts (lq_rs.py:40-59)."""
    tree = et.parse(filepath)
    root = tree.getroot()
    bc = root.findall("./{%s}ProdDist/{%s}BinCount" % (ns, ns))
    bl = root.findall("./{%s}ProdDist/{%s}BinLabel" % (ns, ns))
    p0 = p1 = p2 = 0
    for i, c in enumerate(bl):
        if "BinLabel" in c.tag:
            if "Empty" in c.text:
                p0 = int(bc[i].text)
            elif "Productive" in c.text:
                p1 = int(bc[i].text)
            elif "Other" in c.text:
                p2 = int(bc[i].text)
    return [p0, p1, p2]


def read_sts_csv(path, names=STS_COLUMNS):
    """The named columns of a comma-separated table with a header row
    -> {name: numpy array}: int64 where every value is an integer, else
    float64 (the dtypes pandas gives them). Blank lines are skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header = rows[0]
    out = {}
    for name in names:
        j = header.index(name)
        col = [r[j] for r in rows[1:]]
        try:
            out[name] = np.array([int(v) for v in col], np.int64)
        except ValueError:
            out[name] = np.array(col, np.float64)
    return out


def _find_suffix(d, suffix):
    if not os.path.isdir(d):
        return None
    for i in os.listdir(d):
        p = os.path.join(d, i)
        if p.endswith(suffix):
            return p
    return None


def run_platformqc(data_path, output_path, *, suffix=None, b_width=1000,
                   report=True):
    """RS-II run QC -> the QC JSON dict (1 when the sts.csv is missing).
    report: draw the two figures (needs matplotlib); False writes the
    QC JSON alone."""
    check_report_modules(report)
    sfx = ("_" + suffix) if suffix else ""
    os.makedirs(os.path.join(output_path, "log"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "fig"), exist_ok=True)
    log_path = os.path.join(output_path, "log",
                            "log_rs2_platformqc%s.txt" % sfx)
    fig_path = os.path.join(output_path, "fig",
                            "fig_rs2_platformqc_length%s.png" % sfx)
    fig_path2 = os.path.join(output_path, "fig",
                             "fig_rs2_platformqc_score%s.png" % sfx)
    json_path = os.path.join(output_path, "QC_vals_rs%s.json" % sfx)

    fh = logging.FileHandler(log_path, "w")
    logger.addHandler(fh)
    try:
        logger.info("Started RS-II platform QC for %s" % data_path)
        xml_file = _find_suffix(data_path, ".sts.xml")
        if not xml_file:
            logger.warning("sts.xml is missing. Productivity won't be "
                           "shown")
            p0 = p1 = p2 = None
        else:
            p0, p1, p2 = parse_sts_xml(xml_file)

        csv_path = _find_suffix(data_path, ".sts.csv")
        if not csv_path:
            logger.error("Platform QC failed due to missing csv files")
            return 1
        cols = read_sts_csv(csv_path)
        hq_len = cols["HQRegionEnd"] - cols["HQRegionStart"]
        sel = cols["ReadScore"] > 0.1
        vals = hq_len[sel]
        numbases = cols["NumBases"][sel]
        a, b = estimate_gamma_dist(vals)
        _max = int(np.max(vals))
        _mean = float(np.mean(vals))
        _n50 = float(get_N50(vals))
        _n90 = float(get_NXX(vals, 90))
        throughput = int(np.sum(vals))
        fracs = vals / numbases

        tobe_json = {
            "Productivity": {"P0": p0, "P1": p1, "P2": p2},
            "Throughput": throughput,
            "Longest_read": _max,
            "Num_of_reads": len(vals),
            "polread_gamma_params": [float(a), float(b)],
            "Mean_polread_length": _mean,
            "N50_polread_length": _n50,
            "Mean_HQ_fraction": float(np.mean(fracs)),
        }
        with open(json_path, "w") as f:
            json.dump(tobe_json, f, indent=4)

        if report:
            plot_polread_lengths(fig_path, vals, numbases, a, b, _max,
                                 _mean, _n50, _n90, b_width)
            _plot_read_scores(fig_path2, cols["ReadScore"], hq_len,
                              b_width)
        logger.info("Finished all processes.")
    finally:
        logger.removeHandler(fh)
        fh.close()
    return tobe_json


def _plot_read_scores(fig_path, scores, hq_len, b_width):
    """ReadScore of every ZMW boxed by its HQ-region length bin."""
    plt = pyplot()
    bins = np.floor(hq_len / b_width).astype(np.int64)
    boxplot_by_bin(plt, np.asarray(scores, np.float64), bins, b_width,
                   figsize=(max(int(bins.max() / 5 + 0.5), 4), 6))
    plt.title("Read scores over different length reads")
    plt.suptitle("")
    plt.savefig(fig_path, bbox_inches="tight")
    plt.close()

"""ONT MinION/GridION platform QC (port of
longqc_tpu/platform/nanopore.py; cf. lq_nanopore.py:11-377).

Traverses a run's fast5 files (plain, subdirs, or tar.gz), reads
channel id / start time / duration / flowcell / kit (io/fast5: h5py is
imported on the first file), aggregates the per-second active-pore
occupancy over 512 channels, and writes the QC JSON and, with report,
the R9.4/9.5 physical-layout activity heat map.
"""

import json
import logging
import os
import shutil
import tarfile
from concurrent.futures import ThreadPoolExecutor
from operator import itemgetter

import numpy as np

from longqc_tpu_torch.platform import check_report_modules
from longqc_tpu_torch.report.plots import pyplot

logger = logging.getLogger(__name__)

THRESHOLD_INACTIVE = 0.0025


def get_flowcell_coord():
    """channel -> (row, col) for the R9.4/R9.5 physical layout
    (lq_nanopore.py:31-47)."""
    layout = [0] * 513
    asc = [33, 481, 417, 353, 289, 225, 161, 97]
    desc = [1, 449, 385, 321, 257, 193, 129, 65]
    for i, num in enumerate(asc):
        for j in range(4):
            for z, c in enumerate(range(num + 8 * j, num + 8 * j + 8)):
                layout[c] = (i * 4 + j, z)
    for i, num in enumerate(desc):
        for j in range(4):
            for z, c in enumerate(range(num + 8 * j, num + 8 * j + 8)):
                layout[c] = (i * 4 + j, 15 - z)
    layout[0] = None
    return layout


def list_fast5_files(d):
    if not os.path.isdir(d):
        return []
    out = []
    for i in os.listdir(d):
        p = os.path.join(d, i)
        if os.path.isdir(p):
            for j in os.listdir(p):
                if j.endswith("fast5"):
                    out.append(os.path.join(p, j))
        if p.endswith("fast5"):
            out.append(p)
    return out


def list_fast5_targz(d):
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, i) for i in os.listdir(d)
            if not os.path.isdir(os.path.join(d, i))
            and i.endswith("tar.gz")]


def read_meta(path):
    """-> (channel0, (start_s, end_s), flowcell, kit) or None."""
    from longqc_tpu_torch.io import fast5 as f5
    try:
        f = f5.open_fast5(path)
    except Exception:
        return None
    try:
        g = f["/UniqueGlobalKey"]
        c_id = int(g["channel_id"].attrs["channel_number"]) - 1
        rate = int(g["channel_id"].attrs["sampling_rate"])
        node = list(f["Raw/Reads"].keys())[0]
        s_t = int(f["Raw/Reads"][node].attrs["start_time"] / rate)
        dur = int(f["Raw/Reads"][node].attrs["duration"] / rate)
        fc = g["context_tags"].attrs["flowcell_type"]
        kit = g["context_tags"].attrs["sequencing_kit"]
        return (c_id, (s_t, s_t + dur), fc, kit)
    finally:
        f.close()


def _collect(paths, bag, fcs, kits, n_workers=8):
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        for t in ex.map(read_meta, paths):
            if t is None:
                continue
            bag[t[0]].add(t[1])
            fcs.add(t[2])
            kits.add(t[3])


def aggregate_occupancy(bag, n_channel):
    """Per-second active-channel counts with the reference's pop-based
    sweep semantics (lq_nanopore.py:295-314): when a channel's earliest
    interval expires at second i, that second is skipped for the channel
    even if a later interval covers it."""
    mx = -1
    sorted_bag = []
    for s in bag:
        sl = sorted(s, key=itemgetter(0, 1))
        sorted_bag.append(sl)
        if sl and sl[-1][1] > mx:
            mx = sl[-1][1]
    channel_active = np.zeros((n_channel, max(mx, 0) + 1), dtype=bool)
    for j, intervals in enumerate(sorted_bag):
        iv = list(intervals)
        i = 1
        while i <= mx and iv:
            s, e = iv[0]
            if s <= i <= e:
                channel_active[j][i] = True
                i += 1
            elif e < i:
                iv.pop(0)
                i += 1  # the pop consumes this second without counting
            else:
                i += 1
    occ = channel_active[:, 1:mx + 1].sum(axis=0) / n_channel
    channel_wise_cnt = channel_active.sum(axis=1).astype(float)
    return occ, channel_wise_cnt, mx


def run_platformqc(platform, data_path, output_path, *, suffix=None,
                   n_channel=512, n_process=8, report=True):
    """MinION / GridION run QC -> the QC JSON dict (1 when no fast5 is
    found, or plain and compressed ones are mixed). report: draw the
    activity figure (needs matplotlib); False writes the QC JSON
    alone."""
    check_report_modules(report)
    sfx = ("_" + suffix) if suffix else ""
    os.makedirs(os.path.join(output_path, "log"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "fig"), exist_ok=True)
    log_path = os.path.join(output_path, "log",
                            "log_ont_platform%s.txt" % sfx)
    plot_path = os.path.join(output_path, "fig",
                             "fig_ont_platform%s.png" % sfx)
    json_path = os.path.join(output_path,
                             "QC_vals_%s%s.json" % (platform, sfx))
    fh = logging.FileHandler(log_path, "w")
    logger.addHandler(fh)
    try:
        logger.info("Started %s platform QC for %s" % (platform, data_path))
        l = list_fast5_files(data_path)
        ltgz = list_fast5_targz(data_path)
        if not l and not ltgz:
            logger.warning("No fast5 or compressed file in %s" % data_path)
            return 1
        if l and ltgz:
            logger.warning("Mixture of compressed and uncompressed files.")
            return 1

        bag = [set() for _ in range(n_channel)]
        fcs, kits = set(), set()
        if not l:
            for f in ltgz:
                base_dir = os.path.dirname(os.path.abspath(f))
                sub_dir = os.path.basename(f).replace(".tar.gz", "")
                with tarfile.open(f) as tar:
                    # the "data" filter refuses members that would land
                    # outside base_dir (absolute paths, .., links)
                    tar.extractall(base_dir, filter="data")
                _l = list_fast5_files(os.path.join(base_dir, sub_dir))
                _collect(_l, bag, fcs, kits, n_process)
                shutil.rmtree(os.path.join(base_dir, sub_dir))
        else:
            _collect(l, bag, fcs, kits, n_process)

        def _dec(s):
            return s.decode("utf-8") if isinstance(s, bytes) else str(s)

        tobe_json = {
            "Sequencing kit": ", ".join(sorted(_dec(s) for s in kits)),
            "Flowcell": ", ".join(sorted(_dec(s) for s in fcs)),
        }

        occ, channel_wise_cnt, mx = aggregate_occupancy(bag, n_channel)
        tobe_json["Sequencing time in seconds"] = int(mx)
        tobe_json["The time reached maximum active pore rate"] = \
            int(np.argmax(occ))
        tobe_json["The maximum active pore rate"] = float(np.max(occ))
        channel_wise_cnt = channel_wise_cnt / mx
        tobe_json["The fraction of inactive pores"] = float(
            (channel_wise_cnt < THRESHOLD_INACTIVE).sum() / n_channel)

        if report:
            _plot_activity(plot_path, occ, channel_wise_cnt, mx)
        with open(json_path, "w") as f:
            json.dump(tobe_json, f, indent=4)
        logger.info("Finished all processes.")
    finally:
        logger.removeHandler(fh)
        fh.close()
    return tobe_json


def _plot_activity(plot_path, occ, channel_wise_cnt, mx):
    """Active channel rate over time, the channels' activity on the
    flow cell's layout, and its histogram."""
    plt = pyplot()
    y = np.arange(0, 33)
    x = np.arange(0, 17)
    X, Y = np.meshgrid(x, y)
    Z = np.zeros((33, 17), dtype=float)
    for c, cor in enumerate(get_flowcell_coord()):
        if cor is None:
            continue
        Z[cor[0]][cor[1]] = channel_wise_cnt[c - 1]

    plt.subplot(3, 1, 1)
    plt.plot(occ)
    plt.grid(True)
    plt.xlabel("Elapsed time in seconds")
    plt.ylabel("Active channel rate")
    for i in np.arange(1, mx + 1, 28800):
        if i == 1:
            continue
        plt.axvline(x=i, linestyle="dashed", linewidth=1, color="blue",
                    alpha=0.8)
    plt.subplot(3, 1, 2)
    plt.pcolor(X, Y, Z, cmap="RdBu")
    plt.colorbar()
    plt.tight_layout()
    plt.title("Pore activity mapped on the actual layout")
    try:
        plt.contour(X, Y, Z, levels=[THRESHOLD_INACTIVE], linewidths=2,
                    linestyles="dashed")
    except Exception:
        pass
    plt.pink()
    plt.subplot(3, 1, 3)
    plt.hist(channel_wise_cnt, color="blue", bins=100)
    plt.xlabel("Channel wise activity rate")
    plt.ylabel("Frequency")
    plt.subplots_adjust(hspace=1.0)
    plt.savefig(plot_path, bbox_inches="tight")
    plt.close()

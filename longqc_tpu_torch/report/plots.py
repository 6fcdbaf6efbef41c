"""Report figures: length/gamma, QV-vs-length, masked fraction, GC (port
of longqc_tpu/report/plots).

Reproduces the reference's figure set (lq_gamma.plot_length_dist,
LqMask.plot_qscore_dist / plot_masked_fraction, LqGC.plot_unmasked_gc_frac)
from numpy columns (no pandas). matplotlib is imported only by the
functions that draw, so every statistic of a run can be computed where
matplotlib is not installed.
"""

import numpy as np
from scipy.stats import gamma, gaussian_kde


def pyplot():
    """matplotlib.pyplot on the Agg backend (imported on first draw)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def rgb(r, g, b):
    return [r / 255, g / 255, b / 255]


def boxplot_by_bin(plt, values, bins, interval, figsize=None):
    """Box plot of `values` grouped by their read-length bin, one box per
    occupied bin at x = 1, 2, ... (pandas' boxplot `by` layout), each
    labelled with its bin's first length. -> the sorted occupied bins."""
    uniq = np.unique(bins)
    plt.figure(figsize=figsize)
    plt.boxplot([values[bins == b] for b in uniq], sym="+")
    plt.xticks(np.arange(1, len(uniq) + 1),
               [int(b * interval) for b in uniq], rotation=90)
    return uniq


def plot_length_dist(fig_path, lengths, g_a, g_b, _max, _mean, _n50,
                     is_pb=False, b_width=1000):
    plt = pyplot()
    x = np.linspace(0, gamma.ppf(0.99, g_a, 0, g_b))
    est_dist = gamma(g_a, 0, g_b)
    plt.hist(lengths, histtype="step",
             bins=np.arange(min(lengths), _max + b_width, b_width),
             color=rgb(214, 39, 40), alpha=0.7, density=True)
    plt.grid(True)
    plt.xlabel("Read length")
    plt.ylabel("Probability density")
    plt.axvline(x=_mean, linestyle="dashed", linewidth=2,
                color=rgb(214, 39, 40), alpha=0.8)
    plt.axvline(x=_n50, linewidth=2, color=rgb(214, 39, 40), alpha=0.8)
    plt.xlim(0, gamma.ppf(0.99, g_a, 0, g_b))
    ymin, ymax = plt.gca().get_ylim()
    xmin, xmax = plt.gca().get_xlim()
    if not is_pb:
        plt.text(xmax * 0.6, ymax * 0.72,
                 r"$\alpha=%.3f,\ \beta=%.3f$" % (g_a, g_b))
        plt.text(xmax * 0.6, ymax * 0.77, r"Gamma dist params:")
        plt.plot(x, est_dist.pdf(x), color=rgb(214, 39, 40))
    plt.text(xmax * 0.6, ymax * 0.85, r"sample mean: %.3f" % (_mean,))
    plt.text(xmax * 0.6, ymax * 0.9, r"N50: %.3f" % (_n50,))
    plt.text(_mean, ymax * 0.85, r"Mean", color=rgb(214, 39, 40))
    plt.text(_n50, ymax * 0.9, r"N50", color=rgb(214, 39, 40))
    plt.axis("tight")
    plt.xlim(0, gamma.ppf(0.99, g_a, 0, g_b))
    plt.savefig(fig_path, bbox_inches="tight", transparent=True)
    plt.close()


def plot_qscore_dist(qv, lengths, *, fp=None, platform="ont",
                     interval=3000):
    """Per-read mean QV boxed by binned read length."""
    plt = pyplot()
    mid_threshold = 7 if platform == "ont" else 8
    bins = np.floor(np.asarray(lengths) / interval).astype(np.int64)
    top = int(bins.max())
    boxplot_by_bin(plt, np.asarray(qv, float), bins, interval,
                   figsize=(2 * int(top / 5 + 0.5) if top >= 5 else 6.4,
                            4.8))
    plt.grid(True)
    xmin, xmax = plt.gca().get_xlim()
    ymin, ymax = plt.gca().get_ylim()
    plt.axhspan(0, mid_threshold, facecolor="red", alpha=0.1)
    plt.axhspan(mid_threshold, ymax, facecolor="green", alpha=0.1)
    plt.ylim(0, ymax)
    plt.ylabel("Averaged QV")
    if fp:
        plt.savefig(fp, bbox_inches="tight")
    plt.close()


def plot_masked_fraction(masked_frac, fp=None):
    plt = pyplot()
    plt.grid(True)
    plt.hist(masked_frac, alpha=0.2, bins=np.arange(0, 1.0, 0.01),
             color="red")
    plt.xlim(0, 1.0)
    plt.xlabel("Low complexity fraction")
    plt.ylabel("Frequency")
    if fp:
        plt.savefig(fp, bbox_inches="tight")
    plt.close()


def plot_unmasked_gc_frac(gc_acc, fp=None, b_width=0.02):
    """Per-read and chunk GC fraction densities (cf. lq_gcfrac.py:49-85;
    their mean and sd: GCAccumulator.read_mean_sd)."""
    plt = pyplot()
    r_frac = np.asarray(gc_acc.r_frac, float)
    c_frac = np.asarray(gc_acc.c_frac, float)
    plt.hist(r_frac, alpha=0.3,
             bins=np.arange(r_frac.min(), r_frac.max() + b_width, b_width),
             color="blue", density=True)
    dens_read = gaussian_kde(r_frac) if len(r_frac) > 1 else None
    if len(c_frac) > 1:
        plt.hist(c_frac, alpha=0.3,
                 bins=np.arange(c_frac.min(), c_frac.max() + b_width,
                                b_width),
                 color="red", density=True)
        dens_chunk = gaussian_kde(c_frac)
    else:
        dens_chunk = None
    plt.grid(True)
    xs = np.linspace(0, 1.0, 50)
    if dens_read is not None:
        plt.plot(xs, dens_read(xs), label="GC fraction read")
    if dens_chunk is not None:
        plt.plot(xs, dens_chunk(xs),
                 label="GC fraction of chunked read (%dbp)"
                 % gc_acc.chunk_size)
    plt.xlabel("GC fraction")
    plt.ylabel("Probability density")
    plt.legend(bbox_to_anchor=(1, 1), loc="upper right", borderaxespad=1)
    if fp:
        plt.savefig(fp, bbox_inches="tight", transparent=True)
    plt.close()


def plot_polread_lengths(fig_path, vals, numbases, a, b, _max, _mean,
                         _n50, _n90, b_width):
    """runqc (RS-II, Sequel): HQ-region (polymerase read) lengths with
    their gamma fit, against the whole reads' lengths (lq_rs.py,
    lq_sequel.py)."""
    plt = pyplot()
    x = np.linspace(0, gamma.ppf(0.99, a, 0, b))
    plt.plot(x, gamma(a, 0, b).pdf(x), c=rgb(214, 39, 40))
    plt.grid(True)
    plt.hist(vals, histtype="step",
             bins=np.arange(min(vals), _max + b_width, b_width),
             color=rgb(214, 39, 40), alpha=0.7, density=True)
    plt.xlabel("Read length")
    plt.ylabel("Probability density")
    good = rgb(44, 160, 44)
    meh = rgb(188, 189, 34)
    plt.axvline(x=_mean, linestyle="dashed", linewidth=2,
                color=good if _mean >= 10000 else meh, alpha=0.8)
    plt.axvline(x=_n50, linewidth=2,
                color=good if _n50 >= 20000 else meh, alpha=0.8)
    plt.hist(numbases, histtype="step",
             bins=np.arange(min(numbases), max(numbases) + b_width, b_width),
             color=rgb(31, 119, 180), alpha=0.7, density=True)
    ymin, ymax = plt.gca().get_ylim()
    xmin, xmax = plt.gca().get_xlim()
    plt.text(xmax * 0.6, ymax * 0.72,
             r"$\alpha=%.3f,\ \beta=%.3f$" % (a, b))
    plt.text(xmax * 0.6, ymax * 0.77, r"Gamma dist params:")
    plt.text(xmax * 0.6, ymax * 0.85, r"sample mean: %.3f" % (_mean,))
    plt.text(xmax * 0.6, ymax * 0.9, r"N50: %.3f" % (_n50,))
    plt.text(xmax * 0.6, ymax * 0.95, r"N90: %.3f" % (_n90,))
    plt.text(_mean, ymax * 0.85, r"Mean")
    plt.text(_n50, ymax * 0.9, r"N50")
    plt.savefig(fig_path, bbox_inches="tight")
    plt.close()

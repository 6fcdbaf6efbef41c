"""Coverage analytics over the 9-column per-read coverage table (port
of longqc_tpu/report/coverage).

Equivalent of the reference's LqCoverage (lq_coverage.py:68-655):
non-sense-read fractions, deterministic 2-component GMM of per-read
coverage, Normal+LogNormal mixture for low-coverage/transcript data,
Poisson lambda bounds at high zero-coverage fraction, Xome-size
estimate, and the four coverage plots. The table is read into numpy
columns (no pandas); every getter gives the JAX package's value. The
fits run on the given device (ops/distfit); matplotlib is imported only
by the functions that draw.
"""

import math
from logging import getLogger
from operator import itemgetter

import numpy as np
import scipy.stats as st
from scipy.signal import argrelmax

from longqc_tpu_torch.ops.distfit import (fit_gmm, fit_norm_lognorm,
                                          gmm_score_samples)
from longqc_tpu_torch.report.plots import boxplot_by_bin, pyplot

logger = getLogger(__name__)


def read_table_rows(table_path_or_rows):
    """Tab-separated rows (a list of strings, or a file path) -> a list
    of per-column lists of strings."""
    if isinstance(table_path_or_rows, (list, tuple)):
        lines = table_path_or_rows
    else:
        with open(table_path_or_rows) as f:
            lines = f.read().splitlines()
    fields = [ln.split("\t") for ln in lines if ln]
    return [list(c) for c in zip(*fields)]


class CoverageTable:
    """The 9 columns of a coverage table as numpy arrays (lq_coverage.py:
    77-85): names and the two coordinate columns as strings, lengths as
    int64, the rest as float64."""

    def __init__(self, cols):
        self.name = np.array(cols[0], dtype=object)
        self.qlength = np.array(cols[1], dtype=np.int64)
        self.n_mbase = np.array(cols[2], dtype=np.int64)
        self.cov_cors = np.array(cols[3], dtype=object)
        self.med_cov_cors = np.array(cols[4], dtype=object)
        self.t1_coverage = np.array(cols[5], dtype=np.float64)
        self.qv = np.array(cols[6], dtype=np.float64)
        self.div = np.array(cols[7], dtype=np.float64)
        self.coverage = np.array(cols[8], dtype=np.float64)

    def __len__(self):
        return len(self.name)

    def select(self, keep):
        out = CoverageTable.__new__(CoverageTable)
        for k, v in vars(self).items():
            setattr(out, k, v[keep])
        return out


class CoverageAnalytics:
    UNMAPPED_FRACTION_THRESHOLD = 0.4
    UNMAPPED_FRACTION_PARAM_MIN = 0.05
    UNMAPPED_FRACTION_PARAM_MAX = 0.2
    COV_CORRECTION = 0.9
    DIV_SCORE_THRESHOLD = 0.25
    COV_THRESHOLD_FOR_DIV_SC = 25
    LENGTH_BIN_THRESHOLD = 100

    def __init__(self, table_path_or_rows, is_transcript=False,
                 control_filtering=None, device="cuda"):
        self.device = device
        self.t = CoverageTable(read_table_rows(table_path_or_rows))
        self.min_lambda = None
        self.max_lambda = None
        self.unmapped_frac_trimmed = -1.0
        self.unmapped_frac_med = -1.0
        self.high_div_frac = -1.0
        self.model = None          # (weights, means, covs) tuple
        self.mean_main = None
        self.cov_main = None
        self.main_comp_index = None
        self.control_reads = None
        self.low_coverage = None
        self.no_coverage = None
        self.mix_model = None
        self.mode_logn_main = None
        self.mu_logn_main = None
        self.sigma_logn_main = None
        self.warnings = []
        self.errors = []
        self.is_transcript = is_transcript

        if control_filtering is not None:
            ctl = CoverageTable(read_table_rows(control_filtering))
            self.control_reads = ctl.name[ctl.t1_coverage >= 0.5].tolist()
            drop = set(self.control_reads)
            self.t = self.t.select(np.array(
                [n not in drop for n in self.t.name], dtype=bool))

        self._est_coverage()

    @property
    def n_reads(self):
        return len(self.t)

    # ------------------------------------------------------------------
    def get_mean(self):
        return self.mean_main

    def get_sd(self):
        return np.sqrt(self.cov_main) if self.cov_main else None

    def get_logn_mode(self):
        return self.mode_logn_main

    def get_logn_mu(self):
        return self.mu_logn_main

    def get_logn_sigma(self):
        return self.sigma_logn_main

    def get_expected_zero_rate(self):
        # empirical zero-coverage rate model (lq_coverage.py:151-158)
        if not self.mode_logn_main and not self.mean_main:
            return None
        if not self.mode_logn_main:
            return (self.mean_main, 1.3865 * 0.64086 ** self.mean_main)
        return (self.mode_logn_main, 1.3865 * 0.64086 ** self.mode_logn_main)

    def get_unmapped_frac(self):
        return self.unmapped_frac_trimmed

    def get_unmapped_med_frac(self):
        return self.unmapped_frac_med

    def is_no_coverage(self):
        return self.no_coverage

    def is_low_coverage(self):
        return self.low_coverage

    def get_high_div_frac(self):
        return self.high_div_frac

    def get_control_num(self):
        return len(self.control_reads) if self.control_reads else 0.0

    def get_control_frac(self):
        if self.control_reads:
            return len(self.control_reads) / (len(self.control_reads)
                                              + self.n_reads)
        return 0.0

    def get_errors(self):
        return self.errors

    def get_warnings(self):
        return self.warnings

    def _est_coverage(self):
        t = self.t
        n = len(t)
        self.unmapped_frac_trimmed = float(
            (t.t1_coverage == 0.0).sum()) / n
        self.unmapped_frac_med = float((t.med_cov_cors == "0").sum()) / n
        self.high_div_frac = float(
            ((t.div >= self.DIV_SCORE_THRESHOLD)
             & (t.t1_coverage >= self.COV_THRESHOLD_FOR_DIV_SC)
             & (t.med_cov_cors != "0")).sum()) / n

        model = self._est_coverage_dist_gmm()
        self.model, self.mean_main, self.cov_main, self.main_comp_index = model

        # low-coverage shape detection via the raw per-base coverage
        # histogram (lq_coverage.py:234-243,287-295)
        ratio = t.n_mbase / t.qlength
        bins = np.arange(0, self.mean_main + 10 * np.sqrt(self.cov_main)
                         + self.mean_main / 10, self.mean_main / 10)
        hist, _ = np.histogram(ratio, bins=bins, density=True)
        self.low_coverage = self._looks_lowcoverage(hist)

        if self.unmapped_frac_med >= self.UNMAPPED_FRACTION_THRESHOLD:
            self.min_lambda = -1 * math.log(
                self.unmapped_frac_med - self.UNMAPPED_FRACTION_PARAM_MIN)
            self.max_lambda = -1 * math.log(
                self.unmapped_frac_med - self.UNMAPPED_FRACTION_PARAM_MAX)

        if self.model is None:
            self.low_coverage = None
            self.no_coverage = True
            logger.warning("No coverage data is available.")
            return

        if (self.low_coverage and not self.is_transcript):
            self._est_coverage_dist_lognorm_norm()
            self.mode_logn_main = float(np.exp(
                self.mix_model[1][1] - self.mix_model[2][1] ** 2))
            self.mu_logn_main = self.mix_model[1][1]
            self.sigma_logn_main = self.mix_model[2][1]

        if self.is_transcript:
            self._est_coverage_dist_lognorm_norm()
            self.mode_logn_main = float(np.exp(
                self.mix_model[1][1] - self.mix_model[2][1] ** 2 * 0.5))
            self.mu_logn_main = self.mix_model[1][1]
            self.sigma_logn_main = self.mix_model[2][1]

    def _looks_lowcoverage(self, hist):
        if len(hist) == 0 or hist.sum() == 0:
            return True
        relmaxs = argrelmax(hist)
        if hist[0] / np.sum(hist) < 0.01:
            return False
        for mx_i in relmaxs[0]:
            if hist[mx_i] > (hist[0] / 5):
                return False
        return True

    def _nonzero_below_quantile(self):
        vals = self.t.coverage
        th = np.percentile(vals, 85.0)
        if th == 0.0:
            th = np.percentile(vals, 100.0)
        nz = vals[vals.nonzero()]
        return nz[nz < th]

    def _est_coverage_dist_gmm(self, k=2):
        data = self._nonzero_below_quantile()
        if data.size == 0:
            return (None, 1, 10, 0)
        weights, means, covs = fit_gmm(data, n_comp=k, device=self.device)
        order = weights / covs
        c_i = int(np.argmax(order))
        return ((weights, means, covs), float(means[c_i]),
                float(covs[c_i]), c_i)

    def _est_coverage_dist_lognorm_norm(self):
        data = self._nonzero_below_quantile()
        weights, means, covs = self.model
        i_bg = 0 if self.main_comp_index == 1 else 1
        i_m = 1 if self.main_comp_index == 1 else 0
        w, mus, sigmas = fit_norm_lognorm(
            data, means[i_bg], np.sqrt(covs[i_bg]),
            np.log(means[i_m]), 1.0, device=self.device)
        self.mix_model = (w, mus, sigmas)

    def check_length_coverage(self, interval=3000.0):
        """The coverage-homogeneity warning (lq_coverage.py, drawn beside
        the length-vs-coverage plot in the reference): under the GMM
        model, a length bin of at least LENGTH_BIN_THRESHOLD reads whose
        median coverage lies past 3 sigma of the main component."""
        if (self.min_lambda or self.max_lambda
                or self.mix_model is not None):
            return
        bins = np.floor(self.t.qlength.astype(float) / interval)
        uniq, inv, size = np.unique(bins, return_inverse=True,
                                    return_counts=True)
        meds = np.array([np.median(self.t.coverage[inv == i])
                         for i in range(len(uniq))])
        meds = meds[size >= self.LENGTH_BIN_THRESHOLD]
        hi = self.get_mean() + 3 * self.get_sd()
        lo = self.get_mean() - 3 * self.get_sd()
        if np.any((meds > hi) | (meds <= lo)):
            self.warnings.append(
                ("Coverage warning",
                 "Coverage might not be homogenous over the read length."))

    # ------------------------------------------------------------------
    def calc_xome_size(self, throughput):
        if self.no_coverage:
            return "N/A"
        if self.is_transcript or self.low_coverage:
            m_size = int((throughput * (1.0 - self.unmapped_frac_med))
                         / self.mode_logn_main)
        else:
            m_size = int((throughput * (1.0 - self.unmapped_frac_med))
                         / self.mean_main)
        if self.unmapped_frac_med >= self.UNMAPPED_FRACTION_THRESHOLD:
            _s1 = (throughput * self.COV_CORRECTION
                   * (1 - self.UNMAPPED_FRACTION_PARAM_MIN) / self.min_lambda)
            _s2 = (throughput * self.COV_CORRECTION
                   * (1 - self.UNMAPPED_FRACTION_PARAM_MAX) / self.max_lambda)
            return "%d (e = %.1f%%), %d (e = 20%%), %d (e = 5%%)" % (
                m_size, self.unmapped_frac_med * 100, _s2, _s1)
        return "%d (e = %.1f%%)" % (m_size, self.unmapped_frac_med * 100)

    # ------------------------------------------------------------------
    # plots

    def plot_coverage_dist(self, fp=None):
        plt = pyplot()
        if self.min_lambda and self.max_lambda:
            plt.figure(figsize=(12, 5))
            plt.subplot(1, 2, 1)
            plt.grid(True)
            pois_x = np.arange(int(self.mean_main
                                   + 4 * np.sqrt(self.cov_main)) + 1)
            plt.xlim(0, 50)
            plt.plot(pois_x, st.poisson(self.min_lambda).pmf(pois_x),
                     label="Fitted Model by Poisson model (%.3f)"
                     % self.min_lambda)
            plt.plot(pois_x, st.poisson(self.max_lambda).pmf(pois_x),
                     label="Fitted Model by Poisson model (%.3f)"
                     % self.max_lambda)
            plt.xlabel("Per read coverage")
            plt.ylabel("Probability density")
            self._cov_hist(plt)
            plt.legend(bbox_to_anchor=(1, 1), loc="upper right",
                       borderaxespad=1)
            plt.subplot(1, 2, 2)
            plt.grid(True)
        else:
            plt.grid(True)

        gmm_x = np.linspace(0, self.mean_main
                            + 10 * np.sqrt(self.cov_main), 5000)
        if self.mix_model is not None:
            w, mus, sigmas = self.mix_model
            mix_y = (w[0] * st.norm(mus[0], sigmas[0]).pdf(gmm_x)
                     + w[1] * st.lognorm.pdf(gmm_x, sigmas[1], loc=0,
                                             scale=np.exp(mus[1])))
            plt.plot(gmm_x, mix_y,
                     label="Fitted by Lognormal and gaussian mixture model")
            plt.xlim(0, gmm_x[-1])
            plt.legend(bbox_to_anchor=(1, 1), loc="upper right",
                       borderaxespad=1)
        elif self.model is None:
            plt.gcf().text(0.30, 0.5, "Caution: coverage estimation was "
                           "skipped due to insufficient amount of data.",
                           backgroundcolor="yellow")
        else:
            weights, means, covs = self.model
            gmm_y = np.exp(gmm_score_samples(gmm_x, weights, means, covs))
            plt.plot(gmm_x, gmm_y, label="Fitted by Gaussian mixture model")
            plt.xlim(0, gmm_x[-1])
            plt.legend(bbox_to_anchor=(1, 1), loc="upper right",
                       borderaxespad=1)
        self._cov_hist(plt)
        plt.xlabel("Per read coverage")
        plt.ylabel("Probability density")
        if fp:
            plt.savefig(fp, bbox_inches="tight")
        plt.close()

    def _cov_hist(self, plt):
        plt.hist(self.t.coverage,
                 alpha=0.2,
                 bins=np.arange(0, self.mean_main
                                + 10 * np.sqrt(self.cov_main)
                                + self.mean_main / 10,
                                self.mean_main / 10),
                 color="green", density=True)

    def _region_analysis(self):
        """Parse coords column -> 5'/3' distances + internal gaps
        (lq_coverage.py:623-655)."""
        trim_5, trim_3, intrnl = [], [], []
        for sv, ql in zip(self.t.cov_cors, self.t.qlength):
            if sv == "0":
                continue
            regs = [(int(r.split("-")[0]), int(r.split("-")[1]))
                    for r in sv.split(",")]
            if len(regs) > 1:
                sr = sorted(regs, key=itemgetter(0, 1))
                s, e = sr[0][0], sr[-1][1]
                for kk in range(len(regs) - 1):
                    intrnl.append(regs[kk + 1][0] - regs[kk][1])
            elif len(regs) == 1:
                s, e = regs[0]
            else:
                continue
            trim_5.append(s)
            trim_3.append(int(ql) - int(e))
        return trim_5, trim_3, intrnl

    def plot_unmapped_frac_terminal(self, fp=None, *, adp5_pos=None,
                                    adp3_pos=None, x_max=145):
        plt = pyplot()
        plt.figure(figsize=(12, 5))
        ax1 = plt.subplot(1, 2, 1)
        t5l, t3l, _ = self._region_analysis()
        plt.sca(ax1)
        plt.hist(t5l, alpha=0.2, bins=np.arange(0, x_max, 5), color="green")
        plt.xlim(0, x_max)
        plt.xlabel("Distance from 5' terminal")
        plt.ylabel("Frequency")
        _, ymax5 = plt.gca().get_ylim()
        ax2 = plt.subplot(1, 2, 2)
        plt.sca(ax2)
        plt.hist(t3l, alpha=0.2, bins=np.arange(0, x_max, 5), color="orange")
        plt.xlim(x_max, 0)
        plt.xlabel("Distance from 3' terminal")
        plt.ylabel("Frequency")
        _, ymax3 = plt.gca().get_ylim()
        ymax = max(ymax5, ymax3)
        if ymax5 > ymax3:
            ax2.set_ylim(0, ymax5)
        else:
            ax1.set_ylim(0, ymax3)
        if adp5_pos:
            ax1.axvline(x=adp5_pos, linestyle="dashed", linewidth=2,
                        color="red", alpha=0.8)
            ax1.text(adp5_pos, ymax * 0.85, r"Length of the adapter",
                     horizontalalignment="right" if adp5_pos > 90 else "left")
        if adp3_pos:
            ax2.axvline(x=adp3_pos, linestyle="dashed", linewidth=2,
                        color="red", alpha=0.8)
            ax2.text(adp3_pos, ymax * 0.85, r"Length of the adapter",
                     horizontalalignment="left" if adp3_pos > 90 else "right")
        if fp:
            plt.savefig(fp, bbox_inches="tight")
        plt.close()

    def plot_qscore_dist(self, fp=None, *, platform="ont"):
        plt = pyplot()
        mid_threshold = 7
        plt.grid(True)
        qv, cov = self.t.qv, self.t.coverage
        plt.boxplot([qv[cov == 0.0], qv[cov != 0.0]])
        plt.xticks([1, 2], ["Non-sense reads", "Normal reads"])
        _, ymax = plt.gca().get_ylim()
        plt.axhspan(0, mid_threshold, facecolor="red", alpha=0.1)
        plt.axhspan(mid_threshold, ymax, facecolor="green", alpha=0.1)
        plt.ylim(0, ymax)
        plt.ylabel("Averaged QV")
        if fp:
            plt.savefig(fp, bbox_inches="tight")
        plt.close()

    def plot_length_vs_coverage(self, fp=None, *, interval=3000.0):
        """Per-read coverage (the reliable-region coverage below 3 kbp)
        boxed by binned read length; bins under LENGTH_BIN_THRESHOLD
        reads are shaded."""
        plt = pyplot()
        t = self.t
        merged = np.where(t.qlength >= 3000, t.coverage, t.t1_coverage)
        bins = np.floor(t.qlength.astype(float) / interval).astype(np.int64)
        top = int(bins.max())
        uniq = boxplot_by_bin(
            plt, merged, bins, interval,
            figsize=None if top < 5 else (2 * int(top / 5 + 0.5), 4.8))
        size = np.array([(bins == b).sum() for b in uniq])
        reliable = np.where(size >= self.LENGTH_BIN_THRESHOLD)[0]
        xmin, xmax = plt.gca().get_xlim()
        if reliable.size > 0:
            dmin, dmax = reliable.min(), reliable.max()
            if dmax < xmax:
                plt.axvspan(dmax + 1.5, xmax + 1, facecolor="gray",
                            alpha=0.1)
            if dmin > xmin:
                plt.axvspan(xmin - 1, dmin + 1.5, facecolor="gray",
                            alpha=0.1)
        else:
            plt.axvspan(xmin - 1, xmax + 1, facecolor="gray", alpha=0.1)
        plt.xlim(xmin, xmax)
        plt.title("Read coverage over different length reads")
        plt.ylim(0, self.mean_main + 20 * np.sqrt(self.cov_main))
        plt.ylabel("per-read coverage")
        if (not self.min_lambda and not self.max_lambda
                and self.mix_model is None):
            for yc in (self.get_mean() - 3 * self.get_sd(),
                       self.get_mean() + 3 * self.get_sd()):
                plt.axhline(y=yc, color="royalblue", alpha=0.4, lw=1)
                plt.text(0, yc, r"3$\sigma$", color="royalblue")
        if fp:
            plt.savefig(fp, bbox_inches="tight", transparent=True)
        plt.close()

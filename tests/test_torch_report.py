"""The port's coverage analytics and report against the JAX package's on
the CPU.

Both read one coverage table: rows of the overlap host spec (identical
in both packages) for normal, high-zero (junk-dominated) and transcript
inputs, plus hand-made rows whose long reads sit past 3 sigma (the
coverage warning) and a spike-in filter table. The port reads the table
into numpy columns, the JAX package into pandas. Exact: fractions,
lambdas, flags, counts, warnings, errors and the Xome-size string;
within rel=1e-9: every value that comes from an EM fit (see
tests/test_torch_distfit.py)."""

import re

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu.report.coverage import CoverageAnalytics as JCov
from longqc_tpu.report.html import render_report as jrender
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import overlap_host as oh
from longqc_tpu_torch.report import plots
from longqc_tpu_torch.report.coverage import CoverageAnalytics as TCov
from longqc_tpu_torch.report.html import render_report as trender
from test_html_report import _root
from util_synth import make_genome, sample_reads

REL = 1e-9


def _overlap_rows(seed, n_reads, genome_n, junk_frac, err=0.12):
    rng = np.random.RandomState(seed)
    reads = sample_reads(rng, make_genome(rng, genome_n), n_reads,
                         min_len=700, max_len=1900, err=err,
                         junk_frac=junk_frac)
    cfg = OverlapConfig(index=IndexOpt(k=12, w=5),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    return oh.overlap_run(list(reads), reads, cfg, device="cpu")


def _outlier_rows():
    """300 reads of 1 kbp at coverage ~10 and 150 of 7 kbp at ~40: the
    long bin's median lies past 3 sigma of the main component."""
    rng = np.random.RandomState(8)
    rows = []
    for i in range(450):
        ql = 1000 if i < 300 else 7000
        cov = rng.normal(10.0, 1.0) if i < 300 else rng.normal(40.0, 2.0)
        if i % 10 == 0:
            rows.append("r%03d\t%d\t0\t0\t0\t0.0\t%.3f\t1.000\t0.0"
                        % (i, ql, rng.uniform(5, 15)))
            continue
        rows.append("r%03d\t%d\t%d\t%d-%d\t%d-%d\t%.3f\t%.3f\t%.3f\t%.3f" % (
            i, ql, int(cov * ql), 5, ql - 7, 9, ql - 20, cov,
            rng.uniform(5, 15), rng.uniform(0.0, 0.4), cov))
    return rows


def _control_rows(rows):
    """A filter table marking every 9th read (t1 coverage >= 0.5), and a
    few below the threshold."""
    out = []
    for i, r in enumerate(rows):
        f = r.split("\t")
        t1 = "0.900" if i % 9 == 0 else ("0.300" if i % 9 == 1 else "0.0")
        out.append("%s\t%s\t0\t0\t0\t%s\t0.000\t1.000\t0.0"
                   % (f[0], f[1], t1))
    return out


@pytest.fixture(scope="module")
def tables():
    normal = _overlap_rows(17, 130, 22000, 0.1)
    return {
        "normal": (normal, False, None),
        "high-zero": (_overlap_rows(29, 110, 18000, 0.75), False, None),
        "transcript": (_overlap_rows(31, 120, 20000, 0.15), True, None),
        "outlier": (_outlier_rows(), False, None),
        "control": (normal, False, _control_rows(normal)),
    }


def _close(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and np.isnan(a):
        return np.isnan(b)
    return a == pytest.approx(b, rel=REL)


def _outcome(f, *a):
    try:
        return "ok", f(*a)
    except ValueError as e:
        return "raises", str(e)


CASES = ["normal", "high-zero", "transcript", "outlier", "control"]


@pytest.mark.parametrize("case", CASES)
def test_coverage_getters_equal_jax(tables, tmp_path, case):
    rows, transcript, control = tables[case]
    want = JCov(rows, is_transcript=transcript, control_filtering=control)
    got = TCov(rows, is_transcript=transcript, control_filtering=control,
               device="cpu")
    # exact contract
    assert got.get_unmapped_frac() == want.get_unmapped_frac()
    assert got.get_unmapped_med_frac() == want.get_unmapped_med_frac()
    assert got.get_high_div_frac() == want.get_high_div_frac()
    assert got.is_no_coverage() == want.is_no_coverage()
    assert got.is_low_coverage() == want.is_low_coverage()
    assert (got.min_lambda, got.max_lambda) == \
        (want.min_lambda, want.max_lambda)
    assert got.get_control_num() == want.get_control_num()
    assert got.get_control_frac() == want.get_control_frac()
    assert got.main_comp_index == want.main_comp_index
    assert got.get_errors() == want.get_errors()
    for thr in (3.3e6, 91041, 1e9):
        # a degenerate lognormal fit (NaN mode) raises in both
        assert _outcome(got.calc_xome_size, thr) == \
            _outcome(want.calc_xome_size, thr)
    # EM-derived values
    for name in ("get_mean", "get_sd", "get_logn_mode", "get_logn_mu",
                 "get_logn_sigma"):
        assert _close(getattr(got, name)(), getattr(want, name)()), name
    ez_g, ez_w = got.get_expected_zero_rate(), want.get_expected_zero_rate()
    assert (ez_g is None) == (ez_w is None)
    if ez_w is not None:
        assert all(_close(a, b) for a, b in zip(ez_g, ez_w))
    if want.model is not None:
        for a, b in zip(got.model, want.model):
            np.testing.assert_allclose(a, b, rtol=REL, atol=0)
    # the coverage warning: drawn beside the length plot in the JAX
    # package, a check of its own in the port
    interval = 3000.0 if case != "high-zero" else 700.0
    want.plot_length_vs_coverage(None, interval=interval)
    got.check_length_coverage(interval=interval)
    assert got.get_warnings() == want.get_warnings()
    if case == "outlier":
        assert got.get_warnings()
    if case == "high-zero":
        assert got.min_lambda is not None
    if case == "transcript":
        assert got.get_logn_mode() is not None
    if case == "control":
        assert got.get_control_num() == 15 and got.n_reads == 115


@pytest.mark.parametrize("case", ["high-zero", "transcript", "outlier"])
def test_coverage_figures_draw(tables, tmp_path, case):
    rows, transcript, control = tables[case]
    got = TCov(rows, is_transcript=transcript, control_filtering=control,
               device="cpu")
    figs = {name: str(tmp_path / (name + ".png")) for name in
            ("coverage", "terminal", "olp_qv", "length")}
    got.plot_coverage_dist(figs["coverage"])
    got.plot_unmapped_frac_terminal(figs["terminal"], adp5_pos=27.0,
                                    adp3_pos=95.0)
    got.plot_qscore_dist(figs["olp_qv"])
    got.plot_length_vs_coverage(figs["length"], interval=500.0)
    for p in figs.values():
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_table_figures_draw(tmp_path):
    rng = np.random.RandomState(4)
    lengths = rng.randint(300, 9000, 400)
    qv = rng.uniform(4, 16, 400)
    frac = rng.uniform(0, 0.3, 400)
    g_a, g_b = 2.5, 1500.0
    paths = [str(tmp_path / ("f%d.png" % i)) for i in range(3)]
    plots.plot_qscore_dist(qv, lengths, fp=paths[0], interval=1000)
    plots.plot_masked_fraction(frac, fp=paths[1])
    plots.plot_length_dist(paths[2], lengths, g_a, g_b, int(lengths.max()),
                           float(lengths.mean()), 5000.0, False)
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(4) == b"\x89PNG"


@pytest.mark.parametrize("kw", [dict(), dict(pb=True, sequel=True),
                                dict(with_ad=False, warns={"W": "w!"},
                                     errors={"E": "e!"})],
                         ids=["ont", "sequel", "banners"])
def test_html_equals_jax(tmp_path, kw):
    root = _root(**kw)
    jrender(root, str(tmp_path / "j.html"))
    trender(root, str(tmp_path / "t.html"))
    want = (tmp_path / "j.html").read_text()
    got = (tmp_path / "t.html").read_text()
    assert got == want.replace("generated by longqc_tpu<",
                               "generated by longqc_tpu_torch<")
    cells = re.findall(r"<td>([^<]*)</td>", got)
    assert "123456" in cells and all(c.strip() for c in cells)


def test_analytics_default_to_the_card(tables):
    rows = tables["normal"][0]
    if torch.cuda.is_available():
        TCov(rows)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCov(rows)

"""Per-run instrument QC (`runqc`): PacBio RS-II (rs), Sequel (sequel)
and ONT MinION / GridION (nanopore).

Host code, as in the JAX package (numpy and scipy; no device work).
matplotlib is imported only to draw (report/plots.pyplot), so every
module loads, and every QC value is computed, where it is missing.
"""

import importlib.util


def check_report_modules(report):
    """A run that draws its figures refuses to start where matplotlib
    is not installed (report=False, `--no-report`, writes the QC JSON
    alone)."""
    if report and importlib.util.find_spec("matplotlib") is None:
        raise ImportError("runqc draws its figures with matplotlib (not "
                          "installed); run with report=False (--no-report) "
                          "for the QC JSON alone")

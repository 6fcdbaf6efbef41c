"""The comparisons that decide `correct`: a job's outputs against the
reference's, each as a count or a relative error."""

import re

import numpy as np

# QC JSON values compared exactly (counts, lengths, the adapter tallies);
# every other number is compared by relative error
EXACT_QC = ("Yield", "Q7 bases", "Longest_read", "Num_of_reads",
            "Length_stats.Mean_read_length", "Length_stats.N50_read_length")
_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def row_key(row):
    f = row.split("\t")
    return "\t".join((f[0], f[1], f[6])) if len(f) == 9 else row


def rows_keys_bad(rows, exp_keys):
    """Rows whose name, length or meanQ differ from the reference's, one
    per expected query, in order (a missing or extra row counts)."""
    bad = abs(len(rows) - len(exp_keys))
    for r, k in zip(rows, exp_keys):
        bad += row_key(r) != k
    return bad


def rows_bad(rows, ref_rows):
    """Sampled rows (ref_rows: query index -> row) that differ in any of
    the 9 columns."""
    return sum(1 for i, ref in ref_rows.items()
               if i >= len(rows) or rows[i] != ref)


def mask_bad(lines, exp_keys, ref_full):
    """Per-read table rows: name, length, meanQ and Q7 bases of every
    read, and whole rows (the masked length too) of a sample."""
    bad = abs(len(lines) - len(exp_keys))
    for ln, k in zip(lines, exp_keys):
        f = ln.split("\t")
        bad += (len(f) != 6 or "\t".join((f[0], f[2], f[4], f[5])) != k)
    bad += sum(1 for i, ref in ref_full.items()
               if i >= len(lines) or lines[i] != ref)
    return bad


def mask_key(table, names, i):
    return "%s\t%d\t%.3f\t%d" % (names[i], table["length"][i],
                                 table["meanq"][i], table["nq7"][i])


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        key = pre + k
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                out["%s.%d" % (key, i)] = x
        else:
            out[key] = v
    return out


def _exact(key):
    return key in EXACT_QC or key.startswith("Stats_for_adapter")


def qc_compare(got, ref):
    """-> (values that differ where they must be equal, largest relative
    error of the other numbers). A key on one side only counts as a
    difference; numbers inside strings are compared one by one."""
    g, r = _flat(got), _flat(ref)
    exact_bad = len(set(g) ^ set(r))
    rel = 0.0
    for k in set(g) & set(r):
        a, b = g[k], r[k]
        if _exact(k):
            exact_bad += a != b
            continue
        if isinstance(b, str):
            na, nb = _NUM.findall(str(a)), _NUM.findall(b)
            if len(na) != len(nb) or _NUM.sub("#", str(a)) != _NUM.sub(
                    "#", b):
                exact_bad += 1
                continue
            pairs = [(float(x), float(y)) for x, y in zip(na, nb)]
        else:
            pairs = [(float(a), float(b))]
        for x, y in pairs:
            if np.isnan(x) or np.isnan(y):
                exact_bad += np.isnan(x) != np.isnan(y)
                continue
            den = abs(y) if y != 0 else 1.0
            rel = max(rel, abs(x - y) / den)
    return exact_bad, rel

"""The reference against each entry at a tiny size on the CPU (the
port's plain kernel versions), the control failing, and runs with the
timed path broken underneath coming out not correct."""

import pytest

from benchmark import gen, harness
from benchmark.control import control_job

MAN = harness.load_json(harness.ROOT, "BENCHMARK.json")
# a mix whose traffic file is kept for a later cell (see PERF.md): its
# entry and reference are held to each other here too
MAN["workloads"].append({"name": "pb-hifi.sampleqc", "config": "pb-hifi",
                         "traffic": "sampleqc_8k_6mb_control1", "chips": 1})
SEED = 2 ** 31 + 4321


def tiny(cell, n_reads=150, n_sample=50):
    c = harness.cell_of(MAN, cell)
    cfg = harness.load_json(harness.HERE, "configs", c["config"] + ".json")
    tr = harness.load_json(harness.HERE, "traffic", c["traffic"] + ".json")
    cfg["reads"].update(min_len=700, max_len=1800)
    cfg["settings"]["n_sample"] = n_sample
    tr.update(n_reads=n_reads, genome_bp=n_reads * 200, warmup_reads=40,
              warmup_genome_bp=8000, check_rows=12, check_mask_rows=3)
    return cfg, tr


def run_tiny(cell, hook=None, **kw):
    cfg, tr = tiny(cell, **kw)
    return harness.run_cell(cell, SEED, 0.0, 0, device="cpu", config=cfg,
                            traffic=tr, workers=1, entry_hook=hook,
                            manifest=MAN)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_reference_agrees_with_the_entry(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1


@pytest.mark.parametrize("cell", ["ont-ligation.sampleqc",
                                  "ont-ligation.overlap"])
def test_control_fails(cell):
    """The reference in float32 in the program's place fails a number."""
    cfg, tr = tiny(cell, n_reads=300, n_sample=250)
    entry = harness.load_module("entries", tr["entry"])
    run = {"config": cfg, "traffic": tr, "seed": SEED, "device": "cpu",
           "workdir": None, "workers": 1}
    run["reads"] = gen.make_reads(SEED, cfg, tr)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        run["workdir"] = d
        state = entry.prepare(run)
        job = entry.job(state)
        ref = entry.reference(state)
        prog = entry.compare([job], ref, state)
        ctl = entry.compare([control_job(entry, state, ref, job)], ref,
                            state)
    limits = tr["limits"]
    assert all(v <= limits[k] for k, v in prog.items()), prog
    assert any(v > limits[k] for k, v in ctl.items()), ctl
    assert ctl["rows_keys_bad"] > 0


def _half_batch(entry):
    prep = entry.prepare

    def prepare(run):
        run = dict(run, reads=run["reads"][:len(run["reads"]) // 2])
        state = prep(run)
        if "queries" in state:
            state["queries"] = state["queries"][:len(state["queries"]) // 2]
        return state
    entry.prepare = prepare
    ref = entry.reference
    entry.reference = lambda state, variant=None: ref(
        _full(state), variant)


def _full(state):
    """The reference sees the cell's whole input, not the broken one."""
    run = state["run"]
    full = gen.make_reads(run["seed"], run["config"], run["traffic"])
    state = dict(state, reads=full, run=dict(run, reads=full))
    if "queries" in state:
        picks = gen.sample_indices(run["seed"], len(full),
                                   int(run["config"]["settings"]["n_sample"]))
        state["queries"] = [full[i] for i in picks]
    return state


def _wrap_rows(entry, change):
    job = entry.job

    def broken(state):
        out = job(state)
        out["rows"] = change(out["rows"])
        return out
    entry.job = broken


def _altered(entry):
    """One answer wrong where it is produced: the last row's meanQ."""
    def change(rows):
        f = rows[-1].split("\t")
        f[6] = "%.3f" % (float(f[6]) + 0.001)
        return rows[:-1] + ["\t".join(f)]
    _wrap_rows(entry, change)


def _unchanged(entry):
    def change(rows):
        out = []
        for r in rows:
            f = r.split("\t")
            out.append("\t".join([f[0], f[1], "0", "0", "0", "0.0", f[6],
                                  "1.000", "0.0"]))
        return out
    _wrap_rows(entry, change)


@pytest.mark.parametrize("fault", [_half_batch, _altered, _unchanged])
@pytest.mark.parametrize("cell", ["ont-ligation.sampleqc",
                                  "ont-ligation.overlap"])
def test_broken_timed_path_is_not_correct(cell, fault):
    res = run_tiny(cell, hook=fault)
    assert res["correct"] is False, res["checks"]


def test_limits_are_exact_where_the_comparison_is():
    for w in MAN["workloads"]:
        tr = harness.load_json(harness.HERE, "traffic",
                               w["traffic"] + ".json")
        for k, v in tr["limits"].items():
            if k != "qc_rel_err":
                assert v == 0
            else:
                assert 0 < v < 1e-6

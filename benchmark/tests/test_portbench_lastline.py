"""The result line, the rate over a window that a job overruns, the
module checks, and the card-only measurement path."""

import os
import subprocess
import sys
import time

import pytest

from benchmark import harness

MAN = harness.load_json(harness.ROOT, "BENCHMARK.json")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


class FakeEntry:
    """Jobs of a fixed length and size, judged exact."""

    def __init__(self, job_s, bases):
        self.job_s, self.bases = job_s, bases

    def hook(self, entry):
        entry.prepare = lambda run: {}
        entry.warmup = lambda state: None

        def job(state):
            import torch
            torch.ones(8).sum()
            time.sleep(self.job_s)
            return {"bases": self.bases, "stats": {}, "queries": 1}
        entry.job = job
        entry.reference = lambda state, variant=None: {}
        entry.compare = lambda jobs, ref, state: {"rows_keys_bad": 0,
                                                  "rows_bad": 0}


def _run(cell, seconds, trace, fake):
    tr = harness.load_json(harness.HERE, "traffic",
                           harness.cell_of(MAN, cell)["traffic"] + ".json")
    tr = dict(tr, n_reads=4, genome_bp=5000)
    return harness.run_cell(cell, 5, seconds, trace, device="cpu",
                            traffic=tr, entry_hook=fake.hook)


def test_rate_counts_the_job_past_the_window():
    fake = FakeEntry(0.3, 30_000_000)
    res = _run("ont-ligation.overlap", 0.45, 0, fake)
    # two jobs: the second starts inside the window and ends past it
    assert res["attempted"] == 2
    rate = res["metrics"]["overlap_mbp_s"]["value"]
    assert 60.0 / 0.7 < rate < 60.0 / 0.6
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"overlap_mbp_s", "setup_s"}
    assert res["correct"] is True


def test_traced_line_has_the_layer_metrics_and_device_window():
    fake = FakeEntry(0.05, 1_000_000)
    res = _run("ont-ligation.overlap", 0.1, 1, fake)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "breakdown" in res
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    assert "setup_s" not in res["metrics"]


def test_forbidden_modules_by_whole_top_level_name():
    assert harness.forbidden_modules(["longqc_tpu_torch.engine",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["longqc_tpu.ops", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "longqc_tpu"]


def _child(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_reference_loads_nothing_of_the_port_or_jax():
    p = _child("import sys\n"
               "import benchmark.reference.overlap, benchmark.reference.qc\n"
               "import benchmark.reference.sketch\n"
               "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr
    tops = eval(p.stdout.strip().splitlines()[-1])
    assert not {"longqc_tpu_torch", "longqc_tpu", "jax", "jaxlib"} & \
        set(tops)


def test_a_run_loads_no_jax():
    """The harness and the port's entries, imported and run at a tiny
    size, leave no JAX module behind (the run's own end check)."""
    p = _child(
        "import sys, time\n"
        "from benchmark import harness\n"
        "m = harness.load_json(harness.ROOT, 'BENCHMARK.json')\n"
        "c = harness.cell_of(m, 'ont-ligation.overlap')\n"
        "cfg = harness.load_json(harness.HERE, 'configs', c['config'] + '.json')\n"
        "tr = harness.load_json(harness.HERE, 'traffic', c['traffic'] + '.json')\n"
        "cfg['reads'].update(min_len=600, max_len=900)\n"
        "cfg['settings']['n_sample'] = 8\n"
        "tr.update(n_reads=30, genome_bp=6000, warmup_reads=20, "
        "warmup_genome_bp=4000, check_rows=4)\n"
        "res = harness.run_cell(c['name'], 3, 0.0, 0, device='cpu', "
        "config=cfg, traffic=tr, workers=1)\n"
        "assert res['correct'], res\n"
        "print(harness.forbidden_modules())\n")
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        MAN["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "ont-ligation.overlap", "--seed", "4242",
                        "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    import json
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"

"""The spike-in filter's flags in a `pb-hifi.sampleqc` job against the
plain answer of reference/spike_in.py, on the CPU at a tiny size, and
the filter broken underneath (dropped, run against another reference,
its HPC compression of the sample wrong) coming out wrong."""

import os
import tempfile

import numpy as np
import pytest

from benchmark import gen, harness
from benchmark.reference import spike_in as si

SEED = 2 ** 31 + 4321


def _job(mp, fault, tmp):
    from longqc_tpu_torch.config import PRESETS
    from longqc_tpu_torch.engine import device_overlap, pipeline
    # the sample's overlap stage at the ont-ligation preset's settings,
    # which the CPU runs in seconds (pb-hifi's takes minutes there); the
    # spike-in run keeps its own
    overlap = pipeline._overlap
    mp.setattr(pipeline, "_overlap", lambda t, s, ss, preset, *a, **kw:
               overlap(t, s, ss, PRESETS["ont-ligation"], *a, **kw))
    cfg = harness.load_json(harness.HERE, "configs", "pb-hifi.json")
    tr = harness.load_json(harness.HERE, "traffic",
                           "sampleqc_8k_6mb_control1.json")
    cfg["reads"].update(min_len=700, max_len=1800)
    cfg["settings"]["n_sample"] = 30
    tr.update(n_reads=40, genome_bp=40000, control_share=0.1,
              warmup_reads=40, warmup_genome_bp=8000)
    if fault == "dropped":
        mp.setattr(pipeline, "_spike_in", lambda *a, **kw: None)
    elif fault == "other_reference":
        path = os.path.join(tmp, "other.fa")
        with open(path, "w") as f:
            f.write(">other\n%s\n" % gen.make_genome(
                gen.make_rng(7), 4000).tobytes().decode())
        mp.setattr(pipeline, "_control_ref_path", lambda sequel: path)
    elif fault == "hpc_reversed":
        real = device_overlap.hpc_compress_all
        mp.setattr(device_overlap, "hpc_compress_all",
                   lambda seqs, k: real([s[::-1] for s in seqs], k))
    entry = harness.load_module("entries", tr["entry"])
    run = {"config": cfg, "traffic": tr, "seed": SEED, "device": "cpu",
           "workdir": tmp, "workers": 1}
    run["reads"] = gen.make_reads(SEED, cfg, tr)
    job = entry.job(entry.prepare(run))
    controls = si.control_names(run["reads"], gen.read_fasta_seq(
        os.path.join(harness.HERE, tr["control_fasta"])))
    return job, controls, run["reads"]


@pytest.mark.parametrize("fault", [None, "dropped", "other_reference",
                                   "hpc_reversed"])
def test_spike_in_flags_the_control_reads(monkeypatch, fault):
    with tempfile.TemporaryDirectory() as tmp:
        job, controls, reads = _job(monkeypatch, fault, tmp)
    sample = {r.split("\t")[0] for r in job["rows"]}
    # the reference's control reads are the simulator's: the reads of
    # the control's length (the others are 700-1,800 bp)
    assert controls == {r[0] for r in reads if len(r[1]) > 3000}
    assert len(sample & controls) >= 2
    bad = si.spike_in_bad(job, controls)
    if fault is None:
        assert bad == 0
        assert si.flagged_names(job["control"]) == sample & controls
    else:
        assert bad > 0


def test_kmers_and_flags():
    assert si.kmers("ACGTA", 3).tolist() == [0b000110, 0b011011, 0b101100]
    assert len(si.kmers("AC", 3)) == 0
    rows = ["a\t0\t0\t0\t0\t0.5", "b\t0\t0\t0\t0\t0.49", ""]
    assert si.flagged_names(rows) == {"a"} and si.flagged_names(None) == set()
    job = {"rows": ["a\t1", "b\t1", "c\t1"], "control": rows}
    assert si.spike_in_bad(job, {"a"}) == 0
    assert si.spike_in_bad(job, {"b", "z"}) == 2
    seq = gen.make_genome(np.random.RandomState(3), 3000).tobytes().decode()
    assert si.control_names([["x", seq[500:2500]], ["y", seq[::-1]]],
                            seq) == {"x"}

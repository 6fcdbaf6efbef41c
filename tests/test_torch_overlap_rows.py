"""Port engine rows (plain kernel versions on CPU tensors) vs the JAX
host spec on the multipart and high-coverage-repeat inputs of
tests/test_device_overlap.py; the port's own host spec is held to the
same rows."""

import numpy as np
import torch_util  # noqa: F401

from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import overlap_host as joh
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import overlap_host as toh
from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine
from util_synth import make_genome, sample_reads


def _cfgs(batch_size=4_000_000_000):
    t = OverlapConfig(index=IndexOpt(k=12, w=5, batch_size=batch_size),
                      map=MapOpt(min_score_med=80, min_score_good=160),
                      flt=FltOpt(min_ovlp=0))
    j = JOverlapConfig(index=JIndexOpt(k=12, w=5, batch_size=batch_size),
                       map=JMapOpt(min_score_med=80, min_score_good=160),
                       flt=JFltOpt(min_ovlp=0))
    return t, j


def test_rows_match_jax_host_multipart():
    rng = np.random.RandomState(23)
    genome = make_genome(rng, 25000)
    reads = sample_reads(rng, genome, 160, min_len=600, max_len=2000,
                         err=0.13, junk_frac=0.15)
    queries = reads[:30]
    cfg_t, cfg_j = _cfgs(batch_size=60_000)   # several index parts
    want = joh.overlap_run(list(reads), queries, cfg_j)
    assert toh.overlap_run(list(reads), queries, cfg_t,
                           device="cpu") == want
    eng = DeviceOverlapEngine(cfg_t, queries, device="cpu")
    assert eng.run(list(reads)) == want
    assert eng.n_device_calls >= 2


def test_rows_match_jax_host_high_coverage_repeats():
    rng = np.random.RandomState(7)
    core = make_genome(rng, 3000)
    genome = core * 6 + make_genome(rng, 4000)
    reads = sample_reads(rng, genome, 220, min_len=500, max_len=1800,
                         err=0.08, junk_frac=0.05)
    queries = reads[:25]
    cfg_t, cfg_j = _cfgs()
    want = joh.overlap_run(list(reads), queries, cfg_j)
    assert toh.overlap_run(list(reads), queries, cfg_t,
                           device="cpu") == want
    eng = DeviceOverlapEngine(cfg_t, queries, device="cpu")
    assert eng.run(list(reads)) == want

"""The port's multi-device overlap path (parallel/mesh, the engine's
`devices=` and `lanes_per_shard=`) against the JAX package's mesh path
on the virtual 8-device CPU mesh (tests/conftest.py), the port's
single-device engine and the port's host spec. On the CPU the shards are
entries of ["cpu"] * n. Rows are strings built from integers, so every
comparison is exact (tolerance 0)."""

import jax
import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import device_overlap as jdo
from longqc_tpu.parallel import mesh as jmesh
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_overlap as tdo
from longqc_tpu_torch.engine import overlap_host as toh
from longqc_tpu_torch.parallel import mesh as tmesh
from util_synth import make_genome, sample_reads


def _cfgs(**index):
    t = OverlapConfig(index=IndexOpt(k=12, w=5, **index),
                      map=MapOpt(min_score_med=80, min_score_good=160),
                      flt=FltOpt(min_ovlp=0))
    j = JOverlapConfig(index=JIndexOpt(k=12, w=5, **index),
                       map=JMapOpt(min_score_med=80, min_score_good=160),
                       flt=JFltOpt(min_ovlp=0))
    return t, j


def _multichip_reads():
    """tests/test_multichip.py's input."""
    rng = np.random.RandomState(5)
    genome = make_genome(rng, 20000)
    return sample_reads(rng, genome, 90, min_len=500, max_len=1500,
                        err=0.12, junk_frac=0.1)


@pytest.fixture(scope="module")
def jax_mesh_rows():
    assert len(jax.devices()) >= 8, "conftest sets up 8 CPU devices"
    reads = _multichip_reads()
    _, cfg_j = _cfgs()
    return jdo.overlap_run_device2(list(reads), reads[:24], cfg_j,
                                   mesh=jmesh.make_mesh(8),
                                   lanes_per_shard=8)


def test_rows_match_jax_mesh_and_host_spec(jax_mesh_rows):
    reads = _multichip_reads()
    cfg_t, _ = _cfgs()
    stats = {}
    rows = tdo.overlap_run_device2(list(reads), reads[:24], cfg_t,
                                   device="cpu", devices=["cpu"] * 8,
                                   lanes_per_shard=8, stats=stats)
    assert rows == jax_mesh_rows
    assert rows == toh.overlap_run(list(reads), reads[:24], cfg_t,
                                   device="cpu")
    assert stats["shards"] == ["cpu"] * 8
    assert stats["device_calls"] >= 1 and stats["host_fixed_rows"] == 0


# 20 queries in one length bucket, 3 parts, and a top anchor rung of 256,
# so some rows of every part are past it: host-fixed under a device list,
# their state carrying to the next part across the shards; on one device
# stepped at the wide rungs
_SHARD_CFG = dict(batch_size=45000)
_SHARD_LADDER = (256,)


def _shard_run(devices, lanes_per_shard):
    reads = _multichip_reads()
    cfg_t, _ = _cfgs(**_SHARD_CFG)
    eng = tdo.DeviceOverlapEngine(cfg_t, reads[30:50], device="cpu",
                                  devices=devices,
                                  lanes_per_shard=lanes_per_shard,
                                  a_ladder=_SHARD_LADDER)
    return eng.run(list(reads)), dict(eng.stats(),
                                      counters=eng.spans["counters"])


@pytest.fixture(scope="module")
def single_device_run():
    return _shard_run(None, tdo.GROUP_Q)


@pytest.mark.parametrize("shards,lanes", [(1, 8), (2, 8), (3, 4), (8, 2)])
def test_shards_match_single_device(single_device_run, shards, lanes):
    """The last group is partly empty, and with 2+ shards some shards of
    it hold no live lane (20 queries over 8, 16, 12 and 16 lanes)."""
    want_rows, want = single_device_run
    rows, got = _shard_run(["cpu"] * shards, lanes)
    assert rows == want_rows
    # the rows the one device steps past the top rung, the device list
    # host-fixes
    wide = want["counters"]["step.wide_rows"]
    assert got["host_fixed_rows"] == want["host_fixed_rows"] + wide
    assert wide > 0
    assert "step.wide_rows" not in got["counters"]
    assert got["host_only_parts"] == want["host_only_parts"] == 0
    assert len(got["part_ranges"]) == 3
    assert got["shards"] == ["cpu"] * shards


def test_synthetic_reads_match_jax():
    want = jmesh._synthetic_reads(np.random.RandomState(42), 12000, 72,
                                  500, 1400, 0.12)
    got = tmesh._synthetic_reads(np.random.RandomState(42), 12000, 72,
                                 500, 1400, 0.12)
    assert got == want


def test_overlap_dryrun_on_cpu_mesh():
    assert tmesh.make_mesh(8, device="cpu") == [torch.device("cpu")] * 8
    tmesh.overlap_dryrun(8, device="cpu")


def test_hpc_with_a_device_list_raises_in_both_packages():
    q = [["q", "ACGT" * 100, ""]]
    cfg_t = OverlapConfig(index=IndexOpt(k=15, w=10, is_hpc=True))
    cfg_j = JOverlapConfig(index=JIndexOpt(k=15, w=10, is_hpc=True))
    with pytest.raises(NotImplementedError, match="single-device"):
        jdo.DeviceOverlapEngine(cfg_j, q, mesh=jmesh.make_mesh(2))
    with pytest.raises(NotImplementedError, match="single-device"):
        tdo.DeviceOverlapEngine(cfg_t, q, device="cpu",
                                devices=["cpu"] * 2)
    # one device and no list: the HPC engine as before
    assert tdo.DeviceOverlapEngine(cfg_t, q, device="cpu").lanes == \
        tdo.GROUP_Q


def test_hash_range_part_is_host_only_under_a_device_list():
    """tests/test_torch_big_index.py's engine input, whose one part takes
    the hash-range build: under two shards the host spec computes it."""
    rng = np.random.RandomState(53)
    genome = make_genome(rng, 40000)
    reads = sample_reads(rng, genome, 300, min_len=600, max_len=1800,
                         err=0.12, junk_frac=0.1)
    queries = reads[:32]
    cfg_t, _ = _cfgs()
    eng = tdo.DeviceOverlapEngine(cfg_t, queries, device="cpu",
                                  devices=["cpu"] * 2, lanes_per_shard=16)
    eng.n_idx_sizes = (1 << 12, 1 << 14)
    eng.range_max = 1 << 15
    assert eng.run(list(reads)) == toh.overlap_run(list(reads), queries,
                                                   cfg_t, device="cpu")
    st = eng.stats()
    assert st["host_only_parts"] == 1 and st["part_ranges"][0] >= 4
    assert st["index_copies"] == 0 and st["device_calls"] == 0
    assert st["host_fixed_rows"] == len(queries)


def test_index_copied_once_per_part_and_distinct_device():
    """["cpu"] * 8 holds one copy of each part's index."""
    reads = _multichip_reads()
    cfg_t, _ = _cfgs(**_SHARD_CFG)
    eng = tdo.DeviceOverlapEngine(cfg_t, reads[:24], device="cpu",
                                  devices=["cpu"] * 8, lanes_per_shard=4)
    eng.run(list(reads))
    st = eng.stats()
    assert len(st["part_ranges"]) == 3
    assert st["index_copies"] == 3
    assert eng.lanes == 32 and len(eng.groups[0].shards) == 8

"""The port's one-device rows against the JAX package's mesh path on
the virtual 8-device CPU mesh (tests/conftest.py) and the port's host
spec, and the port's engine at other group widths (`lanes=`). Rows are
strings built from integers, so every comparison is exact (tolerance
0)."""

import jax
import numpy as np
import pytest
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
                                   device="cpu", stats=stats)
    assert rows == jax_mesh_rows
    assert rows == toh.overlap_run(list(reads), reads[:24], cfg_t,
                                   device="cpu")
    assert stats["device_calls"] >= 1 and stats["host_fixed_rows"] == 0


# 20 queries in one length bucket, 3 parts, and a top anchor rung of 256,
# so some rows of every part are past it and step at the wide rungs,
# their state carrying to the next part
_SHARD_CFG = dict(batch_size=45000)
_SHARD_LADDER = (256,)


def _lanes_run(lanes):
    reads = _multichip_reads()
    cfg_t, _ = _cfgs(**_SHARD_CFG)
    eng = tdo.DeviceOverlapEngine(cfg_t, reads[30:50], device="cpu",
                                  lanes=lanes, a_ladder=_SHARD_LADDER)
    return eng.run(list(reads)), dict(eng.stats(),
                                      counters=eng.spans["counters"])


@pytest.fixture(scope="module")
def group_q_run():
    return _lanes_run(tdo.GROUP_Q)


@pytest.mark.parametrize("lanes", [8, 4, 12, 2])
def test_group_width_keeps_the_rows(group_q_run, lanes):
    """The 20 queries over groups of 8, 4, 12 and 2 lanes (the last
    group of 8 and of 12 partly empty) give the rows of one group of
    GROUP_Q lanes. Every row past the top rung steps at a wide rung or,
    past the widest (512 at 2 lanes), is host-fixed."""
    want_rows, want = group_q_run
    rows, got = _lanes_run(lanes)
    assert rows == want_rows
    past = got["host_fixed_rows"] - want["host_fixed_rows"]
    assert (past > 0) == (lanes == 2)
    assert got["flag_counts"].get(str(tdo.F_ANCH), 0) == past
    assert got["counters"]["step.wide_rows"] + past == \
        want["counters"]["step.wide_rows"]
    assert got["counters"]["step.wide_rows"] > 0
    assert got["host_only_parts"] == want["host_only_parts"] == 0
    assert len(got["part_ranges"]) == 3

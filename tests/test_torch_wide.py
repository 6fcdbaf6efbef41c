"""The wide-hash path (2k > 30: the pb-hifi fast preset, k = 19 / w = 10;
hashes on int64 lanes) and wide windows (w = 33..255) of the port against
the JAX package, on the CPU (the B1 kernel's plain version; the JAX side
sketches these configurations with its XLA path). Every comparison is
exact: integers, multisets, TSV rows."""

import numpy as np
import pytest
import torch
from torch_util import index_triples as _triples
from torch_util import rand_reads as _rand_reads

from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import device_index as jdi
from longqc_tpu.engine import device_overlap as jdo
from longqc_tpu_torch import convert
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import overlap_host as toh
from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine
from oracles.sketch_ref import sketch as ref_sketch
from util_synth import make_genome, sample_reads


# at w = 255 the JAX tile program unrolls 255 window offsets and takes
# minutes to compile on the CPU, so those cases are held against the
# oracle alone (tests/oracles/sketch_ref.py, the emulation of sketch.c
# that the JAX sketch is validated against)
@pytest.mark.parametrize("k,w,jax_side", [
    (19, 10, True), (28, 5, True), (16, 32, True), (12, 33, True),
    (12, 64, True), (19, 40, True), (12, 255, False), (19, 255, False)])
def test_tile_sketch_matches_jax_tile_flat(k, w, jax_side):
    """Per tile, the port's B1 output (expanded and sorted by tile_flat)
    holds the entries of the JAX tile_flat and of the oracle's per-read
    sketches: int64 lanes when 2k > 30, any w below 256."""
    rng = np.random.RandomState(7 + k + w)
    part = _rand_reads(rng, 30, 300, 1900)
    tiles, jumbo = di.pack_part_tiles(part, w, ladder=di.TILE_LADDER_SMALL)
    jtiles, _ = jdi.pack_part_tiles(part, w, ladder=jdi.TILE_LADDER_SMALL)
    assert not jumbo and len(tiles) == len(jtiles)
    wide = 2 * k > 30
    got = []
    for t, jt in zip(tiles, jtiles):
        ih, irid, ips, n_exp = di._run_tile(t, k, w, "cpu")
        assert ih.dtype == (torch.int64 if wide else torch.int32)
        got += _triples(ih, irid, ips)
        if jax_side:
            jr = jdi._run_tile(jt, k, w)
            assert np.asarray(jr[0]).dtype == ih.numpy().dtype
            assert int(n_exp) == int(np.asarray(jr[3]))
            assert _triples(ih, irid, ips) == _triples(*jr[:3])
    want = sorted((x >> 8, gid, y & 0xFFFFFFFF)
                  for gid, r in enumerate(part)
                  for x, y in ref_sketch(r[1], w, k))
    assert sorted(got) == want
    assert len(got) > (100 if w < 100 else 20)
    if wide:
        # past int32 (k = 16 with w = 32 keeps the smallest of 32 hashes
        # of 32 bits: past the u32 variant's 30 bits)
        assert max(h for h, _, _ in got) > 1 << (31 if k >= 19 else 30)


def test_wide_index_matches_jax_through_convert():
    """build_device_index at k = 19: the sorted (hash, rid, ps) multiset
    and mid_occ of the JAX index, which convert carries across on int64
    lanes; the port's host spec index holds the same entries."""
    k, w = 19, 10
    rng = np.random.RandomState(31)
    core = "".join("ACGT"[j] for j in rng.randint(0, 4, 400))
    part = [["c%d" % i, core, ""] for i in range(12)]
    part += _rand_reads(rng, 100, 40, 1500)
    jidx = jdi.build_device_index(part, k, w, ladder=jdi.TILE_LADDER_SMALL,
                                  n_idx_sizes=jdi.N_IDX_SIZES_SMALL,
                                  mid_occ_frac=0.05)
    carried = convert.index_from_arrays(jidx["ih"], jidx["irid"],
                                        jidx["ips"], jidx["mid_occ"],
                                        device="cpu")
    idx = di.build_device_index(part, k, w, device="cpu",
                                ladder=di.TILE_LADDER_SMALL,
                                n_idx_sizes=di.N_IDX_SIZES_SMALL,
                                mid_occ_frac=0.05)
    assert carried["ih"].dtype == idx["ih"].dtype == torch.int64
    assert idx["irid"].dtype == idx["ips"].dtype == torch.int32
    got = _triples(idx["ih"], idx["irid"], idx["ips"])
    assert got == _triples(carried["ih"], carried["irid"], carried["ips"])
    assert got[-1][0] > 1 << 31
    assert (np.diff(idx["ih"].numpy()) >= 0).all()
    assert int(idx["mid_occ"]) == int(carried["mid_occ"]) > 1
    hidx = toh.build_index(part, k, w, device="cpu")
    assert got == sorted(zip(hidx.h.astype(np.int64).tolist(),
                             hidx.rid.tolist(), hidx.ps.tolist()))


def _cfgs(k, w, batch_size=4_000_000_000):
    t = OverlapConfig(index=IndexOpt(k=k, w=w, batch_size=batch_size),
                      map=MapOpt(min_score_med=80, min_score_good=160),
                      flt=FltOpt(min_ovlp=0))
    j = JOverlapConfig(index=JIndexOpt(k=k, w=w, batch_size=batch_size),
                       map=JMapOpt(min_score_med=80, min_score_good=160),
                       flt=JFltOpt(min_ovlp=0))
    return t, j


# the two wide-hash inputs of tests/test_device_overlap.py (one part, and
# several parts), and a w = 40 run at k = 12
RUNS = {
    "k19": dict(seed=11, genome=30000, n=120, min_len=900, max_len=2600,
                err=0.04, junk=0.05, nq=40, k=19, w=10, calls=1),
    "k19-multipart": dict(seed=41, genome=24000, n=140, min_len=700,
                          max_len=2000, err=0.08, junk=0.1, nq=24, k=19,
                          w=10, batch_size=60_000, calls=2),
    "w40": dict(seed=11, genome=30000, n=120, min_len=900, max_len=2600,
                err=0.04, junk=0.05, nq=40, k=12, w=40, calls=1),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_rows_match_jax_engine_and_host_spec(name):
    """Whole-run rows of the port's engine equal the JAX engine's and
    the port's host spec. (The JAX host spec takes the chain gap cost in
    f32 where chain.c and both engines take a double, so the JAX engine
    is the JAX side here.)"""
    r = RUNS[name]
    rng = np.random.RandomState(r["seed"])
    genome = make_genome(rng, r["genome"])
    reads = sample_reads(rng, genome, r["n"], min_len=r["min_len"],
                         max_len=r["max_len"], err=r["err"],
                         junk_frac=r["junk"])
    queries = reads[:r["nq"]]
    cfg_t, cfg_j = _cfgs(r["k"], r["w"],
                         r.get("batch_size", 4_000_000_000))
    jeng = jdo.DeviceOverlapEngine(cfg_j, queries)
    want = jeng.run(list(reads))
    eng = DeviceOverlapEngine(cfg_t, queries, device="cpu")
    rows = eng.run(list(reads))
    assert rows == want
    assert rows == toh.overlap_run(list(reads), queries, cfg_t,
                                   device="cpu")
    assert eng.n_device_calls >= r["calls"]
    assert eng.n_host_fallback == 0 and eng.n_host_only_parts == 0
    assert sum(row.split("\t")[3] != "0" for row in rows) > r["nq"] // 2
    hdt = torch.int64 if 2 * r["k"] > 30 else torch.int32
    assert all(g.qh.dtype == hdt for g in eng.groups)


def test_hpc_with_wide_k_still_raises():
    cfg = OverlapConfig(index=IndexOpt(k=19, w=10, is_hpc=True))
    with pytest.raises(NotImplementedError, match="k <= 15"):
        DeviceOverlapEngine(cfg, [["q", "ACGT" * 50, ""]], device="cpu")


@pytest.mark.parametrize("k,w", [(29, 10), (12, 256), (12, 0)])
def test_sketch_refuses_what_no_lane_holds(k, w):
    part = [["r", "ACGT" * 100, ""]]
    with pytest.raises(ValueError):
        di.build_device_index(part, k, w, device="cpu",
                              ladder=di.TILE_LADDER_SMALL,
                              n_idx_sizes=di.N_IDX_SIZES_SMALL)

"""Port device index (flat layout, plain B1 on CPU tensors) vs the JAX
package's build_device_index: the same sorted (hash, rid, pos) multiset
and the same mid_occ. The JAX single-key sort is unstable, so entries
compare as multisets."""

import numpy as np
import pytest
import torch
from torch_util import index_triples as _triples
from torch_util import rand_reads as _rand_reads

from longqc_tpu.engine import device_index as jdi
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import overlap_host as toh


@pytest.mark.parametrize("k,w", [(12, 5), (15, 5), (12, 10)])
def test_build_device_index_matches_jax(k, w):
    rng = np.random.RandomState(11 + k + w)
    part = _rand_reads(rng, 120, 40, 1500)
    jidx = jdi.build_device_index(part, k, w, ladder=jdi.TILE_LADDER_SMALL,
                                  n_idx_sizes=jdi.N_IDX_SIZES_SMALL)
    idx = di.build_device_index(part, k, w, device="cpu",
                                ladder=di.TILE_LADDER_SMALL,
                                n_idx_sizes=di.N_IDX_SIZES_SMALL)
    got = _triples(idx["ih"], idx["irid"], idx["ips"])
    assert got == _triples(jidx["ih"], jidx["irid"], jidx["ips"])
    assert (np.diff(idx["ih"].numpy()) >= 0).all()
    assert int(idx["mid_occ"]) == int(np.asarray(jidx["mid_occ"]))
    # and the port's host spec index holds the same entries
    hidx = toh.build_index(part, k, w, device="cpu")
    want = sorted(zip(hidx.h.astype(np.uint32).astype(np.int32).tolist(),
                      hidx.rid.tolist(), hidx.ps.tolist()))
    assert got == want


def test_build_device_index_mid_occ_frac():
    rng = np.random.RandomState(5)
    core = "".join("ACGT"[j] for j in rng.randint(0, 4, 300))
    part = [["c%d" % i, core, ""] for i in range(30)]
    part += _rand_reads(rng, 20, 50, 400)
    for frac in (0.5, 0.1, 2e-4):
        jidx = jdi.build_device_index(part, 12, 5,
                                      ladder=jdi.TILE_LADDER_SMALL,
                                      n_idx_sizes=jdi.N_IDX_SIZES_SMALL,
                                      mid_occ_frac=frac)
        idx = di.build_device_index(part, 12, 5, device="cpu",
                                    ladder=di.TILE_LADDER_SMALL,
                                    n_idx_sizes=di.N_IDX_SIZES_SMALL,
                                    mid_occ_frac=frac)
        assert int(idx["mid_occ"]) == int(np.asarray(jidx["mid_occ"]))


def test_tile_flat_chunks_match_jax_tiles():
    rng = np.random.RandomState(7)
    part = _rand_reads(rng, 40, 30, 900)
    tiles, jumbo = di.pack_part_tiles(part, 5, ladder=di.TILE_LADDER_SMALL)
    jtiles, _ = jdi.pack_part_tiles(part, 5, ladder=jdi.TILE_LADDER_SMALL)
    assert not jumbo and len(tiles) == len(jtiles)
    for t, jt in zip(tiles, jtiles):
        ih, irid, ips, n_exp = di._run_tile(t, 12, 5, "cpu")
        jr = jdi._run_tile(jt, 12, 5)
        assert int(n_exp) == int(np.asarray(jr[3]))
        assert _triples(ih, irid, ips) == _triples(*jr[:3])


def test_part_past_the_width_ladder_raises():
    """A part past the width ladder takes the hash-range build; past the
    entry limit (shrunk here) or the free device memory it raises, and
    the engine computes it on the host."""
    rng = np.random.RandomState(3)
    part = _rand_reads(rng, 30, 200, 600)
    idx = di.build_device_index(part, 12, 5, device="cpu",
                                ladder=di.TILE_LADDER_SMALL,
                                n_idx_sizes=(1 << 10,))
    assert idx["n_ranges"] >= 1 and idx["n_real"] > 1 << 10
    with pytest.raises(di.IndexOverflowError, match="entries"):
        di.build_device_index(part, 12, 5, device="cpu",
                              ladder=di.TILE_LADDER_SMALL,
                              n_idx_sizes=(1 << 10,),
                              max_entries=idx["n_real"] - 1)
    with pytest.raises(di.IndexOverflowError, match="device bytes"):
        di.build_device_index(part, 12, 5, device="cpu",
                              ladder=di.TILE_LADDER_SMALL,
                              n_idx_sizes=(1 << 10,), mem_free=1 << 20)
    assert torch.get_num_threads() == 2

"""The hash-range build of the port's device index (parts past the width
ladder, engine/device_index) vs the port's single-sort flat build and
the JAX package's hash-range-sharded index (its stack flattened, pads
dropped), the engine's rows over such a part vs the JAX engine on its
sharded layout and the JAX host spec, and the count pass over a
range-built index vs the JAX sharded count pass. Ladders and range
sizes are shrunk so that small parts take these paths with at least 4
ranges. Every comparison is exact: the JAX single-key sorts are
unstable, so entries compare as multisets per hash run."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_util import index_triples, np_, rand_reads, t32

from longqc_tpu.config import FltOpt as JFltOpt
from longqc_tpu.config import IndexOpt as JIndexOpt
from longqc_tpu.config import MapOpt as JMapOpt
from longqc_tpu.config import OverlapConfig as JOverlapConfig
from longqc_tpu.engine import device_index as jdi
from longqc_tpu.engine import device_overlap as jdo
from longqc_tpu.engine import overlap_host as joh
from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.engine import device_overlap as tdo
from util_synth import make_genome, sample_reads

# the JAX package's sharded layout needs every tile chunk within its
# top width; the port's ranges hold at most RANGE entries
SIZES = (1 << 12, 1 << 14)
RANGE = 1 << 15


def _part(seed=21):
    rng = np.random.RandomState(seed)
    part = rand_reads(rng, 200, 600, 1800)
    core = "".join("ACGT"[j] for j in rng.randint(0, 4, 500))
    part += [["c%d" % i, core, ""] for i in range(40)]   # a repeat
    return part


def _port(part, k, w, **kw):
    return di.build_device_index(part, k, w, device="cpu",
                                 ladder=di.TILE_LADDER_SMALL, **kw)


def _flat_jax(jidx):
    """The JAX index's (stacked or flat) arrays as one flat triple
    list, pads dropped."""
    return index_triples(*(np.asarray(jidx[n]).reshape(-1)
                           for n in ("ih", "irid", "ips")))


@pytest.mark.parametrize("k,w", [(12, 5), (19, 10)])
def test_range_build_matches_flat_build_and_jax_sharded(k, w):
    """k = 19 puts the hashes on int64 lanes in both packages."""
    part = _part()
    flat = _port(part, k, w, n_idx_sizes=di.N_IDX_SIZES_SMALL)
    rng_b = _port(part, k, w, n_idx_sizes=SIZES, range_max=RANGE)
    assert flat["n_ranges"] == 0 and rng_b["n_ranges"] >= 4
    n = flat["n_real"]
    assert rng_b["n_real"] == n and rng_b["n_idx"] % di.PAD_TO == 0
    assert torch.equal(rng_b["ih"][:n], flat["ih"][:n])
    assert (rng_b["ih"][n:] == di.infk(rng_b["ih"].dtype)).all()
    got = index_triples(rng_b["ih"], rng_b["irid"], rng_b["ips"])
    assert got == index_triples(flat["ih"], flat["irid"], flat["ips"])
    assert int(rng_b["mid_occ"]) == int(flat["mid_occ"]) > 1

    jidx = jdi.build_device_index(part, k, w, ladder=jdi.TILE_LADDER_SMALL,
                                  n_idx_sizes=SIZES)
    assert jidx["n_shards"] > 1
    assert got == _flat_jax(jidx)
    assert int(rng_b["mid_occ"]) == int(np.asarray(jidx["mid_occ"]))


@pytest.mark.parametrize("frac", [0.5, 0.1, 2e-4])
def test_range_mid_occ_past_the_histogram(frac, monkeypatch):
    """Run lengths at or past the histogram's cap (shrunk to 3) take the
    exact tail: mid_occ equals the flat build's at every quantile."""
    part = _part(5)
    want = _port(part, 12, 5, n_idx_sizes=di.N_IDX_SIZES_SMALL,
                 mid_occ_frac=frac)
    monkeypatch.setattr(di, "_RL_CAP", 3)
    got = _port(part, 12, 5, n_idx_sizes=SIZES, range_max=RANGE,
                mid_occ_frac=frac)
    assert got["n_ranges"] >= 4
    assert int(got["mid_occ"]) == int(want["mid_occ"])


def test_range_build_reruns_tiles_past_their_crop(monkeypatch):
    """Crops far below the tiles' real entries: every tile is re-run and
    kept whole, and no entry is lost."""
    part = _part(9)
    want = _port(part, 12, 5, n_idx_sizes=di.N_IDX_SIZES_SMALL)
    monkeypatch.setattr(di, "_compact_width",
                        lambda t, w: min(t.R * t.W, 1024))
    seen = []
    got = _port(part, 12, 5, n_idx_sizes=(1 << 10,), range_max=RANGE,
                on_chunk=lambda c, n: seen.append((c[0].shape[0], n)))
    assert got["n_ranges"] >= 4
    assert all(size > 1024 for size, _n in seen)
    assert sum(n for _size, n in seen) == got["n_real"] == want["n_real"]
    assert index_triples(got["ih"], got["irid"], got["ips"]) == \
        index_triples(want["ih"], want["irid"], want["ips"])


def test_engine_rows_match_jax_sharded_engine_and_host_spec():
    """The inputs of the JAX package's sharded-engine test: the whole
    part rides the device path through the range-built index."""
    rng = np.random.RandomState(53)
    genome = make_genome(rng, 40000)
    reads = sample_reads(rng, genome, 300, min_len=600, max_len=1800,
                         err=0.12, junk_frac=0.1)
    queries = reads[:32]
    kw = dict(map=dict(min_score_med=80, min_score_good=160),
              flt=dict(min_ovlp=0))
    cfg_j = JOverlapConfig(index=JIndexOpt(k=12, w=5),
                           map=JMapOpt(**kw["map"]),
                           flt=JFltOpt(**kw["flt"]))
    cfg_t = OverlapConfig(index=IndexOpt(k=12, w=5), map=MapOpt(**kw["map"]),
                          flt=FltOpt(**kw["flt"]))
    want = joh.overlap_run(list(reads), queries, cfg_j)
    jeng = jdo.DeviceOverlapEngine(cfg_j, queries)
    jeng.n_idx_sizes = SIZES
    assert jeng.run(list(reads)) == want
    assert jeng.n_sharded_parts == 1

    eng = tdo.DeviceOverlapEngine(cfg_t, queries, device="cpu")
    eng.n_idx_sizes = SIZES
    eng.range_max = RANGE
    assert eng.run(list(reads)) == want
    assert eng.n_hash_range_parts == 1 and eng.n_host_only_parts == 0
    assert eng.n_host_fallback == 0
    st = eng.stats()
    assert st["hash_range_parts"] == 1
    assert set(st["index_s"]) == {"pack", "tiles", "merge"}


@pytest.mark.parametrize("mcrop", [None, 16])
def test_count_pass_over_range_index_matches_jax_sharded(mcrop):
    """The data of the JAX package's sharded count-crop test: a stack of
    4 hash-range shards of 1,024 keys under 2^20. The port builds its
    flat index from the same entries with the range merge (one chunk
    per shard, 8 ranges); n_q and occ equal the JAX sharded count's."""
    rng = np.random.RandomState(11)
    S, Ns, kb = 4, 1024, 20
    lgS = S.bit_length() - 1
    keys = np.sort(rng.randint(0, 1 << 20, S * Ns).astype(np.int64))
    stack = np.full((S, Ns), np.iinfo(np.int64).max, np.int64)
    for s in range(S):
        ks = keys[(keys >> (kb - lgS)) == s][:Ns]
        stack[s, :len(ks)] = ks
        stack[s] = np.sort(stack[s])
    ihs = jnp.asarray(stack)
    # the boundary keys as the JAX build makes them (n_bnd scales with
    # the stack; the default 8,192 exceeds a 4,096-entry stack)
    bnd_ck = jdi._bnd_ck(ihs, S=S, kb=kb, n_bnd=max(S * Ns // 1024, 1))
    Q, M = 4, 32
    qh = rng.randint(0, 1 << 20, (Q, M)).astype(np.int64)
    qcnt = rng.randint(1, 3, (Q, M)).astype(np.int32)
    n_slots = rng.randint(0, M // 2, Q).astype(np.int32)
    # half the slots look up indexed keys, some of them repeated ones
    hit = np.random.RandomState(12)
    qh[:, ::2] = hit.choice(np.concatenate([keys, keys[:40].repeat(8)]),
                            (Q, M // 2))
    jcnt, _jleft, jocc = jdo._count_expanded_sharded(
        ihs, bnd_ck, jnp.asarray(qh), jnp.asarray(qcnt),
        jnp.asarray(n_slots), jnp.int32(6), kb=kb, mcrop=mcrop)

    real = stack != np.iinfo(np.int64).max
    chunks = [[torch.from_numpy(stack[s]),
               torch.zeros(Ns, dtype=torch.int32),
               torch.zeros(Ns, dtype=torch.int32)] for s in range(S)]
    (ih, _irid, _ips), n_ranges, _mo = di._range_merge(
        chunks, kb // 2, int(real.sum()), int(real.sum()) // 8 + 64, 6, 0.)
    assert n_ranges == 8 and ih.dtype == torch.int64
    assert np.array_equal(np_(ih)[:int(real.sum())], stack[real])
    cnt, _left, occ = tdo._count_expanded(
        ih, torch.from_numpy(qh), t32(qcnt), t32(n_slots),
        torch.tensor(6, dtype=torch.int32), mcrop=mcrop)
    assert np.array_equal(np_(cnt), np.asarray(jcnt))
    for r in range(Q):
        ns = n_slots[r]
        assert np.array_equal(np_(occ)[r, :ns], np.asarray(jocc)[r, :ns])
    assert np.asarray(jcnt).sum() > 0

"""Port sketch vs the JAX package: the tensor sketch (the host spec's,
ops/sketch) against JAX sketch_batch and the oracle, and the B1 plain
version (ops/sketch_cuda.sketch_tiles on CPU tensors) against the JAX
Pallas sketch kernel in interpret mode. All comparisons exact."""

import random

import numpy as np
import pytest
import torch
from torch_util import np_, rand_seq, t32

from longqc_tpu.engine import device_index as jdi
from longqc_tpu.io.pack import pack_reads
from longqc_tpu.ops.sketch import sketch_batch as jax_sketch_batch
from longqc_tpu.ops.sketch import sketch_to_lists as jax_to_lists
from longqc_tpu.ops.sketch_pallas import sketch_tiles_pallas
from longqc_tpu_torch.engine import device_index as di
from longqc_tpu_torch.ops.sketch import sketch_batch, sketch_to_lists
from longqc_tpu_torch.ops.sketch_cuda import sketch_tiles
from oracles.sketch_ref import sketch as ref_sketch


def _cases():
    random.seed(42)
    rnd = ["".join(random.choice("ACGT") for _ in range(random.randint(60, 300)))
           for _ in range(20)]
    random.seed(43)
    ns = ["".join(random.choice("ACGTN") for _ in range(random.randint(40, 250)))
          for _ in range(20)]
    random.seed(44)
    low = ["".join(random.choice(a) for _ in range(200))
           for a in ["A", "AT", "AC", "ACG", "ACGTACGTA"]]
    short = ["ACGTACGTACGT", "ACGT" * 3, "A" * 20, "ACGTN" * 4]
    return {"random": (rnd, [(5, 12), (5, 15)]), "with_ns": (ns, [(5, 12)]),
            "low_complexity": (low, [(5, 12)]), "short": (short, [(5, 5)])}


CASES = [(name, w, k) for name, (_s, wk) in _cases().items()
         for (w, k) in wk]


@pytest.mark.parametrize("name,w,k", CASES)
def test_sketch_batch_matches_jax_and_oracle(name, w, k):
    seqs = _cases()[name][0]
    reads = [["r%d" % i, s, "I" * len(s)] for i, s in enumerate(seqs)]
    batch = pack_reads(reads)
    got = sketch_to_lists(sketch_batch(torch.from_numpy(batch.codes),
                                       torch.from_numpy(batch.lengths),
                                       w=w, k=k), k)
    jres = jax_sketch_batch(batch.codes, batch.lengths, w=w, k=k)
    want = jax_to_lists(jres, k)
    for i, s in enumerate(seqs):
        for a, b in zip(got[i], want[i]):
            assert np.array_equal(a.astype(np.uint64), b.astype(np.uint64)), i
        ref = sorted(((x >> 8, (y >> 1) & 0x7FFFFFFF, y & 1)
                      for x, y in ref_sketch(s, w, k)),
                     key=lambda t: (t[1], t[0]))
        h, p, z, _ = got[i]
        have = sorted(zip(h.tolist(), p.tolist(), z.tolist()),
                      key=lambda t: (t[1], t[0]))
        assert have == ref, i


def _tile(reads, w, R, W):
    b = jdi._TileBuilder(R, W, max(w - 1, 1))
    b2 = di._TileBuilder(R, W, max(w - 1, 1))
    for gid, r in enumerate(reads):
        b.add(gid, r[1])
        b2.add(gid, r[1])
    t, t2 = b.tiles(), b2.tiles()
    assert len(t) == 1 and len(t2) == 1
    for f in ("codes2", "nmask", "startmask", "endmask", "starts", "gids",
              "used"):
        assert np.array_equal(getattr(t[0], f), getattr(t2[0], f)), f
    return t2[0]


def _tile_reads(rng, W, k, n):
    reads = []
    for i in range(n):
        ln = rng.randint(40, min(W // 3, 900))
        s = rand_seq(rng, ln, with_n=0.03 if i % 4 == 1 else 0.0)
        if i % 9 == 2:   # a short symmetric stretch (AT)n
            p = rng.randint(0, ln)
            s = s[:p] + "AT" * rng.randint(8, 40) + s[p:]
        reads.append(["r%d" % i, s])
    reads.append(["tiny", rand_seq(rng, k + 2)])
    return reads


@pytest.mark.parametrize("k,w", [(12, 5), (15, 10)])
@pytest.mark.parametrize("R,W", list(jdi.TILE_LADDER_SMALL[:2]))
def test_sketch_tiles_plain_matches_pallas(k, w, R, W):
    rng = np.random.RandomState(17 + W + k)
    reads = []
    b = di._TileBuilder(R, W, max(w - 1, 1))
    for r in _tile_reads(rng, W, k, 400):
        b.add(len(reads), r[1])
        reads.append(r)
        if len(b.rows) >= R - 1:
            break
    t = _tile(reads, w, R, W)
    jres = sketch_tiles_pallas(t.codes2, t.nmask, t.startmask, t.endmask,
                               t.starts, t.gids, W=W, k=k, w=w,
                               interpret=True)
    got = sketch_tiles(t32(t.codes2), t32(t.nmask), t32(t.startmask),
                       t32(t.endmask), t32(t.starts), t32(t.gids),
                       W=W, k=k, w=w)
    assert not np_(got["flags"]).any()
    ok_rows = np.asarray(jres["flags"]) == 0
    assert ok_rows.sum() >= R - 1
    emit = np.asarray(jres["emit"])
    assert emit.sum() > 0
    assert np.array_equal(np_(got["emit"])[ok_rows], emit[ok_rows])
    on = (emit > 0) & ok_rows[:, None]
    for f in ("hash", "rid", "pos", "strand"):
        assert np.array_equal(np_(got[f])[on], np.asarray(jres[f])[on]), f

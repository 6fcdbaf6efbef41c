"""B5 plain version (ops/extend.extz_batch on CPU tensors) vs the JAX
package's lax.scan formulation (ops/extend.extz_batch) and its Pallas
kernel in interpret mode (ops/extend_pallas.extz_batch_pallas): all
eight outputs equal (tolerance 0: integer scores, coordinates and
flags), for extz and extd, W in {32, 63, 64, 127, 300} and a W past
both sequences, zdrop in {100, 400} (the Pallas kernel up to its limit,
W <= 63); that the band clamp the CUDA kernel applies, W -> min(W,
max(qlen, columns)), leaves every output as it is; and the plain version
against the full-DP host reference on short pairs."""

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu.ops.extend import extz_batch as jax_extz_batch
from longqc_tpu.ops.extend_pallas import extz_batch_pallas
from longqc_tpu_torch.ops import extend as ext
from test_extend_pallas import _make_pairs

GAPS = {"extz": {}, "extd": {"gapo2": 24, "gape2": 1}}


def _port(qs, qlens, ts, tlens, **kw):
    res = ext.extz_batch(torch.from_numpy(qs), torch.from_numpy(qlens),
                         torch.from_numpy(ts), torch.from_numpy(tlens), **kw)
    return {k: v.numpy() for k, v in res.items()}


@pytest.mark.parametrize("zdrop", [100, 400])
@pytest.mark.parametrize("W", [32, 63, 64, 127, 300, 450])
@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extz_batch_matches_jax_scan_and_pallas(mode, W, zdrop):
    """W = 450 lies past both code arrays (Lq 200, Lt 184), so the
    kernel's band clamp applies to every pair there."""
    rng = np.random.RandomState(W + zdrop + len(mode))
    B, Lq, Lt = 15, 200, 184
    qs, qlens, ts, tlens, _ = _make_pairs(rng, B, Lq, Lt)
    gap = GAPS[mode]
    want = jax_extz_batch(qs, qlens, ts, tlens, W=W, Lq=Lq, Lt=Lt,
                          zdrop=zdrop, **gap)
    got = _port(qs, qlens, ts, tlens, W=W, zdrop=zdrop, **gap)
    for key in ext.KEYS:
        np.testing.assert_array_equal(np.asarray(want[key]), got[key],
                                      err_msg=key)
    if W <= 63:                     # the Pallas kernel's band limit
        pal = extz_batch_pallas(qs, qlens, ts, tlens, W=W, zdrop=zdrop,
                                interpret=True, **gap)
        for key in ext.KEYS:
            np.testing.assert_array_equal(pal[key], got[key], err_msg=key)
    assert got["zdropped"].dtype == bool
    if zdrop == 100:
        assert got["zdropped"].any()          # the random pairs drop


@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_extz_batch_plain_matches_host(mode):
    rng = np.random.RandomState(31 + len(mode))
    W = 24
    qs, qlens, ts, tlens, pairs = _make_pairs(rng, 10, 120, 120)
    gap = GAPS[mode]
    got = _port(qs, qlens, ts, tlens, W=W, **gap)
    for b, (qc, tc) in enumerate(pairs):
        want = ext.extz_host(qc, tc, w=W, **gap)
        for key in ("max", "max_q", "max_t", "mte", "mte_q"):
            assert int(got[key][b]) == want[key], (b, key)
        if want["mqe"] > -(10 ** 8):
            assert int(got["mqe"][b]) == want["mqe"], b
            assert int(got["mqe_t"][b]) == want["mqe_t"], b


def test_extz_batch_edges_match_jax():
    """Zero lengths, lengths past the code arrays' width and a band
    wider than both sequences, against the lax.scan formulation."""
    rng = np.random.RandomState(5)
    B, Lq, Lt, W = 6, 40, 36, 63
    qs = rng.randint(0, 5, (B, Lq)).astype(np.int32)
    ts = qs[:, :Lt].copy()
    qlens = np.array([0, 40, 45, 12, 40, 1], np.int32)
    tlens = np.array([30, 0, 36, 50, 7, 1], np.int32)
    want = jax_extz_batch(qs, qlens, ts, tlens, W=W, Lq=Lq, Lt=Lt)
    got = _port(qs, qlens, ts, tlens, W=W)
    for key in ext.KEYS:
        np.testing.assert_array_equal(np.asarray(want[key]), got[key],
                                      err_msg=key)


@pytest.mark.parametrize("mode", ["extz", "extd"])
def test_band_clamp_leaves_outputs_unchanged(mode):
    """Outputs at W equal those at min(W, max(qlen, columns)) per pair
    (the CUDA wide body's clamp): pairs of mixed lengths, some query
    lengths past the code arrays' width, zero lengths, every W from the
    tightest clamp up."""
    rng = np.random.RandomState(17 + len(mode))
    B, Lq, Lt = 12, 90, 70
    qs, qlens, ts, tlens, _ = _make_pairs(rng, B, Lq, Lt)
    qlens[:3] = (0, Lq + 9, 5)
    tlens[3:5] = (0, Lt + 4)
    gap = GAPS[mode]
    cols = np.minimum(tlens, Lt)
    for W in (40, 95, 400):
        full = _port(qs, qlens, ts, tlens, W=W, **gap)
        for b in range(B):
            Wb = max(min(W, max(int(qlens[b]), int(cols[b]))), 1)
            one = _port(qs[b:b + 1], qlens[b:b + 1], ts[b:b + 1],
                        tlens[b:b + 1], W=Wb, **gap)
            for key in ext.KEYS:
                assert one[key][0] == full[key][b], (W, b, key)


def test_extz_batch_takes_numpy_and_never_drops_to_cpu():
    """Numpy inputs run where `device` says, on the card by default;
    with no card the default raises instead of running on the CPU."""
    rng = np.random.RandomState(2)
    qs, qlens, ts, tlens, _ = _make_pairs(rng, 5, 100, 100)
    a = ext.extz_batch(qs, qlens, ts, tlens, W=16, device="cpu")
    b = _port(qs, qlens, ts, tlens, W=16)
    for key in ext.KEYS:
        assert a[key].device.type == "cpu"
        np.testing.assert_array_equal(a[key].numpy(), b[key])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ext.extz_batch(qs, qlens, ts, tlens, W=16)
        with pytest.raises(RuntimeError):
            ext.extz_batch(qs, qlens, ts, tlens, W=16, device="cuda")
    with pytest.raises(ValueError):
        ext.extz_batch(qs, qlens, ts, tlens, W=16, gapo2=24, device="cpu")

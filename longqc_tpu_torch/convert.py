"""Carry JAX-built state across into the port's tensors.

The JAX package's device index (engine/device_index.build_device_index:
ih, irid, ips, mid_occ) and a JAX query group's staged arrays and
accumulators (engine/device_overlap._Group, with the HPC group's
per-slot spans and f32 mean-span state) become the port's tensors on a
given device (the card unless the caller asks for the CPU), so one
input can be fed to both packages' step programs and their
intermediates compared. Everything arrives as numpy arrays
(np.asarray of the JAX arrays); this module imports no jax.
"""

import numpy as np
import torch

from longqc_tpu_torch.ops._ext import require_device

GROUP_ARRAYS = ("qh", "qps", "qcnt", "n_slots", "n_exp", "qlen", "qvalid")
STATE_ARRAYS = ("lam", "lam2", "avgk_set", "m_cnts")
HPC_ARRAYS = ("qspan", "avgk_val")


def _t(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype))
                            ).to(require_device(device))


def _hash_lanes(a, device):
    """Hash lanes keep their width: int64 (2k > 30) stays int64."""
    a = np.asarray(a)
    return _t(a, np.int64 if a.dtype == np.int64 else np.int32, device)


def index_from_arrays(ih, irid, ips, mid_occ, device="cuda"):
    """A flat JAX index (1-D ih, int32 or int64 for 2k > 30; int32 irid /
    ips; scalar mid_occ) as the port's index dict."""
    ih = np.asarray(ih)
    if ih.ndim != 1:
        raise ValueError("only the flat (1-D) index layout is ported")
    return {"ih": _hash_lanes(ih, device),
            "irid": _t(irid, np.int32, device),
            "ips": _t(ips, np.int32, device),
            "mid_occ": torch.tensor(int(np.asarray(mid_occ)),
                                    dtype=torch.int32,
                                    device=require_device(device))}


def group_from_arrays(arrays, device="cuda"):
    """A JAX query group's staged arrays (GROUP_ARRAYS: qh, qps, qcnt,
    n_slots, n_exp, qlen, qvalid) and accumulators (STATE_ARRAYS: lam,
    lam2 int64; avgk_set, m_cnts int32) as port tensors; `arrays` maps
    those names to numpy arrays; qh keeps int64 lanes when it has
    them. An HPC group also carries HPC_ARRAYS (qspan int32, avgk_val
    float32)."""
    out = {n: _t(arrays[n], np.int32, device) for n in GROUP_ARRAYS}
    out["qh"] = _hash_lanes(arrays["qh"], device)
    for n in STATE_ARRAYS:
        dt = np.int64 if n in ("lam", "lam2") else np.int32
        out[n] = _t(arrays[n], dt, device)
    if "qspan" in arrays:
        out["qspan"] = _t(arrays["qspan"], np.int32, device)
        out["avgk_val"] = _t(arrays["avgk_val"], np.float32, device)
    return out

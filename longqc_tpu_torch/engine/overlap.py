"""Overlap-engine dispatcher (port of longqc_tpu/engine/overlap.py).

Every configuration the device engine (engine/device_overlap) takes
runs there: plain mode with k <= 28 (int32 hash lanes for 2k <= 30,
int64 above) and HPC with k <= 15. A configuration it rejects (HPC with
k > 15: NotImplementedError) runs the batched-chainer path, as in the
JAX package: the host spec (overlap_host.overlap_run) with DeviceChainer
as its chain_many hook, so the chain-DP fill runs as kernel B2 on the
device and everything else on the host.
"""

from logging import getLogger

import numpy as np
import torch

from longqc_tpu_torch import tracing
from longqc_tpu_torch.config import OverlapConfig
from longqc_tpu_torch.engine import overlap_host as oh
from longqc_tpu_torch.engine.device_overlap import (anchor_rungs,
                                                    overlap_run_device2)
from longqc_tpu_torch.ops._ext import require_device
from longqc_tpu_torch.ops.chain import gap_penalty_table
from longqc_tpu_torch.ops.chain_cuda import chain_dp_fill, count_pieces

logger = getLogger(__name__)

GROUP_Q = 64        # anchor sets per B2 call (the JAX package's _GROUP_Q)

_LO32 = np.uint64(0xFFFFFFFF)


class DeviceChainer:
    """Batched chain DP, usable as the `chain_many` hook of
    overlap_host.overlap_run: anchor sets sorted by count, 64 per B2
    call (ops/chain_cuda.chain_dp_fill: the kernel on the card, its
    plain version on the CPU), each row padded to the smallest anchor
    rung that holds it (the engine's rungs, anchor_rungs); the
    backtrack runs on the host (overlap_host.chain_backtrack). A row past the top rung is chained
    by the host spec and counted in n_host_fallback.

    Unlike the JAX chainer there are no chunks of 2,048 anchors, no J
    ring, no carry and no penalty limbs: B2 scans each anchor's whole
    window in one call with the row's f64-exact gap-penalty table, so
    no row is flagged."""

    def __init__(self, device="cuda"):
        self.device = require_device(device)
        self.a_ladder = anchor_rungs(self.device)
        self.n_host_fallback = 0    # rows chained by the host spec
        self.n_device = 0           # rows chained by B2
        self.n_calls = 0            # B2 calls

    def stats(self):
        return {"device_rows": self.n_device,
                "host_fallback_rows": self.n_host_fallback,
                "b2_calls": self.n_calls}

    def __call__(self, anchor_sets, m):
        results = [None] * len(anchor_sets)
        rows = []
        for i, (ax, ay) in enumerate(anchor_sets):
            if len(ax) == 0:
                results[i] = []
            elif len(ax) > self.a_ladder[-1]:
                self.n_host_fallback += 1
                results[i] = oh.chain_dp(ax, ay, m.max_gap, m.bw,
                                         m.max_chain_skip, m.min_cnt,
                                         m.min_chain_score)
            else:
                rows.append(i)
        # sorted by anchor count, so a group's rung fits its rows closely
        rows.sort(key=lambda i: len(anchor_sets[i][0]))
        for off in range(0, len(rows), GROUP_Q):
            self._run_group(rows[off:off + GROUP_Q], anchor_sets, m,
                            results)
        return results

    def _run_group(self, sel, anchor_sets, m, results):
        ns = np.array([len(anchor_sets[i][0]) for i in sel], np.int32)
        A = next(a for a in self.a_ladder if a >= int(ns.max()))
        Q = len(sel)
        # B2's columns: x's upper word as a dense rank of (rev, rid) in
        # the row's x order (B2 compares it for equality and order
        # only), target and query positions, spans
        cols = np.zeros((4, Q, A), np.int32)
        pen = np.zeros((Q, m.bw + 1), np.int32)
        for r, i in enumerate(sel):
            ax, ay = anchor_sets[i]
            n = len(ax)
            hi = ax >> np.uint64(32)
            cols[0, r, 1:n] = np.cumsum(hi[1:] != hi[:-1])
            cols[1, r, :n] = ax & _LO32
            cols[2, r, :n] = ay & _LO32
            sp = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
            cols[3, r, :n] = sp
            # avg_qspan as chain.c computes it (a C float)
            pen[r] = gap_penalty_table(np.float32(sp.sum() / n), m.bw)
        dev = self.device
        f, p, v = chain_dp_fill(
            *(torch.from_numpy(c).to(dev) for c in cols),
            torch.from_numpy(ns).to(dev), torch.from_numpy(pen).to(dev),
            max_dist=m.max_gap, bw=m.bw, max_skip=m.max_chain_skip)
        self.n_calls += 1
        f, p, v = (t.cpu().numpy() for t in (f, p, v))
        for r, i in enumerate(sel):
            n = int(ns[r])
            self.n_device += 1
            results[i] = oh.chain_backtrack(f[r, :n], p[r, :n], v[r, :n],
                                            m.min_cnt, m.min_chain_score)


def overlap_run_device(target_iter, query_reads, cfg: OverlapConfig,
                       device="cuda", stats=None, parts=None,
                       index_cache=None, progress=None):
    """Device-path overlap run -> 9-column TSV rows.

    The device-resident engine for every configuration it takes; the
    batched-chainer path for the ones it rejects (HPC with k > 15),
    logged and recorded in stats (`engine`, and the chainer's row and
    call counts).
    parts: pre-grouped part read-lists (the -d prefetch path).
    index_cache: npz path prefix of the host index cache; only the
    batched-chainer path reads it (the device engine builds its index
    on the device each part).
    progress: called with the query index once per row and part.
    stats also receives the call's spans (tracing.run: `spans` and, on
    a traced top-level call, `span_log`).
    """
    stats = {} if stats is None else stats
    with tracing.run(stats, "overlap"):
        return _overlap_run_device(target_iter, query_reads, cfg, device,
                                   stats, parts, index_cache, progress)


def _overlap_run_device(target_iter, query_reads, cfg, device, stats,
                        parts, index_cache, progress):
    try:
        rows = overlap_run_device2(target_iter, query_reads, cfg,
                                   device=device, stats=stats, parts=parts,
                                   progress=progress)
        stats["engine"] = "device"
        return rows
    except NotImplementedError as e:
        logger.info("device engine unavailable for this config (%s); "
                    "using the batched-chainer path", e)
    chainer = DeviceChainer(device=device)
    with count_pieces() as pieces:
        rows = oh.overlap_run(target_iter, query_reads, cfg,
                              chain_many=chainer, parts=parts,
                              index_cache=index_cache, device=device,
                              progress=progress)
    # after the chainer's last pull of f, p, v
    pieces.record()
    stats.update(engine="batched_chainer", **chainer.stats())
    logger.info("batched chainer: %d B2 calls, %d device rows, %d host "
                "fallbacks", chainer.n_calls, chainer.n_device,
                chainer.n_host_fallback)
    return rows

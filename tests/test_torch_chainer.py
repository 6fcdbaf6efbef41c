"""The batched-chainer path (engine/overlap.DeviceChainer: B2 over
groups of 64 anchor sets, the backtrack on the host) on the CPU, where
B2 runs its plain version: chain lists equal to the host spec's exact
chain DP on seeded anchor sets, rows past the top anchor rung chained by
the host spec; and `mmcov -H -k 17`, which the device engine rejects,
printing the JAX package's rows (its batched-chainer path)."""

import json

import pytest
from torch_util import assert_same_chains, chainer_anchor_sets, k17_inputs

from longqc_tpu.cli import main as jax_main
from longqc_tpu_torch.cli import main
from longqc_tpu_torch.config import MapOpt
from longqc_tpu_torch.engine import overlap_host as oh
from longqc_tpu_torch.engine.overlap import GROUP_Q, DeviceChainer


def _host_chains(anchor_sets, m):
    return [oh.chain_dp(ax, ay, m.max_gap, m.bw, m.max_chain_skip,
                        m.min_cnt, m.min_chain_score)
            for ax, ay in anchor_sets]


@pytest.mark.parametrize("k,w,hpc,ladder", [
    (12, 5, False, None),
    (17, 10, True, None),
    # rows past the top rung go to the host spec
    (12, 5, False, (64, 128)),
], ids=["plain", "hpc-k17", "over-top-rung"])
def test_chainer_equals_host_chain_dp(k, w, hpc, ladder):
    sets = chainer_anchor_sets(7, 70, k, w, hpc)
    m = MapOpt()
    ch = DeviceChainer(device="cpu")
    if ladder:
        ch.a_ladder = ladder
    got = ch(sets, m)
    assert_same_chains(got, _host_chains(sets, m))
    n = [len(ax) for ax, _ in sets]
    top = ch.a_ladder[-1]
    over = sum(1 for x in n if x > top)
    live = sum(1 for x in n if 0 < x <= top)
    assert ch.n_host_fallback == over and ch.n_device == live
    assert ch.n_calls == -(-live // GROUP_Q)
    assert sum(len(c) for c in got) > 0
    if ladder:
        assert over > 0 and live > 0


def test_mmcov_hpc_k17_runs_the_batched_chainer(tmp_path, capsys):
    """HPC with k > 15: the device engine raises NotImplementedError, so
    the run takes the batched chainer, as the JAX package's does."""
    tf, qf = k17_inputs(tmp_path)
    flags = ["-H", "-k", "17", "-w", "10", "-c", "1", "-l", "0", "--filter"]
    assert jax_main(["mmcov"] + flags + [tf, qf]) == 0
    want = capsys.readouterr().out
    stats = str(tmp_path / "stats.json")
    assert main(["mmcov"] + flags + ["--device", "cpu", "--stats", stats,
                                     tf, qf]) == 0
    got = capsys.readouterr().out
    assert got == want
    rows = got.splitlines()
    assert len(rows) == 20
    assert sum(r.split("\t")[3] != "0" for r in rows[14:]) >= 4
    with open(stats) as f:
        st = json.load(f)
    assert st["engine"] == "batched_chainer"
    assert st["b2_calls"] >= 1 and st["device_rows"] >= 6
    assert st["host_fallback_rows"] == 0

"""The `overlap` entry: the all-vs-sample stage of sampleqc alone.

A job is one call of the port's overlap_run_device: every read of the
set against a query sample drawn from the seed, with the preset's
overlap settings (`-k -w -p -q 160 -l 0 -I 4G`), on the card. The input
is the reads in memory, so a job is the stage's own work: the part
index, the query sketch, the steps and the rows.
"""

from benchmark import check, gen
from benchmark.reference import overlap as ref_ov


def _port():
    from longqc_tpu_torch.config import PRESETS, overlap_config_for_sample
    from longqc_tpu_torch.engine.overlap import overlap_run_device
    return PRESETS, overlap_config_for_sample, overlap_run_device


def prepare(run):
    presets, cfg_for, _ = _port()
    cfg, traffic = run["config"], run["traffic"]
    reads = run["reads"]
    picks = gen.sample_indices(run["seed"], len(reads),
                               int(cfg["settings"]["n_sample"]))
    queries = [reads[i] for i in picks]
    ocfg = cfg_for(presets[cfg["preset"]],
                   index_size=cfg["settings"]["index_size"])
    warm = gen.warmup_reads(run["seed"], cfg, traffic)
    return {"run": run, "reads": reads, "queries": queries, "ocfg": ocfg,
            "bases": sum(len(r[1]) for r in reads),
            "warm": (warm, warm[::4])}


def _job(state, targets, queries):
    _, _, overlap_run_device = _port()
    stats = {}
    rows = overlap_run_device(iter(targets), queries, state["ocfg"],
                              device=state["run"]["device"], stats=stats)
    return {"rows": rows, "stats": stats, "queries": len(queries)}


def warmup(state):
    _job(state, *state["warm"])


def job(state):
    out = _job(state, state["reads"], state["queries"])
    out["bases"] = state["bases"]
    return out


def reference(state, variant=None):
    """What every job must produce: the key columns of all rows, and
    whole rows of a sample of queries drawn from the seed."""
    run = state["run"]
    traffic = run["traffic"]
    queries = state["queries"]
    keys = [ref_ov.row_key(q[0], len(q[1]), q[2], variant) for q in queries]
    rng = gen.make_rng([int(run["seed"]), 2])
    n = min(int(traffic["check_rows"]), len(queries))
    picks = sorted(int(i) for i in rng.permutation(len(queries))[:n])
    rows, _ = ref_ov.rows_for(state["reads"], queries, picks,
                              run["config"]["overlap"],
                              device=run["device"],
                              workers=run["workers"], variant=variant)
    return {"keys": keys, "rows": rows}


def compare(jobs, ref, state):
    return {"rows_keys_bad": sum(check.rows_keys_bad(j["rows"], ref["keys"])
                                 for j in jobs),
            "rows_bad": sum(check.rows_bad(j["rows"], ref["rows"])
                            for j in jobs)}


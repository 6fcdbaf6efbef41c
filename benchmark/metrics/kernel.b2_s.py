"""kernel.b2_s: device seconds of the chain-fill kernel B2 (`lq_chain*`,
csrc/chain.cu) in the traced window, per Gbp of the jobs' target
reads."""

from benchmark.arith import per_gbp
from benchmark.trace import kernel_s


def read(run):
    ev = run.get("events")
    s = kernel_s(ev, "lq_chain") if ev else None
    return None if s is None else per_gbp(s, run["bases"])

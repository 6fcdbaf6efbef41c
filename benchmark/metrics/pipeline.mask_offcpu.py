"""pipeline.mask_offcpu: the share of the mask thread's host-only spans
(`mask.host`: the sdust recursion, the rows, the write) in which that
thread ran no CPU: (wall - thread CPU) / wall, %; mostly the wait for
the interpreter lock, which the main thread's traceback holds."""

from benchmark.spans import offcpu_share


def read(run):
    return offcpu_share(run["jobs"], ("mask.host",))

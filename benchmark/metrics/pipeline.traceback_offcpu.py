"""pipeline.traceback_offcpu: the share of the host traceback's wall time
(`adapter.align`) in which the main thread ran no CPU: (wall - thread
CPU) / wall, %; mostly the wait for the interpreter lock, which the mask
thread holds."""

from benchmark.spans import offcpu_share


def read(run):
    return offcpu_share(run["jobs"], ("adapter.align",))

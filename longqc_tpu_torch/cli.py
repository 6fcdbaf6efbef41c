"""Command-line interface: `python -m longqc_tpu_torch <subcommand>`.

Ported so far: `mmcov`, the overlap engine's debug surface (the
minimap2-coverage binary CLI, minimap2-coverage.c:37-197), on its
default path (any k <= 28, so also the pb-hifi fast preset's wide
hashes at k = 19, and any -w up to 255) and with -H (HPC sketch,
k <= 15: the spike-in-control filter run). `mmcov -z` and `-d`, and the
`sampleqc`, `runqc` and `help` subcommands of the JAX package are not
ported yet.
"""

import argparse
import json
import sys

from longqc_tpu_torch._version import __version__

NOT_PORTED = ("sampleqc", "runqc", "help")


def command_mmcov(args):
    """Emit the 9-column coverage TSV on stdout."""
    from longqc_tpu_torch.config import (FltOpt, IndexOpt, MapOpt,
                                         OverlapConfig, parse_num)
    from longqc_tpu_torch.engine.overlap import overlap_run_device
    from longqc_tpu_torch.io import native
    from longqc_tpu_torch.io.fastx import iter_fastx_timed, reader_name

    if args.z or args.db:
        raise SystemExit("mmcov -z / -d: not yet ported")
    if args.query is None:
        raise SystemExit("mmcov: no query given")
    cfg = OverlapConfig(
        index=IndexOpt(k=args.k, w=args.w, is_hpc=bool(args.hpc),
                       batch_size=parse_num(args.inds)),
        map=MapOpt(min_score_med=args.p, min_score_good=args.q,
                   min_chain_score=args.m),
        flt=FltOpt(min_ovlp=args.l, min_coverage=args.c),
        filter_mode=bool(args.filter),
    )
    parse_s = {}
    targets = ([n, s, q or ""] for n, s, q in
               iter_fastx_timed(args.target, parse_s, "target"))
    queries = [[n, s, q or ""] for n, s, q in
               iter_fastx_timed(args.query, parse_s, "query")]
    stats = {}
    rows = overlap_run_device(targets, queries, cfg, device=args.device,
                              stats=stats)
    sys.stdout.write("\n".join(rows) + "\n")
    # which FASTA/FASTQ reader parsed the inputs, its build and the
    # seconds spent inside it per file
    stats["reader"] = dict(native.BUILD, name=reader_name(),
                           parse_s=parse_s)
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(stats, f, indent=1)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="longqc_tpu_torch",
        description="Long-read quality control on PyTorch + CUDA.")
    parser.add_argument("-v", "--version", action="version",
                        version="%(prog)s " + __version__)
    sub = parser.add_subparsers()

    p_m = sub.add_parser("mmcov",
                         help="overlap-coverage engine (debug surface)")
    p_m.add_argument("target")
    p_m.add_argument("query", nargs="?", default=None)
    p_m.add_argument("-k", type=int, default=12)
    p_m.add_argument("-w", type=int, default=5)
    p_m.add_argument("-H", dest="hpc", action="store_true", default=False)
    p_m.add_argument("-I", dest="inds", default="4G")
    p_m.add_argument("-m", type=int, default=40, help="min chain score")
    p_m.add_argument("-p", type=int, default=80,
                     help="medium chain score threshold")
    p_m.add_argument("-q", type=int, default=160,
                     help="good chain score threshold")
    p_m.add_argument("-l", type=int, default=0, help="min overlap len")
    p_m.add_argument("-c", type=int, default=3, help="min coverage")
    p_m.add_argument("-d", dest="db", default=None,
                     help="npz index cache (not yet ported)")
    p_m.add_argument("-z", dest="z", action="store_true", default=False,
                     help="minimizer-count aggregation (not yet ported)")
    p_m.add_argument("--filter", dest="filter", action="store_true",
                     default=False)
    p_m.add_argument("--stats", default=None,
                     help="write the engine's run counters (JSON) here: "
                          "phase seconds, step calls, flags, host-fixed "
                          "rows, host-only and hash-range-built parts")
    p_m.add_argument("--device", default="cuda",
                     help="torch device of the engine (default cuda; "
                          "raises when no GPU is present)")
    p_m.set_defaults(handler=command_mmcov)

    for name in NOT_PORTED:
        sub.add_parser(name, help="not yet ported")
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        raise SystemExit("longqc_tpu_torch %s: not yet ported" % argv[0])
    parser = build_parser()
    args = parser.parse_args(argv)
    if hasattr(args, "handler"):
        args.handler(args)
    else:
        parser.print_help()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

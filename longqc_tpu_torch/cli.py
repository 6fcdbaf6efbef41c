"""Command-line interface: `python -m longqc_tpu_torch <subcommand>`.

Ported so far: `sampleqc` (reference-free sample QC, with the JAX
package's flags; `-d` is not ported), `help`, and `mmcov`, the overlap
engine's debug surface (the minimap2-coverage binary CLI,
minimap2-coverage.c:37-197), on its default path (any k <= 28, so also
the pb-hifi fast preset's wide hashes at k = 19, and any -w up to 255)
and with -H (HPC sketch, k <= 15: the spike-in-control filter run).
`mmcov -z` and `-d`, `sampleqc -d` and the `runqc` subcommand are not
ported yet. Every subcommand runs on the card unless `--device cpu` is
given.
"""

import argparse
import json
import sys

from longqc_tpu_torch._version import __version__
from longqc_tpu_torch.config import PRESETS, DEFAULT_N_SAMPLE

NOT_PORTED = ("runqc",)


def command_sample(args):
    from longqc_tpu_torch.engine.pipeline import run_sampleqc

    if args.db:
        raise SystemExit("sampleqc -d: not yet ported")
    stats = {}
    run_sampleqc(
        args.input, args.out, args.preset,
        nsample=args.nsample, transcript=bool(args.transcript),
        suffix=args.suf, trim_out=args.trim, adp5=args.adp5,
        adp3=args.adp3, fast=bool(args.fast), mem=args.mem,
        index_size=args.inds, short=bool(args.short), ncpu=args.ncpu,
        force_pb=args.pb, force_sequel=args.sequel, force_ont=args.ont,
        device=args.device, report=not args.no_report, stats=stats)
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(stats, f, indent=1)


def command_help(args):
    # the reference's `help <command>` subcommand (longQC.py:952-954):
    # print the named subcommand's help
    build_parser().parse_args([args.command, "--help"])


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

    p_s = sub.add_parser("sampleqc", help="reference-free sample QC")
    p_s.add_argument("input", help="input [fasta, fastq, pbbam or fast5 dir]")
    p_s.add_argument("-o", "--output", dest="out", required=True)
    p_s.add_argument("-x", "--preset", choices=sorted(PRESETS),
                     required=True)
    p_s.add_argument("-t", "--transcript", dest="transcript",
                     action="store_true", default=None)
    p_s.add_argument("-n", "--n_sample", dest="nsample", type=int,
                     default=DEFAULT_N_SAMPLE)
    p_s.add_argument("-s", "--sample_name", dest="suf", default=None)
    p_s.add_argument("-c", "--trim_output", dest="trim", default=None)
    p_s.add_argument("--adapter_5", dest="adp5", default=None)
    p_s.add_argument("--adapter_3", dest="adp3", default=None)
    p_s.add_argument("-f", "--fast", dest="fast", action="store_true",
                     default=None)
    p_s.add_argument("-m", "--mem", dest="mem", type=float, default=0.5)
    p_s.add_argument("-i", "--index", dest="inds", default="4G")
    p_s.add_argument("-b", "--short", dest="short", action="store_true",
                     default=None)
    p_s.add_argument("-p", "--ncpu", dest="ncpu", type=int, default=4,
                     help="host-thread budget (advisory: stages run as "
                          "in-process device programs here)")
    p_s.add_argument("-d", "--db", dest="db", action="store_true",
                     default=False, help="index prefetch (not yet ported)")
    # hidden expert flags (longQC.py:942-947)
    p_s.add_argument("--pb", help=argparse.SUPPRESS, dest="pb",
                     action="store_true", default=None)
    p_s.add_argument("--sequel", help=argparse.SUPPRESS, dest="sequel",
                     action="store_true", default=None)
    p_s.add_argument("--ont", help=argparse.SUPPRESS, dest="ont",
                     action="store_true", default=None)
    p_s.add_argument("--no-report", dest="no_report", action="store_true",
                     default=False,
                     help="stop after the QC JSON: no figures, no HTML "
                          "(they need matplotlib and jinja2)")
    p_s.add_argument("--stats", default=None,
                     help="write each stage's seconds and the overlap "
                          "engine's run counters (JSON) here")
    p_s.add_argument("--device", default="cuda",
                     help="torch device of every stage (default cuda; "
                          "raises when no GPU is present)")
    p_s.set_defaults(handler=command_sample)

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

    p_h = sub.add_parser("help", help="see `help -h`")
    p_h.add_argument("command")
    p_h.set_defaults(handler=command_help)
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

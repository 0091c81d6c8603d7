"""Command-line tools of the port.

  assemble   iterative consensus assembly; `--engine batch` runs the port's
             batch engine on `--device cuda` (the CUDA kernels) or
             `--device cpu` (their plain versions); `--engine exact` runs
             the shared sequential host engine
  simulate   synthetic PacBio-style reads (shared tools/simulate.py)

Usage: python -m pacbioassembly_tpu_torch <command> [args]

The flags of `assemble` are those of the JAX CLI
(pacbioassembly_tpu/tools/cli.py). `--contigs N > 1` is not ported yet: it
needs tools/postprocess.py's contig dedupe (ROADMAP.md, queue A).
"""

from __future__ import annotations

import argparse
import sys


def cmd_assemble(args) -> int:
    from ..host import Assembler, AssemblyConfig, ReadStore, dna

    if args.contigs > 1:
        raise NotImplementedError(
            "--contigs > 1 is not ported yet: multi-contig restarts need "
            "tools/postprocess.py (ROADMAP.md queue A: tools/locate.py, "
            "tools/postprocess.py and --contigs N)"
        )
    cfg = AssemblyConfig(
        ratio=args.ratio,
        max_round=args.max_round,
        max_trial=args.trials,
        locked=args.lock,
        initial_ref_path=args.ref_file,
        rng_seed=args.rng_seed,
        pattern_schedule=args.schedule,
        engine=args.engine,
        dump_path=args.dump,
        quirk_seed_at=args.quirk_seed_at,
        quirk_init_newline=args.quirk_init_newline,
        quirk_stale_dp=args.quirk_stale_dp,
        max_seq_len=args.max_seq_len,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume_path=args.resume,
        metrics_path=args.metrics,
        edge_retreat=args.edge_retreat,
    )
    reads = ReadStore.from_file(args.bin, cfg)
    patterns = dna.load_patterns(args.seedfile)
    dump = open(args.dump, "w") if args.dump else None
    try:
        if cfg.engine == "batch":
            from ..assemble.batch import BatchAssembler

            asm = BatchAssembler(cfg, reads, patterns, dump=dump, device=args.device)
        else:
            asm = Assembler(cfg, reads, patterns, dump=dump)
        asm.run(out=sys.stdout, log=sys.stderr if not args.quiet else None)
    finally:
        if dump:
            dump.close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pacbioassembly_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("assemble", help="iterative consensus assembly")
    p.add_argument("bin")
    p.add_argument("seedfile")
    p.add_argument("-f", "--ref-file", default=None)
    p.add_argument("-r", "--ratio", type=float, default=0.3)
    p.add_argument("-d", "--dump", default=None)
    p.add_argument("-m", "--max-round", type=int, default=None)
    p.add_argument("-t", "--trials", type=int, default=32)
    p.add_argument("-l", "--lock", action="store_true")
    p.add_argument("--engine", choices=["exact", "batch"], default="exact")
    p.add_argument("--schedule", choices=["random", "roundrobin"], default="random")
    p.add_argument("--rng-seed", type=int, default=None)
    p.add_argument("--quirk-seed-at", action="store_true")
    p.add_argument("--quirk-init-newline", action="store_true")
    p.add_argument("--quirk-stale-dp", action="store_true")
    p.add_argument("--max-seq-len", type=int, default=800_000)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", default=None)
    p.add_argument("--metrics", default=None)
    p.add_argument(
        "--edge-retreat", type=int, default=0,
        help="batch engine: up to N times, recover from an all-patterns"
        "-failed stall by trimming the single-read edge fringe instead of"
        " terminating (0 = reference behavior)",
    )
    p.add_argument(
        "--contigs", type=int, default=1,
        help="multi-contig mode: not ported yet (only 1 is accepted)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="batch engine device: cuda (CUDA kernels) or cpu (plain "
        "versions); asking for cuda without a GPU is an error",
    )
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(fn=cmd_assemble)

    p = sub.add_parser("simulate", help="generate synthetic PacBio-style reads")
    p.add_argument("out")
    p.add_argument("--genome-len", type=int, default=100_000)
    p.add_argument("--coverage", type=float, default=30.0)
    p.add_argument("--mean-read-len", type=int, default=2500)
    p.add_argument("--error-rate", type=float, default=0.15)
    p.add_argument("--error-profile", choices=("uniform", "clr"), default="uniform",
                   help="error composition: uniform sub/ins/del thirds, or "
                        "PacBio CLR-like 1:12:4 (insertion-dominated)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--genome-out", default=None)
    from ..host import cmd_simulate

    p.set_defaults(fn=cmd_simulate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Command-line tools of the port.

  assemble   iterative consensus assembly; `--engine batch` runs the port's
             batch engine on `--device cuda` (the CUDA kernels) or
             `--device cpu` (their plain versions); `--engine exact` runs
             the port's sequential host engine (assemble/driver.py)
  locate     map stdin reads onto a finished contig (locator.cpp:41-96):
             batched screening on `--device cuda|cpu`, or `--host-loop`,
             the sequential exact-aligner loop
  simulate   synthetic PacBio-style reads (tools/simulate.py)

Usage: python -m pacbioassembly_tpu_torch <command> [args]

The flags are those of the JAX CLI (pacbioassembly_tpu/tools/cli.py), plus
`--device`. The screening kernel comes from PBTPU_SCREEN_BACKEND, read
here once (align/screen.py::screen_kernel): unset or `bitpallas` for K1,
`pallas` for K3, `scan` (CPU only) for the plain row DP; anything else
raises. `--contigs N > 1` is not ported yet: it needs
tools/postprocess.py's contig dedupe (ROADMAP.md, queue A).
"""

from __future__ import annotations

import argparse
import sys


def cmd_assemble(args) -> int:
    from ..align.screen import screen_kernel
    from ..assemble import Assembler, ReadStore
    from ..codec import dna
    from ..config import AssemblyConfig

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

            asm = BatchAssembler(
                cfg, reads, patterns, dump=dump, device=args.device,
                screen_kernel=screen_kernel(args.device),
            )
        else:
            asm = Assembler(cfg, reads, patterns, dump=dump)
        asm.run(out=sys.stdout, log=sys.stderr if not args.quiet else None)
    finally:
        if dump:
            dump.close()
    return 0


def cmd_locate(args) -> int:
    """Map stdin reads onto a contig; prints TSV
    nseq, ref_pos, final_cost, len-j, diag_cost (locator.cpp:68-92).

    Default path: batched screening over all (read, seed-offset,
    candidate) triples on `--device` (tools/locate.py). --host-loop runs
    the sequential per-triple exact aligner instead (the literal reference
    loop shape); both produce identical TSV."""
    from ..codec import dna

    with open(args.contig) as fh:
        contig = fh.read().split()[0]
    # locator.cpp:57-60 converts N to A explicitly (C2I alone would map
    # N to T).
    contig = contig.replace("N", "A")
    contig_codes = dna.text_to_codes(contig)
    pattern = dna.parse_pattern(args.seed)
    seqs = [dna.text_to_codes(w) for line in sys.stdin for w in line.split()]

    if not args.host_loop:
        from ..align.screen import screen_kernel
        from .locate import locate_batched

        return locate_batched(
            contig_codes, pattern, seqs, args.ratio,
            device=args.device, screen_kernel=screen_kernel(args.device),
        )
    return locate_host_loop(contig_codes, pattern, seqs, args.ratio)


def locate_host_loop(contig_codes, pattern: int, seqs, ratio: float, out=None) -> int:
    """The locator's sequential loop: per read, seed offsets j = 0..49,
    candidates in index order, the exact aligner, first success wins."""
    from ..align import exact_align
    from ..codec import dna
    from ..index import build_seedmap
    from .locate import MAXM, MAXN, MAX_TRIAL_J, MIN_READ

    out = sys.stdout if out is None else out
    # full index of every position (locator.cpp:62-66)
    idx, _ = build_seedmap(contig_codes, pattern, max_read_len=len(contig_codes))

    nseq = 0
    for seq in seqs:
        if len(seq) < MIN_READ:
            continue  # does NOT count: the reference ++nseq is skipped too
        found = False
        for j in range(MAX_TRIAL_J):
            if j + 16 > len(seq):
                break
            key = dna.encode_seed(seq, j) & pattern
            cands = idx.lookup(key)
            if len(cands) == 0:
                continue
            seg = seq[j:]
            for cand in cands:
                ref = contig_codes[int(cand) :]
                res = exact_align(seg, ref, ratio=ratio, maxn=MAXN, maxm=MAXM)
                if res is not None and res.matlen_b > 0:
                    out.write(
                        f"{nseq}\t{int(cand)}\t{res.cost}\t{len(seq) - j}\t{res.diag_cost}\n"
                    )
                    found = True
                    break
            if found:
                break
        nseq += 1
    print(f"totally {nseq} sequences processed", file=sys.stderr)
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
    from .simulate import cmd_simulate

    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("locate", help="map reads onto a finished contig")
    p.add_argument("contig")
    p.add_argument("seed")
    p.add_argument("-r", "--ratio", type=float, default=0.15)
    p.add_argument(
        "--host-loop",
        action="store_true",
        help="sequential per-triple exact aligner instead of batched screening",
    )
    p.add_argument(
        "--device", default="cuda",
        help="batched screening device: cuda (CUDA kernels) or cpu (plain "
        "version); asking for cuda without a GPU is an error",
    )
    p.set_defaults(fn=cmd_locate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

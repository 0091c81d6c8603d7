"""Command-line tools of the port: every command of the JAX CLI
(pacbioassembly_tpu/tools/cli.py), the same flags and the same output.

  convert    text <-> 2-bit binary record files (binary_test.cpp:44-76)
  assemble   iterative consensus assembly; `--engine batch` runs the port's
             batch engine on `--device cuda` (the CUDA kernels) or
             `--device cpu` (their plain versions), `--contigs N` restarts
             it on the surviving reads and prints FASTA; `--engine exact`
             runs the port's sequential host engine (assemble/driver.py)
  import     FASTA/FASTQ -> 2-bit binary records, with a quality stream
             (tools/fastx.py)
  simulate   synthetic PacBio-style reads (tools/simulate.py)
  locate     map stdin reads onto a finished contig (locator.cpp:41-96):
             batched screening on `--device cuda|cpu`, or `--host-loop`,
             the sequential exact-aligner loop
  visualize  render stdin (ref, seg) alignments (visual_align.cpp:42-74)
  quality    mean ASCII value per stdin line (quality.cpp:32-39)
  stat-hash  base-composition hash per stdin line (stat_hash.c:19-47)

Usage: python -m pacbioassembly_tpu_torch <command> [args]

`assemble` and `locate` take `--device` in addition to the JAX flags. The
screening kernel comes from PBTPU_SCREEN_BACKEND, read here once
(align/screen.py::screen_kernel): unset or `bitpallas` for K1, `pallas`
for K3, `scan` (CPU only) for the plain row DP; anything else raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_convert(args) -> int:
    from ..codec import binary_io, dna

    if args.mode == "0":
        for line in sys.stdin:
            for word in line.split():
                codes = dna.text_to_codes(word)
                rec = np.frombuffer(dna.record_from_codes(codes), dtype=np.uint8)
                back = dna.codes_to_text(dna.unpack_codes(rec[4:], len(codes)))
                if back != word:
                    print(f"Error:{word}\n{back}")
                    return 1
        return 0
    if args.mode == "1":
        binary_io.texts_to_binary_file(sys.stdin, args.file)
        return 0
    if args.mode == "2":
        for text in binary_io.binary_file_to_texts(args.file):
            print(text)
        return 0
    print("mode must be 0, 1 or 2", file=sys.stderr)
    return 1


def cmd_assemble(args) -> int:
    from ..align.screen import screen_kernel
    from ..assemble import Assembler, ReadStore
    from ..codec import dna
    from ..config import AssemblyConfig

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
    if args.contigs > 1:
        if cfg.engine != "batch":
            print("--contigs requires --engine batch", file=sys.stderr)
            return 1
        from ..assemble.batch import assemble_contigs

        contigs, surviving = assemble_contigs(
            cfg, reads, patterns, args.contigs,
            log=sys.stderr if not args.quiet else None,
            device=args.device, screen_kernel=screen_kernel(args.device),
        )
        for i, c in enumerate(contigs):
            print(f">contig_{i} length={len(c.codes)} reads={c.nreads} rounds={c.nrounds}")
            print(dna.codes_to_text(c.codes))
        print(
            f"{len(contigs)} contigs, {len(reads) - len(surviving)} of "
            f"{len(reads)} reads consumed",
            file=sys.stderr,
        )
        return 0
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


def cmd_visualize(args) -> int:
    """Render alignments of (ref, seg) stdin pairs (visual_align.cpp:42-74)."""
    from ..align import INSERT, MATCH, exact_align
    from ..codec import dna

    words = sys.stdin.read().split()
    for i in range(0, len(words) - 1, 2):
        ref_str, seg_str = words[i], words[i + 1]
        a = dna.text_to_codes(seg_str)
        b = dna.text_to_codes(ref_str)
        res = exact_align(a, b, ratio=args.ratio)
        if res is None or res.matlen_b <= 0:
            print("cannot align", file=sys.stderr)
            print(ref_str, file=sys.stderr)
            print(seg_str, file=sys.stderr)
            continue
        print(res.cost)
        aref, aseg = [], []
        iref = iseg = 0
        for op in res.ops:
            if op == MATCH:
                aref.append(ref_str[iref]); iref += 1
                aseg.append(seg_str[iseg]); iseg += 1
            elif op == INSERT:
                aseg.append("-")
                aref.append(ref_str[iref]); iref += 1
            else:
                aref.append("-")
                aseg.append(seg_str[iseg]); iseg += 1
        print("".join(aref))
        print("".join(aseg))
    return 0


def cmd_quality(args) -> int:
    for line in sys.stdin:
        line = line.rstrip("\n")
        if not line:
            continue
        vals = np.frombuffer(line.encode("latin1"), dtype=np.uint8)
        print(int(vals.sum()) // len(vals))
    return 0


def cmd_stat_hash(args) -> int:
    def quantize(v: int) -> int:
        return 0xFF if (v >> 4) > 0xFF else (v >> 4) & 0xFF

    def line_hash(line: str) -> int:
        a = line.count("A"); c = line.count("C")
        g = line.count("G"); t = line.count("T")
        return (
            (quantize(a) << 24) | (quantize(c) << 16) | (quantize(g) << 8) | quantize(t)
        )

    data = sys.stdin.read()
    for line in data.split("\n"):
        print(f"{line_hash(line):08x}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pacbioassembly_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("convert", help="text <-> 2-bit binary record files")
    p.add_argument("mode", choices=["0", "1", "2"])
    p.add_argument("file", nargs="?")
    p.set_defaults(fn=cmd_convert)

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
        help="multi-contig mode (batch engine): restart on surviving reads "
        "until N contigs are built; prints FASTA",
    )
    p.add_argument(
        "--device", default="cuda",
        help="batch engine device: cuda (CUDA kernels) or cpu (plain "
        "versions); asking for cuda without a GPU is an error",
    )
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(fn=cmd_assemble)

    p = sub.add_parser("import", help="FASTA/FASTQ -> 2-bit binary records")
    p.add_argument("input")
    p.add_argument("out")
    p.add_argument("--min-len", type=int, default=0)
    p.add_argument("--quality-out", default=None)
    from .fastx import cmd_fastx

    p.set_defaults(fn=cmd_fastx)

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

    p = sub.add_parser("visualize", help="render stdin (ref, seg) alignments")
    p.add_argument("-r", "--ratio", type=float, default=0.3)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("quality", help="mean ASCII value per stdin line")
    p.set_defaults(fn=cmd_quality)

    p = sub.add_parser("stat-hash", help="base-composition hash per stdin line")
    p.set_defaults(fn=cmd_stat_hash)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

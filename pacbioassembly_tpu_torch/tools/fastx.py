"""FASTA/FASTQ ingestion.

The reference pipeline's data prep was 3 GB FASTQ -> sequence lines ->
2-bit binary (doc/final.tex:125-131, binary_test mode 1). This module does
the whole ingestion in one pass: parse FASTA or FASTQ (auto-detected),
filter by length, write binary records, and optionally emit the per-read
mean quality stream that the reference's `quality` tool produced
(quality.cpp:32-39) for reference selection.
"""

from __future__ import annotations

import sys
from typing import Iterator, Optional, TextIO, Tuple

import numpy as np

from ..codec import dna


def parse_fastx(fh: TextIO) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (name, sequence, quality|None) from FASTA or FASTQ."""
    first = fh.read(1)
    if not first:
        return
    if first == ">":
        name = fh.readline().strip()
        seq_parts = []
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                yield name, "".join(seq_parts), None
                name = line[1:]
                seq_parts = []
            elif line:
                seq_parts.append(line)
        yield name, "".join(seq_parts), None
    elif first == "@":
        name = fh.readline().strip()
        while True:
            seq = fh.readline().strip()
            plus = fh.readline()
            qual = fh.readline().strip()
            if not qual and not seq:
                break
            yield name, seq, qual
            tag = fh.readline()
            if not tag:
                break
            name = tag.strip()[1:] if tag.startswith("@") else tag.strip()
    else:
        # headerless: treat every line as a sequence (reference text files)
        rest = first + fh.readline()
        yield "", rest.strip(), None
        for i, line in enumerate(fh):
            line = line.strip()
            if line:
                yield "", line, None


def cmd_fastx(args) -> int:
    from ..codec import binary_io

    n = 0
    n_skip = 0
    qual_fh = open(args.quality_out, "w") if args.quality_out else None
    with open(args.input) as src, open(args.out, "wb") as out:
        for name, seq, qual in parse_fastx(src):
            if len(seq) < args.min_len:
                n_skip += 1
                continue
            binary_io.write_records(out, [dna.text_to_codes(seq)])
            if qual_fh:
                if qual:
                    vals = np.frombuffer(qual.encode("latin1"), dtype=np.uint8)
                    qual_fh.write(f"{int(vals.sum()) // len(vals)}\n")
                else:
                    qual_fh.write("0\n")
            n += 1
    if qual_fh:
        qual_fh.close()
    print(f"wrote {n} records to {args.out} ({n_skip} below min length)", file=sys.stderr)
    return 0

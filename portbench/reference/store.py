"""The benchmark's read store generator: a random genome and its reads.

The model of the assembler's simulator (tools/simulate.py, the generator
of the published E. coli runs), vectorised with torch on one device: a
uniform random genome of `genome_len` bases; coverage * genome_len /
mean_read_len reads, each of length int(clip(N(mean, mean / 4), min_len,
min(max_len, genome_len))), starting uniformly, forward strand; then per
base a substitution (to one of the three other bases), a deletion, and an
insertion after it (a uniform base), each at its own rate. The genome and
the reads come from the configuration's own `seed` (the published
simulator seed); the run's seed orders the reads in the store: a random
permutation of the reads, except that with `hold` (the position the engine
starts its first contig from) every read whose middle lies within
`fixed_span` / 2 bases of that read's middle keeps its position. So every
run seed holds the same reads in another order, and the region the window
assembles is read in the same order (the commit order, which sets the
trajectory). The same seeds on the same
kind of device give the same store. Returns host numpy arrays: the flat
read codes with their offsets and lengths, the genome, and the store as
the assembler's binary records ([u32 length][2-bit codes, first base in
bits 7-6]).
"""

from __future__ import annotations

import torch

ERROR_PROFILES = {"uniform": (1, 1, 1), "clr": (1, 12, 4)}  # sub : ins : del


def error_rates(total: float, profile: str) -> tuple[float, float, float]:
    s, i, d = ERROR_PROFILES[profile]
    n = s + i + d
    return total * s / n, total * i / n, total * d / n


def n_reads(store: dict) -> int:
    return max(1, int(store["coverage"] * store["genome_len"] / store["mean_read_len"]))


def generate(store: dict, seed: int, device, hold: int | None = None,
             fixed_span: int = 0) -> dict:
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(store["seed"]))
    G = int(store["genome_len"])
    mean = int(store["mean_read_len"])
    sub, ins, dele = error_rates(store["error_rate"], store["error_profile"])
    genome = torch.randint(0, 4, (G,), generator=g, device=dev, dtype=torch.uint8)
    n = n_reads(store)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    lens = (torch.randn(n, **f64) * (mean * 0.25) + mean).clamp(
        store["min_read_len"], min(store["max_read_len"], G)).long()
    starts = (torch.rand(n, **f64) * (G - lens + 1).double()).long()

    total = int(lens.sum())
    read_of = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    src = starts[read_of] + torch.arange(total, device=dev) - first[read_of]
    base = genome[src]
    f32 = dict(generator=g, device=dev, dtype=torch.float32)
    shift = torch.randint(1, 4, (total,), generator=g, device=dev, dtype=torch.uint8)
    base = torch.where(torch.rand(total, **f32) < sub, (base + shift) % 4, base)
    deleted = torch.rand(total, **f32) < dele
    inserted = torch.rand(total, **f32) < ins
    ins_val = torch.randint(0, 4, (total,), generator=g, device=dev, dtype=torch.uint8)

    # each base emits itself unless deleted, then its insertion: two slots a base
    slots = torch.stack([torch.where(deleted, 255, base), torch.where(inserted, ins_val, 255)], 1)
    keep = (slots != 255).reshape(-1)
    codes = slots.reshape(-1)[keep]
    out_len = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, read_of, (~deleted).long() + inserted.long())
    offsets = torch.cumsum(out_len, 0) - out_len

    # the run's order of the reads
    order = torch.Generator(device=dev)
    order.manual_seed(int(seed) % (1 << 63))
    perm = torch.arange(n, device=dev)
    moved = torch.ones(n, dtype=torch.bool, device=dev)
    if hold is not None:
        mid = starts.double() + lens.double() / 2
        moved = (mid - mid[hold]).abs() > fixed_span / 2
        moved[hold] = False
    slots = torch.nonzero(moved).flatten()
    perm[slots] = slots[torch.randperm(len(slots), generator=order, device=dev)]
    src_off = offsets[perm]
    out_len = out_len[perm]
    offsets = torch.cumsum(out_len, 0) - out_len
    rid = torch.repeat_interleave(torch.arange(n, device=dev), out_len)
    codes = codes[src_off[rid] + torch.arange(len(codes), device=dev) - offsets[rid]]

    # binary records: 4 header bytes, then ceil(len / 4) packed bytes
    nbytes = 4 + (out_len + 3) // 4
    rec_off = torch.cumsum(nbytes, 0) - nbytes
    buf = torch.zeros(int(nbytes.sum()), dtype=torch.int32, device=dev)
    for k in range(4):
        buf[rec_off + k] = ((out_len >> (8 * k)) & 0xFF).int()
    pos = torch.arange(len(codes), device=dev) - offsets[rid]
    buf.index_add_(0, rec_off[rid] + 4 + (pos >> 2), codes.int() << (6 - 2 * (pos & 3)).int())
    return {
        "genome": genome.cpu().numpy(),
        "codes": codes.cpu().numpy(),
        "offsets": offsets.cpu().numpy(),
        "lengths": out_len.cpu().numpy(),
        "records": buf.to(torch.uint8).cpu().numpy(),
    }

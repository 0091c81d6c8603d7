"""2-bit DNA codec, vectorized with numpy.

Bit layout (pinned by the reference's hard-coded test constants,
test/dna_test.cpp:26-29, and by src/dna_seq.h:86-176):

  * base codes: A=0, C=1, G=2, everything else (T, N, ...) = 3   (C2I, dna_seq.h:21)
  * 4 bases per byte, FIRST base in bits 7-6, fourth in bits 1-0 (t2b, dna_seq.h:147)
  * a 16-base "seed" is the little-endian uint32 of its 4 packed bytes,
    i.e. seed = byte0 | byte1<<8 | byte2<<16 | byte3<<24 where byte0 holds
    bases 0..3                                               (encode, dna_seq.h:86-96)
  * a sequence record is [uint32 LE length][ceil(len/4) packed bytes]
                                                             (text2bin, dna_seq.h:113-127)

Everything here operates on *code arrays* (uint8 values 0..3), the native
representation used across the engine; text (ASCII) only appears at the IO
boundary.
"""

from __future__ import annotations

import numpy as np

SEED_LEN = 16

# C2I (dna_seq.h:21): anything that is not A/C/G maps to 3 ('T'), including N.
CHAR2CODE = np.full(256, 3, dtype=np.uint8)
CHAR2CODE[ord("A")] = 0
CHAR2CODE[ord("C")] = 1
CHAR2CODE[ord("G")] = 2

CODE2CHAR = np.frombuffer(b"ACGT", dtype=np.uint8)

# Left-shift of base t (t = 0..15) inside the uint32 seed value:
# byte index t//4 (little-endian => *8), and within a byte the first base
# occupies bits 7-6 => shift (3 - t%4)*2.
SEED_SHIFTS = np.array(
    [(t // 4) * 8 + (3 - t % 4) * 2 for t in range(SEED_LEN)], dtype=np.uint32
)
_SEED_WEIGHTS = (np.uint64(1) << SEED_SHIFTS.astype(np.uint64)).astype(np.int64)

# packing weights within one byte: first base << 6 ... fourth base << 0
_BYTE_WEIGHTS = np.array([64, 16, 4, 1], dtype=np.uint16)


def text_to_codes(text) -> np.ndarray:
    """ASCII DNA text -> uint8 code array (A=0 C=1 G=2 other=3)."""
    if isinstance(text, str):
        raw = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
    elif isinstance(text, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(bytes(text), dtype=np.uint8)
    else:
        raw = np.asarray(text, dtype=np.uint8)
    return CHAR2CODE[raw]


def codes_to_text(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII DNA string."""
    return CODE2CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack codes 4-per-byte (first base in bits 7-6). Tail bits are zero,
    matching t2b (dna_seq.h:147-159)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    npad = (-n) % 4
    if npad:
        codes = np.concatenate([codes, np.zeros(npad, dtype=np.uint8)])
    quads = codes.reshape(-1, 4).astype(np.uint16)
    return (quads @ _BYTE_WEIGHTS).astype(np.uint8)


def unpack_codes(packed: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_codes: packed bytes -> first `length` codes."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((len(packed), 4), dtype=np.uint8)
    out[:, 0] = (packed >> 6) & 0x3
    out[:, 1] = (packed >> 4) & 0x3
    out[:, 2] = (packed >> 2) & 0x3
    out[:, 3] = packed & 0x3
    return out.reshape(-1)[:length]


def record_from_codes(codes: np.ndarray) -> bytes:
    """[uint32 LE length][packed bytes] record (text2bin, dna_seq.h:113-127)."""
    header = np.uint32(len(codes)).tobytes()
    return header + pack_codes(codes).tobytes()


def encode_seed(codes: np.ndarray, pos: int = 0) -> int:
    """uint32 seed of the 16 codes starting at pos (encode, dna_seq.h:86-96)."""
    window = np.asarray(codes[pos : pos + SEED_LEN], dtype=np.int64)
    return int((window * _SEED_WEIGHTS).sum()) & 0xFFFFFFFF


def encode_seeds(codes: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Vectorized uint32 seeds at many positions of one code array.

    positions must satisfy pos+16 <= len(codes).
    """
    codes = np.asarray(codes, dtype=np.int64)
    positions = np.asarray(positions, dtype=np.int64)
    idx = positions[:, None] + np.arange(SEED_LEN, dtype=np.int64)[None, :]
    return ((codes[idx] * _SEED_WEIGHTS[None, :]).sum(axis=1) & 0xFFFFFFFF).astype(
        np.uint32
    )


def sliding_seeds(codes: np.ndarray) -> np.ndarray:
    """uint32 seeds at every position 0..len-16 (vectorized sliding window)."""
    n = len(codes) - SEED_LEN + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint32)
    win = np.lib.stride_tricks.sliding_window_view(
        np.asarray(codes, dtype=np.uint8), SEED_LEN
    ).astype(np.int64)
    return ((win * _SEED_WEIGHTS[None, :]).sum(axis=1) & 0xFFFFFFFF).astype(np.uint32)


def seed_at(packed_record: np.ndarray, pos: int) -> int:
    """Correct seed extraction from a packed *record* (header + payload) at
    base offset pos. Matches dna_seq::seed_at (dna_seq.h:62-76) for
    unaligned pos, and fixes its pos%4==0 fast-path bug (which reads the
    byte at offset `pos` instead of `pos>>2`; see SURVEY.md §2.1)."""
    payload = np.asarray(packed_record, dtype=np.uint8)[4:]
    byte0 = pos >> 2
    ls = (pos & 0x3) << 1
    if ls == 0:
        chunk = payload[byte0 : byte0 + 4].astype(np.uint32)
    else:
        rs = 8 - ls
        b = payload[byte0 : byte0 + 5].astype(np.uint32)
        chunk = ((b[:4] << ls) | (b[1:5] >> rs)) & 0xFF
    return int(chunk[0] | (chunk[1] << 8) | (chunk[2] << 16) | (chunk[3] << 24))


def seed_at_quirk(packed_record: np.ndarray, pos: int) -> int:
    """Bit-parity replica of the reference seed_at INCLUDING its aligned-pos
    bug (dna_seq.h:64: byte offset `pos` instead of `pos>>2`). Use only in
    quirk-compat parity runs."""
    if (pos & 0x3) == 0:
        payload = np.asarray(packed_record, dtype=np.uint8)[4:]
        chunk = np.zeros(4, dtype=np.uint32)
        avail = payload[pos : pos + 4]
        chunk[: len(avail)] = avail
        return int(chunk[0] | (chunk[1] << 8) | (chunk[2] << 16) | (chunk[3] << 24))
    return seed_at(packed_record, pos)


def parse_pattern(pattern: str) -> int:
    """Spaced-seed pattern string ('1' = care, '*' = don't care) -> uint32
    mask (parse_pattern, spaced_seed.cpp:166-180): '1'->T(11), else->A(00),
    padded with A to 16, then encoded."""
    pat = pattern.strip()[:SEED_LEN]
    codes = np.zeros(SEED_LEN, dtype=np.uint8)
    for i, ch in enumerate(pat):
        codes[i] = 3 if ch == "1" else 0
    return encode_seed(codes, 0)


def load_patterns(path: str) -> list[int]:
    """Parse a seeds.txt-style file into uint32 masks (spaced_seed.cpp:224-228)."""
    masks = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                masks.append(parse_pattern(line))
    return masks

"""Length-prefixed 2-bit binary sequence files.

File format: concatenated records of [uint32 LE length][ceil(len/4) packed
bytes] — identical to what reference binary_test mode 1 writes
(binary_test.cpp:56-64) and spaced_seed mmaps (spaced_seed.cpp:309-345).

The record scan is a sequential pointer walk; it is done in native C++ when
the extension is available (native/pbcore.cpp) and falls back to a Python
loop otherwise.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np

from .dna import pack_codes, text_to_codes, unpack_codes


def write_records(fh, code_arrays: Iterable[np.ndarray]) -> int:
    """Append records to a binary file handle; returns record count."""
    n = 0
    for codes in code_arrays:
        fh.write(np.uint32(len(codes)).tobytes())
        fh.write(pack_codes(codes).tobytes())
        n += 1
    return n


def scan_records(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walk the record chain of a whole-file byte buffer.

    Returns (offsets, lengths): byte offset of each record header and its
    base-pair length (open_binary, spaced_seed.cpp:331-342).
    """
    buf = np.asarray(buf, dtype=np.uint8)
    try:
        from ..native import pbcore

        lib = pbcore.load(optional=True)
        if lib is not None:
            return pbcore.scan_records(lib, buf)
    except ImportError:
        pass

    offsets = []
    lengths = []
    total = len(buf)
    off = 0
    while off + 4 <= total:
        ln = int(np.frombuffer(buf[off : off + 4].tobytes(), dtype=np.uint32)[0])
        offsets.append(off)
        lengths.append(ln)
        off += 4 + (ln + 3) // 4
    return np.asarray(offsets, dtype=np.int64), np.asarray(lengths, dtype=np.int64)


def read_records(path: str) -> Iterator[np.ndarray]:
    """Yield the code array of every record in a binary file."""
    buf = np.fromfile(path, dtype=np.uint8)
    offsets, lengths = scan_records(buf)
    for off, ln in zip(offsets, lengths):
        payload = buf[off + 4 : off + 4 + (ln + 3) // 4]
        yield unpack_codes(payload, int(ln))


def record_view(buf: np.ndarray, offset: int) -> Tuple[int, np.ndarray]:
    """(length, packed payload view) of the record at byte offset."""
    ln = int(np.frombuffer(np.ascontiguousarray(buf[offset : offset + 4]).tobytes(), dtype=np.uint32)[0])
    return ln, buf[offset + 4 : offset + 4 + (ln + 3) // 4]


def texts_to_binary_file(lines: Iterable[str], out_path: str) -> int:
    """binary_test mode 1: whitespace-separated text sequences -> binary file."""
    n = 0
    with open(out_path, "wb") as fh:
        for line in lines:
            for word in line.split():
                n += write_records(fh, [text_to_codes(word)])
    return n


def binary_file_to_texts(path: str) -> Iterator[str]:
    """binary_test mode 2: binary file -> text sequences."""
    from .dna import codes_to_text

    for codes in read_records(path):
        yield codes_to_text(codes)

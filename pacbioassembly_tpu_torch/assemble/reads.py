"""Read set backed by a binary record file.

Replaces the reference's mmap + std::list<seq_index> walk
(open_binary, spaced_seed.cpp:309-345): records are scanned natively, reads
outside (min_read_len, max_read_len) are dropped, and code arrays are
decoded on demand with a one-entry cache (mirroring set_active_seg,
spaced_seed.cpp:109-118).
"""

from __future__ import annotations

import numpy as np

from ..codec import binary_io, dna
from ..config import AssemblyConfig, Constants


class ReadStore:
    def __init__(
        self,
        buf: np.ndarray,
        min_read_len: int = Constants.SEQ_THRESHOLD,
        max_read_len: int = Constants.MAX_READ_LEN,
    ):
        self.buf = np.asarray(buf, dtype=np.uint8)
        offsets, lengths = binary_io.scan_records(self.buf)
        keep = (lengths > min_read_len) & (lengths < max_read_len)
        self.offsets = offsets[keep]
        self.lengths = lengths[keep]
        # ids mirror the reference's running i++ over *kept* records
        self.ids = np.arange(len(self.offsets), dtype=np.int64)
        self._cache_key: int | None = None
        self._cache_codes: np.ndarray | None = None

    @classmethod
    def from_file(
        cls, path: str, cfg: AssemblyConfig | None = None, mmap: bool | None = None
    ) -> "ReadStore":
        """Load a binary read file. Files over ~256 MB are memory-mapped by
        default (the reference mmaps unconditionally, spaced_seed.cpp:324);
        pass mmap=True/False to force."""
        cfg = cfg or AssemblyConfig()
        import os

        if mmap is None:
            mmap = os.path.getsize(path) > 256 * 1024 * 1024
        buf = (
            np.memmap(path, dtype=np.uint8, mode="r")
            if mmap
            else np.fromfile(path, dtype=np.uint8)
        )
        return cls(
            buf,
            min_read_len=cfg.min_read_len,
            max_read_len=cfg.max_read_len,
        )

    def __len__(self) -> int:
        return len(self.offsets)

    def length(self, i: int) -> int:
        return int(self.lengths[i])

    def codes(self, i: int) -> np.ndarray:
        if self._cache_key != i:
            self._cache_codes = self.decode(i)
            self._cache_key = i
        return self._cache_codes

    def decode(self, i: int) -> np.ndarray:
        """Cache-free decode — safe from concurrent threads (the one-entry
        cache above is shared mutable state; the parallel commit path uses
        this instead)."""
        off = int(self.offsets[i])
        ln = int(self.lengths[i])
        payload = self.buf[off + 4 : off + 4 + (ln + 3) // 4]
        return dna.unpack_codes(payload, ln)

    def record(self, i: int) -> np.ndarray:
        """Raw [len][payload] record bytes (for quirk-compat seed_at)."""
        off = int(self.offsets[i])
        ln = int(self.lengths[i])
        return self.buf[off : off + 4 + (ln + 3) // 4]

    def quirk_seed(self, i: int, pos: int) -> int:
        """Bit-parity replica of the reference's seed_at on this read,
        including the aligned-pos fast-path bug (dna_seq.h:64): for
        pos % 4 == 0 it reads the little-endian u32 at BYTE offset pos of
        the payload — which for pos beyond the packed length runs past the
        record into the following reads' bytes of the mmap'd file. Reads
        beyond the buffer end are zero-filled (the mmap zero page)."""
        if (pos & 0x3) == 0:
            off = int(self.offsets[i]) + 4 + pos
            chunk = np.zeros(4, dtype=np.uint32)
            avail = self.buf[off : off + 4]
            chunk[: len(avail)] = avail
            return int(
                chunk[0] | (chunk[1] << 8) | (chunk[2] << 16) | (chunk[3] << 24)
            )
        from ..codec import dna

        return dna.seed_at(self.record(i), pos)

    def decode_all(self) -> list[np.ndarray]:
        return [self.codes(i).copy() for i in range(len(self))]

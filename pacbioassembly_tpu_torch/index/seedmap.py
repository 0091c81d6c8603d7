"""Spaced-seed index of the reference boundaries.

TPU-idiomatic replacement for the reference's
hash_map<unsigned, list<int>> seedmap (common.h:54, ref_seq.h:291-311):
masked 16-mer keys of the boundary windows are sorted once into a CSR
table (keys_sorted, positions_sorted) and looked up with binary search —
branch-free, vectorizable, and shippable to the device as two flat arrays.

Window semantics match get_seedmap exactly:
  * head: first min(len-16, MAX_READ_LEN) positions, ascending
  * tail: last min(len-MAX_READ_LEN-16, MAX_READ_LEN) positions, descending
    from len-16
  * skip keys whose masked value is 0 (poly-A filter)
  * within a bucket, candidate order == insertion order (head ascending,
    then tail descending) — preserved here by a stable sort so that the
    sequential engine probes candidates in reference order.
"""

from __future__ import annotations

import numpy as np

from ..codec.dna import SEED_LEN, encode_seeds
from ..config import Constants


_M32 = np.uint64(0xFFFFFFFF)


def _mix32(x: np.ndarray) -> np.ndarray:
    """Vectorized 32-bit avalanche (xorshift-multiply finalizer) — spreads
    masked seeds (whose masked-out bit positions are always zero) uniformly
    over the hash-table slots."""
    x = np.asarray(x, np.uint64)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & _M32
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & _M32
    x ^= x >> np.uint64(16)
    return x


class SeedIndex:
    __slots__ = (
        "keys", "positions", "n_entries", "n_keys",
        "_tkey", "_tstart", "_tcnt", "_tmask", "_probes",
    )

    # linear-probe bound; build falls back to binary-search lookups if any
    # key would need more (practically impossible at load factor <= 0.5)
    MAX_PROBES = 64

    def __init__(self, keys_sorted: np.ndarray, positions_sorted: np.ndarray):
        self.keys = keys_sorted            # uint32, ascending (stable within key)
        self.positions = positions_sorted  # int32 reference positions
        self.n_entries = len(keys_sorted)
        ukeys, first = np.unique(keys_sorted, return_index=True)
        self.n_keys = len(ukeys)
        ustarts = np.append(first, self.n_entries).astype(np.int64)
        # Open-addressing hash table over the distinct keys (load <= 0.5,
        # linear probing, fully vectorized build and probe). The batched
        # lookup runs over millions of (read, trial) seeds per round and
        # per-query binary search into cache-cold keys was the expand-phase
        # bottleneck at E. coli scale (~0.9 s/round for 3.5M queries on
        # host; the hash probe is ~5x cheaper). The reference itself uses a
        # 2^20-bucket hash_map for the same lookup (spaced_seed.cpp:88).
        self._probes = 0
        if self.n_keys == 0:
            self._tkey = np.zeros(1, np.uint32)
            self._tstart = np.zeros(1, np.int64)
            self._tcnt = np.zeros(1, np.int64)
            self._tmask = 0
            return
        T = 1 << max(4, int(self.n_keys * 4 - 1).bit_length())
        self._tmask = T - 1
        size = T + self.MAX_PROBES  # linear slack region, no wraparound
        self._tkey = np.zeros(size, np.uint32)
        self._tstart = np.zeros(size, np.int64)
        self._tcnt = np.full(size, -1, np.int64)  # -1 = empty slot
        slot = (_mix32(ukeys) & np.uint64(self._tmask)).astype(np.int64)
        pending = np.arange(self.n_keys)
        for p in range(self.MAX_PROBES):
            if len(pending) == 0:
                break
            hp = slot[pending]
            uslot, first_at = np.unique(hp, return_index=True)
            free = self._tcnt[uslot] < 0
            winners = pending[first_at[free]]
            ws = uslot[free]
            self._tkey[ws] = ukeys[winners]
            self._tstart[ws] = ustarts[winners]
            self._tcnt[ws] = ustarts[winners + 1] - ustarts[winners]
            placed = np.zeros(len(pending), bool)
            placed[first_at[free]] = True
            pending = pending[~placed]
            slot[pending] += 1
            self._probes = p + 1
        if len(pending):  # fall back: disable the table
            self._tcnt = None

    def lookup(self, key: int) -> np.ndarray:
        """Positions for one masked seed, in reference insertion order."""
        lo = np.searchsorted(self.keys, np.uint32(key), side="left")
        hi = np.searchsorted(self.keys, np.uint32(key), side="right")
        return self.positions[lo:hi]

    def lookup_batch(self, queries: np.ndarray):
        """(starts, counts) for a batch of masked seeds; counts == 0 rows
        have an unspecified start. Equivalent to two np.searchsorted calls
        (differential-tested in tests/test_device_index.py)."""
        q = np.asarray(queries, dtype=np.uint32)
        if self.n_entries == 0:
            z = np.zeros(len(q), np.int64)
            return z, z
        if self._tcnt is None:
            lo = np.searchsorted(self.keys, q, side="left")
            hi = np.searchsorted(self.keys, q, side="right")
            return lo, hi - lo
        starts = np.zeros(len(q), np.int64)
        cnts = np.zeros(len(q), np.int64)
        # probe with an actively-compacted query set: most queries resolve
        # on the first probe (hit, or empty slot == proven miss), so later
        # passes touch geometrically fewer rows
        act = np.arange(len(q), dtype=np.int64)
        slot = (_mix32(q) & np.uint64(self._tmask)).astype(np.int64)
        qa = q
        for _ in range(self._probes + 1):
            tc = self._tcnt[slot]
            hit = (tc >= 0) & (self._tkey[slot] == qa)
            if hit.any():
                ah = act[hit]
                starts[ah] = self._tstart[slot[hit]]
                cnts[ah] = tc[hit]
            keep = ~hit & (tc >= 0)  # occupied by a different key: probe on
            if not keep.any():
                break
            act = act[keep]
            slot = slot[keep] + 1
            qa = qa[keep]
        return starts, cnts


def build_seedmap(
    codes: np.ndarray,
    mask: int,
    max_read_len: int = Constants.MAX_READ_LEN,
) -> tuple[SeedIndex, int]:
    """Build the boundary seed index of a reference window.

    Returns (index, n_indexed) where n_indexed mirrors the reference's
    get_seedmap return value nhead + max(ntail, 0) (ref_seq.h:291-311).
    """
    L = len(codes)
    nmax = L - SEED_LEN
    nhead = min(nmax, max_read_len)
    head_pos = np.arange(max(0, nhead), dtype=np.int64)
    ntail = min(L - max_read_len - SEED_LEN, max_read_len)
    tail_pos = L - SEED_LEN - np.arange(max(0, ntail), dtype=np.int64)
    positions = np.concatenate([head_pos, tail_pos])

    if len(positions) == 0:
        idx = SeedIndex(np.empty(0, np.uint32), np.empty(0, np.int32))
        return idx, max(0, nhead) + max(0, ntail)

    seeds = encode_seeds(codes, positions) & np.uint32(mask)
    keep = seeds != 0
    seeds = seeds[keep]
    positions = positions[keep]

    order = np.argsort(seeds, kind="stable")
    idx = SeedIndex(seeds[order], positions[order].astype(np.int32))
    return idx, max(0, nhead) + max(0, ntail)

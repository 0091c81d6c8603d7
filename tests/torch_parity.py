"""Helpers for the PyTorch port's tests (imports no jax, so the GPU tests
can use it on a machine without JAX)."""

from __future__ import annotations

import numpy as np
import torch

FIELDS = ("accept", "cost", "matlen_a", "matlen_b", "diag_cost", "dp_rows")


def T(x) -> torch.Tensor:
    """numpy -> CPU tensor (a private, writable copy)."""
    return torch.from_numpy(np.array(x))


def batch_tensors(A, las, Bm, lbs, device="cpu"):
    return tuple(T(x).to(device) for x in (A, las, Bm, lbs))


def assert_scores_match(port, ref, *, dp_rows: bool = True) -> int:
    """The screening contract: accept (and dp_rows) on every pair, the
    value fields on every accepted pair. Returns the accepted count."""
    acc = np.asarray(ref.accept).astype(bool)
    np.testing.assert_array_equal(port.accept.cpu().numpy(), acc, "accept")
    for f in ("cost", "matlen_a", "matlen_b", "diag_cost"):
        np.testing.assert_array_equal(
            getattr(port, f).cpu().numpy()[acc], np.asarray(getattr(ref, f))[acc], f
        )
    if dp_rows:
        np.testing.assert_array_equal(
            port.dp_rows.cpu().numpy(), np.asarray(ref.dp_rows), "dp_rows"
        )
    return int(acc.sum())


def overlap_cases(rng, n, *, src_len, seg_lo, seg_hi, err, a_lo, a_hi):
    """(a, b) pairs: b = a noisy copy of a prefix of a random source (rate
    `err` of substitutions, insertions and deletions in thirds), a = a
    prefix of the source of random length in [a_lo, a_hi)."""
    cases = []
    for _ in range(n):
        src = rng.integers(0, 4, src_len).astype(np.uint8)
        seg = src[: int(rng.integers(seg_lo, seg_hi))].copy()
        k = len(seg)
        sub = rng.random(k) < err / 3
        seg[sub] = (seg[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        keep = rng.random(k) >= err / 3
        ins = rng.random(k) < err / 3
        out = []
        for c, kp, it in zip(seg, keep, ins):
            if kp:
                out.append(int(c))
            if it:
                out.append(int(rng.integers(0, 4)))
        cases.append((src[: int(rng.integers(a_lo, a_hi))].copy(), np.array(out, np.uint8)))
    return cases


def random_cases(rng, n, *, a_hi, b_hi):
    """Unrelated random pairs (mostly early-failure rejects)."""
    return [
        (
            rng.integers(0, 4, int(rng.integers(1, a_hi))).astype(np.uint8),
            rng.integers(0, 4, int(rng.integers(1, b_hi))).astype(np.uint8),
        )
        for _ in range(n)
    ]


def pack(cases, LA, LB):
    """(A, la, B, lb): zero-padded code matrices and int32 lengths, with
    each side clipped to its matrix width."""
    n = len(cases)
    A = np.zeros((n, LA), np.uint8)
    Bm = np.zeros((n, LB), np.uint8)
    las = np.zeros(n, np.int32)
    lbs = np.zeros(n, np.int32)
    for i, (a, b) in enumerate(cases):
        a, b = a[:LA], b[:LB]
        A[i, : len(a)] = a
        Bm[i, : len(b)] = b
        las[i] = len(a)
        lbs[i] = len(b)
    return A, las, Bm, lbs


# ------------------------------------------------------ walk edge planes

WALK_W, WALK_S, WALK_NRB, WALK_LB = 60, 256, 8, 300  # one launch: 128 rows, 256 lanes
WALK_E = 512


def _parent_words(rng, shape, p_match=0.8, p_zero=0.0):
    """Packed parent words (int32), each 2-bit field MATCH with p_match,
    else INSERT or DELETE alike, or 0 (a stop) with p_zero."""
    rest = (1.0 - p_match - p_zero) / 2
    f = rng.choice(4, size=(*shape, 16), p=[p_zero, p_match, rest, rest]).astype(np.uint32)
    return (f << (2 * np.arange(16, dtype=np.uint32))).sum(axis=-1, dtype=np.uint32).view(np.int32)


def _fill(plane, rb_lo, rb_hi, k_lo, k_hi, op):
    """Every row of row blocks [rb_lo, rb_hi] at lanes [k_lo, k_hi] = op."""
    word = np.uint32(sum(op << (2 * r) for r in range(16))).view(np.int32)
    plane[rb_lo : rb_hi + 1, k_lo : k_hi + 1] = word


def walk_edge_cases(seed=0):
    """Synthetic parent planes for the walk (csrc/walk.cu and its plain
    version), one pair each, on a shared (NRB, S) = (8, 256), W = 60:
    {name: (plane, b row, lb_dp, md, matlen_a, matlen_b, accept, E)}.

      insert_run  91 INSERTs in one row block from k = 110 down to 20,
                  longer than the tile's half-width (63 lanes)
      delete_run  88 DELETEs from k = 100 up to 188 across six row blocks:
                  k leaves its tile inside row block 3, then enters row
                  block 2 past the tile prefetched for it
      rows_cut    the walk starts at row 170, past the plane's 128 rows:
                  rows past it read the last row block again
      k_low       j - i + W < 0 at the start: k clamped to 0
      k_high      j - i + W > S - 1 at the start: k clamped to S - 1
      stops       a plane with 1% zero parents: the walk stops early
      e_small     E = 70: the walk stops before its third block of 32
      rejected    accept = 0: nedit 0 and all zeros
    """
    rng = np.random.default_rng(seed)
    shape = (WALK_NRB, WALK_S)
    cases = {}

    def add(name, plane, ma, mb, accept=True, E=WALK_E):
        b = rng.integers(0, 4, WALK_LB).astype(np.uint8)
        cases[name] = (plane, b, 250, 60, ma, mb, accept, E)

    p = _parent_words(rng, shape)
    _fill(p, 6, 6, 20, 110, 2)   # INSERT
    _fill(p, 6, 6, 19, 19, 1)    # then MATCH
    add("insert_run", p, 100, 150)
    p = _parent_words(rng, shape)
    _fill(p, 2, 7, 100, 199, 3)  # DELETE
    add("delete_run", p, 120, 160)
    add("rows_cut", _parent_words(rng, shape), 170, 160)
    add("k_low", _parent_words(rng, shape), 110, 20)
    add("k_high", _parent_words(rng, shape), 10, 250)
    add("stops", _parent_words(rng, shape, p_match=0.79, p_zero=0.01), 120, 130)
    add("e_small", _parent_words(rng, shape), 120, 125, E=70)
    add("rejected", _parent_words(rng, shape), 120, 125, accept=False)
    return cases


def walk_batch(cases, device="cpu"):
    """Stack walk cases (the same E) into the walk's tensors: (plane, b,
    lb_dp, md, matlen_a, matlen_b, accept), E."""
    cols = list(zip(*cases))
    Es = set(cols[7])
    assert len(Es) == 1, Es
    planes, bs = np.stack(cols[0]), np.stack(cols[1])
    vecs = [np.array(c, np.int32) for c in cols[2:6]]
    acc = np.array(cols[6], bool)
    out = tuple(T(x).to(device) for x in (planes, bs, *vecs, acc))
    return out, Es.pop()


# --------------------------------------------- K1 thread path edge batches

PREFILTER = dict(la_max=187, w_max=58, ratio=0.45)  # LA = 187, LB = 128


def _noisy(rng, x, err):
    """x with substitutions at rate err."""
    y = x.copy()
    sub = rng.random(len(y)) < err
    y[sub] = (y[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return y


def zero_band_tables(real):
    """A stand-in for align/scan.py::threshold_tensors whose band table is
    all zeros (md = 0 for every pair)."""

    def fake(ratio, tab_len, device):
        et, am, bt = real(ratio, tab_len, device)
        return et, am, torch.zeros_like(bt)

    return fake


def k1_thread_edge_cases(seed=0):
    """Batches at 2 words a stripe or fewer (K1's thread path and its numpy
    model), {name: (A, la, B, lb, kwargs, zero_band)}; zero_band asks for
    a band table of zeros (md = 0, S = 1: the threshold tables give md >= 1).

      md0         every pair at md = 0: identical, noisy and unrelated
      md1         la or lb of 0 or 1 (md = 1 from the table)
      md63        W = 63: pairs at md = 63 (S = 127, both words full),
                  swapped and not, and pairs at md = 64 (size-rejected)
      swap        overlaps with len_a > len_b (transposed) and not
      row11       unrelated pairs, most failing at row 11, the first row
                  that can fail
      m_minus_n   len_b = la + md (and len_a = lb + md): the far-row goal
                  over all md rows past n
      past_width  lengths past b's width (LB = 32): the row sequence and,
                  transposed, the column sequence read past the row
    """
    rng = np.random.default_rng(seed)
    out = {}

    def add(name, cases, LA, LB, kw, zero_band=False, lbs=None):
        A, las, Bm, lb = pack(cases, LA, LB)
        if lbs is not None:
            lb = np.asarray(lbs, np.int32)
        out[name] = (A, las, Bm, lb, dict(kw, la_max=LA), zero_band)

    x = rng.integers(0, 4, 400).astype(np.uint8)
    y = rng.integers(0, 4, 400).astype(np.uint8)
    add("md0", [(x[:120], x[:128]), (x[:128], _noisy(rng, x[:128], 0.03)),
                (_noisy(rng, x[:90], 0.08), x[:100]), (x[:128], y[:128]), (x[:5], y[:5]),
                (x[:1], x[:1])], 187, 128, PREFILTER, zero_band=True)
    add("md1", [(x[:0], x[:5]), (x[:5], x[:0]), (x[:0], x[:0]), (x[:1], x[:1]),
                (x[:1], y[:3]), (x[:3], x[:1]), (x[:2], x[:2]), (x[:2], y[:2]),
                (x[:2], x[:30])], 187, 128, PREFILTER)
    w63 = dict(w_max=63, ratio=0.45)
    add("md63", [(x[:138], _noisy(rng, x[:150], 0.02)), (_noisy(rng, x[:160], 0.02), x[:139]),
                 (x[:139], x[:139]), (x[:138], y[:200]), (x[:140], x[:145]),
                 (x[:150], x[:140])], 200, 200, w63)
    cases = overlap_cases(rng, 6, src_len=300, seg_lo=60, seg_hi=128, err=0.05, a_lo=40, a_hi=187)
    add("swap", cases + [(b_, a_) for a_, b_ in cases]
        + [(x[:110], x[:90]), (x[:90], x[:110]), (x[:128], _noisy(rng, x[:100], 0.05))],
        187, 128, PREFILTER)
    add("row11", [(rng.integers(0, 4, 128).astype(np.uint8), rng.integers(0, 4, 128).astype(np.uint8))
                  for _ in range(24)], 187, 128, PREFILTER)
    add("m_minus_n", [(x[:80], x[:128]), (x[:80], _noisy(rng, x[:128], 0.05)),
                      (x[:160], x[:80]), (_noisy(rng, x[:180], 0.05), x[:70]),
                      (x[:60], y[:128])], 187, 128, PREFILTER)
    # b rows 32 wide with lengths up to 60: len_b past the width (not
    # swapped) and n = len_b past it (swapped)
    add("past_width", [(x[:40], x[:32]), (x[:100], x[:32]), (x[:20], x[:32]),
                       (x[:60], _noisy(rng, x[:32], 0.05)), (x[:32], x[:32])], 100, 32,
        dict(w_max=58, ratio=0.45), lbs=[60, 60, 50, 45, 32])
    return out

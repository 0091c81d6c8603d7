"""Alignment result types.

Edit semantics (pinned by reference seq_aligner.h:32-44, 214-233): edits
transform sequence *a* into sequence *b*.
  MATCH  — consume one char of a and one of b; carries b's char (also used
           for substitutions).
  INSERT — an extra char of b inserted into a; carries b's char.
  DELETE — a char of a absent from b.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MATCH = 1
INSERT = 2
DELETE = 3


@dataclasses.dataclass
class AlignParams:
    """Band geometry derived from the two lengths (seq_aligner.h:92-107)."""

    len_a: int
    len_b: int
    max_dst: int
    ok: bool  # within MAXN/MAXM limits


@dataclasses.dataclass
class AlignResult:
    matlen_a: int   # length of match in a
    matlen_b: int   # length of match in b (the align() return value)
    cost: int       # edit distance of the matched prefix pair
    ops: np.ndarray   # uint8[nedit] of MATCH/INSERT/DELETE
    vals: np.ndarray  # uint8[nedit] b-side codes (valid for MATCH/INSERT)
    len_a: int
    len_b: int
    max_dst: int
    #: cost of cell (len_a, len_a) — the main-diagonal cell of the final row;
    #: -1 when len_a > len_b (cell outside the computed region). Used by the
    #: locator tool (locator.cpp:88: get_cost(len-j, len-j)).
    diag_cost: int = -1

    @property
    def nedit(self) -> int:
        return len(self.ops)

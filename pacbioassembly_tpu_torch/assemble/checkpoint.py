"""Checkpoint / resume.

The reference's only resume path is manual: every round prints the full
consensus, and `-f file` restarts from a saved sequence with an integer
weight (spaced_seed.cpp:49-56, 449-452). This module makes that a real
checkpoint (SURVEY.md §5): consensus text + full vote tensors +
surviving-read set + round/failure counters + RNG state, in one .npz.
"""

from __future__ import annotations

import json

import numpy as np

from ..consensus import ConsensusRef
from ..utils import span

FORMAT_VERSION = 1


def save_checkpoint(path: str, asm) -> None:
    """Snapshot an Assembler/BatchAssembler mid-run, in the span
    checkpoint.save: the state's copy (checkpoint.state), then the file
    (checkpoint.write)."""
    with span("checkpoint.save", root=asm.nround):
        with span("checkpoint.state"):
            state = asm.ref.state_dict()
        _write(path, asm, state)


def _write(path, asm, state: dict) -> None:
    """The .npz of `state` and the engine's counters, survivors and RNG."""
    meta = {
        "version": FORMAT_VERSION,
        "nround": asm.nround,
        "nfailure": asm.nfailure,
        "retreats": getattr(asm, "retreats", 0),
        "fruitless_retreats": getattr(asm, "fruitless_retreats", 0),
        "matches_since_retreat": getattr(asm, "matches_since_retreat", 0),
        "engine": type(asm).__name__,
        "beg": state["beg"],
        "end": state["end"],
        "locked": bool(state["locked"]),
        "overlap_min": int(state["overlap_min"]),
        "vote_ratio": float(state["vote_ratio"]),
    }
    rng_state = json.dumps(asm.rng.bit_generator.state)
    with span("checkpoint.write"):
        np.savez_compressed(
            path,
            meta=json.dumps(meta),
            rng=rng_state,
            codes=state["codes"],
            sel=state["sel"],
            sup=state["sup"],
            total=state["total"],
            surviving=np.asarray(asm.surviving, dtype=np.int64),
        )


def load_checkpoint(path: str, asm) -> None:
    """Restore a snapshot into a freshly constructed assembler (same reads,
    patterns, and config)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        state = {
            "codes": z["codes"],
            "sel": z["sel"],
            "sup": z["sup"],
            "total": z["total"],
            "beg": meta["beg"],
            "end": meta["end"],
            "locked": meta["locked"],
            "overlap_min": meta["overlap_min"],
            "vote_ratio": meta["vote_ratio"],
        }
        asm.ref = ConsensusRef.from_state_dict(state, capacity=asm.ref.cap)
        asm.surviving = [int(x) for x in z["surviving"]]
        asm.nround = int(meta["nround"])
        asm.nfailure = int(meta["nfailure"])
        if hasattr(asm, "retreats"):
            asm.retreats = int(meta.get("retreats", 0))
            asm.fruitless_retreats = int(meta.get("fruitless_retreats", 0))
            asm.matches_since_retreat = int(meta.get("matches_since_retreat", 0))
        asm.rng.bit_generator.state = json.loads(str(z["rng"]))

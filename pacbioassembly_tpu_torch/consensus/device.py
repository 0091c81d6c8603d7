"""Device form of the consensus commit pass (evolve).

Port of pacbioassembly_tpu/consensus/device.py. `ref_seq::evolve`
(ref_seq.h:317-349) as one tensor program over the (L, 4) vote tensors:
split supplements into new boxes, keep majority winners, delete the rest,
absorbing their selection into the nearest preceding survivor's
supplement: the interleave / mask / compact scheme of the numpy
ConsensusRef.evolve (consensus/state.py), which stays the engine's path.
Equal to it (tests/test_torch_device_twins.py).

Thresholds: the reference compares `max_vote > ratio * total` in double
precision (ref_seq.h:170-175). The caller floors ratio * total in float64
on the host, and the device compares integers: max > ratio * total <=>
max >= floor(ratio * total) + 1 for an integer max. Ties go to the first
maximum (A > C > G > T), as winner() does; several deleted boxes can feed
one survivor, so the absorb is an accumulating scatter; the compaction is
stable. Runs on whichever device its inputs are on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..align.screen import ladder_size
from ..device import resolve_device


class EvolveResult(NamedTuple):
    codes: torch.Tensor    # (2L,) uint8: surviving box winners, compacted to the front
    sel: torch.Tensor      # (2L, 4) int32
    sup: torch.Tensor      # (2L, 4) int32
    total: torch.Tensor    # (2L,) int32
    new_len: torch.Tensor  # () int32: surviving boxes


def device_evolve(
    sel: torch.Tensor,           # (L, 4) int32 selection votes
    sup: torch.Tensor,           # (L, 4) int32 supplement (insert-after) votes
    total: torch.Tensor,         # (L,) int32 participant counts
    thresh_floor: torch.Tensor,  # (L,) int32 = floor64(vote_ratio * total)
    live: torch.Tensor,          # (L,) bool: rows past the real window are False
) -> EvolveResult:
    L = sel.shape[0]
    dev = sel.device
    sel, sup, total = sel.to(torch.int32), sup.to(torch.int32), total.to(torch.int32)
    thr = thresh_floor.to(torch.int32) + 1
    valid = (sel.max(dim=1).values >= thr) & live    # is_valid (ref_seq.h:170)
    has_sup = (sup.max(dim=1).values >= thr) & live  # has_supply (ref_seq.h:175)
    # winner(): argmax with the A > C > G > T tie preference == first max
    sel_win = sel.argmax(dim=1).to(torch.uint8)
    sup_win = sup.argmax(dim=1).to(torch.uint8)

    # candidate slots: 2i = original box i (kept iff valid), 2i+1 = its
    # split box (exists iff has_sup; the split copies total, resets sup)
    K = torch.stack([valid, has_sup], dim=1).reshape(2 * L)
    cand_sel = torch.stack([sel, sup], dim=1).reshape(2 * L, 4)
    cand_sup = torch.stack(
        [torch.where(has_sup[:, None], torch.zeros_like(sup), sup), torch.zeros_like(sup)], dim=1
    ).reshape(2 * L, 4)
    cand_tot = torch.stack([total, total], dim=1).reshape(2 * L)
    cand_code = torch.stack([sel_win, sup_win], dim=1).reshape(2 * L)

    # deleted boxes absorb their selection into the nearest preceding kept
    # candidate's supplement (ref_seq.h:339-346)
    slots = torch.arange(2 * L, dtype=torch.int64, device=dev)
    last_kept = torch.cummax(torch.where(K, slots, torch.full_like(slots, -1)), dim=0).values
    last_kept_before = torch.cat([last_kept.new_full((1,), -1), last_kept[:-1]])
    deleted = ~valid & live
    tgt = last_kept_before[0::2]  # target slot of box i's absorbed votes
    absorb_ok = deleted & (tgt >= 0)
    add = torch.where(absorb_ok[:, None], sel, torch.zeros_like(sel))
    cand_sup = cand_sup.index_add(0, tgt.clamp(0, 2 * L - 1), add)

    # stable compaction: kept slots to the front, in order
    order = torch.sort((~K).to(torch.int8), stable=True).indices
    return EvolveResult(
        codes=cand_code[order],
        sel=cand_sel[order],
        sup=cand_sup[order],
        total=cand_tot[order],
        new_len=K.sum().to(torch.int32),
    )


def evolve_on_device(ref, device: str | torch.device = "cuda") -> None:
    """Run ConsensusRef.evolve's commit through the device pass on
    `device` and write the result back into the host state: the same
    window and geometry updates as the numpy evolve (consensus/state.py)."""
    dev = resolve_device(device)
    if ref.locked:
        return
    pre, post = ref.pre, ref.post
    L = post - pre
    ref.version += 1
    if L == 0:
        ref.beg = ref.end = ref.pre = ref.post = ref.origin
        return
    Lp = ladder_size(L, 8192)  # a handful of padded lengths over a run
    sel = np.zeros((Lp, 4), np.int32)
    sup = np.zeros((Lp, 4), np.int32)
    tot = np.zeros(Lp, np.int32)
    live = np.zeros(Lp, bool)
    sel[:L] = ref.sel[pre:post]
    sup[:L] = ref.sup[pre:post]
    tot[:L] = ref.total[pre:post]
    live[:L] = True
    # float64 threshold on the host (the reference compares C doubles)
    thresh_floor = np.floor(ref.vote_ratio * tot.astype(np.float64)).astype(np.int32)

    res = device_evolve(*(torch.from_numpy(x).to(dev) for x in (sel, sup, tot, thresh_floor, live)))
    newL = int(res.new_len)
    o = ref.origin
    if o + newL > ref.cap:
        raise OverflowError("reference capacity exceeded (evolve)")
    ref.buf[o : o + newL] = res.codes[:newL].cpu().numpy()
    ref.sel[o : o + newL] = res.sel[:newL].cpu().numpy()
    ref.sup[o : o + newL] = res.sup[:newL].cpu().numpy()
    ref.total[o : o + newL] = res.total[:newL].cpu().numpy()
    ref.pre = ref.beg = o
    ref.end = ref.post = o + newL
    # this path does not track absorb receivers: the next host evolve runs full
    ref._dirty = None

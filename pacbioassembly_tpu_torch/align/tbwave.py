"""Traceback on the card: parent plane kernel K2 and walk kernel W.

Port of pacbioassembly_tpu/align/tbwave.py. The screening pass supplies
accept and the goal cell (matlen_a, matlen_b); this module computes no
goal, threshold or early-failure logic.

  * `batch_parents` emits the packed parent plane (csrc/tbwave.cu; replaces
    the Pallas `_kernel` of batch_parents_pallas): (B, NRB, S) int32 with
    bits [2r, 2r+1] of [q, rb, k] = the parent of DP cell (row rb*16+r+1,
    band lane k) of pair q, MATCH > INSERT > DELETE on ties, bit-equal to
    the JAX plane.
  * `walk_parents` walks the plane back from the goal cell (csrc/walk.cu,
    a warp per pair taking a word's run of MATCH parents a step, the plane
    copied 128-lane tiles of row blocks ahead of the walk; replaces the XLA
    while_loop walk_parents) and emits left-aligned edit streams: ops, vals
    (B, E) uint8 and nedit (B,) int32.

For CUDA tensors each wrapper launches its kernel or raises; for CPU
tensors it runs the plain version beside it (`batch_parents_plain`, a
torch row DP with the same min-plus doubling scan, and
`walk_parents_plain`, a per-pair loop).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..config import Constants
from .types import DELETE, INSERT, MATCH
from .scan import COMPACT, INF, pair_geometry, threshold_tensors

CHUNK = 128   # plane lane/row quantum (the JAX plane's shape)
RB = 16       # DP rows per packed int32 (2-bit parents)
TB_WALK = 32  # the walk emits in blocks of this many edits
WALK_TILE, WALK_RING = 128, 8  # csrc/walk.cu: plane words a tile, tiles in its ring
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
TB_STATIC_SMEM = 512  # K2's static shared arrays (per-warp minima and first lanes)
TB_MAX_LANES = 16 * 768  # K2: 16 lanes per thread, 768 threads


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plane_dims(la_max: int, w_max: int, rows_max: int | None):
    """(S, NRB): band lanes and 16-row blocks of the parent plane."""
    S = _round_up(2 * w_max + 1, CHUNK)
    R = _round_up(min(la_max, rows_max) if rows_max else la_max, CHUNK)
    return S, R // RB


def _geometry(la, lb, la_max, LA, LB, ratio):
    tab_len = max(la_max, LB, LA) + 2
    _, _, band_tab = threshold_tensors(ratio, tab_len, str(la.device))
    return pair_geometry(la.to(torch.int32), lb.to(torch.int32), band_tab, tab_len)


def batch_parents_plain(
    a: torch.Tensor,
    la: torch.Tensor,
    b: torch.Tensor,
    lb: torch.Tensor,
    *,
    la_max: int,
    w_max: int,
    ratio: float = Constants.MAXR,
    rows_max: int | None = None,
):
    """Plain torch parent plane; returns (parents, md, len_b_dp)."""
    _build.count("plain_parents")
    dev = a.device
    B, LA = a.shape
    LB = b.shape[1]
    S, NRB = plane_dims(la_max, w_max, rows_max)
    W = w_max
    md, len_a, len_b = _geometry(la, lb, la_max, LA, LB, ratio)
    a32 = a.to(torch.int32)
    b32 = b.to(torch.int32)
    lb32 = lb.to(torch.int32)

    lane = torch.arange(S, dtype=torch.int32, device=dev)
    inf = torch.full((), INF, dtype=torch.int32, device=dev)
    j0 = (lane - W)[None, :]
    prev = torch.where((j0 >= 0) & (j0 <= torch.minimum(len_b, md)[:, None]), j0, inf)
    out = torch.zeros((B, NRB, S), dtype=torch.int32, device=dev)

    # Rows run over a working set of pairs: a pair leaves at a row-block
    # boundary once past its last row (len_a); its remaining rows are all
    # zero parents, so the plane equals the full-batch one.
    w = torch.arange(B, device=dev)
    nrows = min(NRB * RB, int(len_a.max().item())) if B else 0
    for i in range(1, nrows + 1):
        r = (i - 1) % RB
        if i == 1 or (i - 1) % (COMPACT * 2) == 0:
            if i > 1:
                keep = len_a[w] >= i
                w, prev_w = w[keep], prev_w[keep]
            else:
                prev_w = prev[w]
            a_w, b_w, lb_w = a32[w], b32[w], lb32[w]
            md_w, la_w, lbd_w = md[w], len_a[w], len_b[w]
            in_band = (lane[None, :] - W).abs() <= md_w[:, None]
            pw = torch.zeros((len(w), S), dtype=torch.int32, device=dev)
            nw = len(w)
        active = i <= la_w
        j = lane + (i - W)
        validj = ((j >= 1)[None, :] & (j[None, :] <= lbd_w[:, None])) & in_band & active[:, None]
        src = j - 1
        bvalid = (src >= 0)[None, :] & (src[None, :] < lb_w[:, None])
        bj = torch.where(bvalid, b_w[:, src.clamp(0, LB - 1).long()], -1)
        ai = a_w[:, i - 1] if i - 1 < LA else torch.zeros(nw, dtype=torch.int32, device=dev)
        mismatch = (bj != ai[:, None]).to(torch.int32)
        diag = torch.where(validj, prev_w + mismatch, inf)
        up_src = torch.cat([prev_w[:, 1:], inf.expand(nw, 1)], dim=1)
        up = torch.where(validj, up_src + 1, inf)
        D = torch.minimum(diag, up)
        border = (j == 0)[None, :] & ((i <= md_w) & active)[:, None]
        D = torch.where(border, torch.full_like(D, i), D)

        # exact min-plus prefix scan (INSERT chains) by doubling
        rr = D
        sh = 1
        while sh < S:
            shifted = torch.cat([inf.expand(nw, sh), rr[:, :-sh]], dim=1)
            rr = torch.minimum(rr, shifted + sh)
            sh <<= 1
        live = validj | border
        cur = torch.where(live, rr, inf)

        left_plus1 = torch.cat([inf.expand(nw, 1), cur[:, :-1]], dim=1) + 1
        par = torch.full_like(cur, DELETE)
        par = torch.where(cur == left_plus1, torch.full_like(par, INSERT), par)
        par = torch.where(cur == diag, torch.full_like(par, MATCH), par)
        par = torch.where(border, torch.full_like(par, DELETE), par)
        par = torch.where(live, par, torch.zeros_like(par))
        pw = pw | (par << (2 * r))
        prev_w = torch.where(active[:, None], cur, prev_w)
        if r == RB - 1 or i == nrows:
            out[w, (i - 1) // RB] = pw
            pw = torch.zeros_like(pw)
    return out, md, len_b


def batch_parents(
    a: torch.Tensor,
    la: torch.Tensor,
    b: torch.Tensor,
    lb: torch.Tensor,
    *,
    la_max: int,
    w_max: int,
    ratio: float = Constants.MAXR,
    rows_max: int | None = None,
):
    """Emit the packed parent plane; returns (parents, md, len_b_dp):
    parents (B, NRB, S) int32, md / len_b_dp the per-pair band geometry
    the walk needs."""
    if a.device.type == "cpu":
        return batch_parents_plain(
            a, la, b, lb, la_max=la_max, w_max=w_max, ratio=ratio, rows_max=rows_max
        )
    if a.device.type != "cuda":
        raise ValueError(f"no parent kernel for device {a.device}")
    return _launch_parents(
        a, la, b, lb, la_max=la_max, w_max=w_max, ratio=ratio, rows_max=rows_max
    )


def _launch_parents(a, la, b, lb, *, la_max, w_max, ratio, rows_max, lanes=0):
    """Check the inputs, launch csrc/tbwave.cu, count the launch. `lanes`
    (band lanes per thread: 4, 8 or 16; 0 = the kernel's choice) is
    for measurements that compare the kernel's shapes."""
    B, LA = a.shape
    LB = b.shape[1]
    _build.check_tensor(a, torch.uint8, (B, LA), "a")
    _build.check_tensor(b, torch.uint8, (B, LB), "b", a.device)
    _build.check_tensor(la, torch.int32, (B,), "la", a.device)
    _build.check_tensor(lb, torch.int32, (B,), "lb", a.device)
    S, NRB = plane_dims(la_max, w_max, rows_max)
    # shared memory: the parents' staging row (S int32) and the b codes
    smem = 4 * S + _round_up(LB, 16) + TB_STATIC_SMEM
    if S > TB_MAX_LANES or smem > SMEM_LIMIT:
        raise ValueError(
            f"band of {S} lanes with b rows of {LB} needs {smem} B of shared memory "
            f"(limit {SMEM_LIMIT}) and at most {TB_MAX_LANES} lanes"
        )
    md, len_a, len_b = _geometry(la, lb, la_max, LA, LB, ratio)
    a, b = a.contiguous(), b.contiguous()
    md, len_a, len_b = md.contiguous(), len_a.contiguous(), len_b.contiguous()
    # the kernel writes every word of the plane, zeros included
    out = torch.empty((B, NRB, S), dtype=torch.int32, device=a.device)
    lib = _build.library()
    with _build.launching(a) as stream:
        err = lib.pb_tbwave(
            a.data_ptr(), LA, b.data_ptr(), LB, md.data_ptr(),
            len_a.data_ptr(), len_b.data_ptr(), B, w_max, S, NRB, lanes, out.data_ptr(),
            stream,
        )
    _build.check(lib, err, "tbwave")
    _build.count("tbwave")
    return out, md, len_b


def walk_parents_plain(
    parents: torch.Tensor,   # (B, NRB, S) int32 packed parents
    b: torch.Tensor,         # (B, LB) codes (for MATCH/INSERT vals)
    lb_dp: torch.Tensor,     # (B,) DP len_b (for the row-0 analytic border)
    md: torch.Tensor,        # (B,)
    matlen_a: torch.Tensor,  # (B,) start cell (from screening)
    matlen_b: torch.Tensor,
    accept: torch.Tensor,    # (B,) bool
    *,
    w_max: int,
    e_max: int,
):
    """Per-pair walk on the host; returns (ops, vals, nedit) on the
    parents' device."""
    _build.count("plain_walk")
    dev = parents.device
    P = parents.cpu().numpy()
    bn = b.cpu().numpy()
    lim_v = np.minimum(lb_dp.cpu().numpy(), md.cpu().numpy())
    ma_v, mb_v = matlen_a.cpu().numpy(), matlen_b.cpu().numpy()
    acc_v = accept.cpu().numpy()
    B, NRB, S = P.shape
    LB = bn.shape[1]
    E = e_max
    ops = np.zeros((B, E), np.uint8)
    vals = np.zeros((B, E), np.uint8)
    nedit = np.zeros(B, np.int32)
    for q in range(B):
        if not acc_v[q]:
            continue
        lim = int(lim_v[q])
        i, j = int(ma_v[q]), int(mb_v[q])
        so: list[int] = []
        sv: list[int] = []
        done = False
        while not done and len(so) + TB_WALK <= E:
            for _ in range(TB_WALK):
                if i == 0:
                    p = INSERT if 1 <= j <= lim else 0
                else:
                    k = min(max(j - i + w_max, 0), S - 1)
                    im1 = i - 1
                    p = (int(P[q, min(im1 >> 4, NRB - 1), k]) >> ((im1 & 15) * 2)) & 3
                if p == 0:
                    done = True
                    break
                so.append(p)
                sv.append(int(bn[q, min(max(j - 1, 0), LB - 1)]) if p != DELETE else 0)
                if p != INSERT:
                    i -= 1
                if p != DELETE:
                    j -= 1
        t = len(so)
        ops[q, :t] = so[::-1]
        vals[q, :t] = sv[::-1]
        nedit[q] = t
    return (
        torch.from_numpy(ops).to(dev),
        torch.from_numpy(vals).to(dev),
        torch.from_numpy(nedit).to(dev),
    )


def walk_parents(
    parents: torch.Tensor,
    b: torch.Tensor,
    lb_dp: torch.Tensor,
    md: torch.Tensor,
    matlen_a: torch.Tensor,
    matlen_b: torch.Tensor,
    accept: torch.Tensor,
    *,
    w_max: int,
    e_max: int,
):
    """Walk the packed parent plane back from (matlen_a, matlen_b),
    emitting left-aligned edit streams (find_path, seq_aligner.h:214-233)."""
    if parents.device.type == "cpu":
        return walk_parents_plain(
            parents, b, lb_dp, md, matlen_a, matlen_b, accept, w_max=w_max, e_max=e_max
        )
    if parents.device.type != "cuda":
        raise ValueError(f"no walk kernel for device {parents.device}")
    return _launch_walk(
        parents, b, lb_dp, md, matlen_a, matlen_b, accept, w_max=w_max, e_max=e_max
    )


def _launch_walk(parents, b, lb_dp, md, matlen_a, matlen_b, accept, *, w_max, e_max):
    """Check the inputs, launch csrc/walk.cu, count the launch."""
    B, NRB, S = parents.shape
    LB = b.shape[1]
    dev = parents.device
    _build.check_tensor(parents, torch.int32, (B, NRB, S), "parents")
    _build.check_tensor(b, torch.uint8, (B, LB), "b", dev)
    vecs = []
    for name, t in (("lb_dp", lb_dp), ("md", md), ("matlen_a", matlen_a), ("matlen_b", matlen_b)):
        _build.check_tensor(t, torch.int32, (B,), name, dev)
        vecs.append(t.contiguous())
    _build.check_tensor(accept, torch.bool, (B,), "accept", dev)
    # shared memory: a ring of WALK_RING tiles of WALK_TILE plane words, the
    # ops and vals staging rows (E bytes each) and the b row
    smem = WALK_RING * WALK_TILE * 4 + 2 * _round_up(e_max, 16) + LB
    if S < WALK_TILE or NRB < 1 or smem > SMEM_LIMIT:
        raise ValueError(
            f"walk of a ({NRB}, {S}) plane with E={e_max} and b rows of {LB}: needs S >= "
            f"{WALK_TILE}, NRB >= 1 and {smem} B of shared memory (limit {SMEM_LIMIT})"
        )
    acc = accept.to(torch.uint8).contiguous()
    parents, b = parents.contiguous(), b.contiguous()
    ops = torch.empty((B, e_max), dtype=torch.uint8, device=dev)
    vals = torch.empty((B, e_max), dtype=torch.uint8, device=dev)
    nedit = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.library()
    with _build.launching(parents) as stream:
        err = lib.pb_walk(
            parents.data_ptr(), NRB, S, b.data_ptr(), LB,
            *(t.data_ptr() for t in vecs), acc.data_ptr(), B, w_max, e_max,
            ops.data_ptr(), vals.data_ptr(), nedit.data_ptr(), stream,
        )
    _build.check(lib, err, "walk")
    _build.count("walk")
    return ops, vals, nedit

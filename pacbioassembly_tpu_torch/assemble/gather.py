"""Device-side candidate materialization.

Port of pacbioassembly_tpu/assemble/gather.py. The read set is uploaded
once as a padded code matrix (forward rows, then reversed rows, so a
backward segment is the same forward-window rule on the reversed copy);
the current reference window is uploaded once per reference version. Per
candidate only five int32s cross the bus, and the (a, la, b, lb) batch is
gathered on the device with plain advanced indexing, feeding straight
into the kernels: the chosen screening kernel (K1 or K3, align/screen.py)
or the parent kernel and walk. (The TPU kernel's gather-avoiding block
fetches are a TPU workaround and are not ported.)

Semantics mirror BatchAssembler._materialize exactly (reference
get_accessor ref_seq.h:282-286 and the spaced_seed.cpp:424-426 trial
layout):

  forward:  b[t] = codes[j + t]            (t < slen - j, t < LB)
            a[u] = ref[p + u]              (u < la = min(ref_len, LA))
  backward: b[t] = codes[slen - 1 - j - t]
            a[u] = ref[p - u]
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..align.screen import ladder_size, score_batch
from ..align.tbwave import batch_parents, walk_parents


def gather_batch(
    ref_win: torch.Tensor,    # (2*Lrp,) uint8: window [pre,post) padded to Lrp, then its reverse
    wlen: int,                # real window length (post - pre)
    reads_mat: torch.Tensor,  # (2N, Lp) uint8: rows 0..N-1 forward codes, N..2N-1 reversed
    read_len: torch.Tensor,   # (N,) int32
    read_row: torch.Tensor,   # (B,) int32 row into reads_mat
    j: torch.Tensor,          # (B,) int32 trial offset
    fwd: torch.Tensor,        # (B,) bool
    prel: torch.Tensor,       # (B,) int32 window-relative ref position (p - pre)
    la: torch.Tensor,         # (B,) int32 = min(ref_len, LA), precomputed on host
    LA: int,
    LB: int,
):
    """(a, la, b, lb): (B, LA) / (B, LB) uint8 code matrices, zero past
    each pair's length, and int32 lengths. The prefilter's truncation to
    the first LB bases is lb = min(slen - j, LB)."""
    N = reads_mat.shape[0] // 2
    Lp = reads_mat.shape[1]
    Lrp = ref_win.shape[0] // 2
    dev = reads_mat.device
    row = read_row.long()
    jj = j.long()
    lb = torch.minimum(read_len[row].long() - jj, torch.tensor(LB, device=dev))

    t = torch.arange(LB, device=dev)[None, :]
    brow = torch.where(fwd, row, row + N)[:, None]
    b = reads_mat[brow, (jj[:, None] + t).clamp(0, Lp - 1)]
    b = torch.where(t < lb[:, None], b, torch.zeros_like(b))

    astart = torch.where(fwd, prel.long(), Lrp + (wlen - 1 - prel.long()))
    u = torch.arange(LA, device=dev)[None, :]
    a = ref_win[(astart[:, None] + u).clamp(0, 2 * Lrp - 1)]
    a = torch.where(u < la.long()[:, None], a, torch.zeros_like(a))
    return a, la.to(torch.int32), b, lb.to(torch.int32)


def parents_and_walk(a, la, b, lb, ma, mb, acc, *, LA, w_max, ratio, rows_max, e_max):
    """Parent plane + walk from the screening goal cells; returns host
    ((B, 2E) uint8 ops|vals, (B,) int32 nedit)."""
    parents, md, lb_dp = batch_parents(
        a, la, b, lb, la_max=LA, w_max=w_max, ratio=ratio, rows_max=rows_max
    )
    ops, vals, nedit = walk_parents(
        parents, b, lb_dp, md, ma, mb, acc, w_max=w_max, e_max=e_max
    )
    return torch.cat([ops, vals], dim=1).cpu().numpy(), nedit.cpu().numpy()


class DeviceBatchBuilder:
    """Holds the device-resident read matrix (forward AND reversed rows)
    and materializes screening / traceback batches on the device. `ok` is
    False (caller uses host packing) when the dense matrix would exceed
    MAX_MATRIX_BYTES."""

    # dense (2N, Lp) uint8 budget for the device copy
    MAX_MATRIX_BYTES = 1 << 30
    _BLK = 128  # row padding quantum

    def __init__(self, reads, cfg, device: torch.device):
        self.device = device
        lens = reads.lengths.astype(np.int64)
        n = len(lens)
        lmax = int(lens.max()) if n else 0
        lp = -(-max(lmax, 1) // self._BLK) * self._BLK
        self.ok = n > 0 and 2 * n * lp <= self.MAX_MATRIX_BYTES
        if not self.ok:
            return
        mat = np.zeros((2 * n, lp), dtype=np.uint8)
        for i in range(n):
            c = reads.codes(i)
            mat[i, : len(c)] = c
            mat[n + i, : len(c)] = c[::-1]
        self.reads_mat = torch.from_numpy(mat).to(device)
        self.read_len = torch.from_numpy(lens.astype(np.int32)).to(device)
        self._win_cache = (None, None)  # (key, (device window, wlen))

    def window(self, ref):
        """Device copy of ref.buf[pre:post) (padded to the 8192 ladder)
        concatenated with its reverse, plus the real window length;
        uploaded once per reference mutation-version. The key holds a weak
        reference, not id(ref): multi-contig restarts share this builder,
        and a later engine's reference may reuse a freed one's id."""
        key = (weakref.ref(ref), ref.version, ref.pre, ref.post)
        if self._win_cache[0] == key:
            return self._win_cache[1]
        win = ref.buf[ref.pre : ref.post]
        wlen = len(win)
        lrp = ladder_size(max(wlen, 1), 8192)
        arr = np.zeros(2 * lrp, dtype=np.uint8)
        arr[:wlen] = win
        arr[lrp : lrp + wlen] = win[::-1]
        pair = (torch.from_numpy(arr).to(self.device), wlen)
        self._win_cache = (key, pair)
        return pair

    def materialize(self, ref, read_row, j, fwd, prel, la, LA, LB):
        """(a, la, b, lb) as device tensors; inputs are host int vectors
        already padded to the batch ladder (pad rows: la=lb=1 via
        j=slen-1, handled by the caller)."""
        dwin, wlen = self.window(ref)
        v = torch.from_numpy(
            np.stack([read_row, j, fwd, prel, la]).astype(np.int32)
        ).to(self.device)
        return gather_batch(
            dwin, wlen, self.reads_mat, self.read_len,
            v[0], v[1], v[2] != 0, v[3], v[4], LA, LB,
        )

    def score(
        self, ref, read_row, j, fwd, prel, la, *, LA, LB, w_max, ratio, kind, screen_kernel,
    ):
        """Gather + score with the chosen screening kernel; returns host
        (B, 4) int32 [accept, matlen_a, dp_rows, matlen_b]."""
        a, la2, b, lb = self.materialize(ref, read_row, j, fwd, prel, la, LA, LB)
        res = score_batch(
            a, la2, b, lb, screen_kernel=screen_kernel, kind=kind,
            la_max=LA, w_max=w_max, ratio=ratio,
        )
        packed = torch.stack(
            [res.accept.to(torch.int32), res.matlen_a, res.dp_rows, res.matlen_b], dim=1
        )
        return packed.cpu().numpy()

    def traceback_parents(
        self, ref, read_row, j, fwd, prel, la, ma, mb, acc,
        *, LA, LB, w_max, ratio, rows_max, e_max,
    ):
        """Gather + parent kernel + walk; returns host ((B, 2E) uint8
        ops|vals, (B,) int32 nedit)."""
        a, la2, b, lb = self.materialize(ref, read_row, j, fwd, prel, la, LA, LB)
        g = torch.from_numpy(np.stack([ma, mb, acc]).astype(np.int32)).to(self.device)
        return parents_and_walk(
            a, la2, b, lb, g[0], g[1], g[2] != 0,
            LA=LA, w_max=w_max, ratio=ratio, rows_max=rows_max, e_max=e_max,
        )

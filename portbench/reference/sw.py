"""Plain banded Smith-Waterman x-drop endpoints, in torch, over many pairs.

The yardstick for the program's SW pass. It states the recurrence the
program promises and imports nothing of the program.

Pair p aligns q = codes2[qb[p] : qb[p] + qcap[p]] with
t = codes2[tb[p] : tb[p] + tcap[p]] (caps at most L; a read past the end of
codes2 takes its last byte; codes >= 4 read as q_n in q and t_n in t, so an
N never matches). H(i, j) is the best score of an alignment of q[0:i] with
t[0:j] from H(0, 0) = 0, by diagonal moves (match or mismatch) and up or
left moves (gap). Anti-diagonal d = i + j holds the W cells
i = ib(d) + r, r = 0 .. W - 1, ib(d) = (d + 1) // 2 - W // 2; cells outside
0 <= i <= len(q), 0 <= j <= len(t) hold nothing. A cell scoring below the
best of the earlier diagonals minus xdrop is pruned. The answer is
(best, best_i, best_j): the first strict improvement of best, at the
smallest band index of its diagonal.

``needed`` is the last anti-diagonal these inputs need: the first d >= 2 at
which diagonals d - 1 and d are wholly pruned (no later cell can score), or
len(q) + len(t) (at least 1). W * (needed + 1) cells a pair is the work any
implementation has to do.
"""

from __future__ import annotations

import torch

NEG = -(1 << 29)


def doubled(codes: torch.Tensor) -> torch.Tensor:
    """codes ++ reverse complement of codes (N stays N)."""
    comp = torch.where(codes < 4, 3 - codes, codes)
    return torch.cat([codes, comp.flip(0)])


def _windows(codes2, base, cap, L: int, W: int, n_code: int, fill: int):
    """[P, L + 2W] int32: character x of each window at column W + x, the
    fill outside [0, cap)."""
    P = base.shape[0]
    x = torch.arange(L, device=codes2.device)
    idx = (base[:, None] + x[None, :]).clamp(max=codes2.shape[0] - 1)
    ch = codes2[idx].to(torch.int32)
    ch = torch.where(ch >= 4, n_code, ch)
    ch = torch.where(x[None, :] < cap[:, None], ch, fill)
    out = torch.full((P, L + 2 * W), fill, dtype=torch.int32, device=codes2.device)
    out[:, W : W + L] = ch
    return out


def sw_endpoints(
    codes2: torch.Tensor, qb, qcap, tb, tcap, L: int, *, W: int = 128,
    match: int = 1, mismatch: int = -2, gap: int = -3, xdrop: int = 64,
    q_n: int = 250, t_n: int = 251,
):
    """(int32 [P, 3] (best, best_i, best_j), int64 [P] needed diagonal) on
    ``codes2``'s device."""
    dev = codes2.device
    qb = torch.as_tensor(qb, device=dev).to(torch.int64)
    tb = torch.as_tensor(tb, device=dev).to(torch.int64)
    ql = torch.as_tensor(qcap, device=dev).to(torch.int64).clamp(max=L)
    tl = torch.as_tensor(tcap, device=dev).to(torch.int64).clamp(max=L)
    P = qb.shape[0]
    if P == 0:
        return (torch.zeros((0, 3), dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    qw = _windows(codes2, qb, ql, L, W, q_n, 254)
    tw = _windows(codes2, tb, tl, L, W, t_n, 255)
    band = torch.arange(W, device=dev)
    ql_, tl_ = ql[:, None], tl[:, None]
    negrow = torch.full((P, 1), NEG, dtype=torch.int64, device=dev)

    def in_matrix(d: int):
        i = (d + 1) // 2 - W // 2 + band
        j = d - i
        return i, j, (i >= 0) & (j >= 0) & (i <= ql_) & (j <= tl_)

    # d = 0: (0, 0) = 0; d = 1: (1, 0) and (0, 1) cost a gap
    _, _, m0 = in_matrix(0)
    prev2 = torch.where(m0 & (band == W // 2), 0, NEG).to(torch.int64)
    i1, j1, m1 = in_matrix(1)
    prev = torch.where(m1 & (((i1 == 1) & (j1 == 0)) | ((i1 == 0) & (j1 == 1))),
                       gap, NEG).to(torch.int64)
    best = prev.amax(dim=1).clamp(min=0)
    bi = torch.zeros(P, dtype=torch.int64, device=dev)
    bj = torch.zeros(P, dtype=torch.int64, device=dev)
    dend = ql + tl
    needed = dend.clamp(min=1)
    open_ = torch.ones(P, dtype=torch.bool, device=dev)  # not yet wholly pruned
    prev_max = prev.amax(dim=1)
    top = int(dend.max())
    for d in range(2, top + 1):
        i, j, m = in_matrix(d)
        ib = (d + 1) // 2 - W // 2
        qs = qw[:, W + ib - 1 + band]
        ts = tw[:, (W + j - 1).clamp(0, L + 2 * W - 1)]
        sub = torch.where(qs == ts, match, mismatch)
        if d % 2 == 0:  # up = (i - 1, j) is band cell r - 1 of d - 1
            up = torch.cat([negrow, prev[:, :-1]], dim=1)
            left = prev
        else:  # left = (i, j - 1) is band cell r + 1 of d - 1
            up = prev
            left = torch.cat([prev[:, 1:], negrow], dim=1)
        diag_ok = (i >= 1) & (j >= 1)
        s = torch.maximum(
            torch.where(diag_ok, prev2 + sub, NEG),
            torch.maximum(torch.where(i >= 1, up + gap, NEG),
                          torch.where(j >= 1, left + gap, NEG)),
        )
        s = torch.where(m, s, NEG)
        s = torch.where(s < best[:, None] - xdrop, NEG, s)
        col = s.amax(dim=1)
        better = col > best
        r = torch.where(s == col[:, None], band, W).amin(dim=1)
        bi = torch.where(better, ib + r, bi)
        bj = torch.where(better, d - (ib + r), bj)
        best = torch.maximum(best, col)
        done = open_ & (torch.maximum(col, prev_max) == NEG) & (d <= dend)
        needed = torch.where(done, d, needed)
        open_ &= ~done
        prev_max = col
        prev2, prev = prev, s
        if d % 64 == 0 and not bool((open_ & (dend > d)).any()):
            break
    out = torch.stack([best, bi, bj], dim=1).to(torch.int32)
    return out, needed

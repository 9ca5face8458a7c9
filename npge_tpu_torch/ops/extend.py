"""Batched gapless group extension in plain torch ops.

Counterpart of ``npge_tpu/ops/extend.py``. Every anchor group's fragments
extend column by column in lockstep while the extended prefix stays at or
above MIN_IDENTITY (exact integer test) and ends on an identical column.

The doubled arena ``codes2 = codes ++ revcomp(codes)`` makes the column-s
character of any fragment, on either side and strand, ``codes2[base + s]``
for one scalar base per fragment (see the reference module docstring); the
window is read with one byte gather, with no row view or lane shifts.

The freeze rule of the round loop (a group that stops short of a full chunk
gets cap 0) makes each group's result independent of the batch it rides in,
so any batching gives the same answer.
"""

from __future__ import annotations

import numpy as np
import torch


# mirrors npge_tpu/ops/extend.py:make_codes2
def make_codes2(codes: torch.Tensor) -> torch.Tensor:
    """codes ++ revcomp(codes); rc[x] = complement(codes[T-1-x])."""
    comp = torch.where(codes < 4, 3 - codes, codes)
    return torch.cat([codes, comp.flip(0)])


# mirrors npge_tpu/ops/extend.py:_extend_core
def _extend_core(ch, within, fmask, carry_len, carry_ident, ident_num, ident_den):
    """Column logic. ch[B,F,S] codes; within[B,F,S] bool (in cap, in
    arena). Returns (ext[B], new_len[B], new_ident[B]) int32, see
    :func:`extend_chunk`."""
    ch = ch.to(torch.int16)
    usable_f = within & (ch < 4)  # per-fragment usable
    # masked min/max over fragments to test all-equal
    fm = fmask[..., None]
    eff = torch.where(usable_f, ch, 255)
    col_max = torch.where(fm, eff, -1).amax(dim=1)  # [B, S]
    col_min = torch.where(fm, eff, 255).amin(dim=1)
    col_usable = (~fm | usable_f).all(dim=1)  # mask -> usable
    col_ident = col_usable & (col_min == col_max) & (col_max < 4)

    # hard stop at first unusable column
    usable_prefix = torch.cummin(col_usable.to(torch.int32), dim=1).values == 1
    ident_eff = col_ident & usable_prefix
    cnt = torch.cumsum(ident_eff.to(torch.int32), dim=1, dtype=torch.int32)
    S = ch.shape[-1]
    L = torch.arange(1, S + 1, dtype=torch.int32, device=ch.device)[None, :]
    tot_len = (carry_len[:, None] + L).to(torch.int64)
    tot_cnt = (carry_ident[:, None] + cnt).to(torch.int64)
    ok = (
        usable_prefix
        & ident_eff  # last added column identical
        & (tot_cnt * ident_den >= ident_num * tot_len)
    )
    ext = torch.where(ok, L, 0).amax(dim=1).to(torch.int32)  # [B]
    # identical count at the chosen length (0 -> carry unchanged)
    i0 = (ext - 1).clamp(min=0).to(torch.int64)
    cnt_at = cnt.gather(1, i0[:, None])[:, 0]
    new_ident = carry_ident + torch.where(ext > 0, cnt_at, 0)
    return ext, carry_len + ext, new_ident.to(torch.int32)


# mirrors npge_tpu/ops/extend.py:extend_chunk
def extend_chunk(
    codes2: torch.Tensor,       # uint8[2T] doubled arena
    base: torch.Tensor,         # int64[B, F] forward window base per fragment
    fmask: torch.Tensor,        # bool[B, F] fragment present
    cap: torch.Tensor,          # int32[B, F] max further columns this side
    carry_len: torch.Tensor,    # int32[B] columns already extended this side
    carry_ident: torch.Tensor,  # int32[B] identical columns among them
    ident_num: int,
    ident_den: int,
    chunk: int,
):
    """Extend each group by up to ``chunk`` columns on one side.

    Returns ext[B] (0..chunk): the number of additional columns such that
    the cumulative extension (carry + ext) keeps identical / total >=
    ident_num / ident_den and the last added column is identical. A column
    is usable only if every present fragment has an in-cap real base there;
    the first unusable column stops the scan."""
    s = torch.arange(chunk, dtype=torch.int64, device=codes2.device)
    T2 = codes2.shape[0]
    idx = base[..., None] + s  # [B, F, S]
    ch = codes2[idx.clamp(0, T2 - 1)]
    within = (s < cap[..., None]) & (idx >= 0) & (idx < T2)
    return _extend_core(
        ch, within, fmask, carry_len, carry_ident, ident_num, ident_den
    )


# mirrors npge_tpu/ops/extend.py:extend_rounds_rows (byte gather, host loop)
def extend_rounds(
    codes2: torch.Tensor,
    base: torch.Tensor,   # int64[B, F]
    fmask: torch.Tensor,  # bool[B, F]
    cap: torch.Tensor,    # int32[B, F]
    ident_num: int,
    ident_den: int,
    chunk: int,
    max_rounds: int,
):
    """All extension rounds of one batch. Returns (total ext[B] int32
    tensor, rounds executed). After each chunk, groups that did not
    consume the full chunk freeze (cap -> 0), so results never depend on
    other groups in the batch triggering more rounds."""
    B = base.shape[0]
    z = torch.zeros(B, dtype=torch.int32, device=codes2.device)
    cl, ci, total = z, z, z
    rounds = 0
    while rounds < max_rounds:
        ext, cl, ci = extend_chunk(
            codes2, base, fmask, cap, cl, ci, ident_num, ident_den, chunk
        )
        rounds += 1
        total = total + ext
        active = ext == chunk
        if not bool(active.any()):
            break
        e = ext[:, None]
        base = base + e
        cap = torch.where(active[:, None], (cap - e).clamp(min=0), 0)
    return total, rounds


# mirrors npge_tpu/ops/extend.py:bases_for_groups
def bases_for_groups(pos, end, ori, T: int):
    """Per-occurrence forward-window bases into codes2 for both sides.

    pos/end: arena-global [lo, hi) of the current interval; ori +-1.
    Returns (base_left, base_right) int64 host arrays."""
    pos = np.asarray(pos, np.int64)
    end = np.asarray(end, np.int64)
    ori = np.asarray(ori, np.int64)
    base_r = np.where(ori == 1, end, 2 * T - pos)
    base_l = np.where(ori == 1, 2 * T - pos, end)
    return base_l, base_r

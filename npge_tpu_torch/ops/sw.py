"""Banded Smith-Waterman x-drop extension endpoints.

Counterpart of ``npge_tpu/ops/sw.py``. :func:`sw_extend_windows` is the
launch wrapper: on CUDA tensors it runs the hand-written kernel
``csrc/sw_xdrop.cu`` (which replaces the Pallas ``_sw_kernel``), on CPU
tensors the plain torch version :func:`_sw_torch_core`, a line-for-line
port of the reference's NumPy mirror. Both return the same int32 (best,
best_i, best_j) rows; see the kernel source for the recurrence.
"""

from __future__ import annotations

import torch

NEG = -(1 << 29)

# kernel launches by sw_extend_windows in this process (plain-version
# calls on CPU tensors are not launches)
SW_LAUNCHES = 0


# mirrors npge_tpu/ops/sw.py:_sw_numpy_core
def _sw_torch_core(qp, trp, qlen, tlen, L, W, match, mismatch, gap, xdrop):
    """Band recurrence over pre-padded [P, L+2W] tensors (layout of
    :func:`_pad_windows`); qlen/tlen are [P, 1]. Returns int32 [P, 3]."""
    dev = qp.device
    B = qp.shape[0]
    qlen = qlen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    band = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    prev2 = torch.where(band == W // 2, 0, NEG).expand(B, W).clone()
    i1 = (1 - W // 2) + band
    j1 = 1 - i1
    ok1 = ((i1 == 1) & (j1 == 0) & (qlen >= 1)) | (
        (i1 == 0) & (j1 == 1) & (tlen >= 1)
    )
    prev = torch.where(ok1, gap, NEG).to(torch.int64)
    best = prev.amax(dim=1, keepdim=True).clamp(min=0)
    bi = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    bj = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=torch.int64, device=dev)
    for d in range(2, 2 * L + 1):
        ib = (d + 1) // 2 - W // 2
        i = ib + band
        j = d - i
        qs = qp[:, (W + ib - 1 + band).clamp(0, qp.shape[1] - 1)[0]]
        ts = trp[:, (W + 1 + L - d + ib + band).clamp(0, trp.shape[1] - 1)[0]]
        sub = torch.where(qs == ts, match, mismatch)
        if d % 2 == 0:
            up = torch.cat([negcol, prev[:, :-1]], dim=1)
            left = prev
        else:
            up = prev
            left = torch.cat([prev[:, 1:], negcol], dim=1)
        inside = (i <= qlen) & (j <= tlen)
        s = torch.maximum(
            torch.where((i >= 1) & (j >= 1) & inside, prev2 + sub, NEG),
            torch.maximum(
                torch.where((i >= 1) & inside & (j >= 0), up + gap, NEG),
                torch.where((j >= 1) & inside & (i >= 0), left + gap, NEG),
            ),
        )
        s = torch.where(s < best - xdrop, NEG, s)
        col_best = s.amax(dim=1, keepdim=True)
        improved = col_best > best
        first_r = torch.where(s == col_best, band, W).amin(dim=1, keepdim=True)
        ii = ib + first_r
        jj = d - ii
        bi = torch.where(improved, ii, bi)
        bj = torch.where(improved, jj, bj)
        best = torch.maximum(best, col_best)
        prev2, prev = prev, s
    return torch.cat([best, bi, bj], dim=1).to(torch.int32)


# mirrors the window build of npge_tpu/ops/sw.py:sw_extend_windows (CPU branch)
def _pad_windows(codes2, qb, qcap, tb, tcap, L, W, q_n_code, t_n_code):
    """Padded [P, L+2W] int32 query / reversed-target rows of the windows
    codes2[qb : qb+qcap] and codes2[tb : tb+tcap] (N codes -> q_n / t_n,
    fills 254 / 255), and the [P, 1] lengths."""
    dev = codes2.device
    P = qb.shape[0]
    s = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    hi = codes2.shape[0] - 1
    qwin = codes2[torch.clamp(qb[:, None] + s, max=hi)].to(torch.int32)
    qwin = torch.where(qwin >= 4, q_n_code, qwin)
    q_core = torch.where(s < qcap[:, None], qwin, 254)
    twin = codes2[torch.clamp(tb[:, None] + s, max=hi)].to(torch.int32)
    twin = torch.where(twin >= 4, t_n_code, twin)
    t_core = torch.where(s < tcap[:, None], twin, 255)
    qp = torch.full((P, L + 2 * W), 254, dtype=torch.int32, device=dev)
    trp = torch.full((P, L + 2 * W), 255, dtype=torch.int32, device=dev)
    qp[:, W : W + L] = q_core
    trp[:, W + 1 : W + 1 + L] = t_core.flip(1)
    return qp, trp, qcap[:, None], tcap[:, None]


def sw_windows_plain(
    codes2, qb, qcap, tb, tcap, L: int, q_n_code: int = 250,
    t_n_code: int = 251, W: int = 128, match: int = 1, mismatch: int = -2,
    gap: int = -3, xdrop: int = 64,
):
    """The plain torch version of the kernel on any device: window build +
    :func:`_sw_torch_core`. Inputs as :func:`sw_extend_windows` takes
    them after its checks (int64 bases, int32 caps clipped to L)."""
    qp, trp, qlen, tlen = _pad_windows(
        codes2, qb, qcap, tb, tcap, L, W, q_n_code, t_n_code
    )
    return _sw_torch_core(qp, trp, qlen, tlen, L, W, match, mismatch, gap, xdrop)


def _sw_windows_cuda(
    codes2, qb, qcap, tb, tcap, L, q_n_code, t_n_code, W,
    match, mismatch, gap, xdrop,
):
    """Launch ``csrc/sw_xdrop.cu`` on the current stream."""
    global SW_LAUNCHES
    from npge_tpu_torch.ops._build import load_library

    if W != 128:
        raise ValueError(f"the CUDA kernel takes band width W = 128, got {W}")
    if not (0 < L <= 1 << 16):
        raise ValueError(f"window length L = {L} outside (0, 65536]")
    if not (0 <= xdrop < 1 << 28) or max(
        abs(match), abs(mismatch), abs(gap)
    ) >= 1 << 20:
        raise ValueError("scores must be below 2^20 and 0 <= xdrop < 2^28")
    if codes2.dtype != torch.uint8 or codes2.dim() != 1 or not codes2.is_contiguous():
        raise ValueError("codes2 must be a contiguous 1-D uint8 tensor")
    P = qb.shape[0]
    for name, t, dt in (
        ("qb", qb, torch.int64), ("tb", tb, torch.int64),
        ("qcap", qcap, torch.int32), ("tcap", tcap, torch.int32),
    ):
        if t.device != codes2.device or t.dtype != dt or t.shape != (P,):
            raise ValueError(f"{name} must be {dt} [{P}] on {codes2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((P, 3), dtype=torch.int32, device=codes2.device)
    if P == 0:
        return out
    lib = load_library()
    with torch.cuda.device(codes2.device):
        rc = lib.npge_sw_xdrop(
            codes2.data_ptr(), codes2.shape[0], qb.data_ptr(), tb.data_ptr(),
            qcap.data_ptr(), tcap.data_ptr(), out.data_ptr(), P, L, W,
            match, mismatch, gap, xdrop, q_n_code, t_n_code,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        msg = lib.npge_cuda_error_string(rc).decode()
        raise RuntimeError(f"sw_xdrop launch failed: CUDA error {rc} ({msg})")
    SW_LAUNCHES += 1
    return out


# mirrors npge_tpu/ops/sw.py:sw_extend_windows
def sw_extend_windows(
    codes2: torch.Tensor, qb, qcap, tb, tcap, L: int,
    q_n_code: int = 250, t_n_code: int = 251,
    W: int = 128,
    match: int = 1, mismatch: int = -2, gap: int = -3, xdrop: int = 64,
) -> torch.Tensor:
    """Batched x-drop endpoints over contiguous windows of ``codes2``.

    Pair p aligns codes2[qb[p] : qb[p]+qcap[p]] against
    codes2[tb[p] : tb[p]+tcap[p]] (caps clipped to L); N codes map to
    ``q_n_code`` / ``t_n_code``. Returns int32 [P, 3] (best, best_i,
    best_j) on ``codes2``'s device: the CUDA kernel for a CUDA tensor, the
    plain torch version for a CPU tensor."""
    dev = codes2.device
    qb = torch.as_tensor(qb, device=dev).to(torch.int64).contiguous()
    tb = torch.as_tensor(tb, device=dev).to(torch.int64).contiguous()
    qcap = torch.clamp(torch.as_tensor(qcap, device=dev), max=L)
    tcap = torch.clamp(torch.as_tensor(tcap, device=dev), max=L)
    qcap = qcap.to(torch.int32).contiguous()
    tcap = tcap.to(torch.int32).contiguous()
    sw = dict(match=match, mismatch=mismatch, gap=gap, xdrop=xdrop)
    if dev.type == "cuda":
        return _sw_windows_cuda(
            codes2, qb, qcap, tb, tcap, L, q_n_code, t_n_code, W, **sw
        )
    if dev.type != "cpu":
        raise ValueError(f"sw_extend_windows: unsupported device {dev}")
    if qb.shape[0] == 0:
        return torch.zeros((0, 3), dtype=torch.int32)
    return sw_windows_plain(
        codes2, qb, qcap, tb, tcap, L, q_n_code, t_n_code, W, **sw
    )

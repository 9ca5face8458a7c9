"""The benchmark's yardstick for kernels: the table of peaks, and the work
and least time of the SW x-drop pass.

SW work is counted from what the inputs need, not from what an
implementation does: W cells on each anti-diagonal up to the pair's needed
diagonal (``reference.sw``), ``SW_OPS_PER_CELL`` integer operations a cell
(the recurrence's own count: substitution compare and select, diagonal
add, two add-max for up and left, x-drop compare and select, running max).

The bound is the packed one: every operation on two 16-bit lanes of a
32-bit register, as the card's DPX and SIMD integer instructions offer on
sm_90. Scores of a window of L <= 512 fit 16 bits, so a kernel could do
that; a bound on plain int32 lanes would let such a kernel read above
100 %. The int32 bound is kept beside it for comparison with older
numbers.
"""

from __future__ import annotations

import numpy as np

SW_W = 128
SW_OPS_PER_CELL = 8

# published figures of each card the benchmark knows (NVIDIA H100 SXM data
# sheet: 132 SMs, 64 int32 lanes an SM, 1,980 MHz maximum SM clock, 3.35
# TB/s of HBM3), keyed by torch.cuda.get_device_name()
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "sms": 132, "int32_lanes_per_sm": 64, "sm_clock_hz": 1.98e9,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def int32_ops_per_s(peak: dict) -> float:
    return peak["sms"] * peak["int32_lanes_per_sm"] * peak["sm_clock_hz"]


def packed_ops_per_s(peak: dict) -> float:
    """Two 16-bit operations per int32 lane and clock."""
    return 2 * int32_ops_per_s(peak)


def sw_needed_cells(needed) -> int:
    """W * (needed diagonal + 1), summed over pairs."""
    return int(SW_W * (np.asarray(needed, np.int64) + 1).sum())


def sw_bytes(qcap, tcap) -> int:
    """Each pair reads its two windows and four coordinates once and writes
    three int32: sum(qcap + tcap) + 36 bytes a pair."""
    q = np.asarray(qcap, np.int64)
    t = np.asarray(tcap, np.int64)
    return int(q.sum() + t.sum() + 36 * len(q))


def sw_bound_s(cells: int, nbytes: int, peak: dict, packed: bool = True) -> float:
    """Least seconds for the pass: operations over the integer peak or
    bytes over HBM bandwidth, whichever is larger."""
    rate = packed_ops_per_s(peak) if packed else int32_ops_per_s(peak)
    return max(SW_OPS_PER_CELL * cells / rate, nbytes / peak["hbm_bytes_per_s"])

"""The SW kernel's share of its least time, in %.

Least time: the needed cells of every SW batch of the build the check
reads (from the reference's needed diagonals) at 8 integer operations a
cell on the packed 16-bit peak, or the batch's bytes at HBM bandwidth,
whichever is larger (``portbench.roofline``). Kernel time: the device
time of the ``sw_xdrop`` kernel in the traced window, over its builds.
Nothing to read without a known card or without the kernel in the trace.
"""

from portbench import roofline

KERNEL = "sw_xdrop"


def read(rec):
    peak = roofline.PEAKS.get(rec.get("device_name"))
    spent = sum(s for name, s in rec.get("kernels_s", {}).items() if KERNEL in name)
    if peak is None or spent <= 0 or not rec["sw_batches"]:
        return None
    bound = sum(
        roofline.sw_bound_s(roofline.sw_needed_cells(b["needed"]),
                            roofline.sw_bytes(b["qcap"], b["tcap"]), peak)
        for b in rec["sw_batches"])
    return 100.0 * bound / (spent / rec["n_builds"])

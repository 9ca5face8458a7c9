"""The traced window, reduced: device busy time per card, device time per
kernel, and the device's idle time booked to what the host was doing.

Device events are the profiler's CUDA-side events (kernels, copies, sets);
the ``pb:`` spans that the harness opens around pipeline steps, and their
device-side mirrors, are labels and not work. A card's busy time is the
union of its events' spans inside the window (events overlap; summing them
would count time twice). The window is the spans named ``pb.window``, one
a build: what the harness does between builds lies outside it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.capture import LABEL

WINDOW = "pb.window"


def _union(spans, lo: float, hi: float):
    """Merged, clipped (start, end) intervals of ``spans``."""
    out = []
    for a, b in sorted(spans):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _in_windows(spans, windows):
    """Merged intervals of ``spans`` clipped to each window, in order."""
    return [iv for lo, hi in windows for iv in _union(spans, lo, hi)]


def reduce_events(events, n_devices: int, launches_of: str = "sw_xdrop") -> dict:
    """``events``: (name, is_device, device_index, start_us, end_us) rows.
    Returns window_s, busy_s per card, kernel seconds by name, idle seconds
    of card 0 by host label, and the seconds of each launch of the kernels
    whose name holds ``launches_of``, in launch order."""
    windows = []
    labels = []
    per_dev = defaultdict(list)
    kernels = defaultdict(float)
    for name, is_dev, idx, a, b in events:
        if name == WINDOW and not is_dev:
            windows.append((a, b))
        elif name.startswith(LABEL) or name == WINDOW:
            if not is_dev:
                labels.append((a, b, name[len(LABEL):]))
        elif is_dev:
            per_dev[idx].append((a, b, name))
    if not windows:
        raise RuntimeError("the profiler recorded no window span")
    windows.sort()
    busy = []
    for d in range(n_devices):
        spans = [(a, b) for a, b, _n in per_dev.get(d, [])]
        busy.append(sum(b - a for a, b in _in_windows(spans, windows)) / 1e6)
    launches = []
    for spans in per_dev.values():
        for a, b, name in spans:
            for lo, hi in windows:
                a2, b2 = max(a, lo), min(b, hi)
                if b2 > a2:
                    kernels[name] += (b2 - a2) / 1e6
                    if launches_of in name:
                        launches.append((a2, (b2 - a2) / 1e6))
    # idle gaps of card 0 in each window, split over the step spans they
    # overlap ("other" for the time between steps); the steps do not nest
    gaps = []
    for lo, hi in windows:
        t = lo
        for a, b in _union([(a, b) for a, b, _n in per_dev.get(0, [])], lo, hi):
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
    labels.sort()
    starts = [a for a, _b, _n in labels]
    idle = defaultdict(float)
    for a, b in gaps:
        left = b - a
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(labels) and labels[i][0] < b:
            la, lb, name = labels[i]
            part = min(b, lb) - max(a, la)
            if part > 0:
                idle[name] += part / 1e6
                left -= part
            i += 1
        if left > 0:
            idle["other"] += left / 1e6
    return {
        "window_s": sum(hi - lo for lo, hi in windows) / 1e6,
        "busy_s": busy,
        "kernels_s": dict(kernels),
        "idle_by_step_s": dict(idle),
        "launches_s": [d for _a, d in sorted(launches)],
    }


def events_of(prof) -> list:
    """(name, is_device, device_index, start_us, end_us) of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.events():
        dev = e.device_type == DeviceType.CUDA
        rows.append((e.name, dev, int(e.device_index) if dev else -1,
                     float(e.time_range.start), float(e.time_range.end)))
    return rows


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

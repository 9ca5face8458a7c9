"""The program's tracer: :class:`StageTimings`, the books of one build.

A build books every stage, sub-step and blocking host-device transfer as a
span (:meth:`StageTimings.span`): its host seconds under its name, and the
span it ran inside, so that each book's self time (its seconds less those
of the spans inside it) is known and nested books are counted once. Work
counters (extension rounds, candidates by path, transfers and their bytes)
go under :meth:`StageTimings.count`.

While a ``torch.profiler`` records, each span is also a profiler event
named ``npge:<name>`` carrying its tags (a re-seed round's ``round`` and
``k``), so the spans sit on the clock of the device trace. The event is a
function-scope record, not a user annotation: the profiler then makes no
device-side copy of it, and the device timeline holds only device work.
With no profiler recording a span costs a ``perf_counter`` pair, two dict
updates and the profiler check.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

PREFIX = "npge:"


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _record(name: str, tags: dict):
    """The profiler event of span ``name`` (entered only while a profiler
    records)."""
    return torch._C._profiler._RecordFunctionFast(PREFIX + name, (), tags)


@dataclass
class StageTimings:
    """Host-clock books and counters of one build.

    ``seconds[name]`` sums every span of that name; ``nested[name]`` sums
    the spans that ran inside them; ``parents[name]`` holds the names of
    the spans they ran inside ("" at the top), in order of first entry."""

    seconds: dict[str, float] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)
    parents: dict[str, list[str]] = field(default_factory=dict)
    nested: dict[str, float] = field(default_factory=dict)
    _open: list[str] = field(default_factory=list, repr=False)

    def add(self, stage: str, dt: float) -> None:
        self.seconds[stage] = self.seconds.get(stage, 0.0) + dt

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        """Book the host seconds of the ``with`` body under ``name``."""
        parent = self._open[-1] if self._open else ""
        seen = self.parents.setdefault(name, [])
        if parent not in seen:
            seen.append(parent)
        self._open.append(name)
        rec = _record(name, tags) if _profiling() else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with rec:
                yield
        finally:
            dt = time.perf_counter() - t0
            self._open.pop()
            self.add(name, dt)
            if parent:
                self.nested[parent] = self.nested.get(parent, 0.0) + dt

    def self_seconds(self, name: str) -> float:
        return self.seconds.get(name, 0.0) - self.nested.get(name, 0.0)

    def report(self) -> str:
        """The books as a table, each under the span it first ran inside:
        self seconds (counted once however deep the nesting) and total
        seconds; TOTAL is the ``build`` span (the sum of the self times
        where there is none); then the counters."""
        names = list(self.parents) + [k for k in self.seconds if k not in self.parents]

        def depth(name: str) -> int:
            chain = [name]
            while self.parents.get(chain[-1], [""])[0] not in ("", *chain):
                chain.append(self.parents[chain[-1]][0])
            return len(chain) - 1

        lines = [f"{'stage':<30}{'self s':>10}{'total s':>10}"]
        for k in names:
            label = "  " * depth(k) + k
            lines.append(f"{label:<30}{self.self_seconds(k):>10.3f}{self.seconds.get(k, 0.0):>10.3f}")
        total = self.seconds.get("build", sum(self.self_seconds(k) for k in names))
        lines.append(f"{'TOTAL':<30}{total:>20.3f}")
        for k, v in self.counters.items():
            lines.append(f"{k:<30}{v:>20}")
        return "\n".join(lines)


def span(timings: StageTimings | None, name: str, **tags):
    """``timings.span(name, **tags)``, or nothing where no tracer is given."""
    return contextlib.nullcontext() if timings is None else timings.span(name, **tags)

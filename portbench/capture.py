"""What the harness records of the timed builds, from outside the program.

The program has no hooks for a benchmark, so the harness wraps, for the
length of a run, the functions that the pipeline calls by module attribute
(``npge_tpu_torch.algo.pangenome``'s imports, and ``ops.sw``'s SW entry,
which gapext calls through its module), and puts the originals back after.

* Records: each anchor scan (its arena's codes and offsets, k, and the
  groups), each extension (the groups it took, and the candidate blocks),
  each SW batch (its window coordinates and its output rows), and each
  re-seed round's consensus arena (the blocks it was made from, and its
  sequences) and mapping back (the candidates, and the blocks they became),
  and the blockset each join pass leaves, of the builds named in ``keep``. The correctness check reads them once the
  window has closed.
* Labels, in a traced run: every pipeline step runs inside a
  ``torch.profiler.record_function`` span named ``pb:<step>``, so the
  device's idle gaps can be booked to what the host was doing.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np

# the pipeline's steps, as the names it calls them by in its own module
STEPS = (
    "find_anchors", "sharded_find_anchors", "extend_anchor_groups",
    "resolve_overlaps", "join_blocks", "gapped_extend_blocks",
    "consensus_arena", "deconseq", "occupancy", "rest_blocks",
    "blockset_hash", "quality_metric", "assign_names", "upload_arena",
)
PIPELINE = "npge_tpu_torch.algo.pangenome"
SW_MODULE = "npge_tpu_torch.ops.sw"
SW_ENTRY = "sw_extend_windows"
LABEL = "pb:"


class Patches:
    """Module attributes replaced for a while, then put back in reverse."""

    def __init__(self):
        self._saved = []

    def set(self, module: str, name: str, value) -> None:
        mod = importlib.import_module(module)
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def get(self, module: str, name: str):
        return getattr(importlib.import_module(module), name)

    def undo(self) -> None:
        while self._saved:
            mod, name, value = self._saved.pop()
            setattr(mod, name, value)


class Recorder:
    """Installs the wrappers; ``build`` is the index of the build running
    (None outside the window)."""

    def __init__(self, keep=(0, 1), labels: bool = False):
        self.keep = set(keep)
        self.labels = labels
        self.build = None
        self.calls: dict[int, list] = {}  # build -> records in call order
        self.sw_pairs: dict[int, int] = {}  # build -> SW pairs
        self.patches = Patches()

    def _recording(self) -> bool:
        return self.build is not None and self.build in self.keep

    def _note(self, rec: dict) -> None:
        self.calls.setdefault(self.build, []).append(rec)

    def install(self) -> None:
        p = self.patches
        scan = p.get(PIPELINE, "find_anchors")
        sharded = p.get(PIPELINE, "sharded_find_anchors")
        extend = p.get(PIPELINE, "extend_anchor_groups")
        cons_arena = p.get(PIPELINE, "consensus_arena")
        deconseq = p.get(PIPELINE, "deconseq")
        join = p.get(PIPELINE, "join_blocks")
        sw_entry = p.get(SW_MODULE, SW_ENTRY)

        def note_scan(arena, cfg, k, groups):
            self._note({
                "kind": "scan", "codes": arena.codes, "offsets": arena.offsets,
                "circular": np.fromiter((arena.circular(i) for i in range(arena.n_seqs)),
                                        bool, arena.n_seqs),
                "k": int(k or cfg.ANCHOR_SIZE), "w": cfg.MINIMIZER_WINDOW,
                "max_fragments": cfg.MAX_ANCHOR_FRAGMENTS,
                "dedupe": cfg.ANCHOR_DEDUPE_WINDOW, "out": groups,
            })

        def find_anchors(arena, cfg, device, k=None):
            groups = scan(arena, cfg, device, k=k)
            if self._recording():
                note_scan(arena, cfg, k, groups)
            return groups

        def sharded_find_anchors(arena, cfg, mesh, k=None):
            groups = sharded(arena, cfg, mesh, k=k)
            if self._recording():
                note_scan(arena, cfg, k, groups)
            return groups

        def extend_anchor_groups(arena, groups, cfg, device, **kw):
            cand = extend(arena, groups, cfg, device, **kw)
            if self._recording():
                self._note({
                    "kind": "extend", "codes": arena.codes,
                    "offsets": arena.offsets, "groups": groups,
                    "num": cfg.MIN_IDENTITY.num, "den": cfg.MIN_IDENTITY.den,
                    "chunk": min(cfg.EXTEND_CHUNK, cfg.MAX_EXTEND),
                    "max_extend": cfg.MAX_EXTEND,
                    "out": (cand.offsets, cand.seq, cand.start, cand.length,
                            cand.ori),
                })
            return cand

        def consensus_arena(bs, *args, **kw):
            cons, src = cons_arena(bs, *args, **kw)
            if self._recording():
                self._note({
                    "kind": "cons", "blocks": list(bs.blocks),
                    "codes": cons.codes, "offsets": cons.offsets,
                    "src": [i for i, _cmap in src],
                })
            return cons, src

        def deconseq_(cand, cons_src, bs, *args, **kw):
            mapped = deconseq(cand, cons_src, bs, *args, **kw)
            if self._recording():
                self._note({
                    "kind": "deconseq", "blocks": list(bs.blocks),
                    "src": [i for i, _cmap in cons_src],
                    "cand": (cand.offsets, cand.seq, cand.start, cand.length,
                             cand.ori),
                    "out": list(mapped),
                })
            return mapped

        def join_blocks(bs, *args, **kw):
            n = join(bs, *args, **kw)
            if self._recording():
                self._note({"kind": "join", "blocks": list(bs.blocks)})
            return n

        def sw_extend_windows(codes2, qb, qcap, tb, tcap, L, **kw):
            out = sw_entry(codes2, qb, qcap, tb, tcap, L, **kw)
            if self.build is not None:
                self.sw_pairs[self.build] = self.sw_pairs.get(self.build, 0) + len(qb)
            if self._recording():
                self._note({
                    "kind": "sw", "n2": int(codes2.shape[0]), "L": int(L),
                    "kw": dict(kw),
                    "qb": np.array(qb, np.int64), "qcap": np.array(qcap, np.int64),
                    "tb": np.array(tb, np.int64), "tcap": np.array(tcap, np.int64),
                    "out": out,
                })
            return out

        wrapped = {
            "find_anchors": find_anchors,
            "sharded_find_anchors": sharded_find_anchors,
            "extend_anchor_groups": extend_anchor_groups,
            "consensus_arena": consensus_arena,
            "deconseq": deconseq_,
            "join_blocks": join_blocks,
        }
        for name in STEPS:
            fn = wrapped.get(name) or p.get(PIPELINE, name)
            p.set(PIPELINE, name, _labelled(name, fn) if self.labels else fn)
        p.set(SW_MODULE, SW_ENTRY, sw_extend_windows)

    def undo(self) -> None:
        self.patches.undo()


def _labelled(name: str, fn):
    from torch.profiler import record_function

    def run(*args, **kw):
        with record_function(LABEL + name):
            return fn(*args, **kw)

    return run


@contextlib.contextmanager
def installed(recorder: Recorder):
    recorder.install()
    try:
        yield recorder
    finally:
        recorder.undo()

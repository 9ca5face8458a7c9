"""Meta — registry of named pipeline stages and pipes, on a device.

Counterpart of ``npge_tpu/meta.py``: the same processor and pipe names, and
a stage is a function ``(BlockSet, Config, device) -> BlockSet``. The four
stages with device work (AnchorFinder, OverlapsResolver, MakePangenome,
IsPangenome) run on ``device``; every other stage calls the port's copy
of the host function that the reference's stage calls, and ignores the
device.

``run_script`` executes a user script with ``meta``, ``bs``, ``cfg`` and
``device`` in scope (the reference's Lua terminal with ``meta`` in scope).
"""

from __future__ import annotations

from typing import Callable

from npge_tpu_torch.config import Config
from npge_tpu_torch.model.blocks import BlockSet

Stage = Callable[[BlockSet, Config, object], BlockSet]

_REGISTRY: dict[str, Stage] = {}
_PIPES: dict[str, list[str]] = {}


def register(name: str):
    def deco(fn: Stage) -> Stage:
        _REGISTRY[name] = fn
        return fn

    return deco


def register_pipe(name: str, stages: list[str]) -> None:
    _PIPES[name] = stages


def get(name: str) -> Stage:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _PIPES:
        stages = _PIPES[name]

        def pipe(bs: BlockSet, cfg: Config, device) -> BlockSet:
            for s in stages:
                bs = get(s)(bs, cfg, device)
            return bs

        pipe.__name__ = name
        return pipe
    raise KeyError(
        f"unknown processor {name!r}; known: {', '.join(sorted(names()))}"
    )


def names() -> list[str]:
    return sorted(set(_REGISTRY) | set(_PIPES))


def run_script(path: str, bs: BlockSet, cfg: Config, device) -> BlockSet:
    """Execute a Python script with meta/bs/cfg/device in scope. The script
    may rebind ``bs``; the final value is returned."""
    import npge_tpu_torch.meta as meta_mod

    scope = {"meta": meta_mod, "bs": bs, "cfg": cfg, "device": device}
    with open(path) as fh:
        code = fh.read()
    exec(compile(code, path, "exec"), scope)
    return scope["bs"]


# ---- stages with device work (the port's own code) ----


@register("AnchorFinder")
def _anchor_finder(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.anchors import find_anchors
    from npge_tpu_torch.algo.extender import extend_anchor_groups

    groups = find_anchors(bs.arena, cfg, device)
    blocks = extend_anchor_groups(bs.arena, groups, cfg, device)
    return BlockSet(bs.arena, list(bs.blocks) + list(blocks))


@register("OverlapsResolver")
def _resolve(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.overlaps import resolve_overlaps

    return BlockSet(bs.arena, resolve_overlaps(bs.blocks, bs.arena, cfg))


@register("MakePangenome")
def _make_pangenome(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.pangenome import build_pangenome

    out, _ = build_pangenome(bs.arena, cfg, device)
    return out


@register("IsPangenome")
def _is_pangenome(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.is_pangenome import check_is_pangenome

    rep = check_is_pangenome(bs, cfg)
    print("IsPangenome:", "OK" if rep.ok else "FAIL", *rep.messages[:5])
    return bs


# ---- host stages ----


@register("Joiner")
def _join(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.joiner import join_blocks

    join_blocks(bs, cfg)
    return bs


@register("Rest")
def _rest(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.overlaps import occupancy
    from npge_tpu_torch.algo.rest import rest_blocks

    bs.blocks.extend(rest_blocks(bs.arena, occupancy(bs.arena, bs.blocks)))
    return bs


@register("Filter")
def _filter(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.filter import filter_blocks

    return BlockSet(bs.arena, filter_blocks(bs.blocks, bs.arena, cfg))


@register("Stem")
def _stem(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.algebra import stem

    return stem(bs)


@register("UniqueNames")
def _names(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.model.naming import assign_names

    assign_names(bs)
    return bs


@register("MergeUnique")
def _merge_unique(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.surgery import merge_unique

    merge_unique(bs, cfg)
    return bs


@register("MoveGaps")
def _move_gaps(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.surgery import move_gaps

    bs.blocks = [move_gaps(b, bs.arena) for b in bs.blocks]
    return bs


@register("CutGaps")
def _cut_gaps(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.surgery import cut_gaps

    bs.blocks = [
        cb for b in bs.blocks if (cb := cut_gaps(b, bs.arena)) is not None
    ]
    return bs


@register("SplitRepeats")
def _split_repeats(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.surgery import split_repeats

    out = []
    for b in bs.blocks:
        subs = split_repeats(b, bs, cfg) if b.n_frags >= 2 else None
        if subs is None:
            out.append(b)
        else:
            out.extend(subs if subs else [b])
    bs.blocks = out
    return bs


@register("FindLowSimilar")
def _find_low_similar(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.surgery import find_low_similar

    out = []
    for b in bs.blocks:
        out.extend(find_low_similar(b, bs.arena, cfg))
    bs.blocks = out
    return bs


@register("Stick")
def _stick(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.stick import stick_blocks

    stick_blocks(bs, cfg)
    return bs


@register("Align")
@register("MetaAligner")
def _align(bs: BlockSet, cfg: Config, device) -> BlockSet:
    from npge_tpu_torch.algo.aligners import align_block

    bs.blocks = [align_block(b, bs.arena, cfg) for b in bs.blocks]
    return bs


@register("RemoveAlignment")
def _remove_alignment(bs: BlockSet, cfg: Config, device) -> BlockSet:
    for b in bs.blocks:
        if b.alignment is not None and len(set(b.frags.length.tolist())) <= 1:
            b.alignment = None
    return bs


@register("RemoveNames")
def _remove_names(bs: BlockSet, cfg: Config, device) -> BlockSet:
    for b in bs.blocks:
        b.name = None
    return bs


register_pipe("JoinerPipe", ["Joiner", "Rest", "UniqueNames"])
register_pipe(
    "Pangenome",
    ["AnchorFinder", "OverlapsResolver", "Joiner", "Rest", "UniqueNames"],
)
